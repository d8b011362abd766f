"""Port logits vs ``pt2tpu.models.decoder.forward`` on the same parameters,
for the llama and gemma families.

Parameters are f32 (scales bf16, as the packed format stores them), so both
sides compute in f32 on the CPU and differ only in summation order and
transcendental rounding: logits are held at 1e-4 absolute (they are O(1))."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pt2tpu.models import common as jcommon
from pt2tpu.models import decoder as jdec
from pt2tpu.models import registry as jreg
from pt2tpu.utils import checkpoint as jckpt
from pt2tpu.utils import randmodel as jrand
from pt2tpu_torch.models import common as tcommon
from pt2tpu_torch.models import decoder as tdec
from pt2tpu_torch.models.registry import get_config
from pt2tpu_torch.utils.checkpoint import params_from_numpy

TOL = dict(rtol=1e-4, atol=1e-4)


def to_port(tree):
    flat, structure = {}, {}
    jckpt._flatten("", tree, flat, structure)
    return params_from_numpy(structure, {k: np.asarray(v) for k, v in flat.items()}, "cpu")


def make_params(cfg, layout, seed):
    key = jax.random.PRNGKey(seed)
    if layout == "dense":
        return jdec.init_params(cfg, key, dtype=jnp.float32)
    return jrand.random_ternary_params(cfg, key, dtype=jnp.float32, perm_mode=layout)


@pytest.mark.parametrize("layout", ["dense", "identity", "down", "ssr"])
@pytest.mark.parametrize("name", ["tiny-llama", "tiny-llama-gqa", "tiny-gemma"])
def test_logits_match_jax(name, layout):
    jcfg = jreg.get_config(name)
    tcfg = get_config(name)
    params = make_params(jcfg, layout, seed=len(name) + len(layout))
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, size=(2, 11))
    want = np.asarray(jdec.forward(jcfg, params, jnp.asarray(tokens, jnp.int32)))
    got = tdec.forward(tcfg, to_port(params), torch.from_numpy(tokens))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, **TOL)


@pytest.mark.parametrize("name", ["tiny-llama", "tiny-llama-gqa", "tiny-gemma"])
def test_bf16_logits_close_to_jax(name):
    """The serving dtype: bf16 activations round at the same points in both
    packages but through different CPU kernels, so logits are held at a
    relative L2 of 2e-2 (a few bf16 ulps, 2^-8 each, over two layers)."""
    jcfg = jreg.get_config(name)
    params = jrand.random_ternary_params(jcfg, jax.random.PRNGKey(11), perm_mode="down")
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, size=(2, 11))
    want = np.asarray(jdec.forward(jcfg, params, jnp.asarray(tokens, jnp.int32)), np.float32)
    got = tdec.forward(get_config(name), to_port(params), torch.from_numpy(tokens))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.linalg.norm(got - want) <= 2e-2 * np.linalg.norm(want)


def with_random_norms(params, rng, dtype):
    """The params with every RMSNorm weight drawn at random (a trained
    gemma's are far from 0, so 1 + w is far from 2 and rounds in bf16)."""
    def draw(w):
        return jnp.asarray(rng.normal(0.0, 0.7, size=w.shape), dtype)

    layers = dict(params["layers"], ln1_w=draw(params["layers"]["ln1_w"]),
                  ln2_w=draw(params["layers"]["ln2_w"]))
    return dict(params, layers=layers, lnf_w=draw(params["lnf_w"]))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gemma_random_norm_weights_match_jax(dtype):
    """tiny-gemma with random norm weights: (1 + w) rounded to the hidden
    dtype before the product and the bf16 embedding scale (8.0 at dim 64;
    the bf16 rounding of sqrt(dim) is held below). f32 at TOL; bf16 at the
    bf16 test's relative L2."""
    jcfg = jreg.get_config("tiny-gemma")
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    params = jrand.random_ternary_params(jcfg, jax.random.PRNGKey(5), dtype=jdt, perm_mode="down")
    params = with_random_norms(params, np.random.default_rng(6), jdt)
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, size=(2, 11))
    want = np.asarray(jdec.forward(jcfg, params, jnp.asarray(tokens, jnp.int32)), np.float32)
    got = tdec.forward(get_config("tiny-gemma"), to_port(params), torch.from_numpy(tokens))
    got = got.float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        assert np.linalg.norm(got - want) <= 2e-2 * np.linalg.norm(want)


def test_gemma_norm_and_embed_scale_round_as_jax():
    """Bit for bit in bf16: the norm by 1 + w (w random; 1 + w rounded to
    bf16 first) and the embedding scaled by sqrt(2048) rounded to bf16
    (45.25, not 45.2548...). Products by the unrounded factors give other
    bits, so the test sees the rounding."""
    jcfg = jreg.get_config("gemma-2b").with_(vocab_size=64, n_layers=1)
    tcfg = get_config("gemma-2b").with_(vocab_size=64, n_layers=1)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 2048)).astype(np.float32)
    w = rng.normal(0.0, 0.7, size=2048).astype(np.float32)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = np.asarray(jdec._norm(jcfg, xb, wb, None).astype(jnp.float32))
    tx, tw = (torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16() for a in (xb, wb))
    got = tdec._norm(tcfg, tx, tw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    unrounded = tcommon.rms_norm(tx.float(), 1.0 + tw.float(), tcfg.norm_eps)
    assert not np.array_equal(unrounded.bfloat16().float().numpy(), want)

    embed = rng.normal(0.0, 0.02, size=(64, 2048)).astype(np.float32)
    eb = jnp.asarray(embed, jnp.bfloat16)
    tokens = rng.integers(0, 64, size=(2, 5))
    want = np.asarray(jdec.embed_tokens(jcfg, {"embed": eb}, jnp.asarray(tokens, jnp.int32))
                      .astype(jnp.float32))
    te = torch.from_numpy(np.array(eb.astype(jnp.float32))).bfloat16()
    got = tdec.embed_tokens(tcfg, {"embed": te}, torch.from_numpy(tokens))
    assert got.dtype == torch.bfloat16 and float(torch.tensor(tcfg.embed_scale).bfloat16()) == 45.25
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert not torch.equal(got, (te[torch.from_numpy(tokens)].float() * tcfg.embed_scale).bfloat16())


@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
def test_activations_match_jax(act):
    """The MLP activations: gelu in its tanh form (jax.nn.gelu's default)."""
    x = np.random.default_rng(8).normal(0.0, 3.0, size=(4, 257)).astype(np.float32)
    jcfg = jreg.get_config("tiny-gemma").with_(act=act)
    want = np.asarray(jdec._act(jcfg, jnp.asarray(x)))
    got = tdec._act(get_config("tiny-gemma").with_(act=act), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_gemma_registry_entries_equal_jax():
    """The port's gemma entries are the JAX registry's, field by field."""
    for name in ("gemma-2b", "tiny-gemma"):
        want = dataclasses.asdict(jreg.get_config(name))
        assert dataclasses.asdict(get_config(name)) == want, name
    cfg = get_config("gemma-2b")
    assert (cfg.dim, cfg.n_layers, cfg.n_heads, cfg.kv_heads, cfg.hd, cfg.intermediate,
            cfg.vocab_size) == (2048, 18, 8, 1, 256, 16384, 256000)
    assert cfg.tie_embeddings and cfg.norm_plus_one and cfg.act == "gelu"
    assert cfg.embed_scale == 2048 ** 0.5
    tdec.check_supported(cfg)


@pytest.mark.parametrize(
    "llama3", [None, (8.0, 1.0, 4.0, 8192), (32.0, 1.0, 4.0, 64)]
)
def test_rope_tables_match_jax(llama3):
    # XLA's and torch's f32 pow may differ by one ulp in inv_freq; at
    # positions < 300 that moves the angle by at most 300 * 2^-23 ~ 3.6e-5.
    L = 300
    jc, js = jcommon.rope_tables(128, L, 500000.0, 1.0, llama3)
    tc, ts = tcommon.rope_tables(128, L, 500000.0, 1.0, llama3)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=L * 2.0**-23)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=L * 2.0**-23)


def test_attention_gqa_kv_valid_matches_jax():
    rng = np.random.default_rng(5)
    q = rng.normal(size=(2, 1, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 9, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 9, 2, 16)).astype(np.float32)
    valid = np.arange(9)[None, :] <= np.array([[3], [8]])
    want = np.asarray(jcommon.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        kv_valid=jnp.asarray(valid)))
    got = tcommon.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                            kv_valid=torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_unported_family_raises():
    """A config with a feature no family has (a norm, a position encoding, an
    activation) raises naming it; a mixture-of-experts config, ported now,
    is computed, as every dense family is."""
    dense = tdec.ModelConfig(family="gpt2", vocab_size=16, dim=8, n_layers=1, n_heads=2,
                             intermediate=16, norm="layernorm", pos="learned", act="gelu",
                             gated_mlp=False)
    tdec.check_supported(dense)
    tdec.check_supported(dense.with_(n_experts=4))
    with pytest.raises(NotImplementedError, match="not ported") as e:
        tdec.check_supported(dense.with_(norm="groupnorm", act="swish"))
    assert "norm='groupnorm'" in str(e.value) and "act='swish'" in str(e.value)


@pytest.mark.parametrize("name,missing", [
    ("gemma3-4b", "sandwich_norm"), ("qwen3-8b", "qk_norm"), ("bloom-560m", "pos='alibi'"),
    ("mixtral-8x7b", "mixture of experts"), ("tiny-opt", "non-gated MLP"),
])
def test_unported_features_are_named(name, missing):
    """Each of these JAX configs is computed, with experts as without (the
    feature that its family once lacked, ``missing``, is ported); a config
    with an unknown activation raises naming that alone."""
    cfg = tdec.ModelConfig.from_dict(dataclasses.asdict(jreg.get_config(name)))
    tdec.check_supported(cfg)
    tdec.check_supported(cfg if cfg.is_moe else cfg.with_(n_experts=4))
    with pytest.raises(NotImplementedError, match="not ported") as e:
        tdec.check_supported(cfg.with_(act="swish"))
    assert "act='swish'" in str(e.value) and missing not in str(e.value)
