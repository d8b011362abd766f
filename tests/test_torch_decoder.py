"""Port logits vs ``pt2tpu.models.decoder.forward`` on the same parameters.

Parameters are f32 (scales bf16, as the packed format stores them), so both
sides compute in f32 on the CPU and differ only in summation order and
transcendental rounding: logits are held at 1e-4 absolute (they are O(1))."""

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
@pytest.mark.parametrize("name", ["tiny-llama", "tiny-llama-gqa"])
def test_logits_match_jax(name, layout):
    jcfg = jreg.get_config(name)
    tcfg = get_config(name)
    params = make_params(jcfg, layout, seed=len(name) + len(layout))
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, size=(2, 11))
    want = np.asarray(jdec.forward(jcfg, params, jnp.asarray(tokens, jnp.int32)))
    got = tdec.forward(tcfg, to_port(params), torch.from_numpy(tokens))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, **TOL)


@pytest.mark.parametrize("name", ["tiny-llama", "tiny-llama-gqa"])
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
    cfg = tdec.ModelConfig(family="gpt2", vocab_size=16, dim=8, n_layers=1, n_heads=2,
                           intermediate=16, norm="layernorm", pos="learned", act="gelu",
                           gated_mlp=False)
    with pytest.raises(NotImplementedError, match="not ported"):
        tdec.check_supported(cfg)
