"""The artifact format is shared: JAX artifacts load in the port and the
port's load in JAX, with equal arrays (bit for bit, bf16 included)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pt2tpu.models import decoder as jdec
from pt2tpu.models import registry as jreg
from pt2tpu.utils import checkpoint as jckpt
from pt2tpu.utils import randmodel as jrand
from pt2tpu_torch.models.decoder import ModelConfig
from pt2tpu_torch.utils import checkpoint as tckpt


def _np_of_tensor(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _np_of_jax(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def assert_same_params(jparams, tparams):
    jflat, jstruct, tflat, tstruct = {}, {}, {}, {}
    jckpt._flatten("", jparams, jflat, jstruct)
    tckpt._flatten("", tparams, tflat, tstruct)
    assert jstruct == tstruct
    assert sorted(jflat) == sorted(tflat)
    for k in jflat:
        want, got = _np_of_jax(jflat[k]), _np_of_tensor(tflat[k])
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)


MODELS = {
    "ternary-down": lambda cfg: jrand.random_ternary_params(
        cfg, jax.random.PRNGKey(0), perm_mode="down"),
    "ternary-ssr": lambda cfg: jrand.random_ternary_params(
        cfg, jax.random.PRNGKey(1), perm_mode="ssr"),
    "dense-f32": lambda cfg: jdec.init_params(cfg, jax.random.PRNGKey(2)),
}


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_jax_artifact_loads_in_port(tmp_path, kind):
    cfg = jreg.get_config("tiny-llama-gqa")
    params = MODELS[kind](cfg)
    jckpt.save_model(str(tmp_path), cfg, params)
    tcfg, tparams = tckpt.load_model(str(tmp_path), device="cpu")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    _, jparams = jckpt.load_model(str(tmp_path))
    assert_same_params(jparams, tparams)


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_port_artifact_loads_in_jax(tmp_path, kind):
    cfg = jreg.get_config("tiny-llama")
    jckpt.save_model(str(tmp_path / "j"), cfg, MODELS[kind](cfg))
    tcfg, tparams = tckpt.load_model(str(tmp_path / "j"), device="cpu")
    tckpt.save_model(str(tmp_path / "t"), tcfg, tparams)
    jcfg, jparams = jckpt.load_model(str(tmp_path / "t"))
    assert jcfg == cfg
    assert_same_params(jparams, tparams)


def test_params_from_numpy_gives_same_tensors():
    cfg = jreg.get_config("tiny-llama")
    params = jrand.random_ternary_params(cfg, jax.random.PRNGKey(3), perm_mode="down")
    flat, structure = {}, {}
    jckpt._flatten("", params, flat, structure)
    tparams = tckpt.params_from_numpy(
        structure, {k: np.asarray(v) for k, v in flat.items()}, "cpu"
    )
    assert_same_params(params, tparams)
    assert tparams["embed"].dtype == torch.bfloat16
    assert tparams["layers"]["qkv"].packed.dtype == torch.int8


def test_config_tuples_survive_json(tmp_path):
    """JSON turns tuples into lists; the port's config takes them back."""
    cfg = jreg.get_config("tiny-llama").with_(rope_llama3=(8.0, 1.0, 4.0, 64))
    jckpt.save_model(str(tmp_path), cfg, jdec.init_params(cfg, jax.random.PRNGKey(0)))
    tcfg, _ = tckpt.load_model(str(tmp_path), device="cpu")
    assert tcfg.rope_llama3 == (8.0, 1.0, 4.0, 64)
    assert isinstance(tcfg, ModelConfig)


def test_cuda_request_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    cfg = jreg.get_config("tiny-llama")
    jckpt.save_model(str(tmp_path), cfg, jdec.init_params(cfg, jax.random.PRNGKey(0)))
    with pytest.raises(RuntimeError, match="no GPU"):
        tckpt.load_model(str(tmp_path))  # default device: the card


def test_random_params_have_the_jax_layout():
    """The port's random model has JAX's structure, shapes and dtypes (the
    numbers differ: torch.Generator vs jax.random)."""
    from pt2tpu_torch.models.registry import get_config
    from pt2tpu_torch.utils.randmodel import random_ternary_params

    for mode in ("identity", "down"):
        jp = jrand.random_ternary_params(jreg.get_config("tiny-llama-gqa"),
                                         jax.random.PRNGKey(0), perm_mode=mode)
        tp = random_ternary_params(get_config("tiny-llama-gqa"), seed=0, perm_mode=mode,
                                   device="cpu")
        jflat, jstruct, tflat, tstruct = {}, {}, {}, {}
        jckpt._flatten("", jp, jflat, jstruct)
        tckpt._flatten("", tp, tflat, tstruct)
        assert jstruct == tstruct
        for k in jflat:
            want = _np_of_jax(jflat[k])
            got = _np_of_tensor(tflat[k])
            assert (got.shape, got.dtype) == (want.shape, want.dtype), k
            if k.endswith(".perm"):
                np.testing.assert_array_equal(got, want)


def test_pad_gateup_blocks_at_7b_width():
    """llama-2-7b: gateup 2 x 11008 lanes is padded to 2 x 11264 = 22528,
    byte for byte as the JAX package pads it (a short K keeps it small)."""
    from pt2tpu.ops.ternary_matmul import PackedTernaryLinear as JLinear
    from pt2tpu.quant.fold import pad_gateup_blocks as jpad
    from pt2tpu_torch.ops.ternary_matmul import PackedTernaryLinear as TLinear
    from pt2tpu_torch.quant.fold import pad_gateup_blocks as tpad

    rng = np.random.default_rng(0)
    I, D = 11008, 128
    gu = dict(packed=rng.integers(-128, 128, (D // 4, 2 * I)).astype(np.int8),
              alpha=rng.normal(size=(1, 2 * I)).astype(np.float32),
              mu=rng.normal(size=(1, 2 * I)).astype(np.float32),
              perm=np.arange(D, dtype=np.int32))
    dn = dict(packed=np.zeros((12288 // 4, 128), np.int8),
              alpha=np.zeros((96, 128), np.float32), mu=np.zeros((96, 128), np.float32),
              perm=np.arange(12288, dtype=np.int32))
    flags = dict(identity_perm=True, input_folded=True)
    jl = jpad({"gateup": JLinear(bias=None, in_features=D, identity_perm=True,
                                 **{k: jnp.asarray(v) for k, v in gu.items()}),
               "down": JLinear(bias=None, in_features=I, **flags,
                               **{k: jnp.asarray(v) for k, v in dn.items()})})
    tl = tpad({"gateup": TLinear(bias=None, in_features=D, identity_perm=True,
                                 **{k: torch.from_numpy(v) for k, v in gu.items()}),
               "down": TLinear(bias=None, in_features=I, **flags,
                               **{k: torch.from_numpy(v) for k, v in dn.items()})})
    assert tl["gateup"].out_features == 22528 == jl["gateup"].out_features
    for name in ("packed", "alpha", "mu"):
        np.testing.assert_array_equal(getattr(tl["gateup"], name).numpy(),
                                      np.asarray(getattr(jl["gateup"], name)))
    assert tpad(tl)["gateup"].out_features == 22528  # idempotent


def test_gemma_artifact_both_ways_same_logits(tmp_path):
    """A tiny-gemma artifact written by JAX loads in the port, and the
    port's copy of it loads in JAX: the same arrays, no lm_head (tied
    embeddings), gemma's config fields in the manifest, and the same f32
    logits from either package on either artifact."""
    import json

    from pt2tpu_torch.models import decoder as tdec

    cfg = jreg.get_config("tiny-gemma")
    params = jrand.random_ternary_params(cfg, jax.random.PRNGKey(4), dtype=jnp.float32,
                                         perm_mode="down")
    jckpt.save_model(str(tmp_path / "j"), cfg, params)
    tcfg, tparams = tckpt.load_model(str(tmp_path / "j"), device="cpu")
    assert tparams["lm_head"] is None
    tckpt.save_model(str(tmp_path / "t"), tcfg, tparams)
    with open(tmp_path / "t" / "manifest.json") as f:
        manifest = json.load(f)
    mc = manifest["model_config"]
    assert (mc["family"], mc["act"], mc["norm_plus_one"], mc["tie_embeddings"]) == (
        "gemma", "gelu", True, True)
    assert mc["embed_scale"] == 64 ** 0.5 and mc["head_dim"] == 32 and mc["n_kv_heads"] == 2
    assert manifest["structure"]["lm_head"] == {"kind": "none"}
    jcfg, jparams = jckpt.load_model(str(tmp_path / "t"))
    assert jcfg == cfg
    assert_same_params(jparams, tparams)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, size=(2, 9))
    want = np.asarray(jdec.forward(jcfg, jparams, jnp.asarray(tokens, jnp.int32)))
    np.testing.assert_allclose(
        np.asarray(jdec.forward(cfg, params, jnp.asarray(tokens, jnp.int32))), want, rtol=0, atol=0)
    got = tdec.forward(tcfg, tparams, torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_port_random_gemma_has_the_jax_layout():
    """The port's random gemma-layout model: JAX's structure, shapes and
    dtypes, no lm_head, norm weights stored as ones (the 1 + w is applied
    by the norm, never baked into the weights)."""
    from pt2tpu_torch.models.registry import get_config
    from pt2tpu_torch.utils.randmodel import random_ternary_params

    for mode in ("ssr", "down"):
        jp = jrand.random_ternary_params(jreg.get_config("tiny-gemma"), jax.random.PRNGKey(0),
                                         perm_mode=mode)
        tp = random_ternary_params(get_config("tiny-gemma"), seed=0, perm_mode=mode,
                                   device="cpu")
        jflat, jstruct, tflat, tstruct = {}, {}, {}, {}
        jckpt._flatten("", jp, jflat, jstruct)
        tckpt._flatten("", tp, tflat, tstruct)
        assert jstruct == tstruct and tstruct["lm_head"] == {"kind": "none"}
        for k in jflat:
            want, got = _np_of_jax(jflat[k]), _np_of_tensor(tflat[k])
            assert (got.shape, got.dtype) == (want.shape, want.dtype), k
        for w in (tp["lnf_w"], tp["layers"]["ln1_w"], tp["layers"]["ln2_w"]):
            assert torch.equal(w, torch.ones_like(w))
