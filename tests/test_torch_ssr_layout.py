"""The full-SSR serving layout carried across the two packages (CPU).

In that layout qkv, o and gateup carry a PackedGather and down's
permutation is folded into gateup's output lanes (``quant/fold.py``). The
tests here hold the port's fold, random model and artifact handling of that
layout against the JAX package: the same bytes where the layout is
deterministic, greedy tokens identical and f32 logits within the 1e-4 of
``test_torch_decoder.py`` (both sides compute in f32 on the CPU and differ
only in summation order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pt2tpu.models import decoder as jdec
from pt2tpu.models import registry as jreg
from pt2tpu.ops import ternary_matmul as jtm
from pt2tpu.quant import fold as jfold
from pt2tpu.serve.generate import generate as jgenerate
from pt2tpu.utils import checkpoint as jckpt
from pt2tpu.utils import randmodel as jrand
from pt2tpu_torch.models import decoder as tdec
from pt2tpu_torch.models.registry import get_config
from pt2tpu_torch.quant import fold as tfold
from pt2tpu_torch.serve import generate as tgen
from pt2tpu_torch.utils import checkpoint as tckpt
from pt2tpu_torch.utils import randmodel as trand

TOL = dict(rtol=1e-4, atol=1e-4)


def flat_np(tree, ckpt):
    """A parameter tree's flat arrays as numpy (bf16 as uint16 bits) and its
    structure, through the package's own flattener."""
    flat, structure = {}, {}
    ckpt._flatten("", tree, flat, structure)
    out = {}
    for k, v in flat.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            out[k] = v.view(torch.int16).numpy().view(np.uint16) if v.dtype == torch.bfloat16 \
                else v.numpy()
        else:
            a = np.asarray(v)
            out[k] = a.view(np.uint16) if a.dtype == jnp.bfloat16 else a
    return out, structure


def assert_same(jtree, ttree):
    jflat, jstruct = flat_np(jtree, jckpt)
    tflat, tstruct = flat_np(ttree, tckpt)
    assert jstruct == tstruct
    assert sorted(jflat) == sorted(tflat)
    for k in jflat:
        assert tflat[k].dtype == jflat[k].dtype, k
        np.testing.assert_array_equal(tflat[k], jflat[k], err_msg=k)


def ssr_config(intermediate):
    return jreg.get_config("tiny-llama").with_(dim=256, intermediate=intermediate)


@pytest.mark.parametrize("intermediate", [512, 1024])
def test_jax_ssr_artifact_serves_in_port(tmp_path, intermediate):
    cfg = ssr_config(intermediate)
    params = jrand.random_ternary_params(cfg, jax.random.PRNGKey(intermediate),
                                         dtype=jnp.float32, perm_mode="ssr")
    jckpt.save_model(str(tmp_path), cfg, params)
    tcfg, tparams = tckpt.load_model(str(tmp_path), device="cpu")
    _, jparams = jckpt.load_model(str(tmp_path))
    assert_same(jparams, tparams)
    for name in ("qkv", "o", "gateup"):
        g = tparams["layers"][name].gather
        assert g is not None and g.packed.shape == (cfg.n_layers, cfg.dim // 4, g.out_lanes)
    assert tparams["layers"]["down"].input_folded

    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(2, 9)).astype(np.int32)
    want = np.asarray(jdec.forward(cfg, jparams, jnp.asarray(tokens), impl="xla"))
    got = tdec.forward(tcfg, tparams, torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.float().numpy(), want, **TOL)

    prompt = tokens[:, :6]
    want = np.asarray(jgenerate(cfg, jparams, jnp.asarray(prompt), 8, impl="xla"))
    got = tgen.greedy_generate(tcfg, tparams, torch.from_numpy(prompt), 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_port_ssr_artifact_serves_in_jax(tmp_path):
    cfg = ssr_config(512)
    tcfg = get_config("tiny-llama").with_(dim=256, intermediate=512)
    tparams = trand.random_ternary_params(tcfg, seed=3, perm_mode="ssr", device="cpu")
    for k in ("embed", "lnf_w"):  # dense parts in f32, so both sides compute in f32
        tparams[k] = tparams[k].float()
    tparams["lm_head"].w = tparams["lm_head"].w.float()
    for k in ("ln1_w", "ln2_w"):
        tparams["layers"][k] = tparams["layers"][k].float()
    tckpt.save_model(str(tmp_path), tcfg, tparams)
    jcfg, jparams = jckpt.load_model(str(tmp_path))
    assert jcfg == cfg
    assert_same(jparams, tparams)
    assert jparams["layers"]["qkv"].gather.packed.shape == (cfg.n_layers, 64, 2048)

    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(3, 5)).astype(np.int32)
    want = np.asarray(jgenerate(jcfg, jparams, jnp.asarray(prompt), 6, impl="xla"))
    got = tgen.greedy_generate(tcfg, tparams, torch.from_numpy(prompt), 6)
    np.testing.assert_array_equal(got.numpy(), want)


def _unfolded_layer(seed, D=256, I=512, ragged_down=False):
    """One pre-fold layer as the quantizer packs it: SSR perms, no gathers."""
    keys = jax.random.split(jax.random.PRNGKey(seed), 4)
    bare = lambda p: dataclasses.replace(p, gather=None)  # noqa: E731
    lp = {
        "qkv": bare(jrand.random_ternary_linear(keys[0], 3 * D, D, perm_mode="ssr")),
        "o": bare(jrand.random_ternary_linear(keys[1], D, D, perm_mode="ssr")),
        "gateup": bare(jrand.random_ternary_linear(keys[2], 2 * I, D, perm_mode="ssr")),
    }
    if ragged_down:
        # pad lanes interleaved among the valid ones: not a foldable prefix
        rng = np.random.default_rng(seed)
        K = -(-I // 128) * 128
        perm = rng.permutation(np.concatenate([np.arange(I), np.full(K - I, I)])).astype(np.int32)
        codes = rng.integers(-1, 2, size=(D, K)).astype(np.int8)
        nb = K // 128
        lp["down"] = jtm.make_packed_linear(
            jnp.asarray(codes), jnp.asarray(rng.normal(0.05, 0.01, (nb, D)), jnp.float32),
            jnp.asarray(rng.normal(0, 0.01, (nb, D)), jnp.float32), jnp.asarray(perm),
            None, in_features=I, block_size=128)
    else:
        lp["down"] = bare(jrand.random_ternary_linear(keys[3], D, I, perm_mode="ssr"))
    return lp


class _Cfg:
    gated_mlp = True


@pytest.mark.parametrize("ragged_down", [False, True], ids=["folded-down", "ragged-down"])
def test_fold_layer_perms_matches_jax(ragged_down):
    I = 200 if ragged_down else 512
    jlp = _unfolded_layer(7, I=I, ragged_down=ragged_down)
    jflat, jstruct = {}, {}
    jckpt._flatten("", jlp, jflat, jstruct)
    tlp = tckpt.params_from_numpy(jstruct, {k: np.asarray(v) for k, v in jflat.items()}, "cpu")
    want = jfold.fold_layer_perms(_Cfg(), jlp)
    got = tfold.fold_layer_perms(_Cfg(), tlp)
    assert_same(want, got)
    assert got["down"].input_folded != ragged_down
    assert (got["down"].gather is not None) == ragged_down
    assert got["gateup"].out_folded != ragged_down
    sigma = tfold.foldable_prefix_perm(tlp["down"])
    assert (sigma is None) == ragged_down
    if not ragged_down:
        np.testing.assert_array_equal(sigma.numpy(), jfold.foldable_prefix_perm(jlp["down"]))
        head = tfold.fold_head_perm(tlp["o"])
        assert_same({"h": jfold.fold_head_perm(jlp["o"])}, {"h": head})


def test_random_ssr_params_have_the_jax_layout():
    """The port's random full-SSR model has JAX's structure, shapes and
    dtypes, with the gathers stacked per layer and each gather the packed
    one-hot of its layer's own perm (the numbers differ: torch.Generator vs
    jax.random)."""
    from pt2tpu_torch.ops.gather import make_packed_gather

    cfg = ssr_config(1024)
    jp = jrand.random_ternary_params(cfg, jax.random.PRNGKey(0), perm_mode="ssr")
    tp = trand.random_ternary_params(get_config("tiny-llama").with_(dim=256, intermediate=1024),
                                     seed=0, perm_mode="ssr", device="cpu")
    jflat, jstruct = flat_np(jp, jckpt)
    tflat, tstruct = flat_np(tp, tckpt)
    assert jstruct == tstruct
    for k in jflat:
        assert (tflat[k].shape, tflat[k].dtype) == (jflat[k].shape, jflat[k].dtype), k
    for name in ("qkv", "o", "gateup"):
        lin = tp["layers"][name]
        for li in range(cfg.n_layers):
            g = lin.layer(li).gather
            assert torch.equal(g.perm, lin.perm[li])
            assert torch.equal(g.packed, make_packed_gather(lin.perm[li], cfg.dim).packed)


@pytest.mark.parametrize("name,dim", [("tiny-llama", None), ("llama-3-8b", None),
                                      ("tiny-llama", 639), ("tiny-llama", 640)])
def test_default_perm_mode_matches_jax(name, dim):
    jcfg, tcfg = jreg.get_config(name), get_config(name)
    if dim is not None:
        jcfg, tcfg = jcfg.with_(dim=dim), tcfg.with_(dim=dim)
    assert trand.default_perm_mode(tcfg) == jrand.default_perm_mode(jcfg)
