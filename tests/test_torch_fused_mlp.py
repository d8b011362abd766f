"""The fused MLP (K2) of the port against the JAX package (CPU).

  * ``ternary_mlp_plain`` against ``ternary_mlp_pallas`` / ``_stacked`` in
    interpret mode, with and without the gather prologue, at D = 512,
    I = 1408 (11 blocks inside down's 16), n = 512, for each activation
    the TPU kernel takes (silu, gelu in its tanh form, relu). Both keep mid in f32 on
    the CPU, and the scales are drawn so that mu - alpha is exact in bf16
    (the Pallas kernel rounds it to the scale type). The port's plain
    version is held to 1e-5 of max|ref| against an exact float64 evaluation
    of the same MLP (numpy, dense dequantised weights). The Pallas kernel
    itself sits 2.9e-5 to 3.3e-5 from that evaluation on these inputs: its
    telescoped unpack for decode row tiles dots x against raw planes of up
    to 255 and subtracts (pallas_ternary.py:164-179, "algebraically exact but
    NOT bit-equal"), and the MLP chains two such products. So the port is
    held to the kernel within the kernel's own distance from float64 plus
    the same 1e-5.
  * the port's ``fused_mlp_apply`` against its own two-call path: 5e-3
    relative L2, the bound of ``verify_fused_mlp`` (the two-call path rounds
    mid through the activation type).
  * ``fused_mlp_ok`` gives the JAX predicate's answer on every layout of a
    table, the ungated MLP's included, with the backend check factored out
    (JAX's asks for a TPU, the port's for CUDA); an ungated pair that it
    routes goes through ``fused_mlp_apply`` as the two-call act(up) @ down.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from pt2tpu.core import packing as jpack
from pt2tpu.ops import gather as jgather
from pt2tpu.ops import ternary_matmul as jtm
from pt2tpu.ops.kernels import pallas_ternary as jpt
from pt2tpu.quant import fold as jfold
from pt2tpu.utils import checkpoint as jckpt
from pt2tpu.utils import randmodel as jrand
from pt2tpu_torch.ops import gather as tgather
from pt2tpu_torch.ops import ternary_matmul as ttm
from pt2tpu_torch.ops.kernels import ternary as tk
from pt2tpu_torch.utils.checkpoint import params_from_numpy

D, I, N = 512, 1408, 512


class _Cfg:
    gated_mlp = True


def to_port(tree):
    flat, structure = {}, {}
    jckpt._flatten("", tree, flat, structure)
    return params_from_numpy(structure, {k: np.asarray(v) for k, v in flat.items()}, "cpu")


def with_exact_scales(p, rng, valid_blocks):
    """Replace a JAX layer's scales by bf16 alpha = j / 256, mu = k / 1024
    (mu - alpha exact in bf16); pad blocks keep zero scales."""
    nb, n = p.alpha.shape
    keep = (np.arange(nb) < valid_blocks)[:, None]
    alpha = rng.integers(8, 40, size=(nb, n)) / 256.0 * keep
    mu = rng.integers(-30, 31, size=(nb, n)) / 1024.0 * keep
    return dataclasses.replace(p, alpha=jnp.asarray(alpha, jnp.bfloat16),
                               mu=jnp.asarray(mu, jnp.bfloat16))


def jax_mlp_layer(seed, gather):
    """(gateup, down) of one layer as the fold leaves them: a full-SSR layer
    (gather on gateup, down folded) or the "down" layout (no gather)."""
    rng = np.random.default_rng(seed)
    k0, k1 = jax.random.split(jax.random.PRNGKey(seed))
    gu = jrand.random_ternary_linear(k0, 2 * I, D, perm_mode="ssr" if gather else "identity")
    dn = jrand.random_ternary_linear(k1, N, I, perm_mode="ssr" if gather else "folded")
    gu = with_exact_scales(gu, rng, D // 128)
    dn = with_exact_scales(dn, rng, I // 128)
    if gather:
        lp = jfold.fold_layer_perms(_Cfg(), {"gateup": gu, "down": dn})
        gu, dn = lp["gateup"], lp["down"]
    return gu, dn


def rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def dense_f64(p):
    """A JAX packed layer as its dense (K, n) float64 weight, visit order."""
    T = np.asarray(jpack.unpack_ternary(p.packed, block_size=128), np.float64)
    nb, n = p.alpha.shape
    a = np.asarray(p.alpha, np.float64)[:, None, :]
    m = np.asarray(p.mu, np.float64)[:, None, :]
    return (T.reshape(nb, 128, n) * a + m).reshape(nb * 128, n)


def act_f64(act, g):
    if act == "silu":
        return g / (1.0 + np.exp(-g))
    if act == "gelu":  # the tanh form
        return 0.5 * g * (1.0 + np.tanh(np.sqrt(2.0 / np.pi) * (g + 0.044715 * g**3)))
    assert act == "relu"
    return np.maximum(g, 0.0)


def mlp_f64(x, gu, dn, gather, act="silu"):
    """The fused MLP's function in float64: gather (or pad), gate/up at the
    stored half width, act(gate) * up, down over its first half rows."""
    Wg = dense_f64(gu)
    x64 = x.astype(np.float64)
    if gather:
        xg = np.pad(x64, ((0, 0), (0, 1)))[:, np.minimum(np.asarray(gu.perm), x.shape[1])]
    else:
        xg = np.pad(x64, ((0, 0), (0, Wg.shape[0] - x.shape[1])))
    h = xg @ Wg
    half = h.shape[1] // 2
    g = h[:, :half]
    mid = act_f64(act, g) * h[:, half:]
    return mid @ dense_f64(dn)[:half]


def assert_close_to_jax(got, want, exact):
    assert rel_err(got, exact) <= 1e-5
    assert rel_err(got, want) <= rel_err(want, exact) + 1e-5


def check_plain_against_pallas(gather, act):
    gu, dn = jax_mlp_layer(1, gather)
    assert dn.input_folded and (gu.gather is not None) == gather
    x = np.random.default_rng(2).normal(size=(4, D)).astype(np.float32)
    perm = gu.perm if gather else None
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpt.ternary_mlp_pallas(
            jnp.asarray(x), perm, gu.packed, gu.alpha, gu.mu, dn.packed, dn.alpha, dn.mu,
            act=act, intermediate=I,
        ))
    p = to_port({"gu": gu, "dn": dn})
    tgu, tdn = p["gu"], p["dn"]
    got = tk.ternary_mlp_plain(
        torch.from_numpy(x), tgu.perm if gather else None, tgu.packed, tgu.alpha, tgu.mu,
        tdn.packed, tdn.alpha, tdn.mu, intermediate=I, act=act,
    ).numpy()
    assert got.shape == want.shape == (4, N)
    assert_close_to_jax(got, want, mlp_f64(x, gu, dn, gather, act))


def check_plain_against_pallas_stacked(gather, act):
    layers = [jax_mlp_layer(10 + li, gather) for li in range(2)]
    stack = lambda f: jnp.stack([f(gu, dn) for gu, dn in layers])  # noqa: E731
    x = np.random.default_rng(3).normal(size=(3, D)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpt.ternary_mlp_pallas_stacked(
            jnp.asarray(x), stack(lambda g, d: g.perm) if gather else None,
            stack(lambda g, d: g.packed), stack(lambda g, d: g.alpha), stack(lambda g, d: g.mu),
            stack(lambda g, d: d.packed), stack(lambda g, d: d.alpha), stack(lambda g, d: d.mu),
            1, act=act, intermediate=I,
        ))
    p = to_port({"gu": layers[1][0], "dn": layers[1][1]})
    tgu, tdn = p["gu"], p["dn"]
    got = tk.ternary_mlp_plain(
        torch.from_numpy(x), tgu.perm if gather else None, tgu.packed, tgu.alpha, tgu.mu,
        tdn.packed, tdn.alpha, tdn.mu, intermediate=I, act=act,
    ).numpy()
    assert_close_to_jax(got, want, mlp_f64(x, *layers[1], gather, act))


@pytest.mark.parametrize("gather", [True, False], ids=["ssr", "down"])
def test_mlp_plain_matches_pallas_interpret(gather):
    check_plain_against_pallas(gather, "silu")


@pytest.mark.parametrize("gather", [True, False], ids=["ssr", "down"])
def test_mlp_plain_matches_pallas_stacked_interpret(gather):
    check_plain_against_pallas_stacked(gather, "silu")


@pytest.mark.parametrize("gather", [True, False], ids=["ssr", "down"])
@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_mlp_plain_act_matches_pallas_interpret(act, gather):
    """GeGLU (gemma's MLP) and the relu mode, as the silu cases."""
    check_plain_against_pallas(gather, act)


@pytest.mark.parametrize("gather", [True, False], ids=["ssr", "down"])
@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_mlp_plain_act_matches_pallas_stacked_interpret(act, gather):
    check_plain_against_pallas_stacked(gather, act)


def test_mlp_unknown_activation_raises():
    """Any other activation raises ValueError, as the TPU kernel's _act_fn."""
    gu, dn = jax_mlp_layer(1, False)
    p = to_port({"gu": gu, "dn": dn})
    x = torch.zeros((2, D))
    for fn in (tk.ternary_mlp_plain, tk.ternary_mlp):
        with pytest.raises(ValueError, match="swish"):
            fn(x, None, p["gu"].packed, p["gu"].alpha, p["gu"].mu, p["dn"].packed,
               p["dn"].alpha, p["dn"].mu, intermediate=I, act="swish")
    with pytest.raises(ValueError, match="swish"):
        ttm.fused_mlp_apply(p["gu"], p["dn"], x, "swish")
    with pytest.raises(ValueError, match="swish"):
        jpt._act_fn("swish")


def check_fused_apply_against_two_call_path(gather, dtype, act):
    gu, dn = jax_mlp_layer(4, gather)
    p = to_port({"gu": gu, "dn": dn})
    tgu, tdn = p["gu"], p["dn"]
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 3, D)).astype(np.float32)).to(dtype)
    got = ttm.fused_mlp_apply(tgu, tdn, x, act, out_dtype=torch.float32)
    g = ttm.ternary_linear_apply(tgu, x, out_dtype=torch.float32)
    half = g.shape[-1] // 2
    fn = {"silu": F.silu, "gelu": lambda v: F.gelu(v, approximate="tanh"), "relu": F.relu}[act]
    mid = (fn(g[..., :I]) * g[..., half : half + I]).to(dtype)
    want = ttm.ternary_linear_apply(tdn, mid, out_dtype=torch.float32)
    assert got.shape == want.shape == (2, 3, N)
    assert ((got - want).norm() / want.norm()).item() <= 5e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gather", [True, False], ids=["ssr", "down"])
def test_fused_apply_matches_two_call_path(gather, dtype):
    check_fused_apply_against_two_call_path(gather, dtype, "silu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_fused_apply_act_matches_two_call_path(act, dtype):
    check_fused_apply_against_two_call_path(False, dtype, act)


def _pair(K, n, in_features, bs=128, bias=False, gather=False, **flags):
    """The same layout as a JAX and a port PackedTernaryLinear (zero data:
    the predicate reads only shapes and flags)."""
    arrs = dict(packed=np.zeros((K // 4, n), np.int8), alpha=np.zeros((K // bs, n), np.float32),
                mu=np.zeros((K // bs, n), np.float32), perm=np.arange(K, dtype=np.int32),
                bias=np.zeros(n, np.float32) if bias else None)
    gp = np.zeros((-(-in_features // 128) * 32, K), np.int8)
    j = jtm.PackedTernaryLinear(
        **{k: None if v is None else jnp.asarray(v) for k, v in arrs.items()},
        in_features=in_features,
        gather=jgather.PackedGather(jnp.asarray(gp), jnp.asarray(arrs["perm"]), in_features)
        if gather else None, **flags)
    t = ttm.PackedTernaryLinear(
        **{k: None if v is None else torch.from_numpy(v) for k, v in arrs.items()},
        in_features=in_features,
        gather=tgather.PackedGather(torch.from_numpy(gp), torch.from_numpy(arrs["perm"]),
                                    in_features) if gather else None, **flags)
    return j, t


SSR_GU = dict(K=512, n=2 * I, in_features=512, gather=True)
FOLDED_DN = dict(K=2048, n=N, in_features=I, input_folded=True)
LAYOUTS = {
    # name: (gateup, down, port impl, rows, JAX's answer)
    "ssr-decode": (SSR_GU, FOLDED_DN, "auto", 4, True),
    "ssr-64-rows": (SSR_GU, FOLDED_DN, "auto", 64, True),
    "ssr-prefill": (SSR_GU, FOLDED_DN, "auto", 65, False),
    "ssr-a8": (SSR_GU, FOLDED_DN, "a8", 4, False),
    "ssr-plain": (SSR_GU, FOLDED_DN, "plain", 4, False),
    "down-not-folded": (SSR_GU, dict(FOLDED_DN, input_folded=False), "auto", 4, False),
    "gateup-bias": (dict(SSR_GU, bias=True), FOLDED_DN, "auto", 4, False),
    "down-bias": (SSR_GU, dict(FOLDED_DN, bias=True), "auto", 4, False),
    "perm-without-gather": (dict(SSR_GU, gather=False), FOLDED_DN, "auto", 4, False),
    "down-layout": (dict(K=512, n=2 * I, in_features=512, identity_perm=True), FOLDED_DN,
                    "auto", 4, True),
    "down-layout-extra-lanes": (dict(K=2048, n=2 * I, in_features=512, identity_perm=True),
                                FOLDED_DN, "auto", 4, False),
    "down-out-not-128": (SSR_GU, dict(FOLDED_DN, n=320), "auto", 4, False),
    "intermediate-not-128": (dict(SSR_GU, n=2800), dict(FOLDED_DN, in_features=1400),
                             "auto", 4, False),
    "block-64": (dict(SSR_GU, bs=64), FOLDED_DN, "auto", 4, False),
    "ungated-width": (dict(SSR_GU, n=I), FOLDED_DN, "auto", 4, True),
    "llama-2-7b-padded": (dict(K=128, n=22528, in_features=128, identity_perm=True),
                          dict(K=12288, n=128, in_features=11008, input_folded=True),
                          "auto", 4, False),
    "llama-3-8b": (dict(K=128, n=28672, in_features=128, identity_perm=True),
                   dict(K=14336, n=128, in_features=14336, input_folded=True), "auto", 4, True),
}


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_fused_mlp_ok_gives_jax_answer(name, monkeypatch):
    gspec, dspec, impl, rows, expected = LAYOUTS[name]
    jgu, tgu = _pair(**gspec)
    jdn, tdn = _pair(**dspec)
    monkeypatch.setattr(jtm, "FUSED_MLP", True)
    with monkeypatch.context() as mp:
        mp.setattr(jtm.jax, "default_backend", lambda: "tpu")
        want = jtm.fused_mlp_ok(jgu, jdn, {"plain": "xla"}.get(impl, impl), rows)
    assert want == expected
    assert ttm._fused_mlp_layout_ok(tgu, tdn, impl, rows) == want
    assert ttm.fused_mlp_ok(tgu, tdn, impl, rows, "cuda") == want
    assert ttm.fused_mlp_ok(tgu, tdn, impl, rows, "cpu") is False


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gather", [True, False], ids=["ssr", "down"])
def test_fused_mlp_ok_routes_only_what_k2_takes(gather, dtype):
    """The ungated pair that the predicate now routes (up exactly I wide, as
    in the "ungated-width" layout) is one K2 takes: ``fused_mlp_apply`` on
    it equals the two-call act(up) @ down within the two-call bound."""
    from pt2tpu_torch.utils.randmodel import random_ternary_linear

    m = D if gather else 2048  # without a gather, x's width is up's 16 padded blocks
    gen = torch.Generator().manual_seed(6 + gather)
    tgu = random_ternary_linear(gen, I, m, perm_mode="ssr" if gather else "identity",
                                device="cpu")
    tdn = random_ternary_linear(gen, N, I, perm_mode="folded", device="cpu")
    assert ttm._fused_mlp_layout_ok(tgu, tdn, "auto", 4)
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(4, m)).astype(np.float32))
    x = x.to(dtype)
    got = ttm.fused_mlp_apply(tgu, tdn, x, "gelu", out_dtype=torch.float32)
    up = ttm.ternary_linear_apply(tgu, x, out_dtype=torch.float32)
    mid = F.gelu(up, approximate="tanh").to(dtype)
    want = ttm.ternary_linear_apply(tdn, mid, out_dtype=torch.float32)
    assert got.shape == want.shape == (4, N)
    assert ((got - want).norm() / want.norm()).item() <= 5e-3
