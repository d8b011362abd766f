"""K2's floor probe (``fused_mlp_apply(..., impl="floor8")``) of the port
against the JAX package (CPU).

JAX reaches it only by a direct call: ``fused_mlp_apply(impl="floor8")``
passes ``a8="floor"`` to ``ternary_mlp_pallas`` / ``_stacked``, whose
``_accumulate_step`` then takes its floor branch for gate, up and down
alike: x rounded and clipped to int8 (no row normalisation), the raw packed
bytes replicated to the block's depth as the codes, mid rounded and clipped
the same way. The port's contract is ``ternary_mlp_floor_plain``; each of
K2's three paths has a FLOOR instance on the card
(``tests/test_torch_kernels_cuda.py``).

  * ``ternary_mlp_floor_plain`` against the Pallas kernel in interpret mode
    (f32 x, as the JAX package's own tests run it), single and stacked at a
    layer index, with and without the gather prologue, gated and ungated,
    silu / gelu / relu, at D = 512, I = 1408, n = 512, on rows whose scales
    run from 0.05 to 8 (so mid ranges from exact small integers to the
    clip). Held within 1e-5 of max|ref|: both sum the same integer block
    dots in f32 and differ only in the order of the alpha and offset terms.
    A mid that lands within an f32 ulp of a half would round apart (the
    probe's one discontinuity); none does on these draws, and 1e-5 would
    not cover one (a flipped mid moves an output by alpha * b, some 1e-4 of
    max|ref| here).
  * ``fused_mlp_apply(impl="floor8")`` against JAX's, single and stacked;
    every other impl computes the bf16 MLP, as JAX's does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pt2tpu.ops import ternary_matmul as jtm
from pt2tpu.ops.kernels import pallas_ternary as jpt
from pt2tpu_torch.ops import ternary_matmul as ttm
from pt2tpu_torch.ops.kernels import ternary as tk
from test_torch_fused_mlp import D, I, jax_mlp_layer, rel_err, to_port
from test_torch_fused_mlp_ungated import jax_ungated_layer

ACTS = ["silu", "gelu", "relu"]
ROWS = 12
TOL = 1e-5


def floor_x():
    """(ROWS, D) f32 rows whose scales run geometrically from 0.05 to 8."""
    rng = np.random.default_rng(3)
    scale = np.geomspace(0.05, 8.0, ROWS)[:, None]
    return (rng.normal(size=(ROWS, D)) * scale).astype(np.float32)


def layer(gated, gather, seed):
    if gated:
        return jax_mlp_layer(seed, gather)
    return jax_ungated_layer(seed, gather)


def jax_floor(x, layers, gather, act, stacked):
    """JAX's Pallas K2 with a8="floor" in interpret mode: layer 0 alone, or
    layer 1 of the stack of ``layers``."""
    if stacked:
        st = lambda f: jnp.stack([f(g, d) for g, d in layers])  # noqa: E731
        args = (st(lambda g, d: g.perm) if gather else None, st(lambda g, d: g.packed),
                st(lambda g, d: g.alpha), st(lambda g, d: g.mu), st(lambda g, d: d.packed),
                st(lambda g, d: d.alpha), st(lambda g, d: d.mu), 1)
        fn = jpt.ternary_mlp_pallas_stacked
    else:
        g, d = layers[0]
        args = (g.perm if gather else None, g.packed, g.alpha, g.mu, d.packed, d.alpha, d.mu)
        fn = jpt.ternary_mlp_pallas
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn(jnp.asarray(x), *args, act=act, intermediate=I, a8="floor"))


CASES = [(True, True), (True, False), (False, True), (False, False)]  # (gated, gather)
CASE_IDS = ["gated-ssr", "gated-down", "ungated-ssr", "ungated-down"]


@pytest.fixture(scope="module")
def floor_outputs():
    x = floor_x()
    out = {}
    for gated, gather in CASES:
        single = [layer(gated, gather, 1)]
        stack = [layer(gated, gather, 10 + li) for li in range(2)]
        for act in ACTS:
            out[gated, gather, act] = (
                (single[0], jax_floor(x, single, gather, act, False)),
                (stack[1], jax_floor(x, stack, gather, act, True)),
            )
    return x, out


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("gated,gather", CASES, ids=CASE_IDS)
def test_floor_plain_matches_pallas_floor(floor_outputs, gated, gather, act):
    x, out = floor_outputs
    key = "gateup" if gated else "up"
    for (gu, dn), want in out[gated, gather, act]:
        p = to_port({"gu": gu, "dn": dn})
        got = tk.ternary_mlp_floor_plain(
            torch.from_numpy(x), p["gu"].perm if gather else None, p["gu"].packed, p["gu"].alpha,
            p["gu"].mu, p["dn"].packed, p["dn"].alpha, p["dn"].mu, intermediate=I, act=act)
        assert rel_err(got.numpy(), want) <= TOL, (key, act)
        # the probe is wrong by design: far from the bf16 MLP
        exact = tk.ternary_mlp_plain(
            torch.from_numpy(x), p["gu"].perm if gather else None, p["gu"].packed, p["gu"].alpha,
            p["gu"].mu, p["dn"].packed, p["dn"].alpha, p["dn"].mu, intermediate=I, act=act)
        assert rel_err(exact.numpy(), want) > 0.1


def test_floor_rows_cover_rounding_and_clip(floor_outputs):
    """The draws exercise both regimes of mid: some values round to small
    integers, others clip at +-127 (checked on the plain gate and up)."""
    x, out = floor_outputs
    (gu, dn), _ = out[True, False, "silu"][0]
    p = to_port({"gu": gu, "dn": dn})
    xq = tk._rounded(tk._mlp_input(torch.from_numpy(x), None, p["gu"].packed.shape[0] * 4))
    half = p["gu"].packed.shape[1] // 2
    gate = tk._floor_plain(xq, p["gu"].packed[:, :half], p["gu"].alpha[:, :half],
                           p["gu"].mu[:, :half], 128)
    up = tk._floor_plain(xq, p["gu"].packed[:, half:], p["gu"].alpha[:, half:],
                         p["gu"].mu[:, half:], 128)
    mid = (torch.nn.functional.silu(gate) * up).abs()
    assert (mid < 100).float().mean() > 0.05 and (mid > 127).float().mean() > 0.05


@pytest.mark.parametrize("stacked", [False, True], ids=["single", "stacked"])
@pytest.mark.parametrize("gated,gather", CASES, ids=CASE_IDS)
def test_fused_mlp_apply_floor8_matches_jax(gated, gather, stacked):
    x = floor_x()
    layers = [layer(gated, gather, 20 + li) for li in range(2)]
    if stacked:
        jg = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *[g for g, _ in layers])
        jd = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *[d for _, d in layers])
        li = 1
    else:
        (jg, jd), li = layers[0], None
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jtm.fused_mlp_apply(jg, jd, jnp.asarray(x), "gelu", layer_idx=li,
                                              impl="floor8"))
    p = to_port({"gu": jg, "dn": jd})
    got = ttm.fused_mlp_apply(p["gu"], p["dn"], torch.from_numpy(x), "gelu", layer_idx=li,
                              impl="floor8")
    assert got.dtype == torch.float32
    assert rel_err(got.numpy(), want) <= TOL


@pytest.mark.parametrize("impl", ["auto", "a8", "plain"])
def test_fused_mlp_apply_other_impls_are_the_bf16_mlp(impl):
    gu, dn = jax_mlp_layer(1, True)
    p = to_port({"gu": gu, "dn": dn})
    x = torch.from_numpy(floor_x())
    got = ttm.fused_mlp_apply(p["gu"], p["dn"], x, "silu", impl=impl)
    want = ttm.fused_mlp_apply(p["gu"], p["dn"], x, "silu")
    assert torch.equal(got, want)


def test_k2_a8_takes_only_the_floor():
    gu, dn = jax_mlp_layer(1, False)
    p = to_port({"gu": gu, "dn": dn})
    args = (None, p["gu"].packed, p["gu"].alpha, p["gu"].mu, p["dn"].packed, p["dn"].alpha,
            p["dn"].mu)
    with pytest.raises(ValueError, match="floor"):
        tk.ternary_mlp(torch.zeros(2, D), *args, intermediate=I, a8=True)


def test_fused_mlp_ok_refuses_floor8():
    """No route picks the floor: JAX's predicate and the port's answer False
    for impl="floor8" whatever the layout (the backend check factored out)."""
    gu, dn = jax_mlp_layer(1, True)
    p = to_port({"gu": gu, "dn": dn})
    assert ttm._fused_mlp_layout_ok(p["gu"], p["dn"], "auto", 4)
    assert not ttm._fused_mlp_layout_ok(p["gu"], p["dn"], "floor8", 4)
