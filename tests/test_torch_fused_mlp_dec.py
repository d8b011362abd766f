"""K2's decode path (rows 1-8) of the port against the JAX package (CPU).

The path runs on the card only (``csrc/ternary_mlp_dec.cu``); here its
algorithm, ``ternary_mlp_dec_plain`` (K1's decode GEMV over the whole
gateup, x staged through perm or zero-padded to Kg lanes, cut into K
slices; mid = act(gate) * up in x's dtype; the decode GEMV over mid and
down's first half // 128 blocks), is held at D = 512, I = 1408 (11 blocks
inside down's 16), n = 512, with the scale draws of
``tests/test_torch_fused_mlp.py``:

  * against ``ternary_mlp_pallas`` and ``_stacked`` in interpret mode at
    rows 1, 2, 4 and 8, with and without the gather, silu, gelu and relu,
    on f32 x (JAX's interpret mode keeps f32 on the CPU). The tolerance is
    that file's: within 1e-5 of max|ref| of the float64 evaluation, and
    within the Pallas kernel's own distance from it plus 1e-5. The JAX
    outputs are computed once at 8 rows; each row of the MLP is
    independent of the others, so the first r rows stand for an r-row
    call. At the H100's wave (528 CTAs) gateup runs in one slice with the
    gather (4 blocks) and in 4 without (16 blocks, x padded), down in 3
    slices of 4, 4 and 3 blocks.
  * against ``ternary_mlp_plain``, the contract: 1e-5 of max|ref| in f32;
    in bf16 (the kernel's operand type) 1e-3, K2's card tolerance, since
    both round mid to bf16 from gate and up that differ in their last f32
    bits; each for two waves (the H100's and one that leaves every product
    in one slice).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pt2tpu_torch.ops.kernels import ternary as tk
from test_torch_fused_mlp import D, I, N, assert_close_to_jax, jax_mlp_layer, jpt, mlp_f64, \
    rel_err, to_port

ROWS = [1, 2, 4, 8]
WAVES = [528, 1]  # the H100 SXM's dec_wave; one that leaves every product one slice
ACTS = ["silu", "gelu", "relu"]
BF16_TOL = 1e-3


@pytest.fixture(scope="module")
def jax_outputs():
    """Per (layout, act): the port's layers and JAX's 8-row outputs with
    their float64 evaluations, single (layer seed 1) and stacked (layer 1 of
    seeds 10, 11)."""
    x = np.random.default_rng(6).normal(size=(8, D)).astype(np.float32)
    out = {}
    for gather in (True, False):
        gu, dn = jax_mlp_layer(1, gather)
        layers = [jax_mlp_layer(10 + li, gather) for li in range(2)]
        stack = lambda f: jnp.stack([f(g, d) for g, d in layers])  # noqa: E731
        for act in ACTS:
            with pltpu.force_tpu_interpret_mode():
                single = np.asarray(jpt.ternary_mlp_pallas(
                    jnp.asarray(x), gu.perm if gather else None, gu.packed, gu.alpha, gu.mu,
                    dn.packed, dn.alpha, dn.mu, act=act, intermediate=I))
                stacked = np.asarray(jpt.ternary_mlp_pallas_stacked(
                    jnp.asarray(x), stack(lambda g, d: g.perm) if gather else None,
                    stack(lambda g, d: g.packed), stack(lambda g, d: g.alpha),
                    stack(lambda g, d: g.mu), stack(lambda g, d: d.packed),
                    stack(lambda g, d: d.alpha), stack(lambda g, d: d.mu), 1, act=act,
                    intermediate=I))
            out[gather, act] = [
                (to_port({"gu": gu, "dn": dn}), single, mlp_f64(x, gu, dn, gather, act)),
                (to_port({"gu": layers[1][0], "dn": layers[1][1]}), stacked,
                 mlp_f64(x, *layers[1], gather, act)),
            ]
    return x, out


def _args(p, gather):
    gu, dn = p["gu"], p["dn"]
    return (gu.perm if gather else None, gu.packed, gu.alpha, gu.mu, dn.packed, dn.alpha, dn.mu)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("gather", [True, False], ids=["ssr", "down"])
@pytest.mark.parametrize("rows", ROWS)
def test_dec_plain_matches_pallas_interpret(jax_outputs, rows, gather, act):
    x, out = jax_outputs
    xt = torch.from_numpy(x[:rows])
    for p, want, exact in out[gather, act]:  # ternary_mlp_pallas, then _stacked's layer 1
        got = tk.ternary_mlp_dec_plain(xt, *_args(p, gather), intermediate=I, act=act,
                                       wave=WAVES[0]).numpy()
        assert got.shape == (rows, N)
        assert_close_to_jax(got, want[:rows], exact[:rows])


@pytest.mark.parametrize("wave", WAVES)
@pytest.mark.parametrize("gather", [True, False], ids=["ssr", "down"])
def test_dec_plain_matches_contract_in_f32_and_bf16(gather, wave):
    """The contract, ternary_mlp_plain, within 1e-5 of max|ref| on f32 x and
    within K2's card tolerance on bf16 x, as the kernel runs."""
    gu, dn = jax_mlp_layer(1, gather)
    p = to_port({"gu": gu, "dn": dn})
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(8, D)).astype(np.float32))
    for xi, tol in ((x, 1e-5), (x.bfloat16(), BF16_TOL)):
        want = tk.ternary_mlp_plain(xi, *_args(p, gather), intermediate=I, act="gelu")
        got = tk.ternary_mlp_dec_plain(xi, *_args(p, gather), intermediate=I, act="gelu",
                                       wave=wave)
        assert got.dtype == torch.float32 and got.shape == (8, N)
        assert rel_err(got.numpy(), want.numpy()) <= tol


def test_dec_plain_slices_are_the_decode_gemv_s():
    """Gate | up is the decode GEMV over the whole gateup, in dec_splits'
    slices (4 slices of the layer's 16 padded blocks at the H100's wave, one
    at the other), so the kernel's gate/up pairing changes no sum; rows are
    independent and an all-zero row gives zero."""
    gu, dn = jax_mlp_layer(1, False)
    p = to_port({"gu": gu, "dn": dn})
    g = p["gu"]
    Kg = g.packed.shape[0] * 4
    half = g.packed.shape[1] // 2
    assert (tk.dec_splits(Kg, 2 * half, 128, WAVES[0]), tk.dec_splits(Kg, 2 * half, 128, WAVES[1])
            ) == (4, 1)
    assert (tk.dec_splits(half, N, 128, WAVES[0]), tk.dec_splits(half, N, 128, WAVES[1])) == (3, 1)
    x = torch.from_numpy(np.random.default_rng(11).normal(size=(5, D)).astype(np.float32))
    x[2] = 0
    got = tk.ternary_mlp_dec_plain(x, *_args(p, False), intermediate=I, wave=WAVES[0])
    gate_up = tk.ternary_matmul_dec_plain(torch.nn.functional.pad(x, (0, Kg - D)), g.packed,
                                          g.alpha, g.mu, wave=WAVES[0])
    mid = tk.mlp_activation("silu", gate_up[:, :half]) * gate_up[:, half:]
    want = tk.ternary_matmul_dec_plain(mid, p["dn"].packed[: half // 4],
                                       p["dn"].alpha[: half // 128], p["dn"].mu[: half // 128],
                                       wave=WAVES[0])
    assert torch.equal(got, want)
    assert not got[2].any()
    one = tk.ternary_mlp_dec_plain(x[3:4], *_args(p, False), intermediate=I, wave=WAVES[0])
    assert torch.equal(one[0], got[3])
