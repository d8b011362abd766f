"""K2's tensor-core path (rows 9-64) of the port against the JAX package (CPU).

The path runs on the card only (``csrc/ternary_mlp_tc.cu``); here its
algorithm, ``ternary_mlp_tc_plain`` (the gather into a fragment-order
scratch, the gate/up product cut into K slices with the gated epilogue and
its per-block sums of mid, then the down product over mid), is held at
D = 512, I = 1408 (11 blocks inside down's 16), n = 512, with the scale
draws of ``tests/test_torch_fused_mlp.py``:

  * against ``ternary_mlp_pallas`` and ``_stacked`` in interpret mode at
    rows 9, 16, 33 and 64 (every row-tile instance, pad rows in the last
    tile), with and without the gather, silu, gelu and relu, on f32 x (the
    plain version's scratches hold x's dtype; JAX's interpret mode keeps
    f32 on the CPU). The tolerance is that file's: within 1e-5 of max|ref|
    of the float64 evaluation, and within the Pallas kernel's own distance
    from it plus 1e-5. The JAX outputs are computed once at 64 rows; each
    row of the MLP is independent of the others, so the first r rows stand
    for an r-row call.
  * against ``ternary_mlp_plain``, the contract: 1e-5 of max|ref| in f32;
    in bf16 (the kernel's operand type) 1e-3, K2's card tolerance, since
    both round mid to bf16 from gate and up that differ in their last f32
    bits, and so do the slice counts of different waves;
  * its pieces: the gather without a perm (x zero-padded to Kg lanes)
    against a direct index of the fragment order and its sums, and with a
    perm bit-exact against K3's gather; the mid pass against gate and up
    from K1's plain version, at the fragment positions, with the two-half
    block sums;
  * ``k2_path``, ``K2_TC_MIN_ROWS`` and ``K2_DEC_MAX_ROWS`` on tables (rows
    1-8 take the decode path of ``tests/test_torch_fused_mlp_dec.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pt2tpu_torch.ops.kernels import ternary as tk
from test_torch_fused_mlp import D, I, N, assert_close_to_jax, jax_mlp_layer, jpt, mlp_f64, \
    rel_err, to_port

ROWS = [9, 16, 33, 64]
WAVE = 264  # the H100 SXM's igtc_wave: gate/up in 4 slices of 1 block, down in 11
ACTS = ["silu", "gelu", "relu"]
BF16_TOL = 1e-3


@pytest.fixture(scope="module")
def jax_outputs():
    """Per (layout, act): the port's layers and JAX's 64-row outputs with
    their float64 evaluations, single (layer seed 1) and stacked (layer 1 of
    seeds 10, 11)."""
    x = np.random.default_rng(2).normal(size=(64, D)).astype(np.float32)
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
def test_tc_plain_matches_pallas_interpret(jax_outputs, rows, gather, act):
    x, out = jax_outputs
    xt = torch.from_numpy(x[:rows])
    for p, want, exact in out[gather, act]:  # ternary_mlp_pallas, then _stacked's layer 1
        got = tk.ternary_mlp_tc_plain(xt, *_args(p, gather), intermediate=I, act=act,
                                      wave=WAVE).numpy()
        assert got.shape == (rows, N)
        assert_close_to_jax(got, want[:rows], exact[:rows])
        contract = tk.ternary_mlp_plain(xt, *_args(p, gather), intermediate=I, act=act).numpy()
        assert rel_err(got, contract) <= 1e-5


@pytest.mark.parametrize("gather", [True, False], ids=["ssr", "down"])
def test_tc_plain_in_bf16_any_wave_matches_contract(gather):
    """On bf16 x, as the kernel runs: the contract and every slicing (one
    slice each, the H100's, one block a slice) within K2's card tolerance."""
    gu, dn = jax_mlp_layer(1, gather)
    p = to_port({"gu": gu, "dn": dn})
    xb = torch.from_numpy(np.random.default_rng(4).normal(size=(33, D)).astype(np.float32))
    xb = xb.bfloat16()
    want = tk.ternary_mlp_plain(xb, *_args(p, gather), intermediate=I, act="gelu")
    for wave in (1, 22, WAVE, 10**6):
        got = tk.ternary_mlp_tc_plain(xb, *_args(p, gather), intermediate=I, act="gelu",
                                      wave=wave)
        assert got.dtype == torch.float32 and got.shape == (33, N)
        assert rel_err(got.numpy(), want.numpy()) <= BF16_TOL


@pytest.mark.parametrize("rows", [9, 40])
def test_tc_gather_without_perm_is_the_padded_x_in_fragment_order(rows):
    """Position 8h + 2p + i of block blk holds lane blk*128 + 32p + 2h + i of
    x padded with zeros to Kg lanes; pad rows are zero; S sums each block."""
    m, Kg = 500, 1024
    x = torch.from_numpy(np.random.default_rng(rows).normal(size=(rows, m)).astype(np.float32))
    x = x.bfloat16()
    xg, S = tk.mlp_tc_gather_plain(x, None, Kg)
    Bp = tk.igtc_rows_pad(rows)
    assert xg.shape == (Bp, Kg) and xg.dtype == torch.bfloat16 and S.shape == (Kg // 128, Bp)
    blk, h, p, i = np.meshgrid(np.arange(Kg // 128), np.arange(16), np.arange(4), np.arange(2),
                               indexing="ij")
    pos = (blk * 128 + 8 * h + 2 * p + i).ravel()
    lane = (blk * 128 + 32 * p + 2 * h + i).ravel()
    xp = torch.zeros((Bp, Kg), dtype=torch.bfloat16)
    xp[:rows, :m] = x
    assert torch.equal(xg[:, pos], xp[:, lane])
    want_S = xp.float().reshape(Bp, Kg // 128, 128).sum(dim=2).T
    assert torch.allclose(S, want_S, rtol=1e-6, atol=1e-6)
    perm = torch.from_numpy(np.random.default_rng(7).permutation(Kg).astype(np.int32))
    perm[perm >= m] = m  # the pad lanes of a visit perm
    got = tk.mlp_tc_gather_plain(x, perm, Kg)
    want = tk.igathered_tc_gather_plain(x, perm)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("act", ACTS)
def test_tc_mid_pass_pairs_gate_with_up_and_sums_half_blocks(act):
    """mid at down's fragment position of lane j is act(gate_j) * up_j, with
    gate and up from K1's plain version; Smid adds each block's lanes 0-63
    and 64-127 (one CTA each) in that order."""
    gu, _ = jax_mlp_layer(3, False)
    gu = to_port({"gu": gu})["gu"]
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(20, D)).astype(np.float32))
    xg, S = tk.mlp_tc_gather_plain(x, None, gu.packed.shape[0] * 4)
    mid, Smid = tk.mlp_tc_mid_plain(xg, S, gu.packed, gu.alpha, gu.mu, act, wave=WAVE)
    half = gu.packed.shape[1] // 2
    h = tk.ternary_matmul_plain(tk._lane_order(xg, 128)[:20].float(), gu.packed, gu.alpha, gu.mu)
    want = tk.mlp_activation(act, h[:, :half]) * h[:, half:]
    lanes = tk._lane_order(mid, 128)
    assert mid.shape == (32, half) and not lanes[20:].any()
    assert rel_err(lanes[:20].numpy(), want.numpy()) <= 1e-5
    halves = lanes.reshape(32, half // 64, 64).sum(dim=2)
    assert torch.equal(Smid, (halves[:, 0::2] + halves[:, 1::2]).T)


@pytest.mark.parametrize("min_rows,table", [
    (9, {1: "dec", 8: "dec", 9: "tc", 16: "tc", 33: "tc", 64: "tc", 65: "cc"}),
    (1 << 30, {1: "dec", 9: "cc", 64: "cc"}),  # chip_smoke.py's "off" turns of rows 9-64
    (17, {16: "cc", 17: "tc", 64: "tc"}),
])
def test_k2_path_routes_by_rows_read_at_each_call(monkeypatch, min_rows, table):
    assert tk.K2_TC_MIN_ROWS == 9
    monkeypatch.setattr(tk, "K2_TC_MIN_ROWS", min_rows)
    assert {rows: tk.k2_path(rows) for rows in table} == table


@pytest.mark.parametrize("dec_max,table", [
    (0, {0: "cc", 1: "cc", 4: "cc", 8: "cc", 9: "tc", 64: "tc"}),  # the decode A/Bs' "off" turns
    (4, {1: "dec", 4: "dec", 5: "cc", 8: "cc", 9: "tc"}),
    (8, {0: "cc", 1: "dec", 2: "dec", 8: "dec", 9: "tc", 65: "cc"}),
])
def test_k2_path_decode_rows_read_k2_dec_max_rows_at_each_call(monkeypatch, dec_max, table):
    assert tk.K2_DEC_MAX_ROWS == 8
    monkeypatch.setattr(tk, "K2_DEC_MAX_ROWS", dec_max)
    assert {rows: tk.k2_path(rows) for rows in table} == table
