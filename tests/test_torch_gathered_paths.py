"""K6's decode and tensor-core paths (the plane gather, then K1's decode
kernel or K3's split-K tensor-core product) and their routing, held against
the JAX package on the same numpy inputs (CPU).

The paths' plain versions repeat their kernels' arithmetic:
``planes_gather_plain`` (the gather, bit for bit, in lane or fragment
order), ``ternary_matmul_gathered_dec_plain`` (``ternary_matmul_dec_plain``'s
schedule on the lane-order xg) and ``ternary_matmul_gathered_tc_plain``
(``_igtc_product_plain`` on the fragment-order xg and its block sums).

Tolerances. On permutation planes the gathered values are x[b, perm[k]]
exactly, in bf16 as in f32, so the paths are held to
``ternary_matmul_pallas_gathered`` (and ``_stacked``) in interpret mode at
REL = 1e-5 of max|ref| (f32 summation order only; W2A8 rows as
``held_to_pallas`` states), and to ``ternary_matmul_gathered_plain`` at
1e-6. On planes with two fields in a lane or a field of 2, JAX on the CPU
keeps xg in f32 while the paths round it to bf16, as the TPU kernel's
scratch does: each gathered value moves by at most half a bf16 ulp, 2^-9
of itself, so each output is held within 2^-8 * (|xg| @ |W|) of JAX's,
W the dequantised weights (2^-8 leaves room for f32 order). In W2A8 the
integer rounding of an f32 sum of at most two bf16 values comes first, so
there the paths are held to REL.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pt2tpu.core import packing as jpack
from pt2tpu.ops import gather as jgather
from pt2tpu.ops.kernels import pallas_ternary as jpt
from pt2tpu_torch.core.packing import unpack_ternary
from pt2tpu_torch.ops.kernels import gather as tkg
from pt2tpu_torch.ops.kernels import ternary as tk

from test_torch_gather import (H100_IGTC_WAVE, H100_WAVE, _t, bf16_values, held_to_pallas,
                               rand_layer, rel_err, ssr_perm)

REL = 1e-5
DEC_CASES = [(200, 256, 256, H100_WAVE), (600, 640, 128, H100_WAVE)]
TC_CASES = [(200, 256, 256, H100_IGTC_WAVE), (600, 640, 128, 2)]


def planes(perm, m):
    """The JAX package's packed one-hot planes of ``perm`` over m features."""
    return np.array(jgather.make_packed_gather(jnp.asarray(perm), m).packed)


def pallas_gathered(x, g, packed, alpha, mu, a8):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jpt.ternary_matmul_pallas_gathered(
            jnp.asarray(x), jnp.asarray(g), jnp.asarray(packed), alpha, mu,
            tile_n=128, blocks_per_step=1, a8=a8,
        ))


def path_plain(rows):
    """The plain version of the path K6's wrapper takes for ``rows`` rows."""
    return (tk.ternary_matmul_gathered_dec_plain if rows <= 8
            else tk.ternary_matmul_gathered_tc_plain)


@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("rows", [1, 2, 4, 8, 9, 16, 33, 64])
@pytest.mark.parametrize("m,K,n,wave_dec,wave_tc", [c[:3] + (c[3], t[3])
                                                    for c, t in zip(DEC_CASES, TC_CASES)])
def test_paths_plain_match_pallas_interpret(m, K, n, wave_dec, wave_tc, rows, a8):
    """Rows 1-8 on the decode path, 9-64 on the tensor-core path, a ragged
    perm with interleaved pad lanes, in one K slice and in uneven slices."""
    rng = np.random.default_rng(700 + rows + m + int(a8))
    packed, alpha, mu = rand_layer(rng, K, n)
    perm = ssr_perm(rng, m, K, interleave=True)
    g = planes(perm, m)
    x = bf16_values(rng, (rows, m))
    want = pallas_gathered(x, g, packed, alpha, mu, a8)
    got = path_plain(rows)(_t(x), _t(g), _t(packed), _t(alpha), _t(mu), a8=a8,
                           wave=wave_dec if rows <= 8 else wave_tc).numpy()
    assert got.shape == want.shape == (rows, n)
    held_to_pallas(got, x, perm, packed, alpha, mu, want, a8)


@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("rows", [4, 33])
def test_paths_plain_match_pallas_stacked_interpret(rows, a8):
    rng = np.random.default_rng(31 + rows + int(a8))
    m, K, n, wave_dec = DEC_CASES[1]
    wave = wave_dec if rows <= 8 else TC_CASES[1][3]
    L = 2
    layers = [rand_layer(rng, K, n) for _ in range(L)]
    packed = np.stack([l[0] for l in layers])
    alpha = jnp.stack([l[1] for l in layers])
    mu = jnp.stack([l[2] for l in layers])
    perms = np.stack([ssr_perm(rng, m, K, interleave=True) for _ in range(L)])
    gs = np.stack([planes(p, m) for p in perms])
    x = bf16_values(rng, (rows, m))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpt.ternary_matmul_pallas_gathered_stacked(
            jnp.asarray(x), jnp.asarray(gs), jnp.asarray(packed), alpha, mu, 1,
            tile_n=128, a8=a8,
        ))
    tp, ta, tm_, tg = _t(packed), _t(alpha), _t(mu), _t(gs)
    got = path_plain(rows)(_t(x), tg[1], tp[1], ta[1], tm_[1], a8=a8, wave=wave).numpy()
    held_to_pallas(got, x, perms[1], packed[1], alpha[1], mu[1], want, a8)


def non_perm_planes(rng, m, D, K, kind):
    """Planes that are not a permutation: one lane in three with its field
    set to 2, or every other lane with a second field of 1. Returns (g, u)
    with u the (D, K) raw fields."""
    codes = np.full((K, D), -1, np.int8)  # field 0 everywhere
    perm = ssr_perm(rng, m, K, interleave=True)
    valid = perm < m
    codes[np.nonzero(valid)[0], perm[valid]] = 0  # the one-hot
    if kind == "field-of-2":
        codes[np.nonzero(valid)[0][::3], perm[valid][::3]] = 1
    else:
        cols = np.nonzero(valid)[0][::2]
        codes[cols, rng.integers(0, m, size=cols.size)] = 0
    g = np.array(jpack.pack_ternary(jnp.asarray(codes), block_size=128))
    return g, (codes.T + 1).astype(np.float32)


@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("rows", [4, 16])
@pytest.mark.parametrize("kind", ["field-of-2", "two-ones"])
def test_paths_plain_on_planes_that_are_not_a_permutation(kind, rows, a8):
    """JAX keeps xg in f32 on the CPU, the paths round it to bf16 as the
    TPU's scratch does: held within that rounding (bf16) or at REL (W2A8,
    where the integer rounding of the exact f32 sum comes first)."""
    rng = np.random.default_rng(50 + rows + int(a8) + len(kind))
    m, D, K, n = 200, 256, 256, 256
    g, u = non_perm_planes(rng, m, D, K, kind)
    packed, alpha, mu = rand_layer(rng, K, n)
    x = bf16_values(rng, (rows, m))
    want = pallas_gathered(x, g, packed, alpha, mu, a8)
    wave = H100_WAVE if rows <= 8 else H100_IGTC_WAVE
    got = path_plain(rows)(_t(x), _t(g), _t(packed), _t(alpha), _t(mu), a8=a8,
                           wave=wave).numpy()
    assert got.shape == want.shape == (rows, n)
    if a8:
        assert rel_err(got, want) <= REL
        return
    xg = np.pad(x, ((0, 0), (0, D - m))) @ u
    T = unpack_ternary(_t(packed), 128).float().numpy()
    W = np.repeat(np.asarray(alpha, np.float32), 128, axis=0) * T + \
        np.repeat(np.asarray(mu, np.float32), 128, axis=0)
    assert (np.abs(got - want) <= 2.0 ** -8 * (np.abs(xg) @ np.abs(W))).all()
    assert rel_err(got, want) > 0  # the bf16 scratch does round here


@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("rows", [1, 3, 8, 9, 64])
@pytest.mark.parametrize("m,K", [(200, 256), (4000, 4096)])
def test_planes_gather_plain_lane_order_is_onehot_matmul(m, K, rows, a8):
    """Lane order on permutation planes is K5's value (x @ G) in bf16, bit
    for bit, and the index form x[:, perm]; W2A8 rounds it; a -0 stays -0."""
    rng = np.random.default_rng(m + rows + int(a8))
    perm = ssr_perm(rng, m, K, interleave=m == 200)
    g = _t(planes(perm, m))
    x = _t(bf16_values(rng, (rows, m)) * (40.0 if a8 else 1.0)).bfloat16()
    k0 = int(np.argmax(perm < m))  # the first lane that reads a feature
    x[0, perm[k0]] = -0.0
    got = tk.planes_gather_plain(x, g, 128, a8, "lanes")
    want = tkg.onehot_matmul_plain(x.float(), g)
    if a8:
        want = torch.clamp(torch.round(want), -127, 127)
    assert got.dtype == torch.bfloat16 and got.shape == (rows, K)
    assert torch.equal(got, want.bfloat16())
    assert torch.equal(got.float() if a8 else got,
                       want if a8 else tkg.onehot_gather_plain(x, _t(perm)))
    assert torch.signbit(got[0, k0]) and got[0, k0] == 0


@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("rows", [9, 16, 17, 33, 64])
def test_planes_gather_plain_fragment_order_is_k3s_gather(rows, a8):
    """Fragment order on permutation planes is K3's gather scratch on the
    same perm: xg bit for bit (pad rows zero), S within f32 rounding (the
    sums are taken in another order)."""
    rng = np.random.default_rng(90 + rows + int(a8))
    m, K = 900, 1024
    perm = ssr_perm(rng, m, K, interleave=True)
    x = _t(bf16_values(rng, (rows, m)) * (60.0 if a8 else 1.0)).bfloat16()
    x[0, :8] = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 200.0, -200.0, 126.5])
    xg, S = tk.planes_gather_plain(x, _t(planes(perm, m)), 128, a8, "fragments")
    want_xg, want_S = tk.igathered_tc_gather_plain(x, _t(perm), 128, a8)
    Bp = tk.igtc_rows_pad(rows)
    assert xg.shape == (Bp, K) and S.shape == (K // 128, Bp)
    assert torch.equal(xg, want_xg)
    assert not S[:, rows:].any()
    assert float((S - want_S).abs().max()) <= 1e-6 * float(want_S.abs().max())


def test_planes_gather_plain_block_sums_in_kernel_order():
    """S is each block's quarters summed in order, each quarter by a warp's
    butterfly (lane l adds lane l ^ o for o = 16, 8, 4, 2, 1): checked
    against that order written out with Python floats rounded to f32."""
    rng = np.random.default_rng(5)
    m, K, rows = 256, 256, 9
    perm = ssr_perm(rng, m, K)
    x = _t(rng.normal(size=(rows, m)).astype(np.float32) * 1000).bfloat16()
    xg, S = tk.planes_gather_plain(x, _t(planes(perm, m)), 128, False, "fragments")
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    lanes = tk.planes_gather_plain(x, _t(planes(perm, m)), 128, False, "lanes").float()
    for b in (0, 8):
        for blk in range(K // 128):
            quarters = []
            for q in range(4):
                v = [float(t) for t in lanes[b, blk * 128 + 32 * q: blk * 128 + 32 * q + 32]]
                for o in (16, 8, 4, 2, 1):
                    v = [f32(v[i] + v[i ^ o]) for i in range(32)]
                quarters.append(v[0])
            want = f32(f32(f32(quarters[0] + quarters[1]) + quarters[2]) + quarters[3])
            assert float(S[blk, b]) == want


@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("rows", range(1, 9))
@pytest.mark.parametrize("m,K,n,bs", [(200, 256, 256, 128), (600, 640, 128, 128),
                                      (1300, 1408, 256, 128)])
def test_dec_plain_matches_gathered_plain_and_k3s_decode_rows(m, K, n, bs, rows, a8):
    """The decode path's algorithm equals K6's plain version up to f32
    order (1e-6 of max|ref|) in one K slice and in slices of 3 + 2 and
    4 + 4 + 3 blocks, and on permutation planes K3's decode rows' algorithm
    on the same perm bit for bit (same gathered values, same schedule); an
    all-zero row gives 0."""
    rng = np.random.default_rng(3000 * rows + K + n + int(a8))
    packed, alpha, mu = rand_layer(rng, K, n, bs)
    perm = ssr_perm(rng, m, K, interleave=True)
    x = bf16_values(rng, (rows, m))
    x[rows // 2] = 0.0
    ops = (_t(packed), _t(alpha), _t(mu), bs, a8)
    got = tk.ternary_matmul_gathered_dec_plain(_t(x), _t(planes(perm, m)), *ops, wave=H100_WAVE)
    want = tk.ternary_matmul_gathered_plain(_t(x), _t(planes(perm, m)), *ops)
    assert got.shape == (rows, n) and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    assert float(got[rows // 2].abs().max()) == 0.0
    k3 = tk.ternary_matmul_igathered_dec_plain(_t(x), _t(perm), *ops, wave=H100_WAVE)
    assert torch.equal(got, k3)


@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("rows", [9, 16, 32, 33, 64])
@pytest.mark.parametrize("m,K,n,wave", [(200, 256, 256, H100_IGTC_WAVE), (600, 640, 128, 2),
                                        (1300, 1408, 6144, H100_IGTC_WAVE)])
def test_tc_plain_matches_gathered_plain_and_k3s_tc_path(m, K, n, wave, rows, a8):
    """The tensor-core path's algorithm equals K6's plain version and, on
    permutation planes, K3's tensor-core path's algorithm on the same perm,
    up to f32 order (1e-6 of max|ref|): one slice per block, slices of
    3 + 2 blocks, 11 blocks at llama-3-8b qkv's width in slices of 3, 3, 3,
    2; an all-zero row gives 0."""
    rng = np.random.default_rng(4000 * rows + K + n + int(a8))
    packed, alpha, mu = rand_layer(rng, K, n)
    perm = ssr_perm(rng, m, K, interleave=True)
    x = bf16_values(rng, (rows, m))
    x[rows // 2] = 0.0
    ops = (_t(packed), _t(alpha), _t(mu), 128, a8)
    got = tk.ternary_matmul_gathered_tc_plain(_t(x), _t(planes(perm, m)), *ops, wave=wave)
    want = tk.ternary_matmul_gathered_plain(_t(x), _t(planes(perm, m)), *ops)
    k3 = tk.ternary_matmul_igathered_tc_plain(_t(x), _t(perm), *ops, wave=wave)
    assert got.shape == (rows, n) and got.dtype == torch.float32
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-6 * scale
    assert float((got - k3).abs().max()) <= 1e-6 * scale
    assert float(got[rows // 2].abs().max()) == 0.0


@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("rows", [1, 8, 9, 64])
def test_wrapper_on_cpu_is_the_plain_version(rows, a8):
    """On a CPU tensor K6's wrapper runs ternary_matmul_gathered_plain (f32
    xg, as JAX off the TPU) whatever path the rows would take on the card."""
    rng = np.random.default_rng(rows + int(a8))
    m, K, n = 200, 256, 256
    packed, alpha, mu = rand_layer(rng, K, n)
    g = _t(planes(ssr_perm(rng, m, K, interleave=True), m))
    x = _t(bf16_values(rng, (rows, m)))
    args = (x, g, _t(packed), _t(alpha), _t(mu), 128, a8)
    assert tk.k6_path(rows, n, 128, a8) == ("dec" if rows <= 8 and not a8 else
                                            "tc" if rows >= 9 else "cuda_core")
    assert torch.equal(tk.ternary_matmul_gathered(*args), tk.ternary_matmul_gathered_plain(*args))


@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("rows", [1, 2, 4, 8, 9, 16, 64, 65, 128])
def test_k6_path(rows, a8):
    """K6 takes K1's decode kernel where K1 would (bf16 rows <= 8, W2A8
    only with K1_DEC_A8), the tensor-core path at rows 9-64 in both modes,
    the CUDA-core K6 elsewhere: more rows, other block sizes and widths."""
    assert tk.K6_DEC_MAX_ROWS == 8 and tk.K6_TC_MIN_ROWS == 9
    want = "dec" if rows <= 8 and not a8 else "tc" if 9 <= rows <= 64 else "cuda_core"
    assert tk.k6_path(rows, 4096, 128, a8) == want
    assert tk.k6_path(rows, 6144, 256, a8) == want
    assert tk.k6_path(rows, 4096, 64, a8) == "cuda_core"
    assert tk.k6_path(rows, 160, 128, a8) == "cuda_core"


def test_k6_path_reads_its_constants_at_each_call(monkeypatch):
    """K6_DEC_MAX_ROWS 0 and K6_TC_MIN_ROWS 1 << 30 (chip_smoke's "off"
    turns) send every row back to the CUDA-core K6; other values move the
    boundaries; K1's decode switches and K1_TC_MIN_ROWS govern K6 too."""
    rows = (1, 4, 5, 8, 9, 12, 16, 33, 64, 65)
    assert [tk.k6_path(r, 4096, 128, False) for r in rows] == \
        ["dec"] * 4 + ["tc"] * 5 + ["cuda_core"]
    with monkeypatch.context() as mp:
        mp.setattr(tk, "K6_DEC_MAX_ROWS", 0)
        mp.setattr(tk, "K6_TC_MIN_ROWS", 1 << 30)
        for a8 in (False, True):
            assert [tk.k6_path(r, 4096, 128, a8) for r in rows] == ["cuda_core"] * len(rows)
    with monkeypatch.context() as mp:
        mp.setattr(tk, "K6_DEC_MAX_ROWS", 4)
        mp.setattr(tk, "K6_TC_MIN_ROWS", 16)
        assert [tk.k6_path(r, 4096, 128, False) for r in rows] == \
            ["dec", "dec"] + ["cuda_core"] * 4 + ["tc"] * 3 + ["cuda_core"]
    with monkeypatch.context() as mp:
        mp.setattr(tk, "K1_DEC_A8", True)
        assert [tk.k6_path(r, 4096, 128, True) for r in (1, 8, 9)] == ["dec", "dec", "tc"]
        mp.setattr(tk, "K1_DEC_MAX_ROWS", 0)
        assert [tk.k6_path(r, 4096, 128, False) for r in (1, 8)] == ["cuda_core"] * 2
        mp.setattr(tk, "K1_TC_MIN_ROWS", 33)
        assert [tk.k6_path(r, 4096, 128, False) for r in (9, 32, 33)] == \
            ["cuda_core", "cuda_core", "tc"]
