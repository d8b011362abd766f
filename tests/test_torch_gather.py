"""The SSR gather (K4) and the gather fused into the matmul (K3) of the port,
held against the JAX package on the same numpy inputs (CPU).

Tolerances: the gather copies values, so K4's plain version is held
bit-exact against ``onehot_iota_pallas`` in interpret mode (a one-hot f32
product is exact). K3's plain version against
``ternary_matmul_pallas_igathered`` in interpret mode: 1e-5 of max|ref|,
f32 summation order only. The scales are drawn so that mu - alpha is exact
in bf16 (the Pallas kernel rounds that difference to the scale type), so no
other rounding separates the two. The algorithm of K3's decode rows
(``ternary_matmul_igathered_dec_plain``: the decode GEMV's summation order
on x staged through perm) is held to the same 1e-5 against the Pallas
kernel, and to 1e-6 against K3's plain version (f32 order only, outputs
O(1)). So is the algorithm of K3's rows 9-64
(``ternary_matmul_igathered_tc_plain``: the one-pass gather into fragment
order, per-block products, the split-K slices summed in order); its gather
(``igathered_tc_gather_plain``) is held index by index.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pt2tpu.core import packing as jpack
from pt2tpu.ops import gather as jgather
from pt2tpu.ops import ternary_matmul as jtm
from pt2tpu.ops.kernels import pallas_gather as jpg
from pt2tpu.ops.kernels import pallas_ternary as jpt
from pt2tpu.utils import checkpoint as jckpt
from pt2tpu.utils import randmodel as jrand
from pt2tpu_torch.ops import gather as tgather
from pt2tpu_torch.ops import ternary_matmul as ttm
from pt2tpu_torch.ops.kernels import gather as tkg
from pt2tpu_torch.ops.kernels import ternary as tk
from pt2tpu_torch.utils.checkpoint import params_from_numpy

REL = 1e-5


def _t(a):
    """numpy/JAX array -> torch tensor (bf16 through its bit pattern)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def ssr_perm(rng, m, K, interleave=False):
    """A visit-lane perm over m features padded to K lanes with m; with
    ``interleave`` the pad lanes sit among the valid ones (a ragged layer)."""
    perm = np.concatenate([rng.permutation(m), np.full(K - m, m)]).astype(np.int32)
    if interleave:
        perm = rng.permutation(perm).astype(np.int32)
    return perm


def exact_scales(rng, nb, n):
    """bf16 alpha = j / 256 and mu = k / 1024, so mu - alpha = (k - 4j) / 1024
    with |k - 4j| < 256: exact in bf16."""
    alpha = rng.integers(8, 40, size=(nb, n)) / 256.0
    mu = rng.integers(-30, 31, size=(nb, n)) / 1024.0
    return jnp.asarray(alpha, jnp.bfloat16), jnp.asarray(mu, jnp.bfloat16)


def rand_layer(rng, K, n, bs=128):
    T = rng.integers(-1, 2, size=(n, K)).astype(np.int8)
    packed = np.asarray(jpack.pack_ternary(jnp.asarray(T), block_size=bs))
    alpha, mu = exact_scales(rng, K // bs, n)
    return packed, alpha, mu


def bf16_values(rng, shape):
    """f32 values that bf16 represents exactly (the kernels' operand type)."""
    return np.array(jnp.asarray(rng.normal(size=shape), jnp.bfloat16).astype(jnp.float32))


def rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("m,K,interleave", [(256, 256, False), (200, 256, False),
                                            (300, 512, True), (128, 2048, False)])
def test_make_packed_gather_same_bytes(m, K, interleave):
    perm = ssr_perm(np.random.default_rng(m + K), m, K, interleave)
    want = jgather.make_packed_gather(jnp.asarray(perm), m)
    got = tgather.make_packed_gather(torch.from_numpy(perm), m)
    assert got.packed.dtype == torch.int8 and got.perm.dtype == torch.int32
    np.testing.assert_array_equal(got.packed.numpy(), np.asarray(want.packed))
    np.testing.assert_array_equal(got.perm.numpy(), np.asarray(want.perm))
    assert got.out_lanes == want.out_lanes == K
    assert got.in_features == m


@pytest.mark.parametrize("rows,m,K", [(1, 256, 256), (5, 200, 384), (20, 384, 1024)])
def test_gather_plain_bit_exact_vs_iota_interpret(rows, m, K):
    rng = np.random.default_rng(rows)
    perm = ssr_perm(rng, m, K, interleave=rows == 5)
    x = rng.normal(size=(rows, m)).astype(np.float32)
    D = -(-m // 128) * 128
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpg.onehot_iota_pallas(jnp.asarray(x), jnp.asarray(perm), D=D))
    got = tkg.onehot_gather_plain(torch.from_numpy(x), torch.from_numpy(perm))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_gather_plain_bit_exact_vs_iota_stacked_interpret():
    rng = np.random.default_rng(11)
    m, K, L = 256, 384, 3
    perms = np.stack([ssr_perm(rng, m, K) for _ in range(L)])
    x = rng.normal(size=(4, m)).astype(np.float32)
    tperm = torch.from_numpy(perms)
    for li in (0, 2):
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(jpg.onehot_iota_pallas_stacked(
                jnp.asarray(x), jnp.asarray(perms), li, D=m))
        got = tkg.onehot_gather(torch.from_numpy(x), tperm[li])  # a view, as the port stacks
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_apply_matches_jax_index_form(dtype):
    rng = np.random.default_rng(4)
    m, K = 200, 256
    perm = ssr_perm(rng, m, K, interleave=True)
    x = bf16_values(rng, (2, 3, m))
    jg = jgather.make_packed_gather(jnp.asarray(perm), m)
    want = np.asarray(jgather.gather_apply(jg, jnp.asarray(x), impl="xla"))
    tg = tgather.make_packed_gather(torch.from_numpy(perm), m)
    for impl in ("auto", "plain"):
        got = tgather.gather_apply(tg, torch.from_numpy(x).to(dtype), impl)
        assert got.dtype == dtype and got.shape == (2, 3, K)
        np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("B,m,K,n", [(1, 256, 256, 128), (4, 200, 256, 256), (16, 384, 512, 384)])
def test_igathered_plain_matches_pallas_interpret(B, m, K, n, a8):
    rng = np.random.default_rng(B + m + n)
    packed, alpha, mu = rand_layer(rng, K, n)
    perm = ssr_perm(rng, m, K, interleave=m == 200)
    x = bf16_values(rng, (B, m))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpt.ternary_matmul_pallas_igathered(
            jnp.asarray(x), jnp.asarray(perm), jnp.asarray(packed), alpha, mu,
            tile_n=128, blocks_per_step=1, a8=a8,
        ))
    got = tk.ternary_matmul_igathered_plain(
        _t(x), _t(perm), _t(packed), _t(alpha), _t(mu), a8=a8).numpy()
    assert got.shape == want.shape
    assert rel_err(got, want) <= REL
    # the wrapper on a CPU tensor is the plain version
    wrapped = tk.ternary_matmul_igathered(_t(x), _t(perm), _t(packed), _t(alpha), _t(mu), a8=a8)
    np.testing.assert_array_equal(wrapped.numpy(), got)


@pytest.mark.parametrize("a8", [False, True])
def test_igathered_plain_matches_pallas_stacked_interpret(a8):
    rng = np.random.default_rng(21)
    B, m, K, n, L = 3, 256, 256, 256, 2
    layers = [rand_layer(rng, K, n) for _ in range(L)]
    packed = np.stack([l[0] for l in layers])
    alpha = jnp.stack([l[1] for l in layers])
    mu = jnp.stack([l[2] for l in layers])
    perms = np.stack([ssr_perm(rng, m, K) for _ in range(L)])
    x = bf16_values(rng, (B, m))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpt.ternary_matmul_pallas_igathered_stacked(
            jnp.asarray(x), jnp.asarray(perms), jnp.asarray(packed), alpha, mu, 1,
            tile_n=128, a8=a8,
        ))
    tp, ta, tm_, tperm = _t(packed), _t(alpha), _t(mu), _t(perms)
    got = tk.ternary_matmul_igathered_plain(_t(x), tperm[1], tp[1], ta[1], tm_[1], a8=a8).numpy()
    assert rel_err(got, want) <= REL


# K3's decode rows (pt2_ternary_matmul_dec_igathered): K1's decode kernel
# with x staged through perm. Its wave on an H100 SXM (4 CTAs on each of 132
# SMs) sets its K slices; (m, K, n): a ragged perm with interleaved pad lanes
# in one slice, and in slices of 3 + 2 blocks (640 lanes at 128 columns)
H100_WAVE = 4 * 132
DEC_GATHER_CASES = [(200, 256, 256), (600, 640, 128)]


@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("rows", [1, 2, 4, 8])
@pytest.mark.parametrize("m,K,n", DEC_GATHER_CASES)
def test_igathered_dec_plain_matches_pallas_interpret(m, K, n, rows, a8):
    assert tk.dec_splits(640, 128, 128, H100_WAVE) == 2  # 5 blocks: uneven slices
    rng = np.random.default_rng(300 + rows + m + int(a8))
    packed, alpha, mu = rand_layer(rng, K, n)
    perm = ssr_perm(rng, m, K, interleave=True)
    x = bf16_values(rng, (rows, m))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpt.ternary_matmul_pallas_igathered(
            jnp.asarray(x), jnp.asarray(perm), jnp.asarray(packed), alpha, mu,
            tile_n=128, blocks_per_step=1, a8=a8,
        ))
    got = tk.ternary_matmul_igathered_dec_plain(
        _t(x), _t(perm), _t(packed), _t(alpha), _t(mu), a8=a8, wave=H100_WAVE).numpy()
    assert got.shape == want.shape == (rows, n)
    assert rel_err(got, want) <= REL


@pytest.mark.parametrize("a8", [False, True])
def test_igathered_dec_plain_matches_pallas_stacked_interpret(a8):
    rng = np.random.default_rng(23 + int(a8))
    rows, (m, K, n), L = 8, DEC_GATHER_CASES[1], 2
    layers = [rand_layer(rng, K, n) for _ in range(L)]
    packed = np.stack([l[0] for l in layers])
    alpha = jnp.stack([l[1] for l in layers])
    mu = jnp.stack([l[2] for l in layers])
    perms = np.stack([ssr_perm(rng, m, K, interleave=True) for _ in range(L)])
    x = bf16_values(rng, (rows, m))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpt.ternary_matmul_pallas_igathered_stacked(
            jnp.asarray(x), jnp.asarray(perms), jnp.asarray(packed), alpha, mu, 1,
            tile_n=128, a8=a8,
        ))
    tp, ta, tm_, tperm = _t(packed), _t(alpha), _t(mu), _t(perms)
    got = tk.ternary_matmul_igathered_dec_plain(_t(x), tperm[1], tp[1], ta[1], tm_[1], a8=a8,
                                                wave=H100_WAVE).numpy()
    assert rel_err(got, want) <= REL


@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("rows", range(1, 9))
@pytest.mark.parametrize("m,K,n,bs", [(200, 256, 256, 128), (600, 640, 128, 128),
                                      (1300, 1408, 256, 128), (1000, 1024, 256, 256)])
def test_igathered_dec_plain_matches_igathered_plain(m, K, n, bs, rows, a8):
    """The decode path's algorithm equals K3's plain version up to f32 order
    (1e-6 of max|ref|), in one K slice, in slices of 3 + 2 and 4 + 4 + 3
    blocks, at bs 256; an all-zero row (W2A8: sx at its floor) gives 0."""
    rng = np.random.default_rng(1000 * rows + K + n + bs + int(a8))
    packed, alpha, mu = rand_layer(rng, K, n, bs)
    perm = ssr_perm(rng, m, K, interleave=m != 1000)
    x = bf16_values(rng, (rows, m))
    x[rows // 2] = 0.0
    args = (_t(x), _t(perm), _t(packed), _t(alpha), _t(mu), bs, a8)
    got = tk.ternary_matmul_igathered_dec_plain(*args, wave=H100_WAVE)
    want = tk.ternary_matmul_igathered_plain(*args)
    assert got.shape == (rows, n) and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    assert float(got[rows // 2].abs().max()) == 0.0


# K3's rows 9-64 (csrc/ternary_matmul_igathered_tc.cu): the one-pass gather
# then the split-K tensor-core product. Its wave on an H100 SXM (2 CTAs on
# each of 132 SMs) sets its K slices; (m, K, n, wave): a ragged perm with
# interleaved pad lanes over 2 slices, and 5 blocks over a card of one SM
# (a wave of 2 CTAs: slices of 3 + 2 blocks)
H100_IGTC_WAVE = 2 * 132
TC_GATHER_CASES = [(200, 256, 256, H100_IGTC_WAVE), (600, 640, 128, 2)]


def held_to_pallas(got, x, perm, packed, alpha, mu, want, a8):
    """``got`` (the port) held to REL of the Pallas kernel's ``want``. W2A8:
    the Pallas wrapper normalises the rows under jit, where XLA's fused
    x / sx can land one f32 ulp off the division the port and JAX's own
    eager W2A8 emulation (``ternary_matmul_xla_a8``) do, and a bf16 then
    int8 rounding of that ulp moves a whole row (seen on one row of 64).
    So every row is held to REL of the eager emulation on the same
    gathered x, and to REL of the Pallas kernel wherever the jitted and
    eager normalisations agree."""
    if not a8:
        assert rel_err(got, want) <= REL
        return
    xj = jnp.asarray(x)
    eager = np.asarray(jpt.normalize_rows_a8(xj)[0].astype(jnp.float32))
    jitted = np.asarray(jax.jit(lambda v: jpt.normalize_rows_a8(v)[0])(xj).astype(jnp.float32))
    same = (eager == jitted).all(axis=1)
    xg = np.concatenate([x, np.zeros((x.shape[0], 1), np.float32)], axis=1)[:, np.minimum(perm, x.shape[1])]
    emu = np.asarray(jtm.ternary_matmul_xla_a8(jnp.asarray(xg), jnp.asarray(packed), alpha, mu))
    assert rel_err(got, emu) <= REL
    scale = np.abs(want).max()
    assert np.abs(got[same] - want[same]).max(initial=0.0) <= REL * scale


@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("rows", [9, 16, 33, 64])
@pytest.mark.parametrize("m,K,n,wave", TC_GATHER_CASES)
def test_igathered_tc_plain_matches_pallas_interpret(m, K, n, wave, rows, a8):
    assert tk.igtc_splits(640, 128, 128, 2) == 2  # 5 blocks: uneven slices
    rng = np.random.default_rng(500 + rows + m + int(a8))
    packed, alpha, mu = rand_layer(rng, K, n)
    perm = ssr_perm(rng, m, K, interleave=True)
    x = bf16_values(rng, (rows, m))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpt.ternary_matmul_pallas_igathered(
            jnp.asarray(x), jnp.asarray(perm), jnp.asarray(packed), alpha, mu,
            tile_n=128, blocks_per_step=1, a8=a8,
        ))
    got = tk.ternary_matmul_igathered_tc_plain(
        _t(x), _t(perm), _t(packed), _t(alpha), _t(mu), a8=a8, wave=wave).numpy()
    assert got.shape == want.shape == (rows, n)
    held_to_pallas(got, x, perm, packed, alpha, mu, want, a8)


@pytest.mark.parametrize("a8", [False, True])
def test_igathered_tc_plain_matches_pallas_stacked_interpret(a8):
    rng = np.random.default_rng(29 + int(a8))
    rows, (m, K, n, wave), L = 33, TC_GATHER_CASES[1], 2
    layers = [rand_layer(rng, K, n) for _ in range(L)]
    packed = np.stack([l[0] for l in layers])
    alpha = jnp.stack([l[1] for l in layers])
    mu = jnp.stack([l[2] for l in layers])
    perms = np.stack([ssr_perm(rng, m, K, interleave=True) for _ in range(L)])
    x = bf16_values(rng, (rows, m))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpt.ternary_matmul_pallas_igathered_stacked(
            jnp.asarray(x), jnp.asarray(perms), jnp.asarray(packed), alpha, mu, 1,
            tile_n=128, a8=a8,
        ))
    tp, ta, tm_, tperm = _t(packed), _t(alpha), _t(mu), _t(perms)
    got = tk.ternary_matmul_igathered_tc_plain(_t(x), tperm[1], tp[1], ta[1], tm_[1], a8=a8,
                                               wave=wave).numpy()
    held_to_pallas(got, x, perms[1], packed[1], alpha[1], mu[1], want, a8)


@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("rows", [9, 16, 32, 33, 64])
@pytest.mark.parametrize("m,K,n,bs,wave", [(200, 256, 256, 128, H100_IGTC_WAVE),
                                           (600, 640, 128, 128, 2),
                                           (1300, 1408, 6144, 128, H100_IGTC_WAVE),
                                           (1000, 1024, 256, 256, H100_IGTC_WAVE)])
def test_igathered_tc_plain_matches_igathered_plain(m, K, n, bs, wave, rows, a8):
    """The tensor-core path's algorithm equals K3's plain version up to f32
    order (1e-6 of max|ref|): one slice per block, slices of 3 + 2 blocks,
    11 blocks at llama-3-8b qkv's width in 4 slices of 3, 3, 3, 2, bs 256;
    an all-zero row (W2A8: sx at its floor) gives 0."""
    rng = np.random.default_rng(2000 * rows + K + n + bs + int(a8))
    packed, alpha, mu = rand_layer(rng, K, n, bs)
    perm = ssr_perm(rng, m, K, interleave=m != 1000)
    x = bf16_values(rng, (rows, m))
    x[rows // 2] = 0.0
    args = (_t(x), _t(perm), _t(packed), _t(alpha), _t(mu), bs, a8)
    got = tk.ternary_matmul_igathered_tc_plain(*args, wave=wave)
    want = tk.ternary_matmul_igathered_plain(*args)
    assert got.shape == (rows, n) and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    assert float(got[rows // 2].abs().max()) == 0.0


def test_igtc_splits_fill_one_wave():
    """The K slices of the tensor-core path keep each projection's CTAs
    (n / 128 per slice) within one wave of 2 per SM: llama-3-8b qkv 48 x 5,
    o 32 x 8, gateup 224 x 1; none is empty."""
    assert [tk.igtc_splits(4096, n, 128, H100_IGTC_WAVE) for n in (6144, 4096, 28672)] == [5, 8, 1]
    for K, n, bs, wave in ((4096, 6144, 128, 264), (1408, 6144, 128, 264), (640, 128, 128, 2),
                           (1024, 256, 256, 264)):
        nb = K // bs
        splits = tk.igtc_splits(K, n, bs, wave)
        bpc = -(-nb // splits)
        assert splits * (n // 128) <= max(wave, n // 128)
        assert (splits - 1) * bpc < nb <= splits * bpc


@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("rows,bs", [(9, 128), (17, 256), (64, 128)])
def test_igathered_tc_gather_plain_layout(rows, bs, a8):
    """The gather scratch index by index: xg[b, blk*bs + 8h + 2p + i] holds
    x[b, perm[blk*bs + p*bs/4 + 2h + i]] (0 for a pad lane; W2A8 rounded half
    to even and clipped to +-127), rows B .. Bp - 1 are zero, and S holds
    each block's sum."""
    rng = np.random.default_rng(rows + bs + int(a8))
    m, K = 900, 1024
    perm = ssr_perm(rng, m, K, interleave=True)
    x = bf16_values(rng, (rows, m)) * (60.0 if a8 else 1.0)
    x[0, :8] = [0.5, 1.5, 2.5, -0.5, -2.5, 200.0, -200.0, 126.5]
    xg, S = tk.igathered_tc_gather_plain(_t(x).bfloat16(), _t(perm), bs, a8)
    Bp = {9: 16, 17: 32, 64: 64}[rows]
    assert xg.shape == (Bp, K) and xg.dtype == torch.bfloat16 and S.shape == (K // bs, Bp)
    xs = np.concatenate([x, np.zeros((rows, 1), np.float32)], axis=1)
    xs = np.array(jnp.asarray(xs, jnp.bfloat16).astype(jnp.float32))
    if a8:
        xs = np.clip(np.round(xs), -127, 127)  # numpy rounds half to even
    lanes = np.minimum(perm, m)
    want = np.zeros((Bp, K), np.float32)
    for blk in range(K // bs):
        for h in range(bs // 8):
            for p in range(4):
                for i in range(2):
                    want[:rows, blk * bs + 8 * h + 2 * p + i] = \
                        xs[:, lanes[blk * bs + p * bs // 4 + 2 * h + i]]
    np.testing.assert_array_equal(xg.float().numpy(), want)
    ws = xs[:, lanes].reshape(rows, K // bs, bs).sum(axis=2).T
    np.testing.assert_allclose(S[:, :rows].numpy(), ws, rtol=1e-6, atol=1e-6 * np.abs(ws).max())
    assert not S[:, rows:].any()


@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("rows", [1, 2, 4, 8, 9, 16, 64, 65, 128])
def test_k3_path(rows, a8):
    """K3's rows take K1's decode kernel where K1's would: bf16 rows <=
    K1_DEC_MAX_ROWS with scale blocks and out_features multiples of 128
    (W2A8 only with K1_DEC_A8, off by default); rows K1_TC_MIN_ROWS (9) to
    64 at those shapes take the tensor-core path in both modes; more rows,
    W2A8 decode rows and other shapes stay on the CUDA-core K3."""
    assert tk.K1_DEC_MAX_ROWS == 8 and not tk.K1_DEC_A8 and tk.K1_TC_MIN_ROWS == 9
    want = ("dec" if rows <= 8 and not a8 else "tc" if 9 <= rows <= 64 else "cuda_core")
    assert tk.k3_path(rows, 4096, 128, a8) == want
    assert tk.k3_path(rows, 4096, 256, a8) == want
    assert tk.k3_path(rows, 4096, 64, a8) == "cuda_core"
    assert tk.k3_path(rows, 160, 128, a8) == "cuda_core"


def test_k3_path_reads_k1_tc_min_rows_at_each_call(monkeypatch):
    """K1_TC_MIN_ROWS governs K3's tensor-core path too, read at each call:
    rebound to 65 (chip_smoke's "off" turns) it sends rows 9-64 to the
    CUDA-core K3; rebound to 33, rows 9-32 only."""
    assert [tk.k3_path(r, 4096, 128, False) for r in (8, 9, 64, 65)] == \
        ["dec", "tc", "tc", "cuda_core"]
    monkeypatch.setattr(tk, "K1_TC_MIN_ROWS", 65)
    for a8 in (False, True):
        assert [tk.k3_path(r, 4096, 128, a8) for r in (9, 16, 32, 64, 65)] == ["cuda_core"] * 5
    monkeypatch.setattr(tk, "K1_TC_MIN_ROWS", 33)
    assert [tk.k3_path(r, 4096, 128, True) for r in (9, 32, 33, 64)] == \
        ["cuda_core", "cuda_core", "tc", "tc"]


def test_k3_path_reads_the_decode_switches_at_each_call(monkeypatch):
    monkeypatch.setattr(tk, "K1_DEC_A8", True)  # W2A8 decode rows too
    for a8 in (False, True):
        assert [tk.k3_path(r, 4096, 128, a8) for r in (1, 8, 9, 64)] == \
            ["dec", "dec", "tc", "tc"]
    monkeypatch.setattr(tk, "K1_DEC_MAX_ROWS", 0)  # chip_smoke's "off" turns
    for a8 in (False, True):
        assert [tk.k3_path(r, 4096, 128, a8) for r in (1, 4, 8)] == ["cuda_core"] * 3
    monkeypatch.setattr(tk, "K1_DEC_MAX_ROWS", 4)
    assert [tk.k3_path(r, 4096, 128, False) for r in (4, 5)] == ["dec", "cuda_core"]


def test_ssr_linear_apply_on_cpu_matches_jax():
    """A full-SSR projection through the port's apply (gather then K1's plain
    version on the CPU, as JAX takes its index gather off the TPU)."""
    jl = jrand.random_ternary_linear(jax.random.PRNGKey(5), 256, 384, perm_mode="ssr")
    flat, structure = {}, {}
    jckpt._flatten("", {"p": jl}, flat, structure)
    tl = params_from_numpy(structure, {k: np.asarray(v) for k, v in flat.items()}, "cpu")["p"]
    assert tl.gather is not None and tl.gather.out_lanes == jl.gather.out_lanes
    x = np.random.default_rng(5).normal(size=(3, 384)).astype(np.float32)
    for impl, jimpl in (("auto", "xla"), ("a8", "a8"), ("plain", "xla")):
        want = np.asarray(jtm.ternary_linear_apply(jl, jnp.asarray(x), impl=jimpl))
        got = ttm.ternary_linear_apply(tl, torch.from_numpy(x), impl=impl).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
