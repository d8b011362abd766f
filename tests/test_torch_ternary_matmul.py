"""K1's plain version and the packed-linear apply of the port, held against
the JAX package on the same inputs (CPU; JAX computes in f32 there).

Tolerances: port-plain vs JAX-XLA differ only in f32 summation order, so
they are held at 1e-5 (outputs are O(1)). The Pallas kernel in interpret
mode rounds (mu - alpha) to bf16 before its f32 product with the block sums
(pallas_ternary.py:159); that term's error is bounded per output by
sum_blk |blocksum(x)| * |mu - alpha| * 2^-8 (bf16 unit roundoff), which is
the tolerance used there, plus the same 1e-5 slack. The W2A8 dots are
integer-exact on both sides, leaving only the f32 scale products.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pt2tpu.core import packing as jpack
from pt2tpu.models import decoder as jdec
from pt2tpu.ops import ternary_matmul as jtm
from pt2tpu.ops.kernels import pallas_ternary as jpt
from pt2tpu.utils import checkpoint as jckpt
from pt2tpu.utils import randmodel as jrand
from pt2tpu_torch.ops import ternary_matmul as ttm
from pt2tpu_torch.ops.kernels import ternary as tk
from pt2tpu_torch.utils.checkpoint import params_from_numpy

F32_TOL = dict(rtol=1e-5, atol=1e-5)


def to_port(tree):
    """A JAX parameter tree -> the port's, through the artifact's flat form."""
    flat, structure = {}, {}
    jckpt._flatten("", tree, flat, structure)
    return params_from_numpy(structure, {k: np.asarray(v) for k, v in flat.items()}, "cpu")


def _rand_packed(rng, n, K, bs=128):
    T = rng.integers(-1, 2, size=(n, K)).astype(np.int8)
    nb = K // bs
    alpha = jnp.asarray(rng.normal(0.05, 0.01, size=(nb, n)), jnp.bfloat16)
    mu = jnp.asarray(rng.normal(0.0, 0.01, size=(nb, n)), jnp.bfloat16)
    packed = np.asarray(jpack.pack_ternary(jnp.asarray(T), block_size=bs))
    return packed, alpha, mu


def _t(a):
    """numpy/JAX array -> torch tensor (bf16 through its bit pattern)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("B,K,n", [(1, 256, 128), (5, 384, 256), (70, 512, 128)])
def test_plain_matches_xla(B, K, n):
    rng = np.random.default_rng(K + B)
    packed, alpha, mu = _rand_packed(rng, n, K)
    x = rng.normal(size=(B, K)).astype(np.float32)
    want = np.asarray(jtm.ternary_matmul_xla(jnp.asarray(x), jnp.asarray(packed), alpha, mu))
    got = tk.ternary_matmul_plain(_t(x), _t(packed), _t(alpha), _t(mu)).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)


def _offset_rounding_bound(x, alpha, mu, bs):
    s = np.abs(x.reshape(x.shape[0], -1, bs).sum(-1))  # (B, nb)
    off = np.abs(np.asarray(mu, np.float32) - np.asarray(alpha, np.float32))  # (nb, n)
    return s @ off * 2.0**-8


# telescoped (B <= 64) and masked mode; 17 and 256 are prefill-size row
# counts, where the card runs K1's tensor-core path against this plain version
@pytest.mark.parametrize("B", [8, 17, 80, 256])
def test_plain_matches_pallas_interpret(B):
    from jax.experimental.pallas import tpu as pltpu

    rng = np.random.default_rng(B)
    K, n = 384, 256
    packed, alpha, mu = _rand_packed(rng, n, K)
    # bf16-representable x, so the kernel's cast to bf16 is exact
    x = np.asarray(jnp.asarray(rng.normal(size=(B, K)), jnp.bfloat16).astype(jnp.float32))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpt.ternary_matmul_pallas(
            jnp.asarray(x), jnp.asarray(packed), alpha, mu, tile_n=128
        ))
    got = tk.ternary_matmul_plain(_t(x), _t(packed), _t(alpha), _t(mu)).numpy()
    bound = _offset_rounding_bound(x, alpha, mu, 128) + 1e-5 * (1 + np.abs(want))
    assert np.all(np.abs(got - want) <= bound)


def test_plain_matches_pallas_stacked_interpret():
    from jax.experimental.pallas import tpu as pltpu

    rng = np.random.default_rng(3)
    K, n, B = 256, 128, 4
    layers = [_rand_packed(rng, n, K) for _ in range(2)]
    packed = np.stack([l[0] for l in layers])
    alpha = jnp.stack([l[1] for l in layers])
    mu = jnp.stack([l[2] for l in layers])
    x = np.asarray(jnp.asarray(rng.normal(size=(B, K)), jnp.bfloat16).astype(jnp.float32))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpt.ternary_matmul_pallas_stacked(
            jnp.asarray(x), jnp.asarray(packed), alpha, mu, 1, tile_n=128
        ))
    tp, ta, tm_ = _t(packed), _t(alpha), _t(mu)
    got = tk.ternary_matmul_plain(_t(x), tp[1], ta[1], tm_[1]).numpy()
    bound = _offset_rounding_bound(x, alpha[1], mu[1], 128) + 1e-5 * (1 + np.abs(want))
    assert np.all(np.abs(got - want) <= bound)


def test_normalize_rows_a8_bit_identical():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(6, 256)).astype(np.float32)
    x[2] = 0.0  # an all-zero row takes the 1e-12 floor
    jn, jsx = jpt.normalize_rows_a8(jnp.asarray(x))
    tn, tsx = tk.normalize_rows_a8(torch.from_numpy(x))
    np.testing.assert_array_equal(_t(jn).float().numpy(), tn.float().numpy())
    np.testing.assert_array_equal(np.asarray(jsx), tsx.numpy())


@pytest.mark.parametrize("B", [1, 7])
def test_plain_a8_matches_xla_a8(B):
    rng = np.random.default_rng(20 + B)
    K, n = 512, 256
    packed, alpha, mu = _rand_packed(rng, n, K)
    x = rng.normal(size=(B, K)).astype(np.float32)
    want = np.asarray(jtm.ternary_matmul_xla_a8(jnp.asarray(x), jnp.asarray(packed), alpha, mu))
    got = tk.ternary_matmul_plain_a8(_t(x), _t(packed), _t(alpha), _t(mu)).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("n", [160, 256])  # 160: a multiple of 32, not of 128
@pytest.mark.parametrize("bs", [64, 128, 256])
@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("rows", [1, 2, 3, 4, 5, 6, 7, 8, 9, 15, 16, 512])
def test_k1_path(rows, a8, bs, n):
    """K1's path is chosen by shape alone, with bs and n multiples of 128:
    the decode kernel for bf16 rows <= K1_DEC_MAX_ROWS ("dec"; W2A8 decode
    rows stay on the CUDA cores unless K1_DEC_A8 is set), the tensor cores
    for rows >= K1_TC_MIN_ROWS ("tc" in bf16, "tc_a8" on the int8 tensor
    cores in W2A8); every other shape stays on the CUDA-core kernel,
    whatever its rows."""
    assert not tk.K1_DEC_A8
    fits = bs % 128 == 0 and n == 256
    if fits and rows <= tk.K1_DEC_MAX_ROWS and not a8:
        want = "dec"
    elif fits and rows >= tk.K1_TC_MIN_ROWS:
        want = "tc_a8" if a8 else "tc"
    else:
        want = "cuda_core"
    assert tk.k1_path(rows, n, bs, a8) == want
    if bs == 64 or n == 160:
        assert want == "cuda_core"
    elif rows <= 8:
        assert want == ("cuda_core" if a8 else "dec")  # every bf16 decode row
    else:
        assert want in ("tc", "tc_a8")  # rows 9 and up: the prefill kernels, unchanged


def test_k1_path_reads_its_threshold_at_each_call(monkeypatch):
    assert tk.K1_TC_MIN_ROWS > tk.K1_DEC_MAX_ROWS  # decode rows never reach the prefill kernels
    assert tk.k1_path(512, 4096, 128, False) == "tc"
    assert tk.k1_path(512, 4096, 128, True) == "tc_a8"
    monkeypatch.setattr(tk, "K1_TC_MIN_ROWS", 1 << 30)  # chip_smoke's "before" runs
    assert tk.k1_path(512, 4096, 128, False) == "cuda_core"
    assert tk.k1_path(512, 4096, 128, True) == "cuda_core"  # one threshold for both modes
    assert tk.k1_path(8, 4096, 128, False) == "dec"  # decode rows keep their own kernel


def test_k1_path_reads_the_decode_threshold_at_each_call(monkeypatch):
    assert tk.K1_DEC_MAX_ROWS == 8  # the decode kernel's N tile: the engine's 8 slots
    monkeypatch.setattr(tk, "K1_DEC_A8", True)  # both modes on the decode kernel
    for a8 in (False, True):
        assert [tk.k1_path(r, 4096, 128, a8) for r in (1, 8, 9)] == \
            ["dec", "dec", "tc_a8" if a8 else "tc"]
    monkeypatch.setattr(tk, "K1_DEC_MAX_ROWS", 0)  # chip_smoke's "off" turns
    for a8 in (False, True):
        assert [tk.k1_path(r, 4096, 128, a8) for r in (1, 4, 8)] == ["cuda_core"] * 3
        assert tk.k1_path(9, 4096, 128, a8) == ("tc_a8" if a8 else "tc")
    monkeypatch.setattr(tk, "K1_DEC_MAX_ROWS", 4)
    assert [tk.k1_path(r, 4096, 128, False) for r in (4, 5)] == ["dec", "cuda_core"]


@pytest.mark.parametrize("rows", [1, 4, 8])
def test_k1_path_reads_the_w2a8_decode_switch_at_each_call(monkeypatch, rows):
    """W2A8 decode rows take the decode kernel only with K1_DEC_A8 set; bf16
    decode rows and W2A8 prefill rows do not depend on it."""
    assert tk.K1_DEC_A8 is False
    assert [tk.k1_path(rows, 4096, 128, a8) for a8 in (False, True)] == ["dec", "cuda_core"]
    monkeypatch.setattr(tk, "K1_DEC_A8", True)
    assert [tk.k1_path(rows, 4096, 128, a8) for a8 in (False, True)] == ["dec", "dec"]
    assert tk.k1_path(rows, 4096, 64, True) == "cuda_core"  # bs 64: not the decode kernel's
    assert tk.k1_path(9, 4096, 128, True) == "tc_a8"


# (name, K, n): the projections chip_smoke.py's models decode through K1
PROJECTIONS = [("7b qkv", 4096, 12288), ("7b o / 8b o", 4096, 4096), ("7b gateup", 4096, 22528),
               ("7b down", 12288, 4096), ("8b qkv", 4096, 6144), ("8b gateup", 4096, 28672),
               ("8b down", 14336, 4096)]


# the decode kernel's wave (dec_wave) on an H100 SXM (132 SMs) and PCIe (114)
H100_WAVE = 4 * 132


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("name,K,n", PROJECTIONS)
def test_dec_splits_fill_the_card_in_one_wave(name, K, n, sms):
    """The decode kernel's K slices: none empty, each at most DEC_SLICE_LANES
    lanes and (where the blocks allow) one per warp, and the CTAs of every
    projection within one wave of the card's SMs, and at least 2 per SM
    unless every warp already holds a single block (7b o / 8b o: 256 CTAs)."""
    nb = K // 128
    wave = tk.DEC_CTAS_PER_SM * sms
    splits = tk.dec_splits(K, n, 128, wave)
    bpc = -(-nb // splits)
    ctas = splits * n // 128
    assert 1 <= splits <= nb and (splits - 1) * bpc < nb  # the last slice holds >= 1 block
    assert bpc * 128 <= tk.DEC_SLICE_LANES and bpc >= tk.DEC_WARPS
    assert ctas <= wave
    assert ctas >= 2 * sms or bpc == tk.DEC_WARPS


def test_dec_splits_at_small_and_uneven_shapes():
    assert tk.dec_splits(256, 128, 128, H100_WAVE) == 1  # 2 blocks: one slice, out written directly
    assert tk.dec_splits(640, 128, 128, H100_WAVE) == 2  # 5 blocks: slices of 3 and 2
    assert tk.dec_splits(1024, 384, 256, H100_WAVE) == 1
    assert tk.dec_splits(4096, 6144, 128, H100_WAVE) == 8  # 8b qkv
    # 7b qkv: 32 blocks in slices of 7, the last 4; in slices of 8 on 114 SMs
    assert tk.dec_splits(4096, 12288, 128, H100_WAVE) == 5
    assert tk.dec_splits(4096, 12288, 128, 4 * 114) == 4
    for K, n, bs in ((2048, 128, 256), (640, 128, 128), (14336, 4096, 128), (28672, 128, 128)):
        nb = K // bs
        splits = tk.dec_splits(K, n, bs, H100_WAVE)
        bpc = -(-nb // splits)
        assert (splits - 1) * bpc < nb and bpc * bs <= tk.DEC_SLICE_LANES


# the decode kernel's algorithm (its lane permutation, fragment layouts and
# write-back, split-K slices, warps over whole blocks, per-block d and S,
# W2A8 on exact integers) at shapes whose slices divide
# the blocks evenly (768: 3 + 3; 1024: 4 + 4), unevenly (640: 3 + 2; 1408:
# 4 + 4 + 3) or not at all (256), bs 128 and 256
DEC_CASES = [(256, 128, 128), (640, 256, 128), (768, 384, 128), (1024, 128, 128),
             (1408, 128, 128), (1024, 256, 256)]


@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("rows", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("K,n,bs", DEC_CASES)
def test_dec_plain_matches_plain_and_xla(K, n, bs, rows, a8):
    """ternary_matmul_dec_plain equals the plain version (f32 order only:
    1e-6 of max|ref|) and JAX's XLA route (F32_TOL), bf16 and W2A8."""
    rng = np.random.default_rng(1000 * rows + K + n + bs + int(a8))
    packed, alpha, mu = _rand_packed(rng, n, K, bs)
    x = rng.normal(size=(rows, K)).astype(np.float32)
    tx, tp, ta, tm_ = _t(x), _t(packed), _t(alpha), _t(mu)
    got = tk.ternary_matmul_dec_plain(tx, tp, ta, tm_, bs, a8, wave=H100_WAVE)
    plain = tk.ternary_matmul_plain_a8 if a8 else tk.ternary_matmul_plain
    want = plain(tx, tp, ta, tm_, bs)
    assert got.shape == (rows, n) and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    xla = jtm.ternary_matmul_xla_a8 if a8 else jtm.ternary_matmul_xla
    jwant = np.asarray(xla(jnp.asarray(x), jnp.asarray(packed), alpha, mu, block_size=bs))
    np.testing.assert_allclose(got.numpy(), jwant, **F32_TOL)


@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("rows", [1, 4, 8])
def test_dec_plain_matches_pallas_interpret(rows, a8):
    """The decode kernel's algorithm against JAX's Pallas kernel in interpret
    mode at decode rows: bf16 within the kernel's (mu - alpha) rounding bound
    (as test_plain_matches_pallas_interpret), W2A8 at F32_TOL."""
    from jax.experimental.pallas import tpu as pltpu

    rng = np.random.default_rng(70 + rows + 10 * int(a8))
    K, n = 640, 256
    packed, alpha, mu = _rand_packed(rng, n, K)
    x = np.asarray(jnp.asarray(rng.normal(size=(rows, K)), jnp.bfloat16).astype(jnp.float32))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpt.ternary_matmul_pallas(
            jnp.asarray(x), jnp.asarray(packed), alpha, mu, tile_n=128, a8=a8
        ))
    got = tk.ternary_matmul_dec_plain(_t(x), _t(packed), _t(alpha), _t(mu), 128, a8,
                                      wave=H100_WAVE).numpy()
    if a8:
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        bound = _offset_rounding_bound(x, alpha, mu, 128) + 1e-5 * (1 + np.abs(want))
        assert np.all(np.abs(got - want) <= bound)


def test_dec_plain_a8_on_ties_and_a_zero_row():
    """W2A8 through the decode kernel's algorithm with half-integer
    normalised values (rounded half to even) and an all-zero row: the
    per-block dots are exact integers, so only the f32 scale products differ
    from the plain version; the zero row gives exact zeros."""
    rng = np.random.default_rng(5)
    K, n = 768, 256
    packed, alpha, mu = _rand_packed(rng, n, K)
    x = torch.from_numpy(_a8_rows_with_ties(rng, 8, K))
    got = tk.ternary_matmul_dec_plain(x, _t(packed), _t(alpha), _t(mu), 128, True, wave=H100_WAVE)
    want = tk.ternary_matmul_plain_a8(x, _t(packed), _t(alpha), _t(mu))
    assert float(got[1].abs().max()) == 0.0
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


# prefill rows, where JAX's kernel takes its masked W2A8 path (the
# telescoped unpack is bf16-only) and the card runs K1's int8 tensor-core path
@pytest.mark.parametrize("B", [17, 80, 256])
def test_plain_a8_matches_pallas_interpret(B):
    from jax.experimental.pallas import tpu as pltpu

    rng = np.random.default_rng(30 + B)
    K, n = 384, 256
    packed, alpha, mu = _rand_packed(rng, n, K)
    x = rng.normal(size=(B, K)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpt.ternary_matmul_pallas(
            jnp.asarray(x), jnp.asarray(packed), alpha, mu, tile_n=128, a8=True
        ))
    got = tk.ternary_matmul_plain_a8(_t(x), _t(packed), _t(alpha), _t(mu)).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)


def _a8_rows_with_ties(rng, B, K):
    """Random rows, an all-zero row (sx takes its floor) and two rows whose
    normalised values are half-integers (ties for the rounding): row 2
    holds +-127 and half-integers, so sx = 1; row 3 is that times 0.25,
    so sx = 0.25 and x / sx is exact again."""
    x = rng.normal(size=(B, K)).astype(np.float32)
    x[1] = 0.0
    x[2] = rng.integers(-127, 127, size=K) + 0.5
    x[2, 5], x[2, 9] = 127.0, -127.0
    x[3] = 0.25 * x[2]
    return x


@pytest.mark.parametrize("bs", [128, 256])
def test_lanes_plain_matches_plain_a8(bs):
    """The int8 tensor-core path's algorithm on the CPU: the prepass's xq in
    the packed bytes' lane order and its exact block sums, then the integer
    dot in that order and the f32 scales, equal the W2A8 plain version."""
    rng = np.random.default_rng(bs)
    B, K, n = 9, 1024, 256
    packed, alpha, mu = _rand_packed(rng, n, K, bs)
    x = torch.from_numpy(_a8_rows_with_ties(rng, B, K))
    xn, sx = tk.normalize_rows_a8(x)
    ties = (xn[2:4].float().frac().abs() == 0.5).sum().item()
    assert ties == 2 * (K - 2)  # every value of rows 2, 3 but the two +-127 is a tie
    xq, S = tk.quantize_rows_a8_lanes_plain(xn, bs)
    assert xq.dtype == torch.int8 and S.dtype == torch.int32 and tuple(S.shape) == (K // bs, B)
    # half to even, as jnp.round: the lanes hold np.round's values, reordered
    lanes = np.round(xn.float().numpy()).reshape(B, K // bs, 4, bs // 4).transpose(0, 1, 3, 2)
    np.testing.assert_array_equal(xq.numpy(), lanes.reshape(B, K))
    np.testing.assert_array_equal(S.numpy(), lanes.reshape(B, K // bs, bs).sum(-1).T)
    got = tk.ternary_matmul_lanes_plain(xq, S, _t(packed), _t(alpha), _t(mu), bs) * sx
    want = tk.ternary_matmul_plain_a8(x, _t(packed), _t(alpha), _t(mu), bs)
    assert float(got[1].abs().max()) == 0.0
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


def test_linear_route_names_k1_on_both_paths():
    """linear_route names the wrapper, whichever of K1's kernels it picks."""
    jp = jrand.random_ternary_linear(jax.random.PRNGKey(2), 256, 256, perm_mode="folded")
    tp = to_port(jp)
    for rows in (1, 512):
        for impl in ("auto", "a8"):
            assert ttm.linear_route(tp, rows, impl) == ("ternary_matmul",)


def _bias(p, seed):
    b = np.random.default_rng(seed).normal(size=(p.out_features,)).astype(np.float32)
    return dataclasses.replace(p, bias=jnp.asarray(b))


CASES = {
    # name: (out, in, perm_mode, with bias)
    "identity": (256, 384, "identity", False),
    "folded": (128, 256, "folded", True),
    "ragged": (128, 200, "identity", True),  # 200 lanes -> bs 8, padded K
    "ssr_cpu_gather": (128, 192, "ssr", False),
}


@pytest.mark.parametrize("impl", ["auto", "a8"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_linear_apply_matches_jax(case, impl):
    o, i, pm, with_bias = CASES[case]
    jp = jrand.random_ternary_linear(jax.random.PRNGKey(len(case)), o, i, perm_mode=pm)
    if with_bias:
        jp = _bias(jp, 1)
    x = np.random.default_rng(2).normal(size=(3, 2, i)).astype(np.float32)
    want = np.asarray(jtm.ternary_linear_apply(
        jp, jnp.asarray(x), impl="xla" if impl == "auto" else "a8", out_dtype=jnp.float32
    ))
    tp = to_port(jp)
    assert tp.identity_perm == jp.identity_perm and tp.input_folded == jp.input_folded
    got = ttm.ternary_linear_apply(tp, torch.from_numpy(x), impl=impl, out_dtype=torch.float32)
    assert tuple(got.shape) == (3, 2, o)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    # the explicit plain route computes the same as auto on the CPU
    if impl == "auto":
        plain = ttm.ternary_linear_apply(tp, torch.from_numpy(x), impl="plain",
                                         out_dtype=torch.float32)
        np.testing.assert_array_equal(plain.numpy(), got.numpy())


@pytest.mark.parametrize("impl", ["auto", "a8"])
@pytest.mark.parametrize("pm", ["identity", "folded"])
def test_linear_apply_stacked_matches_jax(pm, impl):
    layers = [
        _bias(jrand.random_ternary_linear(jax.random.PRNGKey(s), 128, 320, perm_mode=pm), s)
        for s in (4, 5)
    ]
    jp = jdec.stack_layers(layers)
    x = np.random.default_rng(6).normal(size=(5, 320)).astype(np.float32)
    tp = to_port(jp)
    for li in (0, 1):
        want = np.asarray(jtm.ternary_linear_apply_stacked(
            jp, jnp.asarray(x), jnp.int32(li), impl="xla" if impl == "auto" else "a8",
            out_dtype=jnp.float32,
        ))
        got = ttm.ternary_linear_apply_stacked(tp, torch.from_numpy(x), li, impl=impl,
                                               out_dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_apply_rejects_bad_input():
    jp = jrand.random_ternary_linear(jax.random.PRNGKey(0), 128, 256)
    tp = to_port(jp)
    with pytest.raises(ValueError):
        ttm.ternary_linear_apply(tp, torch.zeros((2, 100)))
    with pytest.raises(ValueError):
        ttm.ternary_linear_apply(tp, torch.zeros((2, 256)), impl="xla")


def test_no_silent_route_off_the_cpu():
    """A non-CPU tensor never takes the plain version: each kernel's wrapper
    refuses devices it has no kernel for (an SSR layer reaches K4's)."""
    jp = jrand.random_ternary_linear(jax.random.PRNGKey(1), 128, 192, perm_mode="ssr")
    tp = to_port(jp)
    x = torch.zeros((1, 192), device="meta")
    with pytest.raises(ValueError, match="no K4"):
        ttm.ternary_linear_apply(tp, x)
    meta = lambda *shape, dt=torch.bfloat16: torch.zeros(shape, dtype=dt, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="no K3"):
        tk.ternary_matmul_igathered(meta(1, 192), meta(256, dt=torch.int32),
                                    meta(64, 128, dt=torch.int8), meta(2, 128), meta(2, 128))
    with pytest.raises(ValueError, match="no K2"):
        tk.ternary_mlp(meta(1, 256), None, meta(64, 512, dt=torch.int8), meta(2, 512),
                       meta(2, 512), meta(64, 256, dt=torch.int8), meta(2, 256), meta(2, 256), 256)
    with pytest.raises(ValueError, match="no K1"):
        tk.ternary_matmul(torch.zeros((1, 256), device="meta"),
                          torch.zeros((64, 128), dtype=torch.int8, device="meta"),
                          torch.zeros((2, 128), device="meta"),
                          torch.zeros((2, 128), device="meta"))
