"""K1-K7 on the card against their plain versions (K1 on its four
kernels: the split-K tensor-core GEMV at decode rows, the bf16 and int8
tensor cores at prefill rows, the CUDA cores for other shapes; K3 on
three: the same GEMV with x staged through perm at decode rows, a one-pass
gather then a split-K tensor-core product at rows 9-64, the CUDA cores for
other shapes; K2 on three: K1's decode GEMV over gateup with the gated
epilogue then K1's decode kernel over mid at decode rows, the gather, a
gate/up product with the gated epilogue and the down product on the
tensor cores at rows 9-64, the CUDA cores with either of those off; and its
ungated mode on each), K4s / K5s / K6s and K1s / K3s with the slot read from
device memory (bit for bit the view route's). Needs an NVIDIA GPU; every
test skips without one. This file
imports neither JAX nor the JAX package, so on a machine without JAX it
runs as

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Tolerances: K1 and K3 get the same bf16 inputs as their plain versions and
accumulate in f32 in different orders, so they agree to 1e-4 of the
output's largest magnitude; so does K6 (the gather K5 computes, then K1's
sum). K4 copies bits on both of its kernels (its rows path from
K4_ROWS_MIN_ROWS: NaN payloads and -0.0 included) and K5 sums one nonzero
term per lane on a one-hot G: both bit-exact (K5 on other planes: 1e-6, f32
order). K5's rows path
(rows >= K5_ROWS_MIN_ROWS) sums in its plain version's order, each product
rounded before it is added: bit-exact to it on any planes, within 1e-6 of
x @ G in f32 (bf16: the result's own rounding). K2 rounds mid =
act(gate) * up (silu, gelu or relu) to bf16 as its plain version does, but
gate and up differ in their last f32 bits between the two, so a few mid
values round to the neighbouring bf16 (2^-8 relative) and K2 is held to 1e-3. K7 rounds the
unnormalised probabilities to bf16 relative to a running maximum (its
tensor-core kernel's of each tile, PR 3's kernel's of each chunk), its
plain version relative to the row's maximum: 1e-2 of max|out|. The
tensor-core kernel follows decode_attention_split_plain's schedule, so it
is held to it within one bf16 step of each value plus 1e-3 of max|out|,
also on the windowed kv_valid of sliding-window layers (slots (p - W, p]
of each row: leading tiles and whole splits with no valid slot)."""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from pt2tpu_torch.core.packing import pack_ternary
from pt2tpu_torch.models import decoder as tdec
from pt2tpu_torch.models.registry import get_config
from pt2tpu_torch.models import common as tcommon
from pt2tpu_torch.ops import gather as tgather
from pt2tpu_torch.ops import ternary_matmul as ttm
from pt2tpu_torch.ops.kernels import attention as tka
from pt2tpu_torch.ops.kernels import gather as tkg
from pt2tpu_torch.ops.kernels import ternary as tk
from pt2tpu_torch.quant import gptq as tgptq
from pt2tpu_torch.quant import hessian as thess
from pt2tpu_torch.quant.pipeline import rel_out_err
from pt2tpu_torch.serve.engine import ServeEngine
from pt2tpu_torch.serve.generate import greedy_generate
from pt2tpu_torch.serve.kvcache import quantize_i8
from pt2tpu_torch.utils.device import quotient_f32
from pt2tpu_torch.utils.randmodel import random_ternary_params

TOL = 1e-4
MLP_TOL = 1e-3
ATTN_TOL = 1e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (K1 has no CPU mode)")
    return torch.device("cuda")


def _layer(g, dev, K, n, bs):
    T = torch.randint(-1, 2, (n, K), generator=g, device=dev, dtype=torch.int8)
    nb = K // bs
    alpha = (0.05 + 0.01 * torch.rand((nb, n), generator=g, device=dev)).bfloat16()
    mu = (0.01 * torch.randn((nb, n), generator=g, device=dev)).bfloat16()
    return pack_ternary(T, bs), alpha, mu


@pytest.mark.cuda
@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("B,K,n,bs", [
    (1, 1024, 384, 128), (2, 14336, 4096, 128), (3, 640, 96, 64), (16, 4096, 256, 128),
    (70, 2304, 128, 128), (9, 512, 64, 16),
])
def test_kernel_matches_plain(cuda_device, B, K, n, bs, a8):
    g = torch.Generator(device=cuda_device).manual_seed(B + K)
    packed, alpha, mu = _layer(g, cuda_device, K, n, bs)
    x = torch.randn((B, K), generator=g, device=cuda_device).bfloat16()
    before = tk.ternary_matmul.launches
    got = tk.ternary_matmul(x, packed, alpha, mu, block_size=bs, a8=a8)
    torch.cuda.synchronize()
    assert tk.ternary_matmul.launches == before + 1
    plain = tk.ternary_matmul_plain_a8 if a8 else tk.ternary_matmul_plain
    want = plain(x, packed, alpha, mu, bs)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert (got - want).abs().max().item() <= TOL * want.abs().max().item()


@pytest.mark.cuda
def test_kernel_on_stacked_view(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    layers = [_layer(g, cuda_device, 1024, 256, 128) for _ in range(3)]
    packed = torch.stack([l[0] for l in layers])
    alpha = torch.stack([l[1] for l in layers])
    mu = torch.stack([l[2] for l in layers])
    x = torch.randn((4, 1024), generator=g, device=cuda_device).bfloat16()
    for li in range(3):
        got = tk.ternary_matmul(x, packed[li], alpha[li], mu[li])
        want = tk.ternary_matmul_plain(x, *layers[li])
        assert (got - want).abs().max().item() <= TOL * want.abs().max().item()


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    packed, alpha, mu = _layer(g, cuda_device, 256, 128, 128)
    x = torch.randn((2, 256), device=cuda_device).bfloat16()
    with pytest.raises(TypeError):
        tk.ternary_matmul(x, packed, alpha.float(), mu.float())
    with pytest.raises(ValueError):
        tk.ternary_matmul(x[:, :128], packed, alpha, mu)
    with pytest.raises(ValueError):
        tk.ternary_matmul(x, packed[:, :96].contiguous()[:, :80], alpha[:, :80], mu[:, :80])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tiny-llama", "tiny-llama-gqa", "tiny-gemma"])
def test_tiny_model_kernel_vs_plain(cuda_device, name):
    cfg = get_config(name)
    params = random_ternary_params(cfg, seed=3, perm_mode="down", device=cuda_device)
    tokens = torch.randint(0, cfg.vocab_size, (2, 9), device=cuda_device)
    before = tk.ternary_matmul.launches
    with torch.inference_mode():
        auto = tdec.forward(cfg, params, tokens, impl="auto").float()
        plain = tdec.forward(cfg, params, tokens, impl="plain").float()
    assert tk.ternary_matmul.launches == before + 4 * cfg.n_layers
    rel = ((auto - plain).norm() / plain.norm()).item()
    assert rel <= 1e-2  # bf16 activations round at different points


# K1's tensor-core path (csrc/ternary_matmul_tc.cu) at the llama-2-7b
# projections (down padded to 96 blocks, gateup to 2 x 11264) and the
# llama-3-8b ones, at prefill row counts
TC_SHAPES = {"7b qkv": (4096, 12288), "7b o / 8b o": (4096, 4096), "7b gateup": (4096, 22528),
             "7b down": (12288, 4096), "8b qkv": (4096, 6144), "8b gateup": (4096, 28672),
             "8b down": (14336, 4096)}


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [16, 17, 64, 100, 128, 512, 1024])
@pytest.mark.parametrize("shape", sorted(TC_SHAPES))
def test_tc_path_matches_plain(cuda_device, shape, rows):
    K, n = TC_SHAPES[shape]
    g = torch.Generator(device=cuda_device).manual_seed(rows + K + n)
    packed, alpha, mu = _layer(g, cuda_device, K, n, 128)
    x = torch.randn((rows, K), generator=g, device=cuda_device).bfloat16()
    assert tk.k1_path(rows, n, 128, False) == "tc"
    before = (tk.ternary_matmul.launches, tk.ternary_matmul.launches_tc)
    got = tk.ternary_matmul(x, packed, alpha, mu)
    torch.cuda.synchronize()
    assert (tk.ternary_matmul.launches, tk.ternary_matmul.launches_tc) == (before[0] + 1,
                                                                           before[1] + 1)
    want = tk.ternary_matmul_plain(x, packed, alpha, mu)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got, want) <= TOL


@pytest.mark.cuda
def test_tc_path_on_stacked_view_and_zero_alpha_blocks(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(5)
    layers = [_layer(g, cuda_device, 2048, 1024, 128) for _ in range(3)]
    packed, alpha, mu = (torch.stack([l[j] for l in layers]) for j in range(3))
    x = torch.randn((300, 2048), generator=g, device=cuda_device).bfloat16()
    for li in range(3):
        assert _rel(tk.ternary_matmul(x, packed[li], alpha[li], mu[li]),
                    tk.ternary_matmul_plain(x, *layers[li])) <= TOL
    # zero-scaled blocks, as a padded layer's pad blocks (alpha and mu both
    # 0) or blocks whose codes carry no scale (alpha 0, mu not)
    p, a, m = layers[0]
    a, m = a.clone(), m.clone()
    a[::3] = 0
    m[::6] = 0
    got = tk.ternary_matmul(x, p, a, m)
    assert _rel(got, tk.ternary_matmul_plain(x, p, a, m)) <= TOL


def _k1_counts():
    return (tk.ternary_matmul.launches, tk.ternary_matmul.launches_tc,
            tk.ternary_matmul.launches_tc_a8)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,bs,a8,path", [
    (512, 1024, 128, False, "tc"), (16, 1024, 128, False, "tc"), (8, 1024, 128, False, "dec"),
    (1, 1024, 128, False, "dec"), (512, 1024, 128, True, "tc_a8"),
    (512, 992, 128, False, "cuda_core"), (512, 1024, 64, False, "cuda_core"),
    (512, 1024, 256, False, "tc"), (9, 1024, 128, True, "tc_a8"), (8, 1024, 128, True, "cuda_core"),
    (512, 992, 128, True, "cuda_core"), (512, 1024, 64, True, "cuda_core"),
    (512, 1024, 256, True, "tc_a8"),
])
def test_k1_launches_tc_count_exactly(cuda_device, rows, n, bs, a8, path):
    """launches counts every K1 launch, launches_tc the bf16 tensor-core ones,
    launches_tc_a8 the int8 tensor-core ones and launches_dec the decode
    ones: shapes outside k1_path stay on the CUDA cores."""
    assert tk.k1_path(rows, n, bs, a8) == path
    g = torch.Generator(device=cuda_device).manual_seed(rows + n + bs)
    packed, alpha, mu = _layer(g, cuda_device, 1024, n, bs)
    x = torch.randn((rows, 1024), generator=g, device=cuda_device).bfloat16()
    before = _k1_counts() + (tk.ternary_matmul.launches_dec,)
    got = tk.ternary_matmul(x, packed, alpha, mu, block_size=bs, a8=a8)
    torch.cuda.synchronize()
    after = _k1_counts() + (tk.ternary_matmul.launches_dec,)
    assert tuple(b - a for a, b in zip(before, after)) \
        == (1, int(path == "tc"), int(path == "tc_a8"), int(path == "dec"))
    plain = tk.ternary_matmul_plain_a8 if a8 else tk.ternary_matmul_plain
    assert _rel(got, plain(x, packed, alpha, mu, bs)) <= TOL


# K1's W2A8 path on the int8 tensor cores (csrc/ternary_matmul_tc_a8.cu):
# the same shapes, from the fewest rows it takes
@pytest.mark.cuda
@pytest.mark.parametrize("rows", [9, 16, 17, 64, 100, 128, 512, 1024])
@pytest.mark.parametrize("shape", sorted(TC_SHAPES))
def test_tc_a8_path_matches_plain(cuda_device, shape, rows):
    K, n = TC_SHAPES[shape]
    g = torch.Generator(device=cuda_device).manual_seed(3 * rows + K + n)
    packed, alpha, mu = _layer(g, cuda_device, K, n, 128)
    x = torch.randn((rows, K), generator=g, device=cuda_device).bfloat16()
    assert tk.k1_path(rows, n, 128, True) == "tc_a8"
    before = _k1_counts()
    got = tk.ternary_matmul(x, packed, alpha, mu, a8=True)
    torch.cuda.synchronize()
    assert tuple(b - a for a, b in zip(before, _k1_counts())) == (1, 0, 1)
    want = tk.ternary_matmul_plain_a8(x, packed, alpha, mu)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got, want) <= TOL


def _a8_rows_with_ties(g, dev, B, K):
    """Random rows, an all-zero row (sx's floor) and rows whose normalised
    values are half-integers: row 2 holds +-127 and half-integers (sx = 1),
    row 3 is that times 0.25 (sx = 0.25, so x / sx is exact again)."""
    x = torch.randn((B, K), generator=g, device=dev)
    x[1] = 0
    x[2] = torch.randint(-127, 127, (K,), generator=g, device=dev) + 0.5
    x[2, 5], x[2, 9] = 127.0, -127.0
    x[3] = 0.25 * x[2]
    return x.bfloat16()


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [128, 256])
def test_tc_a8_path_on_stacked_view_zero_alpha_blocks_zero_row_and_ties(cuda_device, bs):
    g = torch.Generator(device=cuda_device).manual_seed(11 + bs)
    layers = [_layer(g, cuda_device, 2048, 1024, bs) for _ in range(3)]
    packed, alpha, mu = (torch.stack([l[j] for l in layers]) for j in range(3))
    x = _a8_rows_with_ties(g, cuda_device, 300, 2048)
    xn, _ = tk.normalize_rows_a8(x)
    assert (xn[2:4].float().frac().abs() == 0.5).sum().item() == 2 * (2048 - 2)
    before = _k1_counts()
    for li in range(3):
        got = tk.ternary_matmul(x, packed[li], alpha[li], mu[li], block_size=bs, a8=True)
        assert _rel(got, tk.ternary_matmul_plain_a8(x, *layers[li], bs)) <= TOL
        assert got[1].abs().max().item() == 0.0
    p, a, m = layers[0]
    a, m = a.clone(), m.clone()
    a[::3] = 0
    m[::6] = 0
    got = tk.ternary_matmul(x, p, a, m, block_size=bs, a8=True)
    assert _rel(got, tk.ternary_matmul_plain_a8(x, p, a, m, bs)) <= TOL
    assert tuple(b - a for a, b in zip(before, _k1_counts())) == (4, 0, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", range(1, 9))
def test_tc_a8_never_takes_decode_rows(cuda_device, rows):
    g = torch.Generator(device=cuda_device).manual_seed(40 + rows)
    packed, alpha, mu = _layer(g, cuda_device, 4096, 4096, 128)
    x = torch.randn((rows, 4096), generator=g, device=cuda_device).bfloat16()
    before = _k1_counts()
    got = tk.ternary_matmul(x, packed, alpha, mu, a8=True)
    torch.cuda.synchronize()
    assert tuple(b - a for a, b in zip(before, _k1_counts())) == (1, 0, 0)
    assert _rel(got, tk.ternary_matmul_plain_a8(x, packed, alpha, mu)) <= TOL


@pytest.mark.cuda
def test_tc_a8_launch_failure_raises_without_fallback(cuda_device, monkeypatch):
    """An int8 tensor-core launch that fails raises; neither the CUDA-core
    kernel, the bf16 tensor-core kernel nor the plain version runs in its
    place, and nothing is counted."""
    class Refusing:
        @staticmethod
        def pt2_ternary_matmul_tc_a8(*args):
            return 1  # cudaErrorInvalidValue

    def not_asked():
        raise AssertionError("another K1 kernel was asked for")

    g = torch.Generator(device=cuda_device).manual_seed(12)
    packed, alpha, mu = _layer(g, cuda_device, 512, 256, 128)
    x = torch.randn((64, 512), generator=g, device=cuda_device).bfloat16()
    monkeypatch.setattr(tk, "_tc_a8_kernel_lib", lambda: Refusing)
    monkeypatch.setattr(tk, "_tc_kernel_lib", not_asked)
    monkeypatch.setattr(tk, "_kernel_lib", not_asked)
    before = _k1_counts()
    with pytest.raises(RuntimeError, match="integer tensor cores"):
        tk.ternary_matmul(x, packed, alpha, mu, a8=True)
    assert _k1_counts() == before


@pytest.mark.cuda
def test_tc_a8_c_entry_refuses_what_it_does_not_take(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(13)
    packed, alpha, mu = _layer(g, cuda_device, 512, 256, 128)
    x = torch.randn((64, 512), generator=g, device=cuda_device).bfloat16()
    xn, sx = tk.normalize_rows_a8(x)
    xq = torch.empty((64, 512), dtype=torch.int8, device=cuda_device)
    sums = torch.empty((4, 128), dtype=torch.int32, device=cuda_device)
    out = torch.empty((64, 256), device=cuda_device)
    fn = tk._tc_a8_kernel_lib().pt2_ternary_matmul_tc_a8
    stream = torch.cuda.current_stream().cuda_stream
    dev = cuda_device.index or 0
    ptrs = [t.data_ptr() for t in (xn, packed, alpha, mu, xq, sums, out)]
    assert fn(*ptrs, 64, 128, 512, 256, 128, dev, stream) == 0
    torch.cuda.synchronize()
    assert _rel(out * sx, tk.ternary_matmul_plain_a8(x, packed, alpha, mu)) <= TOL
    # the prepass's outputs are the plain version's
    want_xq, want_s = tk.quantize_rows_a8_lanes_plain(xn)
    assert torch.equal(xq, want_xq) and torch.equal(sums[:, :64], want_s)
    assert not sums[:, 64:].any()  # pad rows
    for B, Bp, K, n, bs in ((64, 128, 512, 256, 64), (64, 128, 512, 224, 128),
                            (64, 64, 512, 256, 128), (129, 128, 512, 256, 128),
                            (0, 128, 512, 256, 128), (64, 128, 384, 256, 256)):
        assert fn(*ptrs, B, Bp, K, n, bs, dev, stream) != 0
    assert fn(ptrs[0] + 2, *ptrs[1:], 64, 128, 512, 256, 128, dev, stream) != 0  # misaligned xn


@pytest.mark.cuda
def test_tc_launch_failure_raises_without_fallback(cuda_device, monkeypatch):
    """A tensor-core launch that fails raises; neither the CUDA-core kernel
    nor the plain version runs in its place, and nothing is counted."""
    class Refusing:
        @staticmethod
        def pt2_ternary_matmul_tc(*args):
            return 1  # cudaErrorInvalidValue

    def no_cuda_core():
        raise AssertionError("the CUDA-core kernel was asked for")

    g = torch.Generator(device=cuda_device).manual_seed(8)
    packed, alpha, mu = _layer(g, cuda_device, 512, 256, 128)
    x = torch.randn((64, 512), generator=g, device=cuda_device).bfloat16()
    monkeypatch.setattr(tk, "_tc_kernel_lib", lambda: Refusing)
    monkeypatch.setattr(tk, "_kernel_lib", no_cuda_core)
    before = (tk.ternary_matmul.launches, tk.ternary_matmul.launches_tc)
    with pytest.raises(RuntimeError, match="tensor cores"):
        tk.ternary_matmul(x, packed, alpha, mu)
    assert (tk.ternary_matmul.launches, tk.ternary_matmul.launches_tc) == before


@pytest.mark.cuda
def test_tc_c_entry_refuses_what_it_does_not_take(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(9)
    packed, alpha, mu = _layer(g, cuda_device, 512, 256, 128)
    x = torch.randn((64, 512), generator=g, device=cuda_device).bfloat16()
    out = torch.empty((64, 256), device=cuda_device)
    sums = torch.empty((4, 128), device=cuda_device)
    fn = tk._tc_kernel_lib().pt2_ternary_matmul_tc
    stream = torch.cuda.current_stream().cuda_stream
    dev = cuda_device.index or 0
    ptrs = [t.data_ptr() for t in (x, packed, alpha, mu, sums, out)]
    assert fn(*ptrs, 64, 128, 512, 256, 128, dev, stream) == 0
    torch.cuda.synchronize()
    assert _rel(out, tk.ternary_matmul_plain(x, packed, alpha, mu)) <= TOL
    for B, Bp, K, n, bs in ((64, 128, 512, 256, 64), (64, 128, 512, 224, 128),
                            (64, 64, 512, 256, 128), (129, 128, 512, 256, 128),
                            (0, 128, 512, 256, 128), (64, 128, 384, 256, 256)):
        assert fn(*ptrs, B, Bp, K, n, bs, dev, stream) != 0
    assert fn(ptrs[0] + 2, *ptrs[1:], 64, 128, 512, 256, 128, dev, stream) != 0  # misaligned x


# K1's decode path (csrc/ternary_matmul_dec.cu): rows 1-8 at the same
# shapes, both modes
def _dec_counts():
    return (tk.ternary_matmul.launches, tk.ternary_matmul.launches_dec,
            tk.ternary_matmul.launches_tc, tk.ternary_matmul.launches_tc_a8)


@contextlib.contextmanager
def _dec_a8():
    """W2A8 decode rows on the decode kernel too (K1_DEC_A8)."""
    saved = tk.K1_DEC_A8
    tk.K1_DEC_A8 = True
    try:
        yield
    finally:
        tk.K1_DEC_A8 = saved


def _dec_held(x, packed, alpha, mu, bs=128, a8=False):
    """One K1 call that must take the decode path (W2A8 with K1_DEC_A8
    set): exactly one launch, counted in launches and launches_dec only;
    held to TOL."""
    with _dec_a8():
        assert tk.k1_path(x.shape[0], packed.shape[1], bs, a8) == "dec"
        before = _dec_counts()
        got = tk.ternary_matmul(x, packed, alpha, mu, block_size=bs, a8=a8)
    torch.cuda.synchronize()
    assert tuple(b - a for a, b in zip(before, _dec_counts())) == (1, 1, 0, 0)
    want = (tk.ternary_matmul_plain_a8 if a8 else tk.ternary_matmul_plain)(x, packed, alpha, mu,
                                                                            bs)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got, want) <= TOL
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("rows", range(1, 9))
@pytest.mark.parametrize("shape", sorted(TC_SHAPES))
def test_dec_path_matches_plain(cuda_device, shape, rows, a8):
    K, n = TC_SHAPES[shape]
    g = torch.Generator(device=cuda_device).manual_seed(5 * rows + K + n + int(a8))
    packed, alpha, mu = _layer(g, cuda_device, K, n, 128)
    x = torch.randn((rows, K), generator=g, device=cuda_device).bfloat16()
    _dec_held(x, packed, alpha, mu, a8=a8)


@pytest.mark.cuda
@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("bs", [128, 256])
def test_dec_path_on_stacked_view_zero_alpha_blocks_zero_row_and_ties(cuda_device, bs, a8):
    g = torch.Generator(device=cuda_device).manual_seed(21 + bs + int(a8))
    layers = [_layer(g, cuda_device, 2048, 1024, bs) for _ in range(3)]
    packed, alpha, mu = (torch.stack([l[j] for l in layers]) for j in range(3))
    x = _a8_rows_with_ties(g, cuda_device, 8, 2048)
    if a8:
        xn, _ = tk.normalize_rows_a8(x)
        assert (xn[2:4].float().frac().abs() == 0.5).sum().item() == 2 * (2048 - 2)
    for li in range(3):
        got = _dec_held(x, packed[li], alpha[li], mu[li], bs, a8)
        assert got[1].abs().max().item() == 0.0  # the all-zero row
    p, a, m = layers[0]
    a, m = a.clone(), m.clone()
    a[::3] = 0
    m[::6] = 0
    _dec_held(x, p, a, m, bs, a8)
    _dec_held(x[:3], p, a, m, bs, a8)


@pytest.mark.cuda
@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("K,n", [(640, 256), (1408, 128), (2304, 128), (4096, 12288),
                                 (4096, 22528)])
def test_dec_uneven_slices(cuda_device, K, n, a8):
    """Split counts that leave the last K slice shorter than the others."""
    nb = K // 128
    splits = tk.dec_splits(K, n, 128, tk.dec_wave(cuda_device))
    assert splits > 1 and nb % -(-nb // splits) != 0
    g = torch.Generator(device=cuda_device).manual_seed(K + n + int(a8))
    packed, alpha, mu = _layer(g, cuda_device, K, n, 128)
    for rows in (1, 5, 8):
        x = torch.randn((rows, K), generator=g, device=cuda_device).bfloat16()
        _dec_held(x, packed, alpha, mu, a8=a8)


@pytest.mark.cuda
@pytest.mark.parametrize("a8", [False, True])
def test_dec_same_bits_run_to_run(cuda_device, a8):
    """No float atomics: the same inputs give the same bits, call after call
    and shape after shape (the per-tile counters are left at 0)."""
    g = torch.Generator(device=cuda_device).manual_seed(33 + int(a8))
    shapes = [(4096, 6144), (12288, 4096), (640, 256)]
    layers = [_layer(g, cuda_device, K, n, 128) for K, n in shapes]
    xs = [torch.randn((8, K), generator=g, device=cuda_device).bfloat16() for K, _ in shapes]
    with _dec_a8():
        before = _dec_counts()
        first = [tk.ternary_matmul(x, *l, a8=a8) for x, l in zip(xs, layers)]
        for _ in range(3):
            for x, l, f in zip(xs, layers, first):
                assert torch.equal(tk.ternary_matmul(x, *l, a8=a8), f)
    assert _dec_counts()[1] - before[1] == 12
    torch.cuda.synchronize()
    assert not tk._dec_counters[(xs[0].device, torch.cuda.current_stream().cuda_stream)].any()


@pytest.mark.cuda
def test_dec_counters_are_per_stream(cuda_device):
    """Launches on two streams at once each count their K slices in counters
    of their own: every result is right and the same bits."""
    g = torch.Generator(device=cuda_device).manual_seed(34)
    packed, alpha, mu = _layer(g, cuda_device, 12288, 4096, 128)
    assert tk.dec_splits(12288, 4096, 128, tk.dec_wave(cuda_device)) > 1
    x = torch.randn((8, 12288), generator=g, device=cuda_device).bfloat16()
    want = tk.ternary_matmul_plain(x, packed, alpha, mu)
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    torch.cuda.synchronize()
    outs = []
    for _ in range(20):
        for s in streams:
            with torch.cuda.stream(s):
                outs.append(tk.ternary_matmul(x, packed, alpha, mu))
    torch.cuda.synchronize()
    assert _rel(outs[0], want) <= TOL
    assert all(torch.equal(o, outs[0]) for o in outs)
    for s in streams:
        assert not tk._dec_counters[(x.device, s.cuda_stream)].any()


@pytest.mark.cuda
def test_dec_refuses_graph_capture(cuda_device):
    """The decode path raises inside a CUDA graph capture, whose replays
    could overlap with its stream's launches on the same counters."""
    g = torch.Generator(device=cuda_device).manual_seed(35)
    packed, alpha, mu = _layer(g, cuda_device, 1024, 256, 128)
    x = torch.randn((8, 1024), generator=g, device=cuda_device).bfloat16()
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tk.ternary_matmul(x, packed, alpha, mu)  # built and warmed outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = _dec_counts()
    with pytest.raises(NotImplementedError, match="graph"):
        with torch.cuda.graph(graph):
            tk.ternary_matmul(x, packed, alpha, mu)
    assert _dec_counts() == before


@pytest.mark.cuda
def test_dec_launch_failure_raises_without_fallback(cuda_device, monkeypatch):
    """A decode launch that fails raises; no other K1 kernel nor the plain
    version runs in its place, and nothing is counted."""
    class Refusing:
        @staticmethod
        def pt2_ternary_matmul_dec(*args):
            return 1  # cudaErrorInvalidValue

    def not_asked():
        raise AssertionError("another K1 kernel was asked for")

    g = torch.Generator(device=cuda_device).manual_seed(14)
    packed, alpha, mu = _layer(g, cuda_device, 512, 256, 128)
    monkeypatch.setattr(tk, "_dec_kernel_lib", lambda: Refusing)
    monkeypatch.setattr(tk, "_tc_kernel_lib", not_asked)
    monkeypatch.setattr(tk, "_tc_a8_kernel_lib", not_asked)
    monkeypatch.setattr(tk, "_kernel_lib", not_asked)
    for a8 in (False, True):
        x = torch.randn((8, 512), generator=g, device=cuda_device).bfloat16()
        before = _dec_counts()
        with _dec_a8(), pytest.raises(RuntimeError, match="decode"):
            tk.ternary_matmul(x, packed, alpha, mu, a8=a8)
        assert _dec_counts() == before


@pytest.mark.cuda
def test_dec_c_entry_refuses_what_it_does_not_take(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(15)
    K, n = 1024, 256
    packed, alpha, mu = _layer(g, cuda_device, K, n, 128)
    x = torch.randn((8, K), generator=g, device=cuda_device).bfloat16()
    out = torch.empty((8, n), device=cuda_device)
    partial = torch.empty((8, 8, n), device=cuda_device)
    counters = torch.zeros(n // 128, dtype=torch.int32, device=cuda_device)
    fn = tk._dec_kernel_lib().pt2_ternary_matmul_dec
    stream = torch.cuda.current_stream().cuda_stream
    dev = cuda_device.index or 0
    xn, sx = tk.normalize_rows_a8(x)
    ptrs = [t.data_ptr() for t in (x, packed, alpha, mu, partial, out, counters)]
    for splits in (1, 2):  # 8 blocks: one slice of 8, two of 4
        for a8 in (0, 1):  # W2A8 takes the normalised rows
            assert fn(xn.data_ptr() if a8 else ptrs[0], *ptrs[1:], 8, K, n, 128, splits, a8, dev,
                      stream) == 0
            torch.cuda.synchronize()
            plain = tk.ternary_matmul_plain_a8 if a8 else tk.ternary_matmul_plain
            want = plain(x, packed, alpha, mu)
            assert _rel(out * sx if a8 else out, want) <= TOL
    assert not counters.any()
    # rows past the N tile, no rows, n % 128, bs 64, no slice, more slices
    # than blocks, a slice left empty (8 blocks in 7: slices of 2), a slice
    # over 2048 lanes (32 blocks in one)
    for B, K_, n_, bs, splits in ((9, K, n, 128, 2), (0, K, n, 128, 2), (8, K, 224, 128, 2),
                                  (8, K, n, 64, 2), (8, K, n, 128, 0), (8, K, n, 128, 9),
                                  (8, K, n, 128, 7), (8, 4096, n, 128, 1)):
        assert fn(*ptrs, B, K_, n_, bs, splits, 0, dev, stream) != 0
    assert fn(ptrs[0] + 2, *ptrs[1:], 8, K, n, 128, 2, 0, dev, stream) != 0  # misaligned x
    assert fn(*ptrs[:4], 0, *ptrs[5:], 8, K, n, 128, 2, 0, dev, stream) != 0  # no scratch
    assert fn(*ptrs[:6], 0, 8, K, n, 128, 2, 0, dev, stream) != 0  # no counters


def _perm(g, dev, m, K, interleave=False):
    perm = torch.cat([torch.randperm(m, generator=g, device=dev),
                      torch.full((K - m,), m, device=dev)])
    if interleave:
        perm = perm[torch.randperm(K, generator=g, device=dev)]
    return perm.to(torch.int32)


def _rel(got, want):
    return (got - want).abs().max().item() / want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,m,K", [(1, 4096, 4096), (5, 200, 384), (40, 640, 1024)])
def test_gather_kernel_bit_exact(cuda_device, rows, m, K, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(rows + m)
    perm = _perm(g, cuda_device, m, K, interleave=m == 200)
    x = torch.randn((rows, m), generator=g, device=cuda_device).to(dtype)
    before = tkg.onehot_gather.launches
    got = tkg.onehot_gather(x, perm)
    torch.cuda.synchronize()
    assert tkg.onehot_gather.launches == before + 1
    want = tkg.onehot_gather_plain(x, perm)
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("B,m,K,n", [(1, 4096, 4096, 6144), (2, 4096, 4096, 28672),
                                     (4, 200, 256, 256), (16, 640, 768, 384),
                                     (33, 512, 2048, 128)])
def test_igathered_kernel_matches_plain(cuda_device, B, m, K, n, a8):
    g = torch.Generator(device=cuda_device).manual_seed(B + m + n)
    packed, alpha, mu = _layer(g, cuda_device, K, n, 128)
    perm = _perm(g, cuda_device, m, K, interleave=m == 200)
    x = torch.randn((B, m), generator=g, device=cuda_device).bfloat16()
    before = tk.ternary_matmul_igathered.launches
    got = tk.ternary_matmul_igathered(x, perm, packed, alpha, mu, a8=a8)
    torch.cuda.synchronize()
    assert tk.ternary_matmul_igathered.launches == before + 1
    want = tk.ternary_matmul_igathered_plain(x, perm, packed, alpha, mu, a8=a8)
    assert got.shape == want.shape and _rel(got, want) <= TOL


# K3's decode rows (csrc/ternary_matmul_dec.cu's GATHER instances): rows 1-8
# at the llama-3-8b K3 shapes (qkv, o, gateup), a ragged perm with
# interleaved pad lanes in one K slice and one in uneven slices (5 blocks:
# 3 + 2), bf16 and W2A8
K3_DEC_SHAPES = {"8b qkv": (4096, 4096, 6144), "8b o": (4096, 4096, 4096),
                 "8b gateup": (4096, 4096, 28672), "ragged": (200, 256, 256),
                 "uneven": (600, 640, 128)}


def _k3_counts():
    return (tk.ternary_matmul_igathered.launches, tk.ternary_matmul_igathered.launches_dec,
            tk.ternary_matmul_igathered.launches_tc, tk.ternary_matmul.launches)


def _k3_dec_held(x, perm, packed, alpha, mu, bs=128, a8=False):
    """One K3 call that must take the decode path (W2A8 with K1_DEC_A8 set):
    one launch, counted in launches and launches_dec, none of K1's; held to
    TOL against both plain versions, and the same bits on a second call."""
    with _dec_a8():
        assert tk.k3_path(x.shape[0], packed.shape[1], bs, a8) == "dec"
        before = _k3_counts()
        got = tk.ternary_matmul_igathered(x, perm, packed, alpha, mu, bs, a8=a8)
        again = tk.ternary_matmul_igathered(x, perm, packed, alpha, mu, bs, a8=a8)
    torch.cuda.synchronize()
    assert tuple(b - a for a, b in zip(before, _k3_counts())) == (2, 2, 0, 0)
    assert torch.equal(got, again)
    want = tk.ternary_matmul_igathered_plain(x, perm, packed, alpha, mu, bs, a8)
    algo = tk.ternary_matmul_igathered_dec_plain(x, perm, packed, alpha, mu, bs, a8,
                                                 wave=tk.dec_wave(x.device))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got, want) <= TOL and _rel(got, algo) <= TOL
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("rows", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", sorted(K3_DEC_SHAPES))
def test_k3_dec_path_matches_plain(cuda_device, shape, rows, a8):
    m, K, n = K3_DEC_SHAPES[shape]
    g = torch.Generator(device=cuda_device).manual_seed(7 * rows + m + n + int(a8))
    packed, alpha, mu = _layer(g, cuda_device, K, n, 128)
    perm = _perm(g, cuda_device, m, K, interleave=m < K)
    x = torch.randn((rows, m), generator=g, device=cuda_device).bfloat16()
    if shape == "uneven":
        nb = K // 128
        assert nb % -(-nb // tk.dec_splits(K, n, 128, tk.dec_wave(cuda_device))) != 0
    _k3_dec_held(x, perm, packed, alpha, mu, a8=a8)


@pytest.mark.cuda
@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("bs", [128, 256])
def test_k3_dec_path_on_stacked_views_zero_alpha_blocks_zero_row_and_ties(cuda_device, bs, a8):
    g = torch.Generator(device=cuda_device).manual_seed(41 + bs + int(a8))
    m, K, n, L = 2000, 2048, 1024, 3
    layers = [_layer(g, cuda_device, K, n, bs) for _ in range(L)]
    packed, alpha, mu = (torch.stack([l[j] for l in layers]) for j in range(3))
    perms = torch.stack([_perm(g, cuda_device, m, K, interleave=True) for _ in range(L)])
    x = _a8_rows_with_ties(g, cuda_device, 8, m)
    for li in range(L):
        got = _k3_dec_held(x, perms[li], packed[li], alpha[li], mu[li], bs, a8)
        assert got[1].abs().max().item() == 0.0  # the all-zero row
    p, a, mu0 = layers[0]
    a, mu0 = a.clone(), mu0.clone()
    a[::3] = 0
    mu0[::6] = 0
    _k3_dec_held(x, perms[0], p, a, mu0, bs, a8)
    _k3_dec_held(x[:3], perms[0], p, a, mu0, bs, a8)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 8, 9, 16, 64, 65])
def test_k3_rows_and_modes_pick_their_kernel(cuda_device, rows):
    """bf16 decode rows on the decode path; W2A8 decode rows on the CUDA-core
    K3 unless K1_DEC_A8 is set; rows 9-64 on the tensor-core path in both
    modes; more rows on the CUDA-core K3."""
    g = torch.Generator(device=cuda_device).manual_seed(42 + rows)
    m, K, n = 4000, 4096, 4096
    packed, alpha, mu = _layer(g, cuda_device, K, n, 128)
    perm = _perm(g, cuda_device, m, K)
    x = torch.randn((rows, m), generator=g, device=cuda_device).bfloat16()
    for a8, dec_a8 in ((False, False), (True, False), (True, True)):
        saved = tk.K1_DEC_A8
        tk.K1_DEC_A8 = dec_a8
        try:
            before = _k3_counts()
            got = tk.ternary_matmul_igathered(x, perm, packed, alpha, mu, a8=a8)
        finally:
            tk.K1_DEC_A8 = saved
        torch.cuda.synchronize()
        dec = rows <= 8 and (dec_a8 or not a8)
        tc = 9 <= rows <= 64
        assert tuple(b - a for a, b in zip(before, _k3_counts())) == (1, int(dec), int(tc), 0)
        want = tk.ternary_matmul_igathered_plain(x, perm, packed, alpha, mu, a8=a8)
        assert _rel(got, want) <= TOL


@pytest.mark.cuda
def test_k3_dec_refuses_graph_capture(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(43)
    packed, alpha, mu = _layer(g, cuda_device, 1024, 256, 128)
    perm = _perm(g, cuda_device, 1000, 1024)
    x = torch.randn((8, 1000), generator=g, device=cuda_device).bfloat16()
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tk.ternary_matmul_igathered(x, perm, packed, alpha, mu)  # built outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = _k3_counts()
    with pytest.raises(NotImplementedError, match="K3.*graph"):
        with torch.cuda.graph(graph):
            tk.ternary_matmul_igathered(x, perm, packed, alpha, mu)
    assert _k3_counts() == before


@pytest.mark.cuda
def test_k3_dec_launch_failure_raises_without_fallback(cuda_device, monkeypatch):
    """A K3 decode launch that fails raises; neither the CUDA-core K3 nor a
    plain version runs in its place, and nothing is counted."""
    class Refusing:
        @staticmethod
        def pt2_ternary_matmul_dec_igathered(*args):
            return 1  # cudaErrorInvalidValue

    def not_asked():
        raise AssertionError("the CUDA-core K3 was asked for")

    g = torch.Generator(device=cuda_device).manual_seed(44)
    packed, alpha, mu = _layer(g, cuda_device, 512, 256, 128)
    perm = _perm(g, cuda_device, 500, 512)
    monkeypatch.setattr(tk, "_dec_kernel_lib", lambda: Refusing)
    monkeypatch.setattr(tk, "_kernel_lib", not_asked)
    for a8 in (False, True):
        x = torch.randn((8, 500), generator=g, device=cuda_device).bfloat16()
        before = _k3_counts()
        with _dec_a8(), pytest.raises(RuntimeError, match="K3 \\(decode"):
            tk.ternary_matmul_igathered(x, perm, packed, alpha, mu, a8=a8)
        assert _k3_counts() == before


@pytest.mark.cuda
def test_k3_dec_c_entry_refuses_what_it_does_not_take(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(45)
    m, K, n = 1000, 1024, 256
    packed, alpha, mu = _layer(g, cuda_device, K, n, 128)
    perm = _perm(g, cuda_device, m, K, interleave=True)
    # x 2 bytes past a 16-byte boundary: the gather reads single bf16 values
    xc = torch.randn(8 * m + 1, generator=g, device=cuda_device).bfloat16()[1:].view(8, m)
    assert xc.data_ptr() % 16 == 2
    out = torch.empty((8, n), device=cuda_device)
    partial = torch.empty((8, 8, n), device=cuda_device)
    counters = torch.zeros(n // 128, dtype=torch.int32, device=cuda_device)
    fn = tk._dec_kernel_lib().pt2_ternary_matmul_dec_igathered
    stream = torch.cuda.current_stream().cuda_stream
    dev = cuda_device.index or 0
    ptrs = [t.data_ptr() for t in (xc, perm, packed, alpha, mu, partial, out, counters)]
    for splits in (1, 2):  # 8 blocks: one slice of 8, two of 4
        assert fn(*ptrs, 8, m, K, n, 128, splits, 0, dev, stream) == 0
        torch.cuda.synchronize()
        want = tk.ternary_matmul_igathered_plain(xc, perm, packed, alpha, mu)
        assert _rel(out, want) <= TOL
    assert not counters.any()
    # rows past the N tile, no rows, no features, n % 128, bs 64, no slice,
    # more slices than blocks, a slice left empty, a slice over 2048 lanes
    for B, m_, K_, n_, bs, splits in ((9, m, K, n, 128, 2), (0, m, K, n, 128, 2),
                                      (8, 0, K, n, 128, 2), (8, m, K, 224, 128, 2),
                                      (8, m, K, n, 64, 2), (8, m, K, n, 128, 0),
                                      (8, m, K, n, 128, 9), (8, m, K, n, 128, 7),
                                      (8, m, 4096, n, 128, 1)):
        assert fn(*ptrs, B, m_, K_, n_, bs, splits, 0, dev, stream) != 0
    assert fn(ptrs[0], ptrs[1] + 4, *ptrs[2:], 8, m, K, n, 128, 2, 0, dev, stream) != 0  # perm
    assert fn(ptrs[0] + 1, *ptrs[1:], 8, m, K, n, 128, 2, 0, dev, stream) != 0  # odd x
    assert fn(ptrs[0], 0, *ptrs[2:], 8, m, K, n, 128, 2, 0, dev, stream) != 0  # no perm
    assert fn(*ptrs[:5], 0, *ptrs[6:], 8, m, K, n, 128, 2, 0, dev, stream) != 0  # no scratch
    assert fn(*ptrs[:7], 0, 8, m, K, n, 128, 2, 0, dev, stream) != 0  # no counters


# K3's rows 9-64 (csrc/ternary_matmul_igathered_tc.cu): the same shapes, rows
# 9 / 16 / 32 / 33 / 64 (every row-tile instance, pad rows in the last n8
# tile), bf16 and W2A8
K3_TC_ROWS = [9, 16, 32, 33, 64]


def _k3_tc_held(x, perm, packed, alpha, mu, bs=128, a8=False):
    """One K3 call that must take the tensor-core path: counted in launches
    and launches_tc, none of K1's; held to TOL against both plain versions,
    and the same bits on a second call."""
    assert tk.k3_path(x.shape[0], packed.shape[1], bs, a8) == "tc"
    before = _k3_counts()
    got = tk.ternary_matmul_igathered(x, perm, packed, alpha, mu, bs, a8=a8)
    again = tk.ternary_matmul_igathered(x, perm, packed, alpha, mu, bs, a8=a8)
    torch.cuda.synchronize()
    assert tuple(b - a for a, b in zip(before, _k3_counts())) == (2, 0, 2, 0)
    assert torch.equal(got, again)
    want = tk.ternary_matmul_igathered_plain(x, perm, packed, alpha, mu, bs, a8)
    algo = tk.ternary_matmul_igathered_tc_plain(x, perm, packed, alpha, mu, bs, a8,
                                                wave=tk.igtc_wave(x.device))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got, want) <= TOL and _rel(got, algo) <= TOL
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("rows", K3_TC_ROWS)
@pytest.mark.parametrize("shape", sorted(K3_DEC_SHAPES))
def test_k3_tc_path_matches_plain(cuda_device, shape, rows, a8):
    m, K, n = K3_DEC_SHAPES[shape]
    g = torch.Generator(device=cuda_device).manual_seed(11 * rows + m + n + int(a8))
    packed, alpha, mu = _layer(g, cuda_device, K, n, 128)
    perm = _perm(g, cuda_device, m, K, interleave=m < K)
    x = torch.randn((rows, m), generator=g, device=cuda_device).bfloat16()
    if shape == "8b qkv":  # 32 blocks in 5 slices of 7, 7, 7, 7, 4
        nb = K // 128
        assert nb % -(-nb // tk.igtc_splits(K, n, 128, tk.igtc_wave(cuda_device))) != 0
    _k3_tc_held(x, perm, packed, alpha, mu, a8=a8)


@pytest.mark.cuda
@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("bs", [128, 256])
def test_k3_tc_path_on_stacked_views_zero_alpha_blocks_zero_row_and_ties(cuda_device, bs, a8):
    g = torch.Generator(device=cuda_device).manual_seed(51 + bs + int(a8))
    m, K, n, L = 2000, 2048, 1024, 3
    layers = [_layer(g, cuda_device, K, n, bs) for _ in range(L)]
    packed, alpha, mu = (torch.stack([l[j] for l in layers]) for j in range(3))
    perms = torch.stack([_perm(g, cuda_device, m, K, interleave=True) for _ in range(L)])
    x = torch.cat([_a8_rows_with_ties(g, cuda_device, 8, m),
                   torch.randn((25, m), generator=g, device=cuda_device).bfloat16()])
    for li in range(L):
        got = _k3_tc_held(x, perms[li], packed[li], alpha[li], mu[li], bs, a8)
        assert got[1].abs().max().item() == 0.0  # the all-zero row
    p, a, mu0 = layers[0]
    a, mu0 = a.clone(), mu0.clone()
    a[::3] = 0
    mu0[::6] = 0
    _k3_tc_held(x, perms[0], p, a, mu0, bs, a8)
    _k3_tc_held(x[:9], perms[0], p, a, mu0, bs, a8)


@pytest.mark.cuda
@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("rows", [9, 17, 64])
def test_k3_tc_gather_bit_exact(cuda_device, rows, a8):
    """The path's gather alone (its C entry) writes exactly what
    igathered_tc_gather_plain does: the fragment-order scratch bit for bit
    (pad lanes and pad rows 0, W2A8 rounded), the block sums to f32 order."""
    g = torch.Generator(device=cuda_device).manual_seed(61 + rows + int(a8))
    m, K, bs = 3000, 3072, 128
    perm = _perm(g, cuda_device, m, K, interleave=True)
    x = _a8_rows_with_ties(g, cuda_device, rows, m)
    xk = tk.normalize_rows_a8(x)[0].contiguous() if a8 else x
    Bp = tk.igtc_rows_pad(rows)
    xg = torch.full((Bp, K), float("nan"), device=cuda_device).bfloat16()
    S = torch.full((K // bs, Bp), float("nan"), device=cuda_device)
    rc = tk._igtc_kernel_lib().pt2_ternary_matmul_igathered_tc_gather(
        xk.data_ptr(), perm.data_ptr(), xg.data_ptr(), S.data_ptr(), rows, Bp, m, K, bs, int(a8),
        cuda_device.index or 0, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    want_xg, want_S = tk.igathered_tc_gather_plain(xk, perm, bs, a8)
    assert torch.equal(xg, want_xg)
    assert (S - want_S).abs().max().item() <= 1e-6 * want_S.abs().max().item()


@pytest.mark.cuda
def test_k3_tc_refuses_graph_capture(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(53)
    packed, alpha, mu = _layer(g, cuda_device, 1024, 256, 128)
    perm = _perm(g, cuda_device, 1000, 1024)
    x = torch.randn((16, 1000), generator=g, device=cuda_device).bfloat16()
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tk.ternary_matmul_igathered(x, perm, packed, alpha, mu)  # built outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = _k3_counts()
    with pytest.raises(NotImplementedError, match="K3's tensor-core path.*graph"):
        with torch.cuda.graph(graph):
            tk.ternary_matmul_igathered(x, perm, packed, alpha, mu)
    assert _k3_counts() == before


@pytest.mark.cuda
def test_k3_tc_launch_failure_raises_without_fallback(cuda_device, monkeypatch):
    """A launch of the tensor-core path that fails raises; neither the
    CUDA-core K3 nor a plain version runs in its place, and nothing is
    counted."""
    class Refusing:
        @staticmethod
        def pt2_ternary_matmul_igathered_tc(*args):
            return 1  # cudaErrorInvalidValue

    def not_asked():
        raise AssertionError("the CUDA-core K3 was asked for")

    g = torch.Generator(device=cuda_device).manual_seed(54)
    packed, alpha, mu = _layer(g, cuda_device, 512, 256, 128)
    perm = _perm(g, cuda_device, 500, 512)
    monkeypatch.setattr(tk, "_igtc_kernel_lib", lambda: Refusing)
    monkeypatch.setattr(tk, "_kernel_lib", not_asked)
    for a8 in (False, True):
        for rows in (9, 64):
            x = torch.randn((rows, 500), generator=g, device=cuda_device).bfloat16()
            before = _k3_counts()
            with pytest.raises(RuntimeError, match="K3 \\(rows 9-64, tensor cores\\)"):
                tk.ternary_matmul_igathered(x, perm, packed, alpha, mu, a8=a8)
            assert _k3_counts() == before


@pytest.mark.cuda
def test_k3_tc_c_entry_refuses_what_it_does_not_take(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(55)
    m, K, n, B = 1000, 1024, 256, 16
    packed, alpha, mu = _layer(g, cuda_device, K, n, 128)
    perm = _perm(g, cuda_device, m, K, interleave=True)
    # x 2 bytes past a 16-byte boundary: the gather reads single bf16 values
    xc = torch.randn(B * m + 1, generator=g, device=cuda_device).bfloat16()[1:].view(B, m)
    assert xc.data_ptr() % 16 == 2
    xg = torch.empty((64, K), device=cuda_device).bfloat16()
    sums = torch.empty((K // 128, 64), device=cuda_device)
    out = torch.empty((64, n), device=cuda_device)
    partial = torch.empty((8, 64, n), device=cuda_device)
    counters = torch.zeros(n // 128, dtype=torch.int32, device=cuda_device)
    lib = tk._igtc_kernel_lib()
    fn, gather = lib.pt2_ternary_matmul_igathered_tc, lib.pt2_ternary_matmul_igathered_tc_gather
    stream = torch.cuda.current_stream().cuda_stream
    dev = cuda_device.index or 0
    ptrs = [t.data_ptr() for t in (xc, perm, packed, alpha, mu, xg, sums, partial, out, counters)]
    for splits in (1, 3, 8):  # 8 blocks: one slice, slices of 3 + 3 + 2, of 1
        assert fn(*ptrs, B, m, K, n, 128, splits, 0, dev, stream) == 0
        torch.cuda.synchronize()
        want = tk.ternary_matmul_igathered_plain(xc, perm, packed, alpha, mu)
        assert _rel(out[:B], want) <= TOL
    assert not counters.any()
    # rows below 9 or above 64, no features, n % 128, bs 64, bs 192, no
    # slice, more slices than blocks, a slice left empty (7 of 8 blocks: 2
    # each leaves the last empty), K not a multiple of bs
    for B_, m_, K_, n_, bs, splits in ((8, m, K, n, 128, 2), (65, m, K, n, 128, 2),
                                       (0, m, K, n, 128, 2), (B, 0, K, n, 128, 2),
                                       (B, m, K, 224, 128, 2), (B, m, K, n, 64, 2),
                                       (B, m, K, n, 192, 2), (B, m, K, n, 128, 0),
                                       (B, m, K, n, 128, 9), (B, m, K, n, 128, 7),
                                       (B, m, 1000, n, 128, 2)):
        assert fn(*ptrs, B_, m_, K_, n_, bs, splits, 0, dev, stream) != 0
    for i, off in ((1, 4), (0, 1), (2, 8), (3, 2), (5, 8), (6, 4), (7, 8), (8, 8)):
        bad = list(ptrs)  # perm, x, packed, alpha, xg, sums, partial, out misaligned
        bad[i] += off
        assert fn(*bad, B, m, K, n, 128, 2, 0, dev, stream) != 0, i
    for i in (0, 1, 2, 5, 6, 7, 9):  # a missing operand or scratch
        bad = list(ptrs)
        bad[i] = 0
        assert fn(*bad, B, m, K, n, 128, 2, 0, dev, stream) != 0, i
    # the gather alone: its row pad must be the product's (16, 32 or 64)
    gptrs = [ptrs[0], ptrs[1], ptrs[5], ptrs[6]]
    assert gather(*gptrs, B, 16, m, K, 128, 0, dev, stream) == 0
    for B_, Bp in ((B, 32), (17, 16), (33, 32), (8, 16), (65, 64)):
        assert gather(*gptrs, B_, Bp, m, K, 128, 0, dev, stream) != 0
    assert gather(gptrs[0], gptrs[1] + 4, *gptrs[2:], B, 16, m, K, 128, 0, dev, stream) != 0
    torch.cuda.synchronize()


def _mlp_layer(g, dev, Kg, I, n, L=None):
    """Gateup (Kg lanes -> 2I, gate | up) and down (I -> n, its block count
    padded to 16 as make_packed_linear pads it), optionally stacked L deep."""
    def one():
        gu = _layer(g, dev, Kg, 2 * I, 128)
        nbd = -(-(I // 128) // 16) * 16
        dn = _layer(g, dev, nbd * 128, n, 128)
        return gu + dn
    if L is None:
        return one()
    parts = [one() for _ in range(L)]
    return tuple(torch.stack([p[i] for p in parts]) for i in range(6))


@pytest.mark.cuda
@pytest.mark.parametrize("gather", [True, False], ids=["ssr", "down"])
@pytest.mark.parametrize("B,D,I,n", [(1, 512, 1408, 512), (2, 4096, 14336, 4096),
                                     (4, 4096, 14336, 4096), (16, 512, 1024, 256),
                                     (33, 256, 512, 384)])
def test_mlp_kernel_matches_plain(cuda_device, B, D, I, n, gather):
    _check_mlp_kernel(cuda_device, B, D, I, n, gather, "silu")


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["gelu", "relu"])
@pytest.mark.parametrize("gather", [True, False], ids=["ssr", "down"])
@pytest.mark.parametrize("B,D,I,n", [(1, 2048, 16384, 2048), (8, 2048, 16384, 2048),
                                     (16, 512, 1024, 256), (33, 256, 512, 384)])
def test_mlp_kernel_act_matches_plain(cuda_device, B, D, I, n, gather, act):
    """K2's GeGLU mode (gemma-2b's MLP at 1 and 8 rows) and its relu mode."""
    _check_mlp_kernel(cuda_device, B, D, I, n, gather, act)


def _check_mlp_kernel(cuda_device, B, D, I, n, gather, act):
    g = torch.Generator(device=cuda_device).manual_seed(B + I)
    # with a gather its perm covers D lanes; without, x is zero-padded to the
    # 16-block multiple of lanes that make_packed_linear gives gateup
    Kg = D if gather else -(-D // 2048) * 2048
    gp, ga, gm, dp, da, dm = _mlp_layer(g, cuda_device, Kg, I, n)
    perm = _perm(g, cuda_device, D, Kg) if gather else None
    x = torch.randn((B, D), generator=g, device=cuda_device).bfloat16()
    before = tk.ternary_mlp.launches
    got = tk.ternary_mlp(x, perm, gp, ga, gm, dp, da, dm, intermediate=I, act=act)
    torch.cuda.synchronize()
    assert tk.ternary_mlp.launches == before + 1
    want = tk.ternary_mlp_plain(x, perm, gp, ga, gm, dp, da, dm, intermediate=I, act=act)
    assert got.shape == want.shape == (B, n) and _rel(got, want) <= MLP_TOL
    if act != "silu":  # the activation is the asked one, not silu's
        other = tk.ternary_mlp_plain(x, perm, gp, ga, gm, dp, da, dm, intermediate=I)
        assert _rel(got, other) > 10 * MLP_TOL


# K2's rows 9-64 (csrc/ternary_mlp_tc.cu): llama-3-8b's and gemma-2b's MLPs
# (D, I, n; gateup's lanes are x's width, as fused_mlp_ok asks), rows
# 9 / 16 / 33 / 64 (every row-tile instance, pad rows in the last tile),
# with the gather ("ssr") and without ("down"), silu, gelu and relu
K2_TC_SHAPES = {"llama-3-8b": (4096, 14336, 4096), "gemma-2b": (2048, 16384, 2048)}
K2_TC_ROWS = [9, 16, 33, 64]


def _k2_counts():
    return (tk.ternary_mlp.launches, tk.ternary_mlp.launches_tc, tk.ternary_mlp.launches_gelu)


def _k2_tc_held(x, perm, layer, I, act="silu"):
    """One K2 call that must take the tensor-core path: counted in launches
    and launches_tc (and launches_gelu for gelu); held to MLP_TOL against
    ternary_mlp_plain and ternary_mlp_tc_plain, and the same bits on a
    second call."""
    assert tk.k2_path(x.shape[0]) == "tc"
    before = _k2_counts()
    got = tk.ternary_mlp(x, perm, *layer, intermediate=I, act=act)
    again = tk.ternary_mlp(x, perm, *layer, intermediate=I, act=act)
    torch.cuda.synchronize()
    assert tuple(b - a for a, b in zip(before, _k2_counts())) == (2, 2, 2 * (act == "gelu"))
    assert torch.equal(got, again)
    want = tk.ternary_mlp_plain(x, perm, *layer, intermediate=I, act=act)
    algo = tk.ternary_mlp_tc_plain(x, perm, *layer, intermediate=I, act=act,
                                   wave=tk.igtc_wave(x.device))
    assert got.shape == want.shape == (x.shape[0], layer[3].shape[1])
    assert _rel(got, want) <= MLP_TOL and _rel(got, algo) <= MLP_TOL
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
@pytest.mark.parametrize("gather", [True, False], ids=["ssr", "down"])
@pytest.mark.parametrize("rows", K2_TC_ROWS)
@pytest.mark.parametrize("shape", sorted(K2_TC_SHAPES))
def test_k2_tc_path_matches_plain(cuda_device, shape, rows, gather, act):
    D, I, n = K2_TC_SHAPES[shape]
    g = torch.Generator(device=cuda_device).manual_seed(rows + I + int(gather))
    layer = _mlp_layer(g, cuda_device, D, I, n)
    perm = _perm(g, cuda_device, D, D) if gather else None
    x = torch.randn((rows, D), generator=g, device=cuda_device).bfloat16()
    _k2_tc_held(x, perm, layer, I, act)


@pytest.mark.cuda
@pytest.mark.parametrize("gather", [True, False], ids=["ssr", "down"])
def test_k2_tc_path_on_stacked_views_zero_pads_and_slices(cuda_device, gather):
    """A 3-layer stack at a width whose products are cut into K slices (on
    the H100 gateup in 4 slices of one block, down in 11); pad lanes (the
    perm's, interleaved, or x zero-padded to 2048 lanes), all-zero alpha
    blocks and an all-zero row."""
    g = torch.Generator(device=cuda_device).manual_seed(71 + int(gather))
    m, I, n, L = 500, 1408, 512, 3
    Kg = 512 if gather else 2048
    layers = _mlp_layer(g, cuda_device, Kg, I, n, L=L)
    perms = torch.stack([_perm(g, cuda_device, m, Kg, interleave=True) for _ in range(L)])
    x = torch.randn((40, m), generator=g, device=cuda_device).bfloat16()
    x[1] = 0
    for li in range(L):
        got = _k2_tc_held(x, perms[li] if gather else None, [t[li] for t in layers], I)
        assert got[1].abs().max().item() == 0.0  # the all-zero row
    layer = [t[0].clone() for t in layers]
    layer[1][::3] = 0
    layer[4][::2] = 0
    _k2_tc_held(x[:9], perms[0] if gather else None, layer, I, "gelu")


@pytest.mark.cuda
@pytest.mark.parametrize("rows", range(1, 9))
def test_k2_decode_rows_take_the_cuda_cores(cuda_device, rows, monkeypatch):
    """With the decode path off (K2_DEC_MAX_ROWS 0, the A/Bs' "off" turns)."""
    g = torch.Generator(device=cuda_device).manual_seed(80 + rows)
    D, I, n = 512, 1024, 256
    layer = _mlp_layer(g, cuda_device, D, I, n)
    perm = _perm(g, cuda_device, D, D)
    x = torch.randn((rows, D), generator=g, device=cuda_device).bfloat16()
    assert tk.k2_path(rows) == "dec"
    monkeypatch.setattr(tk, "K2_DEC_MAX_ROWS", 0)
    assert tk.k2_path(rows) == "cc"
    before = _k2_counts()
    got = tk.ternary_mlp(x, perm, *layer, intermediate=I)
    torch.cuda.synchronize()
    assert tuple(b - a for a, b in zip(before, _k2_counts())) == (1, 0, 0)
    want = tk.ternary_mlp_plain(x, perm, *layer, intermediate=I)
    assert _rel(got, want) <= MLP_TOL


@pytest.mark.cuda
def test_k2_tc_off_sends_its_rows_to_the_cuda_cores(cuda_device, monkeypatch):
    g = torch.Generator(device=cuda_device).manual_seed(90)
    D, I, n = 512, 1024, 256
    layer = _mlp_layer(g, cuda_device, D, I, n)
    x = torch.randn((64, D), generator=g, device=cuda_device).bfloat16()
    monkeypatch.setattr(tk, "K2_TC_MIN_ROWS", 1 << 30)
    before = _k2_counts()
    got = tk.ternary_mlp(x, None, *layer, intermediate=I)
    torch.cuda.synchronize()
    assert tuple(b - a for a, b in zip(before, _k2_counts())) == (1, 0, 0)
    assert _rel(got, tk.ternary_mlp_plain(x, None, *layer, intermediate=I)) <= MLP_TOL


@pytest.mark.cuda
def test_k2_tc_refuses_graph_capture(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(91)
    D, I, n = 512, 1024, 256
    layer = _mlp_layer(g, cuda_device, D, I, n)
    x = torch.randn((16, D), generator=g, device=cuda_device).bfloat16()
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tk.ternary_mlp(x, None, *layer, intermediate=I)  # built outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = _k2_counts()
    with pytest.raises(NotImplementedError, match="K2's tensor-core path.*graph"):
        with torch.cuda.graph(graph):
            tk.ternary_mlp(x, None, *layer, intermediate=I)
    assert _k2_counts() == before


@pytest.mark.cuda
def test_k2_tc_launch_failure_raises_without_fallback(cuda_device, monkeypatch):
    """A launch of the tensor-core path that fails raises; neither the
    CUDA-core K2 nor a plain version runs in its place, and nothing is
    counted."""
    class Refusing:
        @staticmethod
        def pt2_ternary_mlp_tc(*args):
            return 1  # cudaErrorInvalidValue

    def not_asked():
        raise AssertionError("the CUDA-core K2 was asked for")

    g = torch.Generator(device=cuda_device).manual_seed(92)
    D, I, n = 512, 1024, 256
    layer = _mlp_layer(g, cuda_device, D, I, n)
    perm = _perm(g, cuda_device, D, D)
    monkeypatch.setattr(tk, "_mlp_tc_kernel_lib", lambda: Refusing)
    monkeypatch.setattr(tk, "_mlp_kernel_lib", not_asked)
    for rows in (9, 64):
        for p in (perm, None):
            x = torch.randn((rows, D), generator=g, device=cuda_device).bfloat16()
            before = _k2_counts()
            with pytest.raises(RuntimeError, match="K2 \\(rows 9-64, tensor cores\\)"):
                tk.ternary_mlp(x, p, *layer, intermediate=I)
            assert _k2_counts() == before


@pytest.mark.cuda
def test_k2_tc_c_entry_refuses_what_it_does_not_take(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(93)
    D, I, n, B = 512, 1024, 256, 16
    gp, ga, gm, dp, da, dm = _mlp_layer(g, cuda_device, D, I, n)
    perm = _perm(g, cuda_device, D, D)
    x = torch.randn((B, D), generator=g, device=cuda_device).bfloat16()
    f32 = dict(device=cuda_device)
    xg = torch.empty((64, D), **f32).bfloat16()
    sums = torch.empty((D // 128, 64), **f32)
    gpart = torch.empty((4, 64, 2 * I), **f32)
    mid = torch.empty((64, I), **f32).bfloat16()
    msums = torch.empty((I // 64 + I // 128, 64), **f32)
    dpart = torch.empty((8, 64, n), **f32)
    out = torch.empty((64, n), **f32)
    counters = torch.zeros(1024, dtype=torch.int32, device=cuda_device)
    fn = tk._mlp_tc_kernel_lib().pt2_ternary_mlp_tc
    stream = torch.cuda.current_stream().cuda_stream
    dev = cuda_device.index or 0
    ptrs = [t.data_ptr() for t in (x, perm, gp, ga, gm, dp, da, dm, xg, sums, gpart, mid, msums,
                                   dpart, out, counters)]
    want = tk.ternary_mlp_plain(x, perm, gp, ga, gm, dp, da, dm, I)
    # 4 gateup blocks and 8 down blocks: one slice each, one block a slice,
    # slices of 2 + 2 and of 3 + 3 + 2
    for gs, ds in ((1, 1), (4, 8), (2, 3)):
        assert fn(*ptrs, B, D, D, I, n, gs, ds, 0, dev, stream) == 0
        torch.cuda.synchronize()
        assert _rel(out[:B], want) <= MLP_TOL
    assert not counters.any()
    # rows below 9 or above 64, half or n not multiples of 128, no slice,
    # more slices than blocks, a slice left empty (3 of 4 blocks, 7 of 8:
    # 2 each leaves the last empty), an unknown activation
    for B_, half, n_, gs, ds, act in ((8, I, n, 1, 1, 0), (65, I, n, 1, 1, 0),
                                      (B, 960, n, 1, 1, 0), (B, I, 224, 1, 1, 0),
                                      (B, I, n, 0, 1, 0), (B, I, n, 5, 1, 0), (B, I, n, 3, 1, 0),
                                      (B, I, n, 1, 7, 0), (B, I, n, 1, 9, 0), (B, I, n, 1, 1, 3)):
        assert fn(*ptrs, B_, D, D, half, n_, gs, ds, act, dev, stream) != 0
    for i, off in ((1, 4), (2, 8), (3, 8), (6, 8), (8, 8), (10, 8), (11, 8), (12, 8), (13, 8),
                   (14, 8), (15, 2)):
        bad = list(ptrs)  # perm, codes, scales, scratch, out, counters misaligned
        bad[i] += off
        assert fn(*bad, B, D, D, I, n, 4, 8, 0, dev, stream) != 0, i
    for i in (0, 1, 2, 8, 9, 10, 11, 12, 13, 14, 15):  # a missing operand or scratch
        bad = list(ptrs)
        bad[i] = 0
        assert fn(*bad, B, D, D, I, n, 4, 8, 0, dev, stream) != 0, i
    torch.cuda.synchronize()


# K2's decode rows (csrc/ternary_mlp_dec.cu): llama-3-8b's and gemma-2b's
# MLPs at rows 1 / 2 / 4 / 8, with the gather ("ssr") and without ("down"),
# silu, gelu and relu
K2_DEC_ROWS = [1, 2, 4, 8]


def _k2_dec_counts():
    return (tk.ternary_mlp.launches, tk.ternary_mlp.launches_dec, tk.ternary_mlp.launches_tc,
            tk.ternary_mlp.launches_gelu, tk.ternary_matmul.launches,
            tk.ternary_matmul.launches_dec)


def _k2_dec_held(x, perm, layer, I, act="silu"):
    """One K2 call that must take the decode path: counted in launches and
    launches_dec (and launches_gelu for gelu), not in K1's counts (its down
    launch is K2's); held to MLP_TOL against ternary_mlp_plain and
    ternary_mlp_dec_plain, and the same bits on a second call."""
    assert tk.k2_path(x.shape[0]) == "dec"
    before = _k2_dec_counts()
    got = tk.ternary_mlp(x, perm, *layer, intermediate=I, act=act)
    again = tk.ternary_mlp(x, perm, *layer, intermediate=I, act=act)
    torch.cuda.synchronize()
    assert tuple(b - a for a, b in zip(before, _k2_dec_counts())) == (
        2, 2, 0, 2 * (act == "gelu"), 0, 0)
    assert torch.equal(got, again)
    want = tk.ternary_mlp_plain(x, perm, *layer, intermediate=I, act=act)
    algo = tk.ternary_mlp_dec_plain(x, perm, *layer, intermediate=I, act=act,
                                    wave=tk.dec_wave(x.device))
    assert got.shape == want.shape == (x.shape[0], layer[3].shape[1])
    assert _rel(got, want) <= MLP_TOL and _rel(got, algo) <= MLP_TOL
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
@pytest.mark.parametrize("gather", [True, False], ids=["ssr", "down"])
@pytest.mark.parametrize("rows", K2_DEC_ROWS)
@pytest.mark.parametrize("shape", sorted(K2_TC_SHAPES))
def test_k2_dec_path_matches_plain(cuda_device, shape, rows, gather, act):
    D, I, n = K2_TC_SHAPES[shape]
    g = torch.Generator(device=cuda_device).manual_seed(200 + rows + I + int(gather))
    layer = _mlp_layer(g, cuda_device, D, I, n)
    perm = _perm(g, cuda_device, D, D) if gather else None
    x = torch.randn((rows, D), generator=g, device=cuda_device).bfloat16()
    _k2_dec_held(x, perm, layer, I, act)


@pytest.mark.cuda
@pytest.mark.parametrize("gather", [True, False], ids=["ssr", "down"])
def test_k2_dec_path_on_stacked_views_zero_pads_and_slices(cuda_device, gather):
    """A 3-layer stack at a width whose products are cut into uneven K
    slices (on the H100 down's 11 blocks in slices of 4, 4, 3; gateup
    without a gather 16 blocks in 4); pad lanes (the perm's, interleaved,
    or x zero-padded to 2048 lanes), all-zero alpha blocks and an all-zero
    row."""
    g = torch.Generator(device=cuda_device).manual_seed(171 + int(gather))
    m, I, n, L = 500, 1408, 512, 3
    Kg = 512 if gather else 2048
    layers = _mlp_layer(g, cuda_device, Kg, I, n, L=L)
    perms = torch.stack([_perm(g, cuda_device, m, Kg, interleave=True) for _ in range(L)])
    x = torch.randn((8, m), generator=g, device=cuda_device).bfloat16()
    x[1] = 0
    for li in range(L):
        got = _k2_dec_held(x, perms[li] if gather else None, [t[li] for t in layers], I)
        assert got[1].abs().max().item() == 0.0  # the all-zero row
    layer = [t[0].clone() for t in layers]
    layer[1][::3] = 0
    layer[4][::2] = 0
    _k2_dec_held(x[:3], perms[0] if gather else None, layer, I, "gelu")


@pytest.mark.cuda
def test_k2_dec_refuses_graph_capture(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(191)
    D, I, n = 512, 1024, 256
    layer = _mlp_layer(g, cuda_device, D, I, n)
    x = torch.randn((4, D), generator=g, device=cuda_device).bfloat16()
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tk.ternary_mlp(x, None, *layer, intermediate=I)  # built outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = _k2_dec_counts()
    with pytest.raises(NotImplementedError, match="K2's decode path.*graph"):
        with torch.cuda.graph(graph):
            tk.ternary_mlp(x, None, *layer, intermediate=I)
    assert _k2_dec_counts() == before


@pytest.mark.cuda
def test_k2_dec_launch_failure_raises_without_fallback(cuda_device, monkeypatch):
    """A launch of the decode path that fails raises; neither the CUDA-core
    K2 nor a plain version runs in its place, and nothing is counted."""
    class Refusing:
        @staticmethod
        def pt2_ternary_mlp_dec(*args):
            return 1  # cudaErrorInvalidValue

    def not_asked():
        raise AssertionError("the CUDA-core K2 was asked for")

    g = torch.Generator(device=cuda_device).manual_seed(192)
    D, I, n = 512, 1024, 256
    layer = _mlp_layer(g, cuda_device, D, I, n)
    perm = _perm(g, cuda_device, D, D)
    monkeypatch.setattr(tk, "_mlp_dec_kernel_lib", lambda: Refusing)
    monkeypatch.setattr(tk, "_mlp_kernel_lib", not_asked)
    for rows in (1, 8):
        for p in (perm, None):
            x = torch.randn((rows, D), generator=g, device=cuda_device).bfloat16()
            before = _k2_dec_counts()
            with pytest.raises(RuntimeError, match="K2 \\(decode rows, tensor cores\\)"):
                tk.ternary_mlp(x, p, *layer, intermediate=I)
            assert _k2_dec_counts() == before


@pytest.mark.cuda
def test_k2_dec_refuses_scales_not_16_byte_aligned(cuda_device, monkeypatch):
    """Gateup's alpha 8 bytes off a 16-byte boundary: the CUDA-core K2 takes
    it, the decode path (16-byte vector loads) refuses it before a launch."""
    g = torch.Generator(device=cuda_device).manual_seed(194)
    D, I, n = 512, 1024, 256
    gp, ga, gm, dp, da, dm = _mlp_layer(g, cuda_device, D, I, n)
    shifted = torch.empty(ga.numel() + 4, dtype=ga.dtype, device=cuda_device)[4:].view(ga.shape)
    shifted.copy_(ga)
    assert shifted.data_ptr() % 16 == 8
    x = torch.randn((4, D), generator=g, device=cuda_device).bfloat16()
    before = _k2_dec_counts()
    with pytest.raises(ValueError, match="gu_alpha.*'dec'"):
        tk.ternary_mlp(x, None, gp, shifted, gm, dp, da, dm, intermediate=I)
    assert _k2_dec_counts() == before
    monkeypatch.setattr(tk, "K2_DEC_MAX_ROWS", 0)
    got = tk.ternary_mlp(x, None, gp, shifted, gm, dp, da, dm, intermediate=I)
    assert _rel(got, tk.ternary_mlp_plain(x, None, gp, ga, gm, dp, da, dm, intermediate=I)) <= MLP_TOL


@pytest.mark.cuda
def test_k2_dec_c_entry_refuses_what_it_does_not_take(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(193)
    D, I, n, B = 512, 1024, 256, 8
    gp, ga, gm, dp, da, dm = _mlp_layer(g, cuda_device, D, I, n)
    perm = _perm(g, cuda_device, D, D)
    x = torch.randn((B, D), generator=g, device=cuda_device).bfloat16()
    f32 = dict(device=cuda_device)
    gpart = torch.empty((4, B, 2 * I), **f32)
    dpart = torch.empty((8, B, n), **f32)
    mid = torch.empty((B, I), **f32).bfloat16()
    out = torch.empty((B, n), **f32)
    counters = torch.zeros(1024, dtype=torch.int32, device=cuda_device)
    fn = tk._mlp_dec_kernel_lib().pt2_ternary_mlp_dec
    stream = torch.cuda.current_stream().cuda_stream
    dev = cuda_device.index or 0
    ptrs = [t.data_ptr() for t in (x, perm, gp, ga, gm, dp, da, dm, gpart, dpart, mid, out,
                                   counters)]
    want = tk.ternary_mlp_plain(x, perm, gp, ga, gm, dp, da, dm, I)
    # 4 gateup blocks and 8 down blocks: one slice each, one block a slice,
    # slices of 2 + 2 and of 3 + 3 + 2
    for gs, ds in ((1, 1), (4, 8), (2, 3)):
        assert fn(*ptrs, B, D, D, I, n, gs, ds, 0, dev, stream) == 0
        torch.cuda.synchronize()
        assert _rel(out, want) <= MLP_TOL
    assert not counters.any()
    # rows outside 1-8, half or n not multiples of 128, no slice, more slices
    # than blocks, a slice left empty (3 of 4 blocks, 7 of 8: 2 each leaves
    # the last empty), an unknown activation
    for B_, half, n_, gs, ds, act in ((0, I, n, 1, 1, 0), (9, I, n, 1, 1, 0),
                                      (B, 960, n, 1, 1, 0), (B, I, 224, 1, 1, 0),
                                      (B, I, n, 0, 1, 0), (B, I, n, 5, 1, 0), (B, I, n, 3, 1, 0),
                                      (B, I, n, 1, 7, 0), (B, I, n, 1, 9, 0), (B, I, n, 1, 1, 3)):
        assert fn(*ptrs, B_, D, D, half, n_, gs, ds, act, dev, stream) != 0
    for i, off in ((0, 1), (1, 4), (2, 8), (3, 8), (6, 8), (8, 8), (9, 8), (10, 8), (11, 8),
                   (12, 2)):
        bad = list(ptrs)  # x, perm, codes, scales, scratch, out, counters misaligned
        bad[i] += off
        assert fn(*bad, B, D, D, I, n, 4, 8, 0, dev, stream) != 0, i
    for i in range(13):  # a missing operand, scratch or out
        bad = list(ptrs)
        bad[i] = 0
        assert fn(*bad, B, D, D, I, n, 4, 8, 0, dev, stream) != 0, i
    torch.cuda.synchronize()
    assert not counters.any()


@pytest.mark.cuda
def test_k2_k3_k4_on_stacked_views(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(5)
    D, I, n, L = 512, 1024, 256, 3
    gp, ga, gm, dp, da, dm = _mlp_layer(g, cuda_device, D, I, n, L=L)
    perms = torch.stack([_perm(g, cuda_device, D, D) for _ in range(L)])
    x = torch.randn((4, D), generator=g, device=cuda_device).bfloat16()
    for li in range(L):
        got = tk.ternary_mlp(x, perms[li], gp[li], ga[li], gm[li], dp[li], da[li], dm[li], I)
        want = tk.ternary_mlp_plain(x, perms[li], gp[li], ga[li], gm[li], dp[li], da[li], dm[li], I)
        assert _rel(got, want) <= MLP_TOL
        got = tk.ternary_matmul_igathered(x, perms[li], gp[li], ga[li], gm[li])
        want = tk.ternary_matmul_igathered_plain(x, perms[li], gp[li], ga[li], gm[li])
        assert _rel(got, want) <= TOL
        assert torch.equal(tkg.onehot_gather(x, perms[li]), tkg.onehot_gather_plain(x, perms[li]))


@pytest.mark.cuda
def test_new_wrappers_reject_what_their_kernels_do_not_take(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(6)
    x = torch.randn((4, 256), generator=g, device=cuda_device).bfloat16()
    perm = _perm(g, cuda_device, 256, 256)
    with pytest.raises(TypeError):  # K4: int64 perm, f16 x
        tkg.onehot_gather(x, perm.long())
    with pytest.raises(TypeError):
        tkg.onehot_gather(x.half(), perm)
    with pytest.raises(ValueError):  # K4: 3-D x
        tkg.onehot_gather(x[None], perm)
    packed, alpha, mu = _layer(g, cuda_device, 256, 128, 128)
    with pytest.raises(ValueError):  # K3: perm of the wrong length
        tk.ternary_matmul_igathered(x, perm[:128], packed, alpha, mu)
    with pytest.raises(TypeError):  # K3: f32 scales
        tk.ternary_matmul_igathered(x, perm, packed, alpha.float(), mu.float())
    gp, ga, gm, dp, da, dm = _mlp_layer(g, cuda_device, 256, 512, 256)
    with pytest.raises(ValueError):  # K2: more than 64 rows
        tk.ternary_mlp(torch.zeros((65, 256), device=cuda_device).bfloat16(), perm,
                       gp, ga, gm, dp, da, dm, 512)
    with pytest.raises(ValueError):  # K2: blocks of 64
        tk.ternary_mlp(x, perm, gp, ga, gm, dp, da, dm, 512, block_size=64)
    with pytest.raises(TypeError):  # K2: f32 scales
        tk.ternary_mlp(x, perm, gp, ga.float(), gm, dp, da, dm, 512)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["ssr", "down"])
def test_ssr_model_routes_through_k2_k3_k4(cuda_device, layout):
    """A 256-wide model whose gateup needs no pad blocks (I = 1024 is 8
    blocks): prefill through K4 + K1, decode through K3 + K2 ("ssr"),
    against the plain route. In the "down" layout decode stays on K1: the
    identity gateup has 2048 lanes (16 blocks, make_packed_linear's pad) for
    a 256-wide x, which fused_mlp_ok rejects, as the JAX predicate does."""
    cfg = get_config("tiny-llama").with_(dim=256, intermediate=1024)
    params = random_ternary_params(cfg, seed=4, perm_mode=layout, device=cuda_device)
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda_device)
    counts = lambda: (tk.ternary_matmul.launches, tk.ternary_matmul_igathered.launches,  # noqa: E731
                      tk.ternary_mlp.launches, tkg.onehot_gather.launches)
    c0 = counts()
    with torch.inference_mode():
        auto = tdec.forward(cfg, params, tokens, impl="auto").float()  # 80 rows: prefill route
        plain = tdec.forward(cfg, params, tokens, impl="plain").float()
    c1 = counts()
    gathers = 3 if layout == "ssr" else 0
    assert [b - a for a, b in zip(c0, c1)] == [4 * cfg.n_layers, 0, 0, gathers * cfg.n_layers]
    assert ((auto - plain).norm() / plain.norm()).item() <= 1e-2
    greedy_generate(cfg, params, tokens, 3)  # an 80-row prefill, then 2 decode steps
    c2 = counts()
    L = cfg.n_layers
    if layout == "ssr":  # prefill K4 x3 + K1 x4; each step K3 x2 (qkv, o) + K2
        want = [4 * L, 2 * 2 * L, 2 * L, 3 * L]
    else:  # prefill K1 x4; each step K1 x4
        want = [4 * L + 2 * 4 * L, 0, 0, 0]
    assert [b - a for a, b in zip(c1, c2)] == want


def _attn_inputs(g, dev, B, M, H, Hkv, hd, quant):
    """q, k, v, ragged kv_valid (every row keeps at least one slot) and, for
    int8, the cache quantised as the KV cache quantises it."""
    q = torch.randn((B, 1, H, hd), generator=g, device=dev).bfloat16()
    k = torch.randn((B, M, Hkv, hd), generator=g, device=dev)
    v = torch.randn((B, M, Hkv, hd), generator=g, device=dev)
    lens = torch.randint(1, M + 1, (B,), generator=g, device=dev)
    valid = torch.arange(M, device=dev)[None, :] < lens[:, None]
    if not quant:
        return q, k.bfloat16(), v.bfloat16(), valid, None, None
    (k8, ks), (v8, vs) = quantize_i8(k), quantize_i8(v)
    return q, k8, v8, valid, ks, vs


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("B,M,H,Hkv,hd", [
    (1, 256, 32, 8, 128), (4, 2048, 32, 8, 128), (8, 2048, 32, 32, 128), (3, 384, 8, 1, 128),
    (2, 200, 16, 1, 128), (2, 640, 8, 4, 256), (5, 1000, 12, 4, 128),
    (1, 256, 8, 1, 256), (8, 2048, 8, 1, 256),  # gemma-2b's heads: 8 / 1 KV, hd 256
])
def test_decode_attention_kernel_matches_plain(cuda_device, B, M, H, Hkv, hd, quant):
    g = torch.Generator(device=cuda_device).manual_seed(B * M + H)
    q, k, v, valid, ks, vs = _attn_inputs(g, cuda_device, B, M, H, Hkv, hd, quant)
    before = tka.decode_attention.launches
    got = tka.decode_attention(q, k, v, valid, 0.0883883, ks, vs)
    torch.cuda.synchronize()
    assert tka.decode_attention.launches == before + 1
    want = tka.decode_attention_plain(q, k, v, valid, 0.0883883, ks, vs)
    assert got.shape == want.shape == (B, 1, H, hd) and got.dtype == torch.bfloat16
    assert _rel(got.float(), want.float()) <= ATTN_TOL


@pytest.mark.cuda
def test_decode_attention_all_invalid_row_is_zero(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(8)
    q, k, v, valid, _, _ = _attn_inputs(g, cuda_device, 2, 256, 8, 2, 128, False)
    valid[1] = False
    got = tka.decode_attention(q, k, v, valid, 0.1)
    assert got[1].abs().max().item() == 0.0 and torch.isfinite(got).all()


@pytest.mark.cuda
def test_decode_attention_wrapper_rejects(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(9)
    q, k, v, valid, _, _ = _attn_inputs(g, cuda_device, 2, 256, 8, 2, 128, False)
    with pytest.raises(TypeError):  # f32 q
        tka.decode_attention(q.float(), k, v, valid, 0.1)
    with pytest.raises(ValueError):  # hd 64
        tka.decode_attention(q[..., :64].contiguous(), k[..., :64].contiguous(),
                             v[..., :64].contiguous(), valid, 0.1)
    with pytest.raises(ValueError):  # one scale only
        tka.decode_attention(q, k.to(torch.int8), v.to(torch.int8), valid, 0.1,
                             torch.ones((2, 256, 2, 1), device=cuda_device), None)
    with pytest.raises(ValueError):  # a non-contiguous cache
        tka.decode_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2), v, valid, 0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_engine_decode_routes_through_k7(cuda_device, kv_quant, monkeypatch):
    """A 128-wide-head model on an engine of 128 positions (K7's shapes):
    every decode step launches K7 once per layer, and every call agrees with
    its plain version on the engine's own activations."""
    cfg = get_config("tiny-llama").with_(dim=256, n_heads=2, n_kv_heads=1, intermediate=1024)
    params = random_ternary_params(cfg, seed=6, perm_mode="down", device=cuda_device)
    kernel = tka.decode_attention
    calls = []

    def held(*args, **kw):
        got, want = kernel(*args, **kw), tka.decode_attention_plain(*args, **kw)
        calls.append(_rel(got.float(), want.float()))
        return got

    monkeypatch.setattr(tcommon, "decode_attention", held)
    eng = ServeEngine(cfg, params, max_batch=3, max_len=128, kv_quant=kv_quant, decode_quantum=4)
    reqs = [eng.submit(torch.randint(0, cfg.vocab_size, (n,)).numpy(), 9) for n in (5, 40, 17, 3)]
    before = kernel.launches
    eng.run()
    assert all(r.done and len(r.out) == 9 for r in reqs)
    assert kernel.launches - before == cfg.n_layers * eng.stats["steps"] == len(calls)
    assert max(calls) <= ATTN_TOL
    monkeypatch.setattr(tcommon, "DECODE_ATTN_KERNEL", False)
    monkeypatch.setattr(tcommon, "INT8_DECODE_ATTN_KERNEL", False)
    before = kernel.launches
    plain = ServeEngine(cfg, params, max_batch=3, max_len=128, kv_quant=kv_quant)
    plain.submit(reqs[0].prompt, 9)
    plain.run()
    assert kernel.launches == before  # the flags off: the plain route


@pytest.mark.cuda
def test_attention_routes_only_head_widths_k7_takes(cuda_device):
    """``supported`` (the TPU kernel's predicate) admits any hd % 128 == 0
    and the route sends all of them to K7: the compile-time widths (128,
    256, 384, 512) and the wide instance's (640) launch it, each held to
    the plain version."""
    g = torch.Generator(device=cuda_device).manual_seed(10)
    for hd in (128, 256, 384, 512, 640):
        q, k, v, valid, _, _ = _attn_inputs(g, cuda_device, 2, 256, 8, 2, hd, False)
        assert tka.supported(256, hd, False)
        before = tka.decode_attention.launches
        out = tcommon.attention(q, k, v, None, valid, scale=hd ** -0.5)
        assert tka.decode_attention.launches - before == 1
        want = tka.decode_attention_plain(q, k, v, valid, hd ** -0.5)
        assert _rel(out.float(), want.float()) <= ATTN_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_gemma_engine_routes_through_k2_gelu_and_k7_hd256(cuda_device, kv_quant, monkeypatch):
    """gemma-2b's width and heads (dim 2048, 8 / 1 KV heads, hd 256), two
    layers, I cut to 1024, "down" layout, on an engine of 256 positions:
    every admission (<= 64 rows) and decode step runs the MLP through K2
    in its GeGLU mode and every decode step K7 at hd 256, each call held
    against its plain version on the engine's own activations."""
    cfg = get_config("gemma-2b").with_(n_layers=2, intermediate=1024, vocab_size=1024)
    params = random_ternary_params(cfg, seed=8, perm_mode="down", device=cuda_device)
    calls = {"mlp": [], "attn": []}
    mlp, attn = tk.ternary_mlp, tka.decode_attention

    def held_mlp(*args, **kw):
        assert kw["act"] == "gelu"
        got, want = mlp(*args, **kw), tk.ternary_mlp_plain(*args, **kw)
        calls["mlp"].append(_rel(got, want))
        return got

    def held_attn(*args, **kw):
        got, want = attn(*args, **kw), tka.decode_attention_plain(*args, **kw)
        calls["attn"].append(_rel(got.float(), want.float()))
        return got

    monkeypatch.setattr(ttm, "ternary_mlp", held_mlp)
    monkeypatch.setattr(tcommon, "decode_attention", held_attn)
    eng = ServeEngine(cfg, params, max_batch=3, max_len=256, kv_quant=kv_quant)
    lens = (5, 40, 17, 3)
    reqs = [eng.submit(torch.randint(0, cfg.vocab_size, (n,)).numpy(), 6) for n in lens]
    before = mlp.launches, attn.launches
    eng.run()
    assert all(r.done and len(r.out) == 6 for r in reqs)
    L, st = cfg.n_layers, eng.stats["steps"]
    assert (mlp.launches - before[0], attn.launches - before[1]) == (L * (st + len(lens)), L * st)
    assert len(calls["mlp"]) == L * (st + len(lens)) and len(calls["attn"]) == L * st
    assert max(calls["mlp"]) <= MLP_TOL and max(calls["attn"]) <= ATTN_TOL


# ---- K7 on its tensor-core kernel (csrc/decode_attention_tc.cu), the
# default route, and PR 3's CUDA-core kernel behind K7_TC
K7_MASKS = ["ragged", "prefix", "holes", "last_only", "empty_row"]
# every registry head layout K7 serves: llama-2-7b, llama-2-13b, llama-3-8b, gemma-2b
K7_HEADS = [(32, 32, 128), (40, 40, 128), (32, 8, 128), (8, 1, 256)]


def _attn_masked(g, dev, B, M, H, Hkv, hd, quant, mask):
    q, k, v, _, ks, vs = _attn_inputs(g, dev, B, M, H, Hkv, hd, quant)
    pos = torch.arange(M, device=dev)[None, :]
    if mask == "ragged":
        valid = pos < torch.randint(1, M + 1, (B, 1), generator=g, device=dev)
    elif mask == "prefix":
        valid = pos <= (M // 3 + 7 * torch.arange(B, device=dev))[:, None]
    elif mask == "holes":
        valid = (torch.rand((B, M), generator=g, device=dev) < 0.4) & (
            pos < torch.randint(M // 2, M + 1, (B, 1), generator=g, device=dev))
    elif mask == "last_only":
        valid = (pos == M - 1).expand(B, M).contiguous()
    else:  # "empty_row": row 0 has no valid slot
        valid = pos < torch.randint(1, M + 1, (B, 1), generator=g, device=dev)
        valid[0] = False
    return q, k, v, valid, ks, vs


def _within_a_bf16_step(got, want, frac=1e-3):
    """max over elements of (|got - want| less one bf16 step of the larger
    of the two), as a fraction of max|want|: outputs that round the same
    f32 sum to neighbouring bf16 values differ by one step (up to 2^-7 of
    the value), which no f32 summation order avoids."""
    got, want = got.float(), want.float()
    step = torch.maximum(got.abs(), want.abs()) * 2.0 ** -7
    return ((got - want).abs() - step).max().item() / want.abs().max().item()


@pytest.mark.cuda
def test_k7_quantize_query_same_bits_on_the_card(cuda_device):
    """K7's int8 query prep gives the CPU's (and JAX's) bytes on the card:
    q_scale is max|q| / 127 correctly rounded, not a product with 1 / 127
    (which PyTorch uses for a scalar divisor on CUDA, an ulp off for some
    heads, with a code off by one where a quotient sits at a half)."""
    g = torch.Generator(device=cuda_device).manual_seed(21)
    q = torch.randn((64, 1, 40, 128), generator=g, device=cuda_device).bfloat16()
    q8, qs = tka.quantize_query(q)
    q8c, qsc = tka.quantize_query(q.cpu())
    assert torch.equal(qs.cpu(), qsc) and torch.equal(q8.cpu(), q8c)
    naive = (q[:, 0].float().abs().amax(dim=-1) / 127.0).clamp_min(1e-20)
    assert not torch.equal(naive.cpu(), qsc)  # what the scalar division gives on the card


def reciprocal_witnesses(seed=127, rows=48, hd=128):
    """(rows, hd) f32 vectors, found with numpy from ``seed``: each one's
    absmax a gives fl(a / 127) != fl(a * fl(1 / 127)) (the product with the
    rounded reciprocal, which PyTorch's CUDA division by the Python scalar
    127 computes), and one element v sits at a half of the correct scale, so
    its int8 code rounds to even there and to the neighbour under the other
    scale."""
    rng = np.random.default_rng(seed)
    inv = np.float32(1) / np.float32(127)
    out = []
    while len(out) < rows:
        a = np.float32(rng.random() * 8 + 0.01)
        s, s_rcp = a / np.float32(127), a * inv
        if s == s_rcp:
            continue
        for k in rng.permutation(np.arange(1, 126)):
            v = np.float32((k + 0.5) * float(s))
            if np.round(v / s) != np.round(v / s_rcp):
                break
        else:
            continue
        x = (rng.uniform(-0.5, 0.5, hd) * a).astype(np.float32)
        i, j = rng.choice(hd, 2, replace=False)
        x[i], x[j] = a * rng.choice([-1, 1]), v * rng.choice([-1, 1])
        out.append(x)
    return np.stack(out)


@pytest.mark.cuda
def test_quotient_f32_same_bits_on_the_card(cuda_device):
    """quotient_f32 gives the CPU's (and JAX's: the CPU's are held to them in
    tests/test_torch_kvcache.py) f32 quotient on the card at absmax values
    where the product with 1 / 127 is an ulp off, which PyTorch's division
    by the scalar 127 gives there; a CUDA graph captures it with nothing
    warmed and replays the same bits."""
    a = torch.from_numpy(reciprocal_witnesses()).abs().amax(dim=-1, keepdim=True)
    want = a / 127.0
    ad = a.to(cuda_device)
    assert torch.equal(quotient_f32(ad, 127.0).cpu(), want)
    assert not torch.equal((ad / 127.0).cpu(), want)  # the scalar division on the card
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = quotient_f32(ad, 127.0)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured.cpu(), want)


@pytest.mark.cuda
def test_quantize_i8_bytes_equal_jax_on_the_card(cuda_device):
    """The card twin of tests/test_torch_kvcache.py's
    test_quantize_i8_bytes_equal_jax_where_the_reciprocal_is_an_ulp_off: at
    absmax values where the product with 1 / 127 is an ulp off, the int8 KV
    cache's codes and scales on the card are JAX's CPU bytes (``_quantize_i8``:
    scale = max|x| / 127 correctly rounded, floored at 1e-8, codes rounded
    half to even and clipped, here in numpy, which computes the same f32
    operations), and the port's CPU bytes (held to JAX's in that test)."""
    x = reciprocal_witnesses()
    scale = np.maximum(np.abs(x).max(axis=-1, keepdims=True) / np.float32(127), np.float32(1e-8))
    codes = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    q, s = quantize_i8(torch.from_numpy(x).to(cuda_device))
    assert s.dtype == torch.float32 and q.dtype == torch.int8
    np.testing.assert_array_equal(s.cpu().numpy(), scale)
    np.testing.assert_array_equal(q.cpu().numpy(), codes)
    qc, sc = quantize_i8(torch.from_numpy(x))
    assert torch.equal(q.cpu(), qc) and torch.equal(s.cpu(), sc)
    rcp = np.abs(x).max(axis=-1, keepdims=True) * (np.float32(1) / np.float32(127))
    assert (np.clip(np.round(x / rcp), -127, 127) != codes).any(axis=-1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("mask", K7_MASKS)
@pytest.mark.parametrize("H,Hkv,hd", K7_HEADS)
def test_k7_tc_matches_split_plain_and_plain(cuda_device, H, Hkv, hd, mask, quant):
    """The kernel follows its schedule: within one bf16 step of each value
    plus 1e-3 of max|ref| of decode_attention_split_plain on the same plan,
    and within K7's 1e-2 of decode_attention_plain; a row with no valid slot
    gives 0."""
    B, M = 3, 2048
    g = torch.Generator(device=cuda_device).manual_seed(H + hd + B)
    q, k, v, valid, ks, vs = _attn_masked(g, cuda_device, B, M, H, Hkv, hd, quant, mask)
    plan = tka.k7_plan(B, M, Hkv, H // Hkv, hd, quant)
    before = tka.decode_attention.launches, tka.decode_attention.launches_tc
    got = tka.decode_attention(q, k, v, valid, hd ** -0.5, ks, vs)
    torch.cuda.synchronize()
    assert (tka.decode_attention.launches, tka.decode_attention.launches_tc) == (
        before[0] + 1, before[1] + 1)
    split = tka.decode_attention_split_plain(q, k, v, valid, hd ** -0.5, ks, vs, tile=plan.tile,
                                             splits=plan.splits)
    plain = tka.decode_attention_plain(q, k, v, valid, hd ** -0.5, ks, vs)
    assert got.shape == (B, 1, H, hd) and got.dtype == torch.bfloat16
    assert torch.isfinite(got).all()
    assert _within_a_bf16_step(got, split) <= 1e-3
    assert _rel(got.float(), plain.float()) <= ATTN_TOL
    if mask == "empty_row":
        assert got[0].abs().max().item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("H,Hkv,hd", [(32, 8, 128), (8, 1, 256)])
def test_k7_tc_same_bits_run_to_run_and_from_a_cuda_graph(cuda_device, H, Hkv, hd, quant):
    """No atomics in the sums and nothing read back on the host: two runs
    give the same bits, and a captured call replays them, also after the
    lengths change in place (the plan depends on the shapes only)."""
    B, M = 8, 2048
    g = torch.Generator(device=cuda_device).manual_seed(31 + hd)
    q, k, v, valid, ks, vs = _attn_masked(g, cuda_device, B, M, H, Hkv, hd, quant, "ragged")
    one = tka.decode_attention(q, k, v, valid, 0.09, ks, vs)
    two = tka.decode_attention(q, k, v, valid, 0.09, ks, vs)
    assert torch.equal(one, two)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tka.decode_attention(q, k, v, valid, 0.09, ks, vs)  # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = tka.decode_attention.launches_tc
    with torch.cuda.graph(graph):
        captured = tka.decode_attention(q, k, v, valid, 0.09, ks, vs)
    assert tka.decode_attention.launches_tc == before + 1  # the capture's one launch
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, one)
    valid.copy_(torch.arange(M, device=cuda_device)[None, :] < torch.randint(
        1, M + 1, (B, 1), generator=g, device=cuda_device))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, tka.decode_attention(q, k, v, valid, 0.09, ks, vs))


@pytest.mark.cuda
def test_k7_tc_counts_and_the_flag(cuda_device, monkeypatch):
    """launches_tc counts the tensor-core kernel's launches exactly;
    K7_TC off sends the calls to PR 3's kernel (launches, not launches_tc);
    launches_hd256 counts either kernel at hd 256."""
    g = torch.Generator(device=cuda_device).manual_seed(12)
    a128 = _attn_inputs(g, cuda_device, 2, 256, 8, 2, 128, False)
    a256 = _attn_inputs(g, cuda_device, 2, 256, 8, 1, 256, True)
    d = tka.decode_attention
    c0 = (d.launches, d.launches_tc, d.launches_hd256)
    for _ in range(3):
        tka.decode_attention(*a128[:4], 0.1)
    tka.decode_attention(*a256[:4], 0.0625, *a256[4:])
    assert (d.launches, d.launches_tc, d.launches_hd256) == (c0[0] + 4, c0[1] + 4, c0[2] + 1)
    monkeypatch.setattr(tka, "K7_TC", False)
    tka.decode_attention(*a128[:4], 0.1)
    tka.decode_attention(*a256[:4], 0.0625, *a256[4:])
    assert (d.launches, d.launches_tc, d.launches_hd256) == (c0[0] + 6, c0[1] + 4, c0[2] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("B,M,H,Hkv,hd", [(4, 2048, 32, 8, 128), (3, 384, 8, 1, 128),
                                          (8, 2048, 8, 1, 256), (2, 200, 16, 1, 128)])
def test_k7_cuda_core_kernel_behind_the_flag(cuda_device, monkeypatch, B, M, H, Hkv, hd, quant):
    """PR 3's kernel, kept for the A/Bs' off turns, still agrees with the
    plain version at K7's tolerance."""
    monkeypatch.setattr(tka, "K7_TC", False)
    g = torch.Generator(device=cuda_device).manual_seed(B * M + hd)
    q, k, v, valid, ks, vs = _attn_inputs(g, cuda_device, B, M, H, Hkv, hd, quant)
    before = tka.decode_attention.launches_tc
    got = tka.decode_attention(q, k, v, valid, 0.0883883, ks, vs)
    assert tka.decode_attention.launches_tc == before
    want = tka.decode_attention_plain(q, k, v, valid, 0.0883883, ks, vs)
    assert _rel(got.float(), want.float()) <= ATTN_TOL


# ---- K7 on the windowed kv_valid of sliding-window layers (gemma2/3):
# slots (p - W, p] of each row, not a prefix. (H, Hkv, hd) with 1 / 2 / 4 / 8
# queries per KV head at hd 128 and 256 (gemma3-4b: 8 / 4 / 256; qwen3-8b:
# 32 / 8 / 128)
K7_WINDOW_HEADS = [(8, 8, 128), (8, 4, 128), (32, 8, 128), (64, 8, 128), (4, 4, 256),
                   (8, 4, 256), (16, 4, 256), (8, 1, 256)]
# (W, last position of each of 3 rows): gemma3's window of 1024 starting off
# a tile; a short window at the end (leading tiles, and whole splits of
# the schedule, empty); a window of one slot
K7_WINDOWS = {"w1024": (1024, (1100, 1337, 2047)), "late": (100, (2047, 1999, 1500)),
              "one_slot": (1, (5, 1030, 2047))}


def _attn_windowed(g, dev, H, Hkv, hd, quant, window):
    B, M = 3, 2048
    q, k, v, _, ks, vs = _attn_inputs(g, dev, B, M, H, Hkv, hd, quant)
    W, last = K7_WINDOWS[window]
    p = torch.tensor(last, device=dev)[:, None]
    pos = torch.arange(M, device=dev)[None, :]
    return q, k, v, ((pos <= p) & (pos > p - W)).contiguous(), ks, vs


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("window", list(K7_WINDOWS))
@pytest.mark.parametrize("H,Hkv,hd", K7_WINDOW_HEADS)
def test_k7_tc_on_windowed_kv_valid(cuda_device, H, Hkv, hd, window, quant):
    """The tensor-core kernel on windows: tiles and splits before the window
    add nothing (the split plain version on the kernel's plan, within one
    bf16 step plus 1e-3) and the combine divides by the valid mass (the
    plain version, K7's 1e-2); the same bits twice."""
    g = torch.Generator(device=cuda_device).manual_seed(H * hd + len(window))
    q, k, v, valid, ks, vs = _attn_windowed(g, cuda_device, H, Hkv, hd, quant, window)
    B, M = valid.shape
    plan = tka.k7_plan(B, M, Hkv, H // Hkv, hd, quant)
    before = tka.decode_attention.launches_tc
    got = tka.decode_attention(q, k, v, valid, hd ** -0.5, ks, vs)
    again = tka.decode_attention(q, k, v, valid, hd ** -0.5, ks, vs)
    torch.cuda.synchronize()
    assert tka.decode_attention.launches_tc == before + 2
    assert torch.equal(got, again)
    split = tka.decode_attention_split_plain(q, k, v, valid, hd ** -0.5, ks, vs, tile=plan.tile,
                                             splits=plan.splits)
    plain = tka.decode_attention_plain(q, k, v, valid, hd ** -0.5, ks, vs)
    assert torch.isfinite(got).all()
    assert _within_a_bf16_step(got, split) <= 1e-3
    assert _rel(got.float(), plain.float()) <= ATTN_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("window", list(K7_WINDOWS))
@pytest.mark.parametrize("H,Hkv,hd", [(32, 8, 128), (8, 4, 256), (8, 1, 256)])
def test_k7_cuda_core_kernel_on_windowed_kv_valid(cuda_device, monkeypatch, H, Hkv, hd, window,
                                                  quant):
    """PR 3's chunk kernel (K7_TC off) on windows: chunks before the window
    add nothing and its combine divides by the valid mass."""
    monkeypatch.setattr(tka, "K7_TC", False)
    g = torch.Generator(device=cuda_device).manual_seed(H + hd + len(window))
    q, k, v, valid, ks, vs = _attn_windowed(g, cuda_device, H, Hkv, hd, quant, window)
    got = tka.decode_attention(q, k, v, valid, hd ** -0.5, ks, vs)
    want = tka.decode_attention_plain(q, k, v, valid, hd ** -0.5, ks, vs)
    assert torch.isfinite(got).all()
    assert _rel(got.float(), want.float()) <= ATTN_TOL


@pytest.mark.cuda
def test_k7_tc_build_or_launch_failure_raises(cuda_device, monkeypatch):
    """No fallback to PR 3's kernel or to the plain version: a build that
    fails and a launch the card refuses both raise, and count nothing."""
    g = torch.Generator(device=cuda_device).manual_seed(13)
    a = _attn_inputs(g, cuda_device, 2, 256, 8, 2, 128, False)
    d = tka.decode_attention
    before = (d.launches, d.launches_tc)

    def no_nvcc(name):
        raise RuntimeError(f"nvcc failed for {name}")

    monkeypatch.setattr(tka, "_tc_lib", None)
    monkeypatch.setattr(tka._build, "load", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tka.decode_attention(*a[:4], 0.1)
    monkeypatch.undo()
    real = tka.k7_plan
    monkeypatch.setattr(tka, "k7_plan", lambda *s: real(*s)._replace(splits=17))  # no such cluster
    with pytest.raises(RuntimeError, match="K7 launch failed"):
        tka.decode_attention(*a[:4], 0.1)
    assert (d.launches, d.launches_tc) == before


# ---- K5 (the packed one-hot gather) and K6 (K5 as K1's prologue)
def _planes(perm, m):
    return tgather.make_packed_gather(perm, m).packed


def _set_flags(monkeypatch, gather_kernel, igather_fused, fused_gather):
    monkeypatch.setattr(tgather, "GATHER_KERNEL", gather_kernel)
    monkeypatch.setattr(ttm, "IGATHER_FUSED", igather_fused)
    monkeypatch.setattr(ttm, "FUSED_GATHER", fused_gather)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,m,K", [(1, 4096, 4096), (5, 200, 384), (40, 640, 1024),
                                      (70, 300, 512), (512, 4096, 4096)])
def test_onehot_matmul_kernel_bit_exact(cuda_device, rows, m, K, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(rows + m + K)
    perm = _perm(g, cuda_device, m, K, interleave=m in (200, 300))
    gp = _planes(perm, m)
    x = torch.randn((rows, m), generator=g, device=cuda_device).to(dtype)
    before = tkg.onehot_matmul.launches
    got = tkg.onehot_matmul(x, gp)
    torch.cuda.synchronize()
    assert tkg.onehot_matmul.launches == before + 1
    assert got.dtype == dtype and got.shape == (rows, K)
    assert torch.equal(got, tkg.onehot_matmul_plain(x, gp))
    assert torch.equal(got, tkg.onehot_gather(x, perm))  # K5 == K4


@pytest.mark.cuda
@pytest.mark.parametrize("planes", ["few", "dense"])
def test_onehot_matmul_kernel_is_x_at_g_for_any_planes(cuda_device, planes):
    """Planes that are not a permutation are still x @ G (f32 order): "few"
    (fields of 2, up to 3 ones in a column) takes K5's list of each lane's
    fields, "dense" (half the fields set) its walk over G per row tile."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    m, D, K = 300, 384, 512
    if planes == "dense":
        codes = torch.randint(-1, 1, (K, D), generator=g, device=cuda_device, dtype=torch.int8)
    else:
        codes = torch.full((K, D), -1, device=cuda_device, dtype=torch.int8)
        for _ in range(3):
            codes[torch.arange(K, device=cuda_device),
                  torch.randint(0, D, (K,), generator=g, device=cuda_device)] = 0
    codes[::7, 5] = 1
    gp = pack_ternary(codes, 128)
    for rows in (1, 9, 70):
        x = torch.randn((rows, m), generator=g, device=cuda_device)
        got = tkg.onehot_matmul(x, gp)
        assert _rel(got, tkg.onehot_matmul_plain(x, gp)) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("B,m,K,n", [(1, 4096, 4096, 6144), (2, 4096, 4096, 4096),
                                     (4, 200, 256, 256), (8, 4096, 4096, 28672),
                                     (16, 640, 768, 384), (33, 512, 2048, 1152),
                                     (64, 300, 512, 2176)])
def test_gathered_kernel_matches_plain(cuda_device, B, m, K, n, a8):
    g = torch.Generator(device=cuda_device).manual_seed(B + m + n)
    packed, alpha, mu = _layer(g, cuda_device, K, n, 128)
    gp = _planes(_perm(g, cuda_device, m, K, interleave=m in (200, 300)), m)
    x = torch.randn((B, m), generator=g, device=cuda_device).bfloat16()
    before = tk.ternary_matmul_gathered.launches
    got = tk.ternary_matmul_gathered(x, gp, packed, alpha, mu, a8=a8)
    torch.cuda.synchronize()
    assert tk.ternary_matmul_gathered.launches == before + 1
    want = tk.ternary_matmul_gathered_plain(x, gp, packed, alpha, mu, a8=a8)
    assert got.shape == want.shape == (B, n) and _rel(got, want) <= TOL


@pytest.mark.cuda
def test_k5_k6_on_stacked_views(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(12)
    m, K, n, L = 384, 512, 256, 3
    layers = [_layer(g, cuda_device, K, n, 128) for _ in range(L)]
    packed, alpha, mu = (torch.stack([l[i] for l in layers]) for i in range(3))
    perms = [_perm(g, cuda_device, m, K, interleave=True) for _ in range(L)]
    gps = torch.stack([_planes(p, m) for p in perms])
    x = torch.randn((4, m), generator=g, device=cuda_device).bfloat16()
    for li in range(L):
        assert torch.equal(tkg.onehot_matmul(x, gps[li]), tkg.onehot_gather(x, perms[li]))
        got = tk.ternary_matmul_gathered(x, gps[li], packed[li], alpha[li], mu[li])
        want = tk.ternary_matmul_gathered_plain(x, gps[li], *layers[li])
        assert _rel(got, want) <= TOL


@pytest.mark.cuda
def test_k5_k6_wrappers_reject_what_their_kernels_do_not_take(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(13)
    perm = _perm(g, cuda_device, 256, 256)
    gp = _planes(perm, 256)
    x = torch.randn((4, 256), generator=g, device=cuda_device).bfloat16()
    with pytest.raises(TypeError):  # K5: f16 x, int32 planes
        tkg.onehot_matmul(x.half(), gp)
    with pytest.raises(TypeError):
        tkg.onehot_matmul(x, gp.int())
    with pytest.raises(ValueError):  # K5: x wider than the planes' features
        tkg.onehot_matmul(torch.zeros((4, 300), device=cuda_device).bfloat16(), gp)
    with pytest.raises(ValueError):  # K5: lanes not a multiple of 128
        tkg.onehot_matmul(x, gp[:, :96].contiguous())
    packed, alpha, mu = _layer(g, cuda_device, 256, 128, 128)
    with pytest.raises(ValueError):  # K6: more than 64 rows
        tk.ternary_matmul_gathered(torch.zeros((65, 256), device=cuda_device).bfloat16(), gp,
                                   packed, alpha, mu)
    with pytest.raises(ValueError):  # K6: planes for another lane count
        tk.ternary_matmul_gathered(x, _planes(_perm(g, cuda_device, 256, 384), 256),
                                   packed, alpha, mu)
    with pytest.raises(ValueError):  # K6: blocks of 64
        p64, a64, m64 = _layer(g, cuda_device, 256, 128, 64)
        tk.ternary_matmul_gathered(x, gp, p64, a64, m64, block_size=64)
    with pytest.raises(TypeError):  # K6: f32 scales
        tk.ternary_matmul_gathered(x, gp, packed, alpha.float(), mu.float())


@pytest.mark.cuda
@pytest.mark.parametrize("flags", ["P1", "P2"])
def test_no_fallback_when_k5_or_k6_cannot_launch(cuda_device, flags, monkeypatch):
    """A layer whose planes K5 / K6 refuse raises on the route the flags
    pick; nothing launches K4, K3 or K1 in its place, and the C entries
    refuse what their wrappers would."""
    _set_flags(monkeypatch, "packed", flags == "P1", flags == "P2")
    cfg = get_config("tiny-llama").with_(dim=256, intermediate=1024)
    params = random_ternary_params(cfg, seed=7, perm_mode="ssr", device=cuda_device)
    lin = params["layers"]["qkv"].layer(0)
    good = lin.gather.packed
    # planes over 128 features for a 256-wide x: both wrappers refuse them
    lin = dataclasses.replace(lin, gather=dataclasses.replace(lin.gather,
                                                              packed=good[:32].contiguous()))
    counts = lambda: (tk.ternary_matmul.launches, tk.ternary_matmul_igathered.launches,  # noqa: E731
                      tkg.onehot_gather.launches, tkg.onehot_matmul.launches,
                      tk.ternary_matmul_gathered.launches)
    c0 = counts()
    rows = 80 if flags == "P1" else 4  # P1: K5 at prefill rows; P2: K6 at decode rows
    with pytest.raises(ValueError):
        ttm.ternary_linear_apply(lin, torch.zeros((rows, 256), device=cuda_device).bfloat16())
    assert counts() == c0
    x = torch.zeros((4, 256), device=cuda_device).bfloat16()
    out = torch.empty((4, 2048), device=cuda_device).bfloat16()
    stream = torch.cuda.current_stream().cuda_stream
    dev = cuda_device.index or 0
    assert tkg._mm_kernel_lib().pt2_onehot_matmul(  # K = 96 lanes
        x.data_ptr(), good.data_ptr(), out.data_ptr(), 4, 256, 64, 96, 2, dev,
        stream) != 0
    assert tk._gathered_kernel_lib().pt2_ternary_matmul_gathered(  # 65 rows
        x.data_ptr(), good.data_ptr(), lin.packed.data_ptr(), lin.alpha.data_ptr(),
        lin.mu.data_ptr(), out.data_ptr(), out.data_ptr(), 65, 256, 64, 2048, 768, 0, dev,
        stream) != 0


@pytest.mark.cuda
@pytest.mark.parametrize("flags", ["P1", "P2"])
def test_ssr_model_routes_through_k5_k6(cuda_device, flags, monkeypatch):
    """The 256-wide "ssr" model of test_ssr_model_routes_through_k2_k3_k4
    under GATHER_KERNEL "packed": the 80-row prefill gathers with K5, never
    K4; decode runs K3 (P1) or K6 (P2) for qkv and o, K2 for the MLP, and
    in W2A8 K3 / K6 for gateup too with K1 for down. P1's tokens equal the
    default route's (K5 is bit-exact); every route stays within 1e-2 of
    the plain logits."""
    cfg = get_config("tiny-llama").with_(dim=256, intermediate=1024)
    params = random_ternary_params(cfg, seed=4, perm_mode="ssr", device=cuda_device)
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda_device)
    default = {impl: greedy_generate(cfg, params, tokens, 3, impl=impl) for impl in ("auto", "a8")}
    _set_flags(monkeypatch, "packed", flags == "P1", flags == "P2")
    counts = lambda: [tk.ternary_matmul.launches, tk.ternary_matmul_igathered.launches,  # noqa: E731
                      tk.ternary_matmul_gathered.launches, tk.ternary_mlp.launches,
                      tkg.onehot_gather.launches, tkg.onehot_matmul.launches]
    L = cfg.n_layers
    fused = "igathered" if flags == "P1" else "gathered"
    for impl in ("auto", "a8"):
        c0 = counts()
        toks = greedy_generate(cfg, params, tokens, 3, impl=impl)  # 80-row prefill, 2 steps
        got = dict(zip(["k1", "igathered", "gathered", "k2", "k4", "k5"],
                       [b - a for a, b in zip(c0, counts())]))
        # prefill K5 x3 + K1 x4 per layer; each step the fused gather for qkv
        # and o, then K2 ("auto") or the fused gather for gateup + K1 (W2A8)
        want = dict(k1=4 * L, igathered=0, gathered=0, k2=0, k4=0, k5=3 * L)
        want[fused] = (2 if impl == "auto" else 3) * L * 2
        want["k2" if impl == "auto" else "k1"] += L * 2
        assert got == want, impl
        if flags == "P1":
            assert torch.equal(toks, default[impl])
    with torch.inference_mode():
        auto = tdec.forward(cfg, params, tokens[:, :20], impl="auto").float()  # 40 rows: K6 / K3
        plain = tdec.forward(cfg, params, tokens[:, :20], impl="plain").float()
    assert ((auto - plain).norm() / plain.norm()).item() <= 1e-2


# ---- K6's decode and tensor-core paths (the plane gather, then K1's decode
# kernel at rows 1-8 or K3's split-K tensor-core product at rows 9-64): the
# llama-3-8b K6 shapes (qkv, o, gateup), a ragged perm with interleaved pad
# lanes, and 5 blocks (uneven K slices on the decode path)
K6_SHAPES = {"8b qkv": (4096, 4096, 6144), "8b o": (4096, 4096, 4096),
             "8b gateup": (4096, 4096, 28672), "ragged": (200, 256, 256),
             "uneven": (600, 640, 128)}


def _k6_counts():
    return (tk.ternary_matmul_gathered.launches, tk.ternary_matmul_gathered.launches_dec,
            tk.ternary_matmul_gathered.launches_tc, tk.ternary_matmul.launches,
            tk.ternary_matmul_igathered.launches)


def _k6_held(x, gp, packed, alpha, mu, path, a8=False):
    """One K6 call that must take ``path`` ("dec": W2A8 with K1_DEC_A8
    set): one launch, counted in launches and launches_dec or launches_tc,
    none of K1's or K3's; the same bits on a second call; held to TOL
    against ternary_matmul_gathered_plain and the path's own plain version."""
    with _dec_a8():
        assert tk.k6_path(x.shape[0], packed.shape[1], 128, a8) == path
        before = _k6_counts()
        got = tk.ternary_matmul_gathered(x, gp, packed, alpha, mu, a8=a8)
        again = tk.ternary_matmul_gathered(x, gp, packed, alpha, mu, a8=a8)
    torch.cuda.synchronize()
    assert tuple(b - a for a, b in zip(before, _k6_counts())) == \
        (2, 2 * (path == "dec"), 2 * (path == "tc"), 0, 0)
    assert torch.equal(got, again)
    want = tk.ternary_matmul_gathered_plain(x, gp, packed, alpha, mu, 128, a8)
    plain = (tk.ternary_matmul_gathered_dec_plain if path == "dec"
             else tk.ternary_matmul_gathered_tc_plain)
    wave = tk.dec_wave(x.device) if path == "dec" else tk.igtc_wave(x.device)
    algo = plain(x, gp, packed, alpha, mu, 128, a8, wave=wave)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got, want) <= TOL and _rel(got, algo) <= TOL
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("rows", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", sorted(K6_SHAPES))
def test_k6_dec_path_matches_plain_and_k1s_decode_kernel(cuda_device, shape, rows, a8):
    """Also bit-identical to K1's decode kernel on onehot_gather(x, perm):
    the same gathered values, the same kernel, the same K slices."""
    m, K, n = K6_SHAPES[shape]
    g = torch.Generator(device=cuda_device).manual_seed(13 * rows + m + n + int(a8))
    packed, alpha, mu = _layer(g, cuda_device, K, n, 128)
    perm = _perm(g, cuda_device, m, K, interleave=m < K)
    x = torch.randn((rows, m), generator=g, device=cuda_device).bfloat16()
    if shape == "uneven":
        nb = K // 128
        assert nb % -(-nb // tk.dec_splits(K, n, 128, tk.dec_wave(cuda_device))) != 0
    got = _k6_held(x, _planes(perm, m), packed, alpha, mu, "dec", a8)
    with _dec_a8():
        k1 = tk.ternary_matmul(tkg.onehot_gather(x, perm), packed, alpha, mu, a8=a8)
    assert torch.equal(got, k1)


@pytest.mark.cuda
@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("rows", [9, 16, 32, 33, 64])
@pytest.mark.parametrize("shape", sorted(K6_SHAPES))
def test_k6_tc_path_matches_plain_and_k3s_tc_path(cuda_device, shape, rows, a8):
    m, K, n = K6_SHAPES[shape]
    g = torch.Generator(device=cuda_device).manual_seed(17 * rows + m + n + int(a8))
    packed, alpha, mu = _layer(g, cuda_device, K, n, 128)
    perm = _perm(g, cuda_device, m, K, interleave=m < K)
    x = torch.randn((rows, m), generator=g, device=cuda_device).bfloat16()
    got = _k6_held(x, _planes(perm, m), packed, alpha, mu, "tc", a8)
    k3 = tk.ternary_matmul_igathered(x, perm, packed, alpha, mu, a8=a8)
    assert _rel(got, k3) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("rows", [8, 33])
def test_k6_paths_on_stacked_views_zero_alpha_blocks_zero_row_and_ties(cuda_device, rows, a8):
    g = torch.Generator(device=cuda_device).manual_seed(71 + rows + int(a8))
    m, K, n, L = 2000, 2048, 1024, 3
    path = "dec" if rows <= 8 else "tc"
    layers = [_layer(g, cuda_device, K, n, 128) for _ in range(L)]
    packed, alpha, mu = (torch.stack([l[j] for l in layers]) for j in range(3))
    gps = torch.stack([_planes(_perm(g, cuda_device, m, K, interleave=True), m)
                       for _ in range(L)])
    x = _a8_rows_with_ties(g, cuda_device, 8, m)
    if rows > 8:
        x = torch.cat([x, torch.randn((rows - 8, m), generator=g, device=cuda_device).bfloat16()])
    for li in range(L):
        got = _k6_held(x, gps[li], packed[li], alpha[li], mu[li], path, a8)
        assert got[1].abs().max().item() == 0.0  # the all-zero row
    p, a, mu0 = layers[0]
    a, mu0 = a.clone(), mu0.clone()
    a[::3] = 0
    mu0[::6] = 0
    _k6_held(x, gps[0], p, a, mu0, path, a8)
    _k6_held(x[: 3 if rows <= 8 else 9], gps[0], p, a, mu0, path, a8)


def _planes_gather(x, gp, rows_out, frag, a8):
    """The plane gather alone through its C entry, into NaN-filled scratch."""
    K = gp.shape[1]
    xg = torch.full((rows_out, K), float("nan"), device=x.device).bfloat16()
    S = torch.full((K // 128, rows_out), float("nan"), device=x.device)
    rc = tk._gathered_tc_kernel_lib().pt2_planes_gather(
        x.data_ptr(), gp.data_ptr(), xg.data_ptr(), S.data_ptr(), x.shape[0], rows_out,
        x.shape[1], gp.shape[0], K, int(frag), int(a8), x.device.index or 0,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    return xg, S


@pytest.mark.cuda
@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("rows", [1, 5, 8, 9, 17, 33, 64])
def test_planes_gather_bit_exact(cuda_device, rows, a8):
    """The plane gather alone writes exactly what planes_gather_plain
    does: lane order (rows 1-8) and fragment order with its block sums
    (rows 9-64, pad rows 0), bit for bit; on a permutation, lane order is
    onehot_gather's values and fragment order K3's gather scratch."""
    g = torch.Generator(device=cuda_device).manual_seed(81 + rows + int(a8))
    m, K = 3000, 3072
    perm = _perm(g, cuda_device, m, K, interleave=True)
    gp = _planes(perm, m)
    x = _a8_rows_with_ties(g, cuda_device, max(rows, 4), m)[:rows]
    xk = tk.normalize_rows_a8(x)[0].contiguous() if a8 else x
    if rows <= 8:
        xg, _ = _planes_gather(xk, gp, rows, False, a8)
        assert torch.equal(xg, tk.planes_gather_plain(xk, gp, 128, a8, "lanes"))
        if not a8:
            assert torch.equal(xg, tkg.onehot_gather(x, perm))
        return
    Bp = tk.igtc_rows_pad(rows)
    xg, S = _planes_gather(xk, gp, Bp, True, a8)
    want_xg, want_S = tk.planes_gather_plain(xk, gp, 128, a8, "fragments")
    assert torch.equal(xg, want_xg) and torch.equal(S, want_S)
    k3_xg, k3_S = tk.igathered_tc_gather_plain(xk, perm, 128, a8)
    assert torch.equal(xg, k3_xg)
    assert (S - k3_S).abs().max().item() <= 1e-6 * k3_S.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("planes", ["few", "dense"])
def test_planes_gather_on_planes_that_are_not_a_permutation(cuda_device, planes):
    """Planes with fields of 2 and up to 3 ones in a lane ("few": each
    lane's fields kept in shared memory) or half the fields set ("dense":
    the lanes with more than E fields walk their column) give
    planes_gather_plain's bits in both orders; so do K6's paths' outputs
    against their plain versions, within TOL."""
    g = torch.Generator(device=cuda_device).manual_seed(91)
    m, D, K, n = 300, 384, 512, 256
    if planes == "dense":
        codes = torch.randint(-1, 1, (K, D), generator=g, device=cuda_device, dtype=torch.int8)
    else:
        codes = torch.full((K, D), -1, device=cuda_device, dtype=torch.int8)
        for _ in range(3):
            codes[torch.arange(K, device=cuda_device),
                  torch.randint(0, D, (K,), generator=g, device=cuda_device)] = 0
    codes[::7, 5] = 1
    gp = pack_ternary(codes, 128)
    packed, alpha, mu = _layer(g, cuda_device, K, n, 128)
    for rows in (3, 40):
        x = torch.randn((rows, m), generator=g, device=cuda_device).bfloat16()
        frag = rows > 8
        xg, S = _planes_gather(x, gp, tk.igtc_rows_pad(rows) if frag else rows, frag, False)
        want = tk.planes_gather_plain(x, gp, 128, False, "fragments" if frag else "lanes")
        if frag:
            assert torch.equal(xg, want[0]) and torch.equal(S, want[1])
        else:
            assert torch.equal(xg, want)
        path = "tc" if frag else "dec"
        before = _k6_counts()
        got = tk.ternary_matmul_gathered(x, gp, packed, alpha, mu)
        torch.cuda.synchronize()
        assert _k6_counts()[1:3] == (before[1] + (path == "dec"), before[2] + (path == "tc"))
        plain = (tk.ternary_matmul_gathered_dec_plain if path == "dec"
                 else tk.ternary_matmul_gathered_tc_plain)
        wave = tk.dec_wave(cuda_device) if path == "dec" else tk.igtc_wave(cuda_device)
        assert _rel(got, plain(x, gp, packed, alpha, mu, wave=wave)) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 8, 9, 16, 64])
def test_k6_rows_and_modes_pick_their_kernel(cuda_device, rows, monkeypatch):
    """bf16 decode rows on the decode path, W2A8 decode rows on the
    CUDA-core K6 (K1_DEC_A8 off), rows 9-64 on the tensor-core path in both
    modes; K6_DEC_MAX_ROWS 0 and K6_TC_MIN_ROWS 1 << 30 send every row to
    the CUDA-core K6, which agrees within TOL."""
    g = torch.Generator(device=cuda_device).manual_seed(101 + rows)
    m, K, n = 1000, 1024, 512
    packed, alpha, mu = _layer(g, cuda_device, K, n, 128)
    gp = _planes(_perm(g, cuda_device, m, K, interleave=True), m)
    x = torch.randn((rows, m), generator=g, device=cuda_device).bfloat16()
    for a8 in (False, True):
        path = tk.k6_path(rows, n, 128, a8)
        assert path == ("tc" if rows > 8 else "cuda_core" if a8 else "dec")
        before = _k6_counts()
        on = tk.ternary_matmul_gathered(x, gp, packed, alpha, mu, a8=a8)
        torch.cuda.synchronize()
        assert tuple(b - a for a, b in zip(before, _k6_counts())) == \
            (1, int(path == "dec"), int(path == "tc"), 0, 0)
        with monkeypatch.context() as mp:
            mp.setattr(tk, "K6_DEC_MAX_ROWS", 0)
            mp.setattr(tk, "K6_TC_MIN_ROWS", 1 << 30)
            assert tk.k6_path(rows, n, 128, a8) == "cuda_core"
            before = _k6_counts()
            off = tk.ternary_matmul_gathered(x, gp, packed, alpha, mu, a8=a8)
            torch.cuda.synchronize()
            assert tuple(b - a for a, b in zip(before, _k6_counts())) == (1, 0, 0, 0, 0)
        assert _rel(on, off) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [4, 16])
def test_k6_paths_refuse_graph_capture(cuda_device, rows):
    g = torch.Generator(device=cuda_device).manual_seed(111 + rows)
    packed, alpha, mu = _layer(g, cuda_device, 1024, 256, 128)
    gp = _planes(_perm(g, cuda_device, 1000, 1024), 1000)
    x = torch.randn((rows, 1000), generator=g, device=cuda_device).bfloat16()
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tk.ternary_matmul_gathered(x, gp, packed, alpha, mu)  # built outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = _k6_counts()
    with pytest.raises(NotImplementedError, match="K6's.*graph"):
        with torch.cuda.graph(graph):
            tk.ternary_matmul_gathered(x, gp, packed, alpha, mu)
    assert _k6_counts() == before


@pytest.mark.cuda
def test_k6_paths_launch_failure_raises_without_fallback(cuda_device, monkeypatch):
    """A launch of the decode or tensor-core path that fails raises;
    neither the CUDA-core K6 nor a plain version runs in its place, and
    nothing is counted."""
    class Refusing:
        @staticmethod
        def pt2_ternary_matmul_gathered_dec(*args):
            return 1  # cudaErrorInvalidValue

        @staticmethod
        def pt2_ternary_matmul_gathered_tc(*args):
            return 1

    def not_asked():
        raise AssertionError("the CUDA-core K6 was asked for")

    g = torch.Generator(device=cuda_device).manual_seed(121)
    packed, alpha, mu = _layer(g, cuda_device, 512, 256, 128)
    gp = _planes(_perm(g, cuda_device, 500, 512), 500)
    monkeypatch.setattr(tk, "_gathered_dec_kernel_lib", lambda: Refusing)
    monkeypatch.setattr(tk, "_gathered_tc_kernel_lib", lambda: Refusing)
    monkeypatch.setattr(tk, "_gathered_kernel_lib", not_asked)
    for rows, a8 in ((1, False), (8, False), (9, False), (64, True)):
        x = torch.randn((rows, 500), generator=g, device=cuda_device).bfloat16()
        before = _k6_counts()
        with pytest.raises(RuntimeError, match="K6 \\('(dec|tc)' path"):
            tk.ternary_matmul_gathered(x, gp, packed, alpha, mu, a8=a8)
        assert _k6_counts() == before


@pytest.mark.cuda
def test_k6_c_entries_refuse_what_they_do_not_take(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(131)
    m, K, n = 1000, 1024, 256
    packed, alpha, mu = _layer(g, cuda_device, K, n, 128)
    gp = _planes(_perm(g, cuda_device, m, K, interleave=True), m)
    x = torch.randn((64, m), generator=g, device=cuda_device).bfloat16()
    xg = torch.empty((64, K), device=cuda_device).bfloat16()
    sums = torch.empty((K // 128, 64), device=cuda_device)
    partial = torch.empty((8, 64, n), device=cuda_device)
    out = torch.empty((64, n), device=cuda_device)
    counters = torch.zeros(n // 128, dtype=torch.int32, device=cuda_device)
    stream = torch.cuda.current_stream().cuda_stream
    dev = cuda_device.index or 0
    dec = tk._gathered_dec_kernel_lib().pt2_ternary_matmul_gathered_dec
    tc = tk._gathered_tc_kernel_lib().pt2_ternary_matmul_gathered_tc
    head = [t.data_ptr() for t in (x, gp, packed, alpha, mu, xg)]
    tail = [t.data_ptr() for t in (partial, out, counters)]
    D4 = gp.shape[0]
    assert dec(*head, *tail, 8, m, D4, K, n, 2, 0, dev, stream) == 0
    torch.cuda.synchronize()
    want = tk.ternary_matmul_gathered_plain(x[:8], gp, packed, alpha, mu)
    assert _rel(out[:8], want) <= TOL
    assert dec(*head, *tail, 9, m, D4, K, n, 2, 0, dev, stream) != 0  # 9 rows
    assert dec(*head[:1], head[1] + 4, *head[2:], *tail, 4, m, D4, K, n, 2, 0, dev,
               stream) != 0  # planes not 16-byte aligned
    assert dec(*head, *tail, 4, 4 * D4 + 1, D4, K, n, 2, 0, dev, stream) != 0  # x too wide
    assert tc(*head, sums.data_ptr(), *tail, 16, m, D4, K, n, 3, 0, dev, stream) == 0
    torch.cuda.synchronize()
    want = tk.ternary_matmul_gathered_plain(x[:16], gp, packed, alpha, mu)
    assert _rel(out[:16], want) <= TOL
    assert tc(*head, sums.data_ptr(), *tail, 8, m, D4, K, n, 3, 0, dev, stream) != 0  # 8 rows
    assert tc(*head, sums.data_ptr(), *tail, 16, m, D4, K, n, 9, 0, dev, stream) != 0  # 9 slices
    assert tc(*head, sums.data_ptr(), *tail, 16, m, D4, K, 200, 3, 0, dev, stream) != 0  # n
    assert counters.sum().item() == 0


# ---- K5's rows path (the lane map, then x's rows staged in shared memory
# and gathered; rows >= K5_ROWS_MIN_ROWS): bit-exact to its plain versions
# and to K4 on permutation planes, x @ G on any planes
def _k5_counts():
    return tkg.onehot_matmul.launches, tkg.onehot_matmul.launches_rows


def _lane_map(gp, m):
    """The rows path's first launch alone, into a fresh scratch."""
    D4, K = gp.shape
    lmap = torch.full(((1 + tkg.K5_MAP_FIELDS) * K,), 7, dtype=torch.int32, device=gp.device)
    rc = tkg._rows_kernel_lib().pt2_onehot_lane_map(
        gp.data_ptr(), lmap.data_ptr(), m, D4, K, gp.device.index or 0,
        torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    torch.cuda.synchronize()
    return lmap


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,K", [(4096, 4096), (8192, 8192), (200, 256), (300, 512)])
@pytest.mark.parametrize("rows", [65, 128, 512, 1000])
def test_k5_rows_path_bit_exact(cuda_device, rows, m, K, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(rows + m + K)
    perm = _perm(g, cuda_device, m, K, interleave=m in (200, 300))
    gp = _planes(perm, m)
    x = torch.randn((rows, m), generator=g, device=cuda_device).to(dtype)
    x[0, : m // 2] = -0.0  # -0.0 is copied as it is
    assert tkg.k5_path(rows, m, x.element_size()) == "rows"
    before = _k5_counts()
    got = tkg.onehot_matmul(x, gp)
    torch.cuda.synchronize()
    assert _k5_counts() == (before[0] + 1, before[1] + 1)
    assert got.dtype == dtype and got.shape == (rows, K)
    assert torch.equal(got, tkg.onehot_matmul_rows_plain(x, gp))
    assert torch.equal(got, tkg.onehot_gather(x, perm))  # the value K4 copies
    assert torch.equal(torch.signbit(got), torch.signbit(tkg.onehot_gather(x, perm)))
    assert torch.equal(_lane_map(gp, m), tkg.onehot_lane_map_plain(gp, m))


def _any_planes(g, dev, kind, m, D, K):
    """Planes that are not a permutation: "few" (fields of 2, up to 3 ones in
    a column: each lane within the map's E), "dense" (half the fields set:
    every lane walks its column)."""
    if kind == "dense":
        codes = torch.randint(-1, 1, (K, D), generator=g, device=dev, dtype=torch.int8)
    else:
        codes = torch.full((K, D), -1, device=dev, dtype=torch.int8)
        for _ in range(3):
            codes[torch.arange(K, device=dev),
                  torch.randint(0, D, (K,), generator=g, device=dev)] = 0
    codes[::7, 5] = 1
    return pack_ternary(codes, 128), codes


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,D,K", [(300, 384, 512), (256, 256, 1024)])
@pytest.mark.parametrize("kind", ["few", "dense"])
def test_k5_rows_path_is_x_at_g_for_any_planes(cuda_device, kind, m, D, K, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(17 + m)
    gp, codes = _any_planes(g, cuda_device, kind, m, D, K)
    exact_u = (codes.t().double() + 1)[:m]
    for rows in (65, 130):
        x = torch.randn((rows, m), generator=g, device=cuda_device).to(dtype)
        before = _k5_counts()
        got = tkg.onehot_matmul(x, gp)
        torch.cuda.synchronize()
        assert _k5_counts() == (before[0] + 1, before[1] + 1)
        assert torch.equal(got, tkg.onehot_matmul_rows_plain(x, gp))
        # f32: summation order; bf16: the result's own rounding (2^-9 relative)
        assert _rel(got.double(), x.double() @ exact_u) <= (1e-6 if dtype == torch.float32
                                                            else 2.0 ** -8)
    assert torch.equal(_lane_map(gp, m), tkg.onehot_lane_map_plain(gp, m))


@pytest.mark.cuda
def test_k5_rows_path_on_stacked_view_and_same_bits_run_to_run(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(18)
    m, K, L = 4096, 4096, 3
    perms = [_perm(g, cuda_device, m, K) for _ in range(L)]
    gps = torch.stack([_planes(p, m) for p in perms])
    x = torch.randn((512, m), generator=g, device=cuda_device).bfloat16()
    for li in range(L):
        got = tkg.onehot_matmul(x, gps[li])  # a view, as the port stacks
        assert torch.equal(got, tkg.onehot_gather(x, perms[li]))
        assert torch.equal(got, tkg.onehot_matmul(x, gps[li]))
    gp, _ = _any_planes(g, cuda_device, "few", 300, 384, 512)
    x = torch.randn((200, 300), generator=g, device=cuda_device)
    assert torch.equal(tkg.onehot_matmul(x, gp), tkg.onehot_matmul(x, gp))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 16, 64, 65, 128, 512])
def test_k5_rows_launch_counts_exact_and_threshold(cuda_device, rows, monkeypatch):
    """Rows >= K5_ROWS_MIN_ROWS count one launch and one rows-path launch, fewer
    one launch of the first kernel; with the threshold rebound every row
    count takes the first kernel, with the same bits."""
    g = torch.Generator(device=cuda_device).manual_seed(19 + rows)
    perm = _perm(g, cuda_device, 1000, 1024, interleave=True)
    gp = _planes(perm, 1000)
    x = torch.randn((rows, 1000), generator=g, device=cuda_device).bfloat16()
    on_rows = rows >= tkg.K5_ROWS_MIN_ROWS
    assert tkg.k5_path(rows, 1000, 2) == ("rows" if on_rows else "cuda_core")
    before = _k5_counts()
    on = tkg.onehot_matmul(x, gp)
    torch.cuda.synchronize()
    assert _k5_counts() == (before[0] + 1, before[1] + int(on_rows))
    monkeypatch.setattr(tkg, "K5_ROWS_MIN_ROWS", 1 << 30)
    before = _k5_counts()
    off = tkg.onehot_matmul(x, gp)
    torch.cuda.synchronize()
    assert _k5_counts() == (before[0] + 1, before[1])
    assert torch.equal(on, off)


@pytest.mark.cuda
def test_k5_rows_path_refuses_graph_capture(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(20)
    gp = _planes(_perm(g, cuda_device, 1000, 1024), 1000)
    x = torch.randn((128, 1000), generator=g, device=cuda_device).bfloat16()
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tkg.onehot_matmul(x, gp)  # built and its scratch made outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = _k5_counts()
    with pytest.raises(NotImplementedError, match="K5's rows path.*graph"):
        with torch.cuda.graph(graph):
            tkg.onehot_matmul(x, gp)
    assert _k5_counts() == before


@pytest.mark.cuda
def test_k5_rows_path_launch_failure_raises_without_fallback(cuda_device, monkeypatch):
    """A rows-path launch that fails raises; neither K5's first kernel nor a
    plain version runs in its place, and nothing is counted."""
    class Refusing:
        @staticmethod
        def pt2_onehot_matmul_rows(*args):
            return 1  # cudaErrorInvalidValue

    def not_asked():
        raise AssertionError("K5's first kernel was asked for")

    g = torch.Generator(device=cuda_device).manual_seed(21)
    gp = _planes(_perm(g, cuda_device, 500, 512), 500)
    monkeypatch.setattr(tkg, "_rows_kernel_lib", lambda: Refusing)
    monkeypatch.setattr(tkg, "_mm_kernel_lib", not_asked)
    for rows, dtype in ((65, torch.bfloat16), (512, torch.float32)):
        x = torch.randn((rows, 500), generator=g, device=cuda_device).to(dtype)
        before = _k5_counts()
        with pytest.raises(RuntimeError, match="K5 \\('rows' path"):
            tkg.onehot_matmul(x, gp)
        assert _k5_counts() == before


@pytest.mark.cuda
def test_k5_rows_c_entry_refuses_what_it_does_not_take(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(22)
    m, K = 1000, 1024
    gp = _planes(_perm(g, cuda_device, m, K, interleave=True), m)
    D4 = gp.shape[0]
    x = torch.randn((130, m), generator=g, device=cuda_device).bfloat16()
    out = torch.empty((130, K), device=cuda_device).bfloat16()
    lmap = torch.empty(((1 + tkg.K5_MAP_FIELDS) * K,), dtype=torch.int32, device=cuda_device)
    stream = torch.cuda.current_stream().cuda_stream
    dev = cuda_device.index or 0
    fn = tkg._rows_kernel_lib().pt2_onehot_matmul_rows
    args = [x.data_ptr(), gp.data_ptr(), lmap.data_ptr(), out.data_ptr()]
    assert fn(*args, 130, m, D4, K, 2, dev, stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(out, tkg.onehot_matmul_rows_plain(x, gp))
    assert fn(*args, 130, m, D4, K, 3, dev, stream) != 0  # 3-byte elements
    assert fn(*args, 130, 4 * D4 + 1, D4, K, 2, dev, stream) != 0  # x wider than the planes
    assert fn(*args, 130, m, D4, 96, 2, dev, stream) != 0  # lanes not a multiple of 128
    assert fn(*args, 0, m, D4, K, 2, dev, stream) != 0  # no rows
    assert fn(args[0], args[1] + 4, *args[2:], 130, m, D4, K, 2, dev, stream) != 0  # planes
    assert fn(*args[:2], args[2] + 4, args[3], 130, m, D4, K, 2, dev, stream) != 0  # map
    assert fn(*args[:3], args[3] + 2, 130, m, D4, K, 2, dev, stream) != 0  # out not 16-byte
    wide = torch.zeros((65, 16385), device=cuda_device)  # a row of 65540 bytes
    gw = torch.zeros((4128, 128), dtype=torch.int8, device=cuda_device)
    assert fn(wide.data_ptr(), gw.data_ptr(), lmap.data_ptr(), out.data_ptr(), 65, 16385,
              gw.shape[0], 128, 4, dev, stream) != 0
    assert tkg.k5_path(65, 16385, 4) == "cuda_core"


# ---- K4's rows path (x's rows staged in shared memory by bulk copies, perm
# held in registers, 16-byte stores; rows >= K4_ROWS_MIN_ROWS): bit-exact to
# its plain version, to K4's first kernel and to K5, NaN payloads included
def _k4_counts():
    return tkg.onehot_gather.launches, tkg.onehot_gather.launches_rows


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _k4_first_kernel(x, perm):
    """K4's first kernel through its C entry."""
    rows, m = x.shape
    out = torch.empty((rows, perm.shape[0]), dtype=x.dtype, device=x.device)
    assert tkg._kernel_lib().pt2_onehot_gather(
        x.data_ptr(), perm.data_ptr(), out.data_ptr(), rows, m, perm.shape[0], x.element_size(),
        x.device.index or 0, torch.cuda.current_stream().cuda_stream) == 0
    return out


def _k4_plan(x, perm, R, gx):
    """The rows path's launch with a named plan, into an output whose every
    element starts as a NaN pattern that no lane of the tests' x holds."""
    rows, m = x.shape
    out = torch.full((rows, perm.shape[0]), -7, dtype=torch.int16 if x.element_size() == 2
                     else torch.int32, device=x.device).view(x.dtype)
    rc = tkg._gather_rows_kernel_lib().pt2_onehot_gather_rows_plan(
        x.data_ptr(), perm.data_ptr(), out.data_ptr(), rows, m, perm.shape[0], x.element_size(),
        R, gx, x.device.index or 0, torch.cuda.current_stream().cuda_stream)
    return rc, out


def _with_nan_payloads(x):
    """x with -0.0 in half of row 0 and NaNs of several payloads (quiet and
    signalling, both signs) in row 1."""
    x = x.clone()
    m = x.shape[1]
    x[0, : m // 2] = -0.0
    pats = ([0x7FC1, -0x005B, 0x7F81, -0x007F] if x.element_size() == 2
            else [0x7FC00001, -0x007FFEDD, 0x7F800123, -0x00000001])
    b = _bits(x)
    for i, p in enumerate(pats):
        b[1, i::len(pats)] = p
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,K", [(4096, 4096), (8192, 8192), (200, 256), (300, 512)])
@pytest.mark.parametrize("rows", [16, 65, 128, 512, 1000])
def test_k4_rows_bit_exact(cuda_device, rows, m, K, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(rows + m + K + 4)
    perm = _perm(g, cuda_device, m, K, interleave=m in (200, 300))
    x = torch.randn((rows, m), generator=g, device=cuda_device).to(dtype)
    x[0, : m // 2] = -0.0
    assert tkg.k4_path(rows, m, K, x.element_size()) == "rows"
    before = _k4_counts()
    got = tkg.onehot_gather(x, perm)
    torch.cuda.synchronize()
    assert _k4_counts() == (before[0] + 1, before[1] + 1)
    assert got.dtype == dtype and got.shape == (rows, K)
    assert torch.equal(_bits(got), _bits(tkg.onehot_gather_plain(x, perm)))
    assert torch.equal(_bits(got), _bits(_k4_first_kernel(x, perm)))
    assert torch.equal(_bits(got), _bits(tkg.onehot_matmul(x, _planes(perm, m))))  # K5
    assert torch.signbit(got[0, perm < m // 2]).all() and not torch.signbit(got[:, perm >= m]).any()
    xn = _with_nan_payloads(x)  # bits, not values: K5 multiplies, so it is not asked here
    got = tkg.onehot_gather(xn, perm)
    assert torch.equal(_bits(got), _bits(tkg.onehot_gather_plain(xn, perm)))
    assert torch.equal(_bits(got), _bits(_k4_first_kernel(xn, perm)))
    assert torch.isnan(got[1, perm < m]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,m,K", [(512, 4096, 4096), (1000, 300, 512), (130, 8192, 8192),
                                      (77, 4096, 6152)])
def test_k4_rows_every_plan_bit_exact(cuda_device, rows, m, K, dtype):
    """Every plan the C entry takes writes every lane with the same bits:
    R 1, 2 and 4, the chunks split over CTAs or looped by one; rows of 600
    bytes (element loads) and a last stage of fewer than R rows included."""
    g = torch.Generator(device=cuda_device).manual_seed(rows + K)
    perm = _perm(g, cuda_device, m, K, interleave=True)
    x = _with_nan_payloads(torch.randn((rows, m), generator=g, device=cuda_device).to(dtype))
    want = _bits(tkg.onehot_gather_plain(x, perm))
    nch = -(-K // 2048)
    for R in (1, 2, 4):
        if R * m * x.element_size() > 65536:
            continue
        for gx in sorted({1, 2, nch} & set(range(1, nch + 1))):
            rc, got = _k4_plan(x, perm, R, gx)
            torch.cuda.synchronize()
            assert rc == 0, (R, gx)
            assert torch.equal(_bits(got), want), (R, gx)


@pytest.mark.cuda
def test_k4_rows_unaligned_operands(cuda_device):
    """x that does not start on 16 bytes takes element loads; a perm view
    that does not either is copied by the wrapper: the same bits."""
    g = torch.Generator(device=cuda_device).manual_seed(41)
    m, K, rows = 4096, 4096, 128
    perm = _perm(g, cuda_device, m, K)
    xbuf = torch.randn((rows * m + 1,), generator=g, device=cuda_device).bfloat16()
    x = xbuf[1:].view(rows, m)  # 2 bytes past the allocation's start
    pbuf = torch.cat([perm[:1], perm])
    pv = pbuf[1:]  # 4 bytes past it
    assert x.data_ptr() % 16 and pv.data_ptr() % 16
    before = _k4_counts()
    got = tkg.onehot_gather(x, pv)
    torch.cuda.synchronize()
    assert _k4_counts() == (before[0] + 1, before[1] + 1)
    assert torch.equal(_bits(got), _bits(tkg.onehot_gather_plain(x, perm)))


@pytest.mark.cuda
def test_k4_rows_on_stacked_view_and_same_bits_run_to_run(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(42)
    m, K, L = 4096, 4096, 3
    perms = torch.stack([_perm(g, cuda_device, m, K) for _ in range(L)])
    x = _with_nan_payloads(torch.randn((512, m), generator=g, device=cuda_device).bfloat16())
    for li in range(L):
        got = tkg.onehot_gather(x, perms[li])  # a view, as the port stacks
        assert torch.equal(_bits(got), _bits(tkg.onehot_gather_plain(x, perms[li])))
        for _ in range(3):
            assert torch.equal(_bits(tkg.onehot_gather(x, perms[li])), _bits(got))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 15, 16, 65, 512])
def test_k4_rows_launch_counts_exact_and_threshold(cuda_device, rows, monkeypatch):
    """Rows >= K4_ROWS_MIN_ROWS count one launch and one rows-path launch,
    fewer one launch of the first kernel; with the threshold rebound every
    row count takes the first kernel, with the same bits."""
    g = torch.Generator(device=cuda_device).manual_seed(43 + rows)
    perm = _perm(g, cuda_device, 1000, 1024, interleave=True)
    x = torch.randn((rows, 1000), generator=g, device=cuda_device).bfloat16()
    on_rows = rows >= tkg.K4_ROWS_MIN_ROWS
    assert tkg.k4_path(rows, 1000, 1024, 2) == ("rows" if on_rows else "cuda_core")
    before = _k4_counts()
    on = tkg.onehot_gather(x, perm)
    torch.cuda.synchronize()
    assert _k4_counts() == (before[0] + 1, before[1] + int(on_rows))
    monkeypatch.setattr(tkg, "K4_ROWS_MIN_ROWS", 1 << 30)
    before = _k4_counts()
    off = tkg.onehot_gather(x, perm)
    torch.cuda.synchronize()
    assert _k4_counts() == (before[0] + 1, before[1])
    assert torch.equal(_bits(on), _bits(off))


@pytest.mark.cuda
def test_k4_rows_replays_from_a_cuda_graph(cuda_device):
    """No scratch and no per-stream state: a capture holds the launch, and
    each replay gathers the rows x then holds."""
    g = torch.Generator(device=cuda_device).manual_seed(44)
    m, K, rows = 4096, 4096, 512
    perm = _perm(g, cuda_device, m, K)
    x = torch.randn((rows, m), generator=g, device=cuda_device).bfloat16()
    tkg.onehot_gather(x, perm)  # built and its attribute set outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = _k4_counts()
    with torch.cuda.graph(graph):
        out = tkg.onehot_gather(x, perm)
    assert _k4_counts() == (before[0] + 1, before[1] + 1)  # counted once, at the capture
    for _ in range(2):
        x.copy_(torch.randn((rows, m), generator=g, device=cuda_device).bfloat16())
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(_bits(out), _bits(tkg.onehot_gather_plain(x, perm)))
    assert _k4_counts() == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_k4_rows_launch_failure_raises_without_fallback(cuda_device, monkeypatch):
    """A rows-path launch that fails raises; neither K4's first kernel nor
    the plain version runs in its place, and nothing is counted."""
    class Refusing:
        @staticmethod
        def pt2_onehot_gather_rows(*args):
            return 1  # cudaErrorInvalidValue

    def not_asked():
        raise AssertionError("K4's first kernel was asked for")

    g = torch.Generator(device=cuda_device).manual_seed(45)
    perm = _perm(g, cuda_device, 500, 512)
    monkeypatch.setattr(tkg, "_gather_rows_kernel_lib", lambda: Refusing)
    monkeypatch.setattr(tkg, "_kernel_lib", not_asked)
    for rows, dtype in ((65, torch.bfloat16), (512, torch.float32)):
        x = torch.randn((rows, 500), generator=g, device=cuda_device).to(dtype)
        before = _k4_counts()
        with pytest.raises(RuntimeError, match="K4 \\('rows' path"):
            tkg.onehot_gather(x, perm)
        assert _k4_counts() == before


@pytest.mark.cuda
def test_k4_rows_c_entries_refuse_what_they_do_not_take(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(46)
    m, K, rows = 1000, 1024, 130
    perm = _perm(g, cuda_device, m, K, interleave=True)
    x = torch.randn((rows, m), generator=g, device=cuda_device).bfloat16()
    out = torch.empty((rows, K), device=cuda_device).bfloat16()
    stream = torch.cuda.current_stream().cuda_stream
    dev = cuda_device.index or 0
    lib = tkg._gather_rows_kernel_lib()
    fn, plan = lib.pt2_onehot_gather_rows, lib.pt2_onehot_gather_rows_plan
    args = [x.data_ptr(), perm.data_ptr(), out.data_ptr()]
    assert fn(*args, rows, m, K, 2, dev, stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(out, tkg.onehot_gather_plain(x, perm))
    assert fn(*args, rows, m, K, 3, dev, stream) != 0  # 3-byte elements
    assert fn(*args, rows, m, 1020, 2, dev, stream) != 0  # lanes not a multiple of 8
    assert fn(*args, 0, m, K, 2, dev, stream) != 0  # no rows
    assert fn(*args, rows, 0, K, 2, dev, stream) != 0  # no features
    assert fn(args[0], args[1] + 4, args[2], rows, m, K, 2, dev, stream) != 0  # perm not 16-byte
    assert fn(*args[:2], args[2] + 2, rows, m, K, 2, dev, stream) != 0  # out not 16-byte
    assert fn(args[0] + 1, *args[1:], rows, m, K, 2, dev, stream) != 0  # x not element-aligned
    wide = torch.zeros((65, 16385), device=cuda_device)  # a row of 65540 bytes
    assert fn(wide.data_ptr(), *args[1:], 65, 16385, K, 4, dev, stream) != 0
    assert tkg.k4_path(65, 16385, K, 4) == "cuda_core"
    assert plan(*args, rows, m, K, 2, 2, 1, dev, stream) == 0
    for R, gx in ((3, 1), (8, 1), (0, 1), (2, 0), (2, 2)):  # K = 1024: one chunk
        assert plan(*args, rows, m, K, 2, R, gx, dev, stream) != 0, (R, gx)
    x8 = torch.zeros((16, 8192), device=cuda_device)  # R x row bytes over 64 KB
    assert plan(x8.data_ptr(), *args[1:], 16, 8192, K, 4, 4, 1, dev, stream) != 0
    assert plan(x8.data_ptr(), *args[1:], 16, 8192, K, 4, 2, 1, dev, stream) == 0
    torch.cuda.synchronize()


# The quantizer on the card against the port on the CPU (chip_smoke.py
# phase 21 (b) holds layer 0's o projection of a quantized llama-3-8b the
# same way): without SSR, f32 products in other orders move a code only at a
# near-tie and the rest of its row after it, so at least 99 % of codes agree;
# the two Hessian-weighted relative errors lie within 5 % of each other. With
# SSR a near-tie in the similarity order at a block boundary moves a whole
# column between blocks and every block after it (measured on an H100: 71.6 %
# of codes equal on this draw), so only the errors are held there.
GPTQ_CODES_EQUAL = 0.99
GPTQ_ERR_REL = 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("use_ssr", [False, True], ids=["dense_order", "ssr"])
def test_ternary_gptq_on_the_card_matches_the_cpu(cuda_device, use_ssr):
    """One llama-3-8b-width projection (4096 -> 4096, o's shape), exact AGA,
    W / H / H_inv made on the card and quantized there and, copied, on the
    CPU."""
    g = torch.Generator(device=cuda_device).manual_seed(51)
    m, n, N = 4096, 4096, 8192
    X = torch.randn((N, m), generator=g, device=cuda_device)
    X[:, 1::2] += 0.6 * X[:, ::2]
    acc = thess.HessianAccumulator(m, device=cuda_device)
    acc.update(X)
    H = acc.normalized()
    _, H_inv = thess.damped_inverse(H)
    W = torch.randn((n, m), generator=g, device=cuda_device) / m**0.5
    assert not torch.backends.cuda.matmul.allow_tf32
    q = tgptq.ternary_gptq(W, H, H_inv, use_ssr=use_ssr)
    qc = tgptq.ternary_gptq(W.cpu(), H.cpu(), H_inv.cpu(), use_ssr=use_ssr)
    assert q.T.is_cuda and q.T.shape == qc.T.shape == (n, m)
    if not use_ssr:
        same = (q.T.cpu() == qc.T).float().mean().item()
        assert same >= GPTQ_CODES_EQUAL, same
        assert torch.equal(q.perm.cpu(), qc.perm)
    assert sorted(q.perm.cpu().tolist()) == list(range(m))
    e_card = rel_out_err(W, tgptq.dequantize_layer(q, m), H)
    e_cpu = rel_out_err(W.cpu(), tgptq.dequantize_layer(qc, m), H.cpu())
    assert 0 < e_card < 1 and abs(e_card - e_cpu) <= GPTQ_ERR_REL * e_cpu, (e_card, e_cpu)


@pytest.mark.cuda
def test_hessian_normalized_gives_the_cpu_bits(cuda_device):
    """H / nsamples on the card is the correctly rounded quotient, the CPU's
    bits, at counts whose reciprocal is inexact."""
    g = torch.Generator(device=cuda_device).manual_seed(52)
    for n in (3, 7, 1000, 12345):
        acc = thess.HessianAccumulator(256, device=cuda_device)
        acc.H = torch.randn((256, 256), generator=g, device=cuda_device) * 1e3
        acc.nsamples = n
        want = acc.H.cpu() / float(n)
        assert torch.equal(acc.normalized().cpu(), want), n


# ---- K1s / K3s: K1's and K3's decode rows with the slot read from device
# memory (the mixture-of-experts decode's routed experts)
IDX_CASES = [(1024, 512, "identity"), (512, 2048, "folded"), (1024, 512, "ssr"),
             (256, 192, "folded")]


@pytest.mark.cuda
@pytest.mark.parametrize("dec_a8", [False, True])
@pytest.mark.parametrize("impl", ["auto", "a8"])
@pytest.mark.parametrize("rows", [1, 2, 8])
@pytest.mark.parametrize("n_out,n_in,mode", IDX_CASES)
def test_device_index_equals_view_route(cuda_device, n_out, n_in, mode, rows, impl, dec_a8,
                                        monkeypatch):
    """Every slot of a (2 x 3)-slot stack, the index an int32 on the card with
    a host base: bit for bit the host-index view route's result, within 1e-4
    of the plain version, counted in the entry's own counters only."""
    from pt2tpu_torch.utils.randmodel import random_expert_stack

    monkeypatch.setattr(tk, "K1_DEC_A8", dec_a8)
    g = torch.Generator(device=cuda_device).manual_seed(n_out + n_in + rows)
    flat = tdec._flatten_expert_stack(
        random_expert_stack(g, 2, 3, n_out, n_in, mode, device=cuda_device))
    x = torch.randn((rows, n_in), generator=g, device=cuda_device).bfloat16()
    sel = torch.arange(3, dtype=torch.int32, device=cuda_device)
    name = "ternary_matmul_igathered_idx" if mode == "ssr" else "ternary_matmul_idx"
    wrapper = getattr(tk, name)
    for s in range(6):
        e, base = sel[s % 3], 3 * (s // 3)
        before = (wrapper.launches, wrapper.launches_dec, tk.ternary_matmul.launches,
                  tk.ternary_matmul_igathered.launches)
        got = ttm.ternary_linear_apply_stacked(flat, x, e, impl=impl, base=base,
                                               out_dtype=torch.float32)
        path = (tk.k3_path if mode == "ssr" else tk.k1_path)(rows, n_out, flat.block_size,
                                                             impl == "a8")
        dec = path == "dec"
        assert (wrapper.launches, wrapper.launches_dec) == (before[0] + 1, before[1] + dec)
        assert (tk.ternary_matmul.launches, tk.ternary_matmul_igathered.launches) == before[2:]
        view = ttm.ternary_linear_apply_stacked(flat, x, s, impl=impl, out_dtype=torch.float32)
        assert torch.equal(got, view)
        K = flat.packed.shape[1] * 4
        bs = flat.block_size
        if mode == "ssr":
            want = tk.ternary_matmul_igathered_idx_plain(x, flat.perm, flat.packed, flat.alpha,
                                                         flat.mu, e, base, bs, a8=impl == "a8")
        else:
            want = tk.ternary_matmul_idx_plain(torch.nn.functional.pad(x, (0, K - n_in)),
                                               flat.packed, flat.alpha, flat.mu, e, base, bs,
                                               a8=impl == "a8")
        assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.cuda
def test_device_index_refusals(cuda_device, monkeypatch):
    """No host read on any route: rows on a tensor-core path (K3s's, K6s's)
    and K5's rows path raise NotImplementedError, while one row runs under
    every flag set (K6s under P2, K4s / K5s then K1s with both fused routes
    off); a wrong index type or a stack that is not whole raises ValueError."""
    from pt2tpu_torch.utils.randmodel import random_expert_stack

    g = torch.Generator(device=cuda_device).manual_seed(3)
    flat = tdec._flatten_expert_stack(
        random_expert_stack(g, 1, 2, 256, 256, "ssr", device=cuda_device))
    e = torch.tensor(1, dtype=torch.int32, device=cuda_device)
    one = torch.zeros((1, 256), device=cuda_device)
    with pytest.raises(NotImplementedError, match="takes no device index"):
        ttm.ternary_linear_apply_stacked(flat, torch.zeros((16, 256), device=cuda_device), e)
    monkeypatch.setattr(ttm, "IGATHER_FUSED", False)
    monkeypatch.setattr(ttm, "FUSED_GATHER", True)
    before = tk.ternary_matmul_gathered_idx.launches
    ttm.ternary_linear_apply_stacked(flat, one, e)
    assert tk.ternary_matmul_gathered_idx.launches == before + 1
    with pytest.raises(NotImplementedError, match="takes no device index"):
        ttm.ternary_linear_apply_stacked(flat, torch.zeros((16, 256), device=cuda_device), e)
    monkeypatch.setattr(ttm, "FUSED_GATHER", False)
    for kernel, wrapper in (("iota", tkg.onehot_gather_idx), ("packed", tkg.onehot_matmul_idx)):
        monkeypatch.setattr(tgather, "GATHER_KERNEL", kernel)
        before = (wrapper.launches, tk.ternary_matmul_idx.launches)
        ttm.ternary_linear_apply_stacked(flat, one, e)
        assert (wrapper.launches, tk.ternary_matmul_idx.launches) == (before[0] + 1,
                                                                       before[1] + 1)
    with pytest.raises(NotImplementedError, match="K5's 'rows' path takes no device index"):
        ttm.ternary_linear_apply_stacked(flat, torch.zeros((16, 256), device=cuda_device), e)
    x = torch.zeros((1, flat.packed.shape[1] * 4), device=cuda_device).bfloat16()  # K lanes
    with pytest.raises(ValueError, match="int32"):
        tk.ternary_matmul_idx(x, flat.packed, flat.alpha, flat.mu, e.long())
    with pytest.raises(ValueError, match="stack"):
        tk.ternary_matmul_idx(x, flat.packed[0], flat.alpha[0], flat.mu[0], e)


@pytest.mark.cuda
def test_device_index_outside_the_stack_traps(cuda_device, tmp_path):
    """A slot outside [0, S) stops the kernel (__trap): in a child process,
    whose CUDA context it takes down, the launch's error surfaces; nothing
    is clamped."""
    import os
    import subprocess
    import sys

    code = (
        "import sys, torch\n"
        f"sys.path.insert(0, {os.path.dirname(os.path.dirname(os.path.abspath(__file__)))!r})\n"
        "from pt2tpu_torch.ops.kernels import ternary as tk\n"
        "dev = torch.device('cuda')\n"
        "packed = torch.zeros((2, 128, 256), dtype=torch.int8, device=dev)\n"
        "alpha = torch.zeros((2, 4, 256), dtype=torch.bfloat16, device=dev)\n"
        "x = torch.ones((1, 512), device=dev).bfloat16()\n"
        "sel = torch.tensor([1], dtype=torch.int32, device=dev)\n"
        "ok = tk.ternary_matmul_idx(x, packed, alpha, alpha, sel, 0)\n"
        "torch.cuda.synchronize()\n"
        "print('slot 1 ran', flush=True)\n"
        "tk.ternary_matmul_idx(x, packed, alpha, alpha, sel, 1)\n"
        "torch.cuda.synchronize()\n"
        "print('NOT TRAPPED', flush=True)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert "slot 1 ran" in r.stdout and "NOT TRAPPED" not in r.stdout, (r.stdout, r.stderr[-2000:])
    assert r.returncode != 0


@pytest.mark.cuda
def test_moe_one_row_makes_no_host_sync_and_matches_plain(cuda_device):
    """tiny-moe's MLP at one row (the top-k plan) under
    set_sync_debug_mode("error"), and the model's greedy tokens vs the plain
    route, every K1s / K3s call held."""
    cfg = get_config("tiny-moe").with_(dim=256, n_heads=2, n_kv_heads=2, intermediate=256)
    params = random_ternary_params(cfg, seed=4, perm_mode="ssr", device=cuda_device)
    lp = tdec.layer_view(params["layers"], 1)
    h = torch.randn((1, 1, cfg.dim), device=cuda_device).bfloat16()
    want = tdec._moe_mlp(cfg, lp, h, "auto", 1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tdec._moe_mlp(cfg, lp, h, "auto", 1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got, want)
    plain = tdec._moe_mlp(cfg, lp, h, "plain", 1)
    assert (got.float() - plain.float()).abs().max() <= 2e-2 * plain.float().abs().max()
    before = (tk.ternary_matmul_idx.launches, tk.ternary_matmul_igathered_idx.launches)
    prompt = torch.randint(0, cfg.vocab_size, (1, 9), device=cuda_device)
    toks = greedy_generate(cfg, params, prompt, 6)
    assert (tk.ternary_matmul_idx.launches - before[0],
            tk.ternary_matmul_igathered_idx.launches - before[1]) == (2 * 2 * 5, 2 * 2 * 5)
    assert toks.shape == (1, 6)


# ---- K4s / K5s / K6s: the gather kernels and K6 with the slot read from
# device memory (a routed expert's projection under the gather-then-K1 and
# P2 routes)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows", [1, 4, 8, 15])
@pytest.mark.parametrize("m,K", [(4096, 4096), (200, 384)])
@pytest.mark.parametrize("first_kernel", [False, True], ids=["rows", "first"])
def test_k4s_k5s_equal_view_route(cuda_device, m, K, rows, dtype, first_kernel, monkeypatch):
    """Every slot of a (2 x 3)-slot stack: K4s (its rows path, and its first
    kernel with K4_ROWS_MIN_ROWS rebound) and K5s (its first kernel) bit for
    bit the view route's K4 / K5 and the plain versions, counted in their
    own counters only."""
    if first_kernel:
        monkeypatch.setattr(tkg, "K4_ROWS_MIN_ROWS", 1 << 30)
    g = torch.Generator(device=cuda_device).manual_seed(m + K + rows)
    perms = torch.stack([_perm(g, cuda_device, m, K, interleave=m == 200) for _ in range(6)])
    planes = torch.stack([_planes(p, m) for p in perms])
    x = torch.randn((rows, m), generator=g, device=cuda_device).to(dtype)
    sel = torch.arange(3, dtype=torch.int32, device=cuda_device)
    for s in range(6):
        e, base = sel[s % 3], 3 * (s // 3)
        before = (tkg.onehot_gather_idx.launches, tkg.onehot_gather_idx.launches_rows,
                  tkg.onehot_matmul_idx.launches, tkg.onehot_gather.launches,
                  tkg.onehot_matmul.launches)
        g4 = tkg.onehot_gather_idx(x, perms, e, base)
        g5 = tkg.onehot_matmul_idx(x, planes, e, base)
        after = (tkg.onehot_gather_idx.launches, tkg.onehot_gather_idx.launches_rows,
                 tkg.onehot_matmul_idx.launches, tkg.onehot_gather.launches,
                 tkg.onehot_matmul.launches)
        assert tuple(b - a for a, b in zip(before, after)) == (1, int(not first_kernel), 1, 0, 0)
        want = tkg.onehot_gather_plain(x, perms[s])
        assert torch.equal(_bits(g4), _bits(want))
        assert torch.equal(_bits(g5), _bits(tkg.onehot_matmul(x, planes[s])))
        assert torch.equal(_bits(g5), _bits(tkg.onehot_matmul_idx_plain(x, planes, e, base)))
        assert torch.equal(_bits(g4), _bits(tkg.onehot_gather(x, perms[s])))


@pytest.mark.cuda
@pytest.mark.parametrize("dec_a8", [False, True])
@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("rows", [1, 2, 8])
@pytest.mark.parametrize("m,n", [(4096, 1024), (384, 384)])
def test_k6s_equals_view_route(cuda_device, m, n, rows, a8, dec_a8, monkeypatch):
    """Every slot of a (2 x 3)-slot stack: K6s bit for bit K6 on the slot's
    views (its decode path, or its CUDA-core kernel for W2A8 while
    K1_DEC_A8 is off) and within TOL of its plain version, counted in its
    own counters only."""
    from pt2tpu_torch.utils.randmodel import random_expert_stack

    monkeypatch.setattr(tk, "K1_DEC_A8", dec_a8)
    g = torch.Generator(device=cuda_device).manual_seed(m + n + rows)
    flat = tdec._flatten_expert_stack(random_expert_stack(g, 2, 3, n, m, "ssr",
                                                          device=cuda_device))
    gp = flat.gather.packed
    assert gp.shape[0] == 6 and flat.packed.shape[1] * 4 == gp.shape[2]
    x = torch.randn((rows, m), generator=g, device=cuda_device).bfloat16()
    sel = torch.arange(3, dtype=torch.int32, device=cuda_device)
    dec = tk.k6_path(rows, n, 128, a8) == "dec"
    for s in range(6):
        e, base = sel[s % 3], 3 * (s // 3)
        before = (tk.ternary_matmul_gathered_idx.launches,
                  tk.ternary_matmul_gathered_idx.launches_dec,
                  tk.ternary_matmul_gathered.launches, tk.ternary_matmul.launches)
        got = tk.ternary_matmul_gathered_idx(x, gp, flat.packed, flat.alpha, flat.mu, e, base,
                                             a8=a8)
        after = (tk.ternary_matmul_gathered_idx.launches,
                 tk.ternary_matmul_gathered_idx.launches_dec,
                 tk.ternary_matmul_gathered.launches, tk.ternary_matmul.launches)
        assert tuple(b - a for a, b in zip(before, after)) == (1, int(dec), 0, 0)
        view = tk.ternary_matmul_gathered(x, gp[s], flat.packed[s], flat.alpha[s], flat.mu[s],
                                          a8=a8)
        assert torch.equal(got, view)
        want = tk.ternary_matmul_gathered_idx_plain(x, gp, flat.packed, flat.alpha, flat.mu, e,
                                                    base, a8=a8)
        assert _rel(got, want) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["auto", "a8"])
@pytest.mark.parametrize("flags", [("iota", False, False), ("packed", False, False),
                                   ("packed", False, True), ("iota", True, False)],
                         ids=["G4", "G5", "P2", "default"])
@pytest.mark.parametrize("n_out", [1024, 416])
def test_device_index_under_every_gather_route(cuda_device, flags, impl, n_out, monkeypatch):
    """One row of an "ssr" expert stack through ternary_linear_apply_stacked
    with a device index, under each flag set and at an out width K3 and K6
    take (1024) and one they refuse (416: the gather kernel then K1s): every
    slot bit for bit the host-index view route, the launches those that
    linear_route names, each once."""
    from pt2tpu_torch.utils.randmodel import random_expert_stack

    _set_flags(monkeypatch, *flags)
    g = torch.Generator(device=cuda_device).manual_seed(n_out + len(impl))
    flat = tdec._flatten_expert_stack(random_expert_stack(g, 2, 2, n_out, 512, "ssr",
                                                          device=cuda_device))
    route = ttm.linear_route(flat, 1, impl, cuda_device, device_index=True)
    assert route and all(r.endswith("_idx") for r in route)
    wrappers = {"ternary_matmul_idx": tk.ternary_matmul_idx,
                "ternary_matmul_igathered_idx": tk.ternary_matmul_igathered_idx,
                "ternary_matmul_gathered_idx": tk.ternary_matmul_gathered_idx,
                "onehot_gather_idx": tkg.onehot_gather_idx,
                "onehot_matmul_idx": tkg.onehot_matmul_idx}
    x = torch.randn((1, 512), generator=g, device=cuda_device).bfloat16()
    sel = torch.arange(2, dtype=torch.int32, device=cuda_device)
    for s in range(4):
        before = {k: w.launches for k, w in wrappers.items()}
        got = ttm.ternary_linear_apply_stacked(flat, x, sel[s % 2], impl=impl, base=2 * (s // 2),
                                               out_dtype=torch.float32)
        rose = {k: w.launches - before[k] for k, w in wrappers.items()
                if w.launches != before[k]}
        assert rose == dict.fromkeys(route, 1)
        view = ttm.ternary_linear_apply_stacked(flat, x, s, impl=impl, out_dtype=torch.float32)
        assert torch.equal(got, view)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["onehot_gather_idx", "onehot_matmul_idx",
                                   "ternary_matmul_gathered_idx"])
def test_k4s_k5s_k6s_outside_the_stack_trap(cuda_device, entry):
    """A slot outside [0, S) stops K4s, K5s and K6s (__trap), as K1s: in a
    child process, whose CUDA context it takes down; nothing is clamped."""
    import os
    import subprocess
    import sys

    call = {"onehot_gather_idx": "tkg.onehot_gather_idx(x, perm, sel, {b})",
            "onehot_matmul_idx": "tkg.onehot_matmul_idx(x, planes, sel, {b})",
            "ternary_matmul_gathered_idx":
                "tk.ternary_matmul_gathered_idx(x, planes, packed, alpha, alpha, sel, {b})"}[entry]
    code = (
        "import sys, torch\n"
        f"sys.path.insert(0, {os.path.dirname(os.path.dirname(os.path.abspath(__file__)))!r})\n"
        "from pt2tpu_torch.ops.kernels import gather as tkg, ternary as tk\n"
        "dev = torch.device('cuda')\n"
        "perm = torch.arange(512, dtype=torch.int32, device=dev).repeat(2, 1)\n"
        "planes = torch.zeros((2, 128, 512), dtype=torch.int8, device=dev)\n"
        "packed = torch.zeros((2, 128, 256), dtype=torch.int8, device=dev)\n"
        "alpha = torch.zeros((2, 4, 256), dtype=torch.bfloat16, device=dev)\n"
        "x = torch.ones((1, 512), device=dev).bfloat16()\n"
        "sel = torch.tensor([1], dtype=torch.int32, device=dev)\n"
        f"{call.format(b=0)}\n"
        "torch.cuda.synchronize()\n"
        "print('slot 1 ran', flush=True)\n"
        f"{call.format(b=1)}\n"
        "torch.cuda.synchronize()\n"
        "print('NOT TRAPPED', flush=True)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert "slot 1 ran" in r.stdout and "NOT TRAPPED" not in r.stdout, (r.stdout, r.stderr[-2000:])
    assert r.returncode != 0


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [("iota", False, False), ("packed", False, False),
                                   ("packed", False, True)], ids=["G4", "G5", "P2"])
def test_moe_one_row_under_every_gather_route(cuda_device, flags, monkeypatch):
    """tiny-moe's MLP at one row (the top-k plan) under the G4, G5 and P2
    flags: no host synchronisation (set_sync_debug_mode("error")), the
    launches of K4s / K5s / K6s and K1s the routes name, and the result
    within 2e-2 of the plain route's."""
    _set_flags(monkeypatch, *flags)
    cfg = get_config("tiny-moe").with_(dim=256, n_heads=2, n_kv_heads=2, intermediate=256)
    params = random_ternary_params(cfg, seed=4, perm_mode="ssr", device=cuda_device)
    lp = tdec.layer_view(params["layers"], 1)
    h = torch.randn((1, 1, cfg.dim), device=cuda_device).bfloat16()
    want = tdec._moe_mlp(cfg, lp, h, "auto", 1)
    torch.cuda.synchronize()
    counted = (tkg.onehot_gather_idx, tkg.onehot_matmul_idx, tk.ternary_matmul_gathered_idx,
               tk.ternary_matmul_idx, tk.ternary_matmul_igathered_idx)
    before = [w.launches for w in counted]
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tdec._moe_mlp(cfg, lp, h, "auto", 1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    rose = [w.launches - b for w, b in zip(counted, before)]
    k = cfg.experts_per_token
    want_rose = {"G4": [k, 0, 0, 2 * k, 0], "G5": [0, k, 0, 2 * k, 0],
                 "P2": [0, 0, k, k, 0]}[{("iota", False, False): "G4",
                                        ("packed", False, False): "G5"}.get(flags, "P2")]
    assert rose == want_rose
    assert torch.equal(got, want)
    plain = tdec._moe_mlp(cfg, lp, h, "plain", 1)
    assert (got.float() - plain.float()).abs().max() <= 2e-2 * plain.float().abs().max()


# ---- K2's ungated mode (gateup is up alone: mid = act(up)) on its three
# paths: the decode path (rows 1-8), the tensor-core path (rows 9-64), the
# CUDA-core kernel
def _ungated_layer(g, dev, Kg, I, n, pad_blocks=0):
    """Up (Kg lanes -> I + pad_blocks * 128, the pad columns zero-scaled, as
    pad_gateup_blocks leaves them) and down (I -> n, its blocks padded to 16)."""
    up = _layer(g, dev, Kg, I + 128 * pad_blocks, 128)
    if pad_blocks:
        up[1][:, I:] = 0
        up[2][:, I:] = 0
    nbd = -(-(I // 128 + pad_blocks) // 16) * 16
    return up + _layer(g, dev, nbd * 128, n, 128)


def _k2_all_counts():
    m = tk.ternary_mlp
    return (m.launches, m.launches_dec, m.launches_tc, m.launches_gelu, m.launches_ungated,
            tk.ternary_matmul.launches)


UNGATED_CASES = [(B, D, I, n, pad, path)
                 for B, D, I, n, pad in ((1, 512, 1024, 256, 0), (8, 512, 1024, 256, 1),
                                         (16, 256, 512, 384, 0), (64, 512, 1024, 256, 1),
                                         (4, 2048, 8192, 2048, 0))
                 for path in ("dec" if B <= 8 else "tc", "cc")]


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
@pytest.mark.parametrize("gather", [True, False], ids=["ssr", "down"])
@pytest.mark.parametrize("B,D,I,n,pad,path", UNGATED_CASES)
def test_k2_ungated_matches_plain(cuda_device, B, D, I, n, pad, path, gather, act, monkeypatch):
    """The ungated MLP on each of K2's paths (the CUDA-core kernel with the
    other two rebound away) within MLP_TOL of ternary_mlp_plain and of the
    path's own plain version, counted in launches_ungated, the same bits on
    a second call, and not the gated MLP's answer on the same planes."""
    if path == "cc":
        monkeypatch.setattr(tk, "K2_DEC_MAX_ROWS", 0)
        monkeypatch.setattr(tk, "K2_TC_MIN_ROWS", 1 << 30)
    assert tk.k2_path(B) == path
    g = torch.Generator(device=cuda_device).manual_seed(B + I + pad)
    Kg = D if gather else -(-D // 2048) * 2048
    layer = _ungated_layer(g, cuda_device, Kg, I, n, pad)
    perm = _perm(g, cuda_device, D, Kg) if gather else None
    x = torch.randn((B, D), generator=g, device=cuda_device).bfloat16()
    before = _k2_all_counts()
    got = tk.ternary_mlp(x, perm, *layer, intermediate=I, act=act)
    again = tk.ternary_mlp(x, perm, *layer, intermediate=I, act=act)
    torch.cuda.synchronize()
    assert tuple(b - a for a, b in zip(before, _k2_all_counts())) == (
        2, 2 * (path == "dec"), 2 * (path == "tc"), 2 * (act == "gelu"), 2, 0)
    assert torch.equal(got, again)
    want = tk.ternary_mlp_plain(x, perm, *layer, intermediate=I, act=act)
    assert got.shape == want.shape == (B, n) and _rel(got, want) <= MLP_TOL
    if path == "dec":
        algo = tk.ternary_mlp_dec_plain(x, perm, *layer, intermediate=I, act=act,
                                        wave=tk.dec_wave(x.device))
        assert _rel(got, algo) <= MLP_TOL
    elif path == "tc":
        algo = tk.ternary_mlp_tc_plain(x, perm, *layer, intermediate=I, act=act,
                                       wave=tk.igtc_wave(x.device))
        assert _rel(got, algo) <= MLP_TOL
    if not pad:  # the same planes read as a gated MLP of I / 2
        gated = tk.ternary_mlp_plain(x, perm, *layer, intermediate=I // 2, act=act)
        assert _rel(got, gated) > 10 * MLP_TOL


@pytest.mark.cuda
def test_fused_mlp_apply_routes_an_ungated_pair_to_k2(cuda_device):
    """fused_mlp_ok takes an ungated gateup on CUDA, as JAX's on the TPU,
    and fused_mlp_apply launches K2's ungated mode, within MLP_TOL of the
    two-call act(up) @ down."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    D, I, n = 512, 1024, 256
    gp, ga, gm, dp, da, dm = _ungated_layer(g, cuda_device, D, I, n)
    perm = _perm(g, cuda_device, D, D)
    gu = ttm.PackedTernaryLinear(packed=gp, alpha=ga, mu=gm, perm=perm, bias=None,
                                 in_features=D, gather=tgather.make_packed_gather(perm, D))
    dn = ttm.PackedTernaryLinear(packed=dp, alpha=da, mu=dm, perm=torch.arange(
        dp.shape[0] * 4, dtype=torch.int32, device=cuda_device), bias=None, in_features=I,
        input_folded=True)
    x = torch.randn((4, D), generator=g, device=cuda_device).bfloat16()
    assert ttm.fused_mlp_ok(gu, dn, "auto", 4, cuda_device)
    before = tk.ternary_mlp.launches_ungated
    got = ttm.fused_mlp_apply(gu, dn, x, "relu", out_dtype=torch.float32)
    assert tk.ternary_mlp.launches_ungated == before + 1
    up = ttm.ternary_linear_apply(gu, x, out_dtype=torch.float32)
    want = ttm.ternary_linear_apply(dn, torch.relu(up).bfloat16(), out_dtype=torch.float32)
    assert _rel(got, want) <= MLP_TOL


# ---- the floor probe (impl="floor8"): the FLOOR instances of K1, K3 and K6
# (and of K1s / K3s / K6s) on W2A8's paths, held to the floor's plain
# versions. Their integer dots are exact on both sides; the f32 epilogue
# (alpha * d + mu * S, or (mu - alpha) * S) sums in another order: 1e-5 of
# max|want|, the floor's outputs being far larger than a product's.
FLOOR_TOL = 1e-5
# llama-2-7b / llama-3-8b projections (K, n) and a ragged one (CUDA cores)
FLOOR_SHAPES = [(4096, 12288), (4096, 6144), (14336, 4096), (4096, 1024)]


def _floor_counts():
    return (tk.ternary_matmul.launches, tk.ternary_matmul.launches_floor,
            tk.ternary_matmul_igathered.launches, tk.ternary_matmul_igathered.launches_floor,
            tk.ternary_matmul_gathered.launches, tk.ternary_matmul_gathered.launches_floor)


@pytest.mark.cuda
@pytest.mark.parametrize("dec_a8", [False, True], ids=["cc", "dec"])
@pytest.mark.parametrize("rows", [1, 8, 16, 64])
@pytest.mark.parametrize("K,n", FLOOR_SHAPES)
def test_floor_k1_k3_k6_match_plain(cuda_device, K, n, rows, dec_a8, monkeypatch):
    """K1 (decode GEMV, int8 tensor cores, CUDA cores), K3 (decode GEMV,
    tensor-core product, CUDA cores) and K6 (decode, tensor-core, CUDA-core
    paths) in their FLOOR instances: each path the a8 route takes at these
    rows, one launch each, held to the floor's plain versions."""
    monkeypatch.setattr(tk, "K1_DEC_A8", dec_a8)
    g = torch.Generator(device=cuda_device).manual_seed(K + n + rows)
    packed, alpha, mu = _layer(g, cuda_device, K, n, 128)
    x = torch.randn((rows, K), generator=g, device=cuda_device).bfloat16()
    perm = _perm(g, cuda_device, K, K)
    gp = _planes(perm, K)
    c0 = _floor_counts()
    got1 = tk.ternary_matmul(x, packed, alpha, mu, a8="floor")
    got3 = tk.ternary_matmul_igathered(x, perm, packed, alpha, mu, a8="floor")
    got6 = tk.ternary_matmul_gathered(x, gp, packed, alpha, mu, a8="floor")
    torch.cuda.synchronize()
    assert tuple(b - a for a, b in zip(c0, _floor_counts())) == (1, 1, 1, 1, 1, 1)
    assert _rel(got1, tk.ternary_matmul_floor_plain(x, packed, alpha, mu)) <= FLOOR_TOL
    assert _rel(got3, tk.ternary_matmul_igathered_floor_plain(x, perm, packed, alpha, mu)) \
        <= FLOOR_TOL
    assert _rel(got6, tk.ternary_matmul_gathered_floor_plain(x, gp, packed, alpha, mu)) \
        <= FLOOR_TOL
    # the same paths as W2A8, and not its answer
    assert tk.k1_path(rows, n, 128, tk.FLOOR) == tk.k1_path(rows, n, 128, True)
    assert _rel(got1, tk.ternary_matmul(x, packed, alpha, mu, a8=True)) > 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [17, 128, 512])
def test_floor_k1_int8_tensor_cores_prefill_rows(cuda_device, rows):
    g = torch.Generator(device=cuda_device).manual_seed(rows)
    packed, alpha, mu = _layer(g, cuda_device, 4096, 4096, 128)
    x = torch.randn((rows, 4096), generator=g, device=cuda_device).bfloat16()
    assert tk.k1_path(rows, 4096, 128, tk.FLOOR) == "tc_a8"
    before = tk.ternary_matmul.launches_tc_a8
    got = tk.ternary_matmul(x, packed, alpha, mu, a8="floor")
    torch.cuda.synchronize()
    assert tk.ternary_matmul.launches_tc_a8 == before + 1
    assert _rel(got, tk.ternary_matmul_floor_plain(x, packed, alpha, mu)) <= FLOOR_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("dec_a8", [False, True], ids=["cc", "dec"])
def test_floor_device_index_entries_equal_view_route(cuda_device, dec_a8, monkeypatch):
    """K1s, K3s and K6s in their FLOOR instances give the view route's bits."""
    monkeypatch.setattr(tk, "K1_DEC_A8", dec_a8)
    g = torch.Generator(device=cuda_device).manual_seed(41)
    S, K, n = 3, 4096, 1024
    layers = [_layer(g, cuda_device, K, n, 128) for _ in range(S)]
    packed, alpha, mu = (torch.stack([l[j] for l in layers]).contiguous() for j in range(3))
    perms = torch.stack([_perm(g, cuda_device, K, K) for _ in range(S)]).contiguous()
    gps = torch.stack([_planes(perms[s], K) for s in range(S)]).contiguous()
    x = torch.randn((1, K), generator=g, device=cuda_device).bfloat16()
    sel = torch.tensor(1, dtype=torch.int32, device=cuda_device)
    for fn, args in ((tk.ternary_matmul_idx, ()), (tk.ternary_matmul_igathered_idx, (perms,)),
                     (tk.ternary_matmul_gathered_idx, (gps,))):
        before = fn.launches_floor
        got = fn(x, *args, packed, alpha, mu, sel, base=1, a8="floor")
        assert fn.launches_floor == before + 1
        view = {tk.ternary_matmul_idx: lambda: tk.ternary_matmul(
                    x, packed[2], alpha[2], mu[2], a8="floor"),
                tk.ternary_matmul_igathered_idx: lambda: tk.ternary_matmul_igathered(
                    x, perms[2], packed[2], alpha[2], mu[2], a8="floor"),
                tk.ternary_matmul_gathered_idx: lambda: tk.ternary_matmul_gathered(
                    x, gps[2], packed[2], alpha[2], mu[2], a8="floor")}[fn]()
        assert torch.equal(got, view)


@pytest.mark.cuda
@pytest.mark.parametrize("dec_a8", [False, True], ids=["cc", "dec"])
@pytest.mark.parametrize("rows", [1, 16])
def test_floor_build_failure_raises_and_counts_nothing(cuda_device, rows, dec_a8, monkeypatch):
    """No fallback for the floor either: on each path of K1, K3 and K6 (the
    CUDA cores or the decode GEMV at one row, the tensor cores at 16), a
    FLOOR call whose kernel does not build raises, and counts no launch."""
    monkeypatch.setattr(tk, "K1_DEC_A8", dec_a8)
    g = torch.Generator(device=cuda_device).manual_seed(43 + rows)
    packed, alpha, mu = _layer(g, cuda_device, 4096, 4096, 128)
    x = torch.randn((rows, 4096), generator=g, device=cuda_device).bfloat16()
    perm = _perm(g, cuda_device, 4096, 4096)
    gp = _planes(perm, 4096)

    def no_nvcc(name):
        raise RuntimeError(f"nvcc failed for {name}")

    for lib in ("_lib", "_dec_lib", "_igtc_lib", "_tc_a8_lib", "_gathered_lib",
                "_gathered_dec_lib", "_gathered_tc_lib"):
        monkeypatch.setattr(tk, lib, None)
    monkeypatch.setattr(tk._build, "load", no_nvcc)

    def counts():
        return _floor_counts() + _dec_counts() + _k3_counts() + _k6_counts()

    before = counts()
    for call in (lambda: tk.ternary_matmul(x, packed, alpha, mu, a8="floor"),
                 lambda: tk.ternary_matmul_igathered(x, perm, packed, alpha, mu, a8="floor"),
                 lambda: tk.ternary_matmul_gathered(x, gp, packed, alpha, mu, a8="floor")):
        with pytest.raises(RuntimeError, match="nvcc failed"):
            call()
    assert counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [("iota", True, False), ("packed", True, False),
                                   ("packed", False, True), ("packed", False, False)],
                         ids=["defaults", "P1", "P2", "unfused"])
@pytest.mark.parametrize("dec_a8", [False, True])
def test_floor8_model_launches_equal_a8(cuda_device, flags, dec_a8, monkeypatch):
    """A 2-layer llama-3-8b-shaped "ssr" model (narrow) decodes under floor8
    and a8 with the same launches of every kernel counter, every flag set."""
    _set_flags(monkeypatch, *flags)
    monkeypatch.setattr(tk, "K1_DEC_A8", dec_a8)
    cfg = get_config("tiny-llama-gqa").with_(n_layers=2)
    params = random_ternary_params(cfg, seed=5, perm_mode="ssr", device=cuda_device)
    prompt = torch.randint(0, cfg.vocab_size, (2, 9), device=cuda_device)
    counts = {}
    for impl in ("a8", "floor8"):
        c0 = _floor_counts()[0::2] + _dec_counts() + _k3_counts() + _k6_counts()
        greedy_generate(cfg, params, prompt, max_new=3, impl=impl)
        torch.cuda.synchronize()
        c1 = _floor_counts()[0::2] + _dec_counts() + _k3_counts() + _k6_counts()
        counts[impl] = tuple(b - a for a, b in zip(c0, c1))
    assert counts["a8"] == counts["floor8"] and sum(counts["a8"]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("tc", [True, False], ids=["tc", "cuda_core"])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("hd", [384, 512])
def test_k7_wide_heads_match_plain(cuda_device, hd, B, quant, tc, monkeypatch):
    """K7 at hd 384 and 512 on both kernels: the tensor-core kernel within a
    bf16 step of its schedule (16 / 32-position tiles there) and within
    K7's tolerance of the plain version; the CUDA-core kernel within K7's
    tolerance."""
    monkeypatch.setattr(tka, "K7_TC", tc)
    M, H, Hkv = 2048, 8, 2
    g = torch.Generator(device=cuda_device).manual_seed(hd + B + quant)
    q, k, v, valid, ks, vs = _attn_masked(g, cuda_device, B, M, H, Hkv, hd, quant, "ragged")
    before = tka.decode_attention.launches, tka.decode_attention.launches_wide
    got = tka.decode_attention(q, k, v, valid, hd ** -0.5, ks, vs)
    torch.cuda.synchronize()
    assert (tka.decode_attention.launches, tka.decode_attention.launches_wide) == (
        before[0] + 1, before[1] + 1)
    plain = tka.decode_attention_plain(q, k, v, valid, hd ** -0.5, ks, vs)
    assert got.shape == (B, 1, H, hd) and torch.isfinite(got).all()
    assert _rel(got.float(), plain.float()) <= ATTN_TOL
    if tc:
        plan = tka.k7_plan(B, M, Hkv, H // Hkv, hd, quant)
        split = tka.decode_attention_split_plain(q, k, v, valid, hd ** -0.5, ks, vs,
                                                 tile=plan.tile, splits=plan.splits)
        assert _within_a_bf16_step(got, split) <= 1e-3


@pytest.mark.cuda
def test_k7_unbuilt_width_raises(cuda_device):
    """hd 640 (no compile-time instance) launches the wide instance on
    either kernel; only a width past WIDE_MAX_HD raises, and launches
    nothing."""
    valid = torch.ones((1, 128), dtype=torch.bool, device=cuda_device)
    q = torch.zeros((1, 1, 2, 640), dtype=torch.bfloat16, device=cuda_device)
    kv = torch.zeros((1, 128, 2, 640), dtype=torch.bfloat16, device=cuda_device)
    d = tka.decode_attention
    before = d.launches_wide_rt
    out = tka.decode_attention(q, kv, kv, valid, 0.04)
    torch.cuda.synchronize()
    assert d.launches_wide_rt == before + 1 and out.abs().max().item() == 0.0
    hd = tka.WIDE_MAX_HD + 128
    q = torch.zeros((1, 1, 2, hd), dtype=torch.bfloat16, device=cuda_device)
    kv = torch.zeros((1, 128, 2, hd), dtype=torch.bfloat16, device=cuda_device)
    before = d.launches
    with pytest.raises(ValueError, match=f"hd={hd}"):
        tka.decode_attention(q, kv, kv, valid, 0.04)
    assert d.launches == before


# The wide instance (hd > 512, the width at run time): hd 640 / 768 / 1024 /
# 1152 x bf16 / int8 x rep 1 / 2 / 4 x B 1 / 8 x M 256 / 2048.
K7_WIDE_RT = (640, 768, 1024, 1152)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [256, 2048])
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("rep", [1, 2, 4])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("hd", K7_WIDE_RT)
def test_k7_wide_rt_matches_split_plain_and_plain(cuda_device, hd, quant, rep, B, M):
    """The tensor-core kernel's wide instance follows its schedule (16-position
    tiles, k7_plan's splits): within one bf16 step plus 1e-3 of the split
    plain version, within K7's 1e-2 of the plain version, and the same bits
    from run to run."""
    Hkv = 2
    H = rep * Hkv
    g = torch.Generator(device=cuda_device).manual_seed(hd + 10 * rep + B + M + quant)
    q, k, v, valid, ks, vs = _attn_masked(g, cuda_device, B, M, H, Hkv, hd, quant, "ragged")
    plan = tka.k7_plan(B, M, Hkv, rep, hd, quant)
    assert plan.tile == 16
    d = tka.decode_attention
    before = d.launches_tc, d.launches_wide_rt
    got = tka.decode_attention(q, k, v, valid, hd ** -0.5, ks, vs)
    torch.cuda.synchronize()
    assert (d.launches_tc, d.launches_wide_rt) == (before[0] + 1, before[1] + 1)
    split = tka.decode_attention_split_plain(q, k, v, valid, hd ** -0.5, ks, vs, tile=plan.tile,
                                             splits=plan.splits)
    plain = tka.decode_attention_plain(q, k, v, valid, hd ** -0.5, ks, vs)
    assert got.shape == (B, 1, H, hd) and torch.isfinite(got).all()
    assert _within_a_bf16_step(got, split) <= 1e-3
    assert _rel(got.float(), plain.float()) <= ATTN_TOL
    assert torch.equal(got, tka.decode_attention(q, k, v, valid, hd ** -0.5, ks, vs))


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("mask", K7_MASKS + ["window"])
@pytest.mark.parametrize("hd", [640, 2048])
def test_k7_wide_rt_masks(cuda_device, hd, mask, quant):
    """Every mask of the narrow instances' tests, and a sliding window's
    kv_valid (slots (p - 300, p] of each row), at the narrowest and the
    widest width of the wide instance (two chunks a warp at 2048)."""
    B, M, H, Hkv = 3, 1024, 8, 2
    g = torch.Generator(device=cuda_device).manual_seed(hd + len(mask))
    if mask == "window":
        q, k, v, _, ks, vs = _attn_inputs(g, cuda_device, B, M, H, Hkv, hd, quant)
        pos = torch.arange(M, device=cuda_device)[None, :]
        p = torch.tensor([400, 777, 1023], device=cuda_device)[:, None]
        valid = (pos <= p) & (pos > p - 300)
    else:
        q, k, v, valid, ks, vs = _attn_masked(g, cuda_device, B, M, H, Hkv, hd, quant, mask)
    plan = tka.k7_plan(B, M, Hkv, H // Hkv, hd, quant)
    got = tka.decode_attention(q, k, v, valid, hd ** -0.5, ks, vs)
    split = tka.decode_attention_split_plain(q, k, v, valid, hd ** -0.5, ks, vs, tile=plan.tile,
                                             splits=plan.splits)
    plain = tka.decode_attention_plain(q, k, v, valid, hd ** -0.5, ks, vs)
    assert torch.isfinite(got).all()
    assert _within_a_bf16_step(got, split) <= 1e-3
    assert _rel(got.float(), plain.float()) <= ATTN_TOL
    if mask == "empty_row":
        assert got[0].abs().max().item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("B,M", [(1, 256), (8, 2048)])
@pytest.mark.parametrize("hd", K7_WIDE_RT)
def test_k7_wide_rt_cuda_core_kernel(cuda_device, monkeypatch, hd, B, M, quant):
    """K7_TC off: the CUDA-core kernel's wide instance (P.V a 128-dim piece at a
    time), within K7's tolerance of the plain version."""
    monkeypatch.setattr(tka, "K7_TC", False)
    H, Hkv = 8, 2
    g = torch.Generator(device=cuda_device).manual_seed(hd + B + quant)
    q, k, v, valid, ks, vs = _attn_masked(g, cuda_device, B, M, H, Hkv, hd, quant, "ragged")
    d = tka.decode_attention
    before = d.launches, d.launches_tc, d.launches_wide_rt
    got = tka.decode_attention(q, k, v, valid, hd ** -0.5, ks, vs)
    torch.cuda.synchronize()
    assert (d.launches, d.launches_tc, d.launches_wide_rt) == (before[0] + 1, before[1],
                                                               before[2] + 1)
    plain = tka.decode_attention_plain(q, k, v, valid, hd ** -0.5, ks, vs)
    assert torch.isfinite(got).all() and _rel(got.float(), plain.float()) <= ATTN_TOL
    assert torch.equal(got, tka.decode_attention(q, k, v, valid, hd ** -0.5, ks, vs))


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("hd", [640, 1024, 2048])
def test_k7_wide_rt_occupancy_table(cuda_device, hd, quant):
    """MAX_ACTIVE_CLUSTERS_WIDE is the card's cudaOccupancyMaxActiveClusters
    for the wide instance at every cluster size (one CTA an SM, whatever
    the width)."""
    got = {s: tka.wide_max_active_clusters(2048, hd, quant, s) for s in range(1, 17)}
    assert got == tka.MAX_ACTIVE_CLUSTERS_WIDE, got


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_k7_wide_rt_from_a_cuda_graph(cuda_device, quant):
    """The wide instance reads nothing back on the host: a captured call
    replays the same bits, also after the lengths change in place."""
    B, M, H, Hkv, hd = 8, 2048, 8, 2, 1024
    g = torch.Generator(device=cuda_device).manual_seed(77 + quant)
    q, k, v, valid, ks, vs = _attn_masked(g, cuda_device, B, M, H, Hkv, hd, quant, "ragged")
    one = tka.decode_attention(q, k, v, valid, 0.03, ks, vs)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = tka.decode_attention(q, k, v, valid, 0.03, ks, vs)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, one)
    valid.copy_(torch.arange(M, device=cuda_device)[None, :] < torch.randint(
        1, M + 1, (B, 1), generator=g, device=cuda_device))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, tka.decode_attention(q, k, v, valid, 0.03, ks, vs))


@pytest.mark.cuda
def test_ring_engine_and_ring_generate_on_the_card(cuda_device, monkeypatch):
    """gemma3-4b's width and heads, 2 layers (both sliding) with the window
    cut to 128 slots so that it wraps: ring_generate and the ring engine
    launch K7 once a layer and decode step, every call over the 128-slot
    ring and within K7's tolerance of its plain version, and each answer's
    picks lie within 2e-2 of max|logit| of the flat route's teacher-forced
    plain logits."""
    from pt2tpu_torch.serve import ring as tring
    from pt2tpu_torch.serve.generate import forward_cached
    from pt2tpu_torch.serve.kvcache import init_cache

    cfg = get_config("gemma3-4b").with_(n_layers=2, sliding_window=128, vocab_size=2048)
    assert not any(cfg.globals_list())
    params = random_ternary_params(cfg, seed=11, perm_mode="down", device=cuda_device)
    slots, errs = [], []
    attn = tcommon.decode_attention

    def held(q, k, v, valid, scale, *a, **kw):
        slots.append(k.shape[1])
        got = attn(q, k, v, valid, scale, *a, **kw)
        want = tka.decode_attention_plain(q, k, v, valid, scale, *a, **kw)
        errs.append(_rel(got.float(), want.float()))
        return got

    monkeypatch.setattr(tcommon, "decode_attention", held)

    def pick_gaps(prompt, ids):
        toks = torch.as_tensor(list(prompt) + list(ids[:-1]), device=cuda_device)[None]
        with torch.inference_mode():
            cache = init_cache(cfg, 1, toks.shape[1], device=cuda_device)
            lf, _ = forward_cached(cfg, params, toks, cache, 0, "plain", all_logits=True)
        lf = lf[0, len(prompt) - 1:].float()
        picked = lf.gather(1, torch.as_tensor(ids, device=cuda_device)[:, None])[:, 0]
        return ((lf.max(1).values - picked) / lf.abs().max(1).values).max().item()

    prompt = torch.randint(0, cfg.vocab_size, (2, 150), device=cuda_device)
    before = tka.decode_attention.launches
    toks = tring.ring_generate(cfg, params, prompt, 12, max_len=256)
    assert tka.decode_attention.launches - before == 2 * 11 and set(slots) == {128}
    for b in range(2):
        assert pick_gaps(prompt[b].tolist(), toks[b].tolist()) <= 2e-2
    pf, df, fac = tring.make_ring_engine_fns(cfg, device=cuda_device)
    eng = ServeEngine(cfg, params, max_batch=4, max_len=256, prefill_fn=pf, decode_fn=df,
                      cache_factory=fac)
    prompts = [torch.randint(0, cfg.vocab_size, (n,)).numpy() for n in (200, 30, 129, 7)]
    reqs = [eng.submit(p, 10) for p in prompts]
    slots.clear()
    before = tka.decode_attention.launches
    eng.run()
    assert tka.decode_attention.launches - before == 2 * eng.stats["steps"]
    assert set(slots) == {128} and max(errs) <= ATTN_TOL
    for p, r in zip(prompts, reqs):
        assert r.done and pick_gaps(p.tolist(), r.out) <= 2e-2


# ---- K2's floor probe (fused_mlp_apply(impl="floor8"), a8 = FLOOR): each
# path's FLOOR instance (the decode path at rows 1-8, the tensor-core path
# at 9-64, the CUDA-core kernel with both rebound away) against
# ternary_mlp_floor_plain. Gate, up and down are integer block dots, exact
# on both sides; their f32 epilogues sum in other orders, and a mid that
# lands within an ulp of a half rounds apart, so K2's own MLP_TOL holds them.
K2_FLOOR_CASES = [("dec", 1), ("dec", 4), ("dec", 8), ("tc", 9), ("tc", 16), ("tc", 33),
                  ("tc", 64), ("cc", 1), ("cc", 5), ("cc", 12)]


def _floor_rows(g, dev, rows, D):
    """bf16 rows whose scales run geometrically from 8 down to 0.05 (one
    row: 8): mid ranges from the clip to small integers."""
    scale = torch.logspace(np.log10(8.0), np.log10(0.05), rows, device=dev)[:, None]
    return (torch.randn((rows, D), generator=g, device=dev) * scale).bfloat16()


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
@pytest.mark.parametrize("gated", [True, False], ids=["gated", "ungated"])
@pytest.mark.parametrize("gather", [True, False], ids=["ssr", "down"])
@pytest.mark.parametrize("path,rows", K2_FLOOR_CASES)
def test_k2_floor_instances_match_floor_plain(cuda_device, path, rows, gather, gated, act,
                                              monkeypatch):
    if path == "cc":
        monkeypatch.setattr(tk, "K2_DEC_MAX_ROWS", 0)
        monkeypatch.setattr(tk, "K2_TC_MIN_ROWS", 1 << 30)
    assert tk.k2_path(rows) == path
    D, I, n = (2048, 8192, 2048) if gated else (2048, 4096, 2048)
    g = torch.Generator(device=cuda_device).manual_seed(300 + rows + int(gather) + 2 * gated)
    layer = _mlp_layer(g, cuda_device, D, I, n) if gated else _ungated_layer(
        g, cuda_device, D, I, n)
    perm = _perm(g, cuda_device, D, D) if gather else None
    x = _floor_rows(g, cuda_device, rows, D)
    m = tk.ternary_mlp
    counts = lambda: (m.launches, m.launches_floor, m.launches_dec, m.launches_tc,  # noqa: E731
                      m.launches_ungated, tk.ternary_matmul.launches)
    before = counts()
    got = tk.ternary_mlp(x, perm, *layer, intermediate=I, act=act, a8=tk.FLOOR)
    again = tk.ternary_mlp(x, perm, *layer, intermediate=I, act=act, a8=tk.FLOOR)
    torch.cuda.synchronize()
    assert tuple(b - a for a, b in zip(before, counts())) == (
        2, 2, 2 * (path == "dec"), 2 * (path == "tc"), 2 * (not gated), 0)
    assert torch.equal(got, again)
    want = tk.ternary_mlp_floor_plain(x, perm, *layer, intermediate=I, act=act)
    assert got.shape == want.shape == (rows, n) and _rel(got, want) <= MLP_TOL
    bf16 = tk.ternary_mlp_plain(x, perm, *layer, intermediate=I, act=act)
    assert _rel(bf16, want) > 0.1  # wrong by design: the unpack is skipped


@pytest.mark.cuda
def test_fused_mlp_apply_floor8_launches_the_floor(cuda_device):
    """fused_mlp_apply(impl="floor8") runs K2's floor on a stacked layer at
    a layer index; fused_mlp_ok answers False for it (no route picks it)."""
    g = torch.Generator(device=cuda_device).manual_seed(9)
    D, I, n = 1024, 2048, 1024
    gp, ga, gm, dp, da, dm = _mlp_layer(g, cuda_device, D, I, n, L=2)
    ident = torch.arange(D, dtype=torch.int32, device=cuda_device)
    gu = ttm.PackedTernaryLinear(packed=gp, alpha=ga, mu=gm, perm=ident.expand(2, D), bias=None,
                                 in_features=D, identity_perm=True)
    dn = ttm.PackedTernaryLinear(packed=dp, alpha=da, mu=dm, perm=torch.arange(
        dp.shape[1] * 4, dtype=torch.int32, device=cuda_device).expand(2, -1), bias=None,
        in_features=I, input_folded=True)
    x = _floor_rows(g, cuda_device, 4, D)
    assert ttm.fused_mlp_ok(gu, dn, "auto", 4, cuda_device)
    assert not ttm.fused_mlp_ok(gu, dn, "floor8", 4, cuda_device)
    before = tk.ternary_mlp.launches_floor
    got = ttm.fused_mlp_apply(gu, dn, x, "silu", layer_idx=1, out_dtype=torch.float32,
                              impl="floor8")
    assert tk.ternary_mlp.launches_floor == before + 1
    want = tk.ternary_mlp_floor_plain(x, None, gp[1], ga[1], gm[1], dp[1], da[1], dm[1],
                                      intermediate=I)
    assert _rel(got, want) <= MLP_TOL


# ---- the paged KV pool (serve/paged.py): its view gathers each row's
# pages into logical order, and K7 runs on the gathered tensor as on a flat
# pool that holds the same K / V (bit for bit)
@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_paged_view_feeds_k7_as_the_flat_pool(cuda_device, quant):
    from pt2tpu_torch.serve import paged as tpaged
    from pt2tpu_torch.serve.kvcache import init_cache

    cfg = get_config("llama-3-8b").with_(n_layers=2)
    B, ps, maxp, P = 4, 64, 8, 20
    pool = tpaged.init_paged(cfg, P, ps, B, maxp, quantized=quant, device=cuda_device)
    flat = init_cache(cfg, B, maxp * ps, quantized=quant, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    perm = torch.randperm(P - 1, generator=g, device=cuda_device)[: B * 4] + 1
    pool.table[:, :4] = perm.view(B, 4).to(torch.int32)  # the rest: scratch page 0
    for leaf in pool.leaves()[:-1]:
        leaf.copy_(torch.randn(leaf.shape, generator=g, device=cuda_device).mul(40).to(leaf.dtype)
                   if leaf.dtype != torch.float32 else
                   torch.rand(leaf.shape, generator=g, device=cuda_device) * 0.02)
    view = tpaged._PagedView(pool)
    for dst, src in zip(flat.leaves(), pool.leaves()[:-1]):
        dst.copy_(src[:, pool.table.long()].reshape(dst.shape))
    positions = torch.tensor([5, 130, 255, 70], device=cuda_device)
    valid = positions[:, None] >= torch.arange(maxp * ps, device=cuda_device)[None, :]
    q = torch.randn((B, 1, cfg.n_heads, cfg.hd), generator=g, device=cuda_device).bfloat16()
    for li in range(2):
        pk, pv, pks, pvs = view.read_raw(li)
        fk, fv, fks, fvs = flat.read_raw(li)
        assert torch.equal(pk, fk) and torch.equal(pv, fv)
        before = tka.decode_attention.launches
        got = tcommon.attention(q, pk, pv, None, valid, k_scale=pks, v_scale=pvs)
        want = tcommon.attention(q, fk, fv, None, valid, k_scale=fks, v_scale=fvs)
        assert tka.decode_attention.launches == before + 2
        assert torch.equal(got, want)
    if not quant:
        assert torch.equal(view.read(0)[0], flat.read(0)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("quantum", [1, 4])
def test_paged_engine_on_the_card_equals_the_flat_engine(cuda_device, quantum):
    """A 2-layer llama-3-8b-shaped model (K7 on both pools: hd 128, M 512):
    the paged engine's tokens are the flat engine's, K7 launched once per
    layer and step on the gathered view, every page back after the drain."""
    from pt2tpu_torch.serve.paged import PagedServeEngine

    cfg = get_config("llama-3-8b").with_(n_layers=2)
    params = random_ternary_params(cfg, seed=13, perm_mode="down", device=cuda_device)
    g = torch.Generator().manual_seed(3)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g).numpy()
               for n in (70, 200, 9, 130)]

    def run(eng):
        reqs = [eng.submit(p, 20) for p in prompts]
        before = tka.decode_attention.launches
        eng.run()
        return [r.out for r in reqs], tka.decode_attention.launches - before

    flat, _ = run(ServeEngine(cfg, params, max_batch=2, max_len=512, decode_quantum=quantum))
    eng = PagedServeEngine(cfg, params, max_batch=2, max_len=512, page_size=64, kv_pages=10,
                           decode_quantum=quantum)
    paged, k7 = run(eng)
    assert paged == flat
    assert k7 == cfg.n_layers * eng.stats["steps"]
    assert sorted(eng._free) == list(range(1, 11))


# ------------------------------------------------ tensor parallelism ----
@pytest.mark.cuda
def test_tp_world_of_one_over_nccl_equals_the_single_process_port(cuda_device):
    """A one-rank NCCL world: the TP engine (its fns, ``kv_heads``,
    ``multihost``) gives the default engine's tokens, and ``tp_layer_forward``
    the single-process layer's hidden, bit for bit, on a "down" model whose
    MLP the default route does not fuse (the same kernels on both)."""
    import torch.distributed as dist

    from pt2tpu_torch.parallel import mesh as tmesh
    from pt2tpu_torch.parallel import tp as ttp

    from torch_tp_worker import _free_port

    cfg = get_config("tiny-llama").with_(dim=256, n_heads=2, n_kv_heads=1, intermediate=1024)
    params = random_ternary_params(cfg, seed=6, perm_mode="down", device=cuda_device)
    prompts = [torch.randint(0, cfg.vocab_size, (n,)).numpy() for n in (5, 40, 17, 3)]
    eng = ServeEngine(cfg, params, max_batch=3, max_len=128)
    want = [eng.submit(p, 9) for p in prompts]
    eng.run()
    assert tmesh.initialize_distributed(backend="nccl",
                                        init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                                        world_size=1, timeout_s=60) is False  # one process
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                            world_size=1)
    try:
        assert dist.get_backend() == "nccl"
        axis = tmesh.make_mesh({"data": 1, "model": 1})["model"]
        shard = ttp.shard_tp_params(ttp.prepare_tp_params(cfg, params, 1), axis)
        pf, df = ttp.make_tp_engine_fns(cfg, axis, shard)
        teng = ServeEngine(cfg, shard, max_batch=3, max_len=128, kv_heads=cfg.kv_heads,
                           prefill_fn=pf, decode_fn=df, multihost=True)
        got = [teng.submit(p, 9) for p in prompts]
        teng.run()
        assert [r.out for r in got] == [r.out for r in want]
        x = torch.randn((2, 8, cfg.dim), device=cuda_device).bfloat16()
        cos, sin, _, _ = tdec.pos_tables(cfg, 8, device=cuda_device)
        mask = tdec.build_mask(cfg, 8, 8, device=cuda_device)
        lp = tdec.layer_view(params["layers"], 0)
        lt = tdec.layer_view(shard["layers"], 0)
        with torch.inference_mode():
            a = tdec.layer_forward(cfg, lp, x, cos, sin, mask, layer_idx=0)
            b = ttp.tp_layer_forward(cfg, lt, x, cos, sin, mask, axis=axis, layer_idx=0)
        assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_tp_two_gloo_ranks_on_one_card_layer(cuda_device, tmp_path):
    """Two gloo ranks, both on cuda:0 (NCCL takes one rank a card), run
    ``tp_layer_forward`` on llama-3-8b's width ("ssr": K3 for qkv / gateup,
    K5's rows path for o's gather, K1 on the tensor cores, 16 rows): both
    ranks return the same hidden, within 1e-2 of the single-process plain
    route."""
    from torch_tp_worker import run_world

    from pt2tpu_torch.parallel.tp import _whole

    cfg = get_config("llama-3-8b").with_(n_layers=1, vocab_size=1024)
    params = random_ternary_params(cfg, seed=3, perm_mode="ssr", device="cpu")
    layer = tdec.layer_slice(params["layers"], 0)
    x = torch.randn((2, 8, cfg.dim)).bfloat16() * 0.5
    lp, xd = _whole(layer, cuda_device), x.to(cuda_device)
    cos, sin, _, _ = tdec.pos_tables(cfg, 8, device=cuda_device)
    mask = tdec.build_mask(cfg, 8, 8, device=cuda_device)
    with torch.inference_mode():
        # build the kernels here, once, before the ranks load them
        tdec.layer_forward(cfg, lp, xd, cos, sin, mask)
        tkg.onehot_matmul(torch.zeros((16, cfg.dim), dtype=torch.bfloat16, device=cuda_device),
                          lp["o"].gather.packed)
        want = tdec.layer_forward(cfg, lp, xd, cos, sin, mask, impl="plain")
    case = dict(name="layer", kind="layer", cfg=cfg, ways=2, layer=layer, x=x, device="cuda:0")
    res = run_world([case], 2, str(tmp_path), timeout_s=300)
    a, b = res[0]["layer"], res[1]["layer"]
    assert torch.equal(a, b) and torch.isfinite(a).all()
    assert _rel(a.float(), want.float().cpu()) <= ATTN_TOL
