"""The SSR input gather kernels K4 and K5: plain versions and wrappers.

  * K4 ``onehot_gather``: x[:, perm], an indexed load per lane
    (``csrc/onehot_gather.cu``; replaces
    ``pt2tpu/ops/kernels/pallas_gather.py:onehot_iota_pallas``).
  * K5 ``onehot_matmul``: x @ G with G the packed one-hot planes
    (``csrc/onehot_matmul.cu``; replaces ``onehot_matmul_pallas``).

On a CUDA tensor each wrapper launches its hand-written kernel or raises; on
a CPU tensor it runs the plain version below. There is no fallback from a
kernel to its plain version. The ``_stacked`` TPU variants collapse into
these: a stacked layer is the zero-copy view ``perm[li]`` / ``packed[li]``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["onehot_gather", "onehot_gather_plain", "onehot_matmul", "onehot_matmul_plain",
           "onehot_planes"]


def onehot_gather_plain(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Index form: out[..., k] = x[..., perm[k]], and 0 where perm[k] >= m
    (pad lanes point at m). A zero column is appended at index m, so the
    result is bit-exact in any dtype."""
    m = x.shape[-1]
    idx = perm.to(device=x.device, dtype=torch.long).clamp(max=m)
    return torch.index_select(F.pad(x, (0, 1)), -1, idx)


def onehot_planes(gpacked: torch.Tensor) -> torch.Tensor:
    """(D//4, K) int8 packed planes -> (D, K) uint8 raw 2-bit fields u, row =
    feature. Byte [blk*32 + r, k] holds the fields of features
    blk*128 + p*32 + r in bits 2p..2p+1 (the pack layout at block 128). The
    field is the stored code + 1, so a one-hot plane holds u in {0, 1}."""
    D4, K = gpacked.shape
    if D4 % 32:
        raise ValueError(f"packed one-hot rows {D4} not a multiple of 32")
    pr = gpacked.view(torch.uint8).reshape(D4 // 32, 32, K)
    return torch.cat([(pr >> (2 * p)) & 3 for p in range(4)], dim=1).reshape(D4 * 4, K)


def onehot_matmul_plain(x: torch.Tensor, gpacked: torch.Tensor) -> torch.Tensor:
    """out = x @ u: (rows, m) x (D//4, K) planes -> (rows, K) in x's dtype,
    as ``onehot_matmul_pallas`` computes it: x zero-padded from m to D
    features, a real f32 product with the raw fields u (not the {-1, 0, +1}
    codes), so it is x @ G for any planes and, for a one-hot G and finite
    x, bit-exact to the index form."""
    D = gpacked.shape[0] * 4
    m = x.shape[-1]
    if m > D:
        raise ValueError(f"x width {m} exceeds the gather's {D} features")
    u = onehot_planes(gpacked).float()
    return (F.pad(x.float(), (0, D - m)) @ u).to(x.dtype)


_lib = None
_mm_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("onehot_gather")
        fn = lib.pt2_onehot_gather
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _mm_kernel_lib():
    global _mm_lib
    if _mm_lib is None:
        lib = _build.load("onehot_matmul")
        fn = lib.pt2_onehot_matmul
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _mm_lib = lib
    return _mm_lib


def onehot_gather(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """(rows, m) x (K,) int32 perm -> (rows, K) in x's dtype.

    CUDA: launches K4 on the current stream and counts the launch in
    ``onehot_gather.launches``; x must be bf16 or f32. CPU: the plain
    version."""
    if x.device.type == "cpu":
        return onehot_gather_plain(x, perm)
    if x.device.type != "cuda":
        raise ValueError(f"no K4 for device {x.device}")
    if x.dim() != 2 or perm.dim() != 1:
        raise ValueError(f"K4 takes x (rows, m) and perm (K,), got {tuple(x.shape)}, "
                         f"{tuple(perm.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"K4 takes bf16 or f32 x, got {x.dtype}")
    if perm.dtype != torch.int32:
        raise TypeError(f"perm must be int32, got {perm.dtype}")
    if perm.device != x.device or not perm.is_contiguous():
        raise ValueError(f"perm must be contiguous on {x.device}")
    rows, m = x.shape
    K = perm.shape[0]
    x = x.contiguous()
    out = torch.empty((rows, K), dtype=x.dtype, device=x.device)
    if rows == 0 or K == 0:
        return out
    rc = _kernel_lib().pt2_onehot_gather(
        x.data_ptr(), perm.data_ptr(), out.data_ptr(), rows, m, K, x.element_size(),
        x.device.index if x.device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"K4 launch failed: cudaError {rc}")
    onehot_gather.launches += 1
    return out


onehot_gather.launches = 0


def onehot_matmul(x: torch.Tensor, gpacked: torch.Tensor) -> torch.Tensor:
    """(rows, m) x (D//4, K) int8 packed one-hot planes -> (rows, K) in x's
    dtype: x @ G.

    CUDA: launches K5 on the current stream and counts the launch in
    ``onehot_matmul.launches``; x must be bf16 or f32. CPU: the plain
    version."""
    if x.device.type == "cpu":
        return onehot_matmul_plain(x, gpacked)
    if x.device.type != "cuda":
        raise ValueError(f"no K5 for device {x.device}")
    if x.dim() != 2 or gpacked.dim() != 2:
        raise ValueError(f"K5 takes x (rows, m) and planes (D//4, K), got {tuple(x.shape)}, "
                         f"{tuple(gpacked.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"K5 takes bf16 or f32 x, got {x.dtype}")
    if gpacked.dtype != torch.int8:
        raise TypeError(f"the planes must be int8, got {gpacked.dtype}")
    if gpacked.device != x.device or not gpacked.is_contiguous() or gpacked.data_ptr() % 4:
        raise ValueError(f"the planes must be contiguous and 4-byte aligned on {x.device}")
    rows, m = x.shape
    D4, K = gpacked.shape
    if D4 % 32 or K % 128 or m > D4 * 4:
        raise ValueError(f"bad one-hot shapes: planes {tuple(gpacked.shape)} for x width {m}")
    x = x.contiguous()
    out = torch.empty((rows, K), dtype=x.dtype, device=x.device)
    if rows == 0:
        return out
    rc = _mm_kernel_lib().pt2_onehot_matmul(
        x.data_ptr(), gpacked.data_ptr(), out.data_ptr(), rows, m, D4, K, x.element_size(),
        x.device.index if x.device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"K5 launch failed: cudaError {rc}")
    onehot_matmul.launches += 1
    return out


onehot_matmul.launches = 0
