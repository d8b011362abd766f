"""K1: the fused 2-bit unpack + matmul, its plain version and its wrapper.

``ternary_matmul`` is the one entry point. On a CUDA tensor it launches the
hand-written kernel in ``csrc/ternary_matmul.cu`` (which replaces
``pt2tpu/ops/kernels/pallas_ternary.py:ternary_matmul_pallas`` and its
``_stacked`` variant: a stacked layer is the zero-copy view ``packed[li]``)
or raises; on a CPU tensor it runs the plain version below. There is no
fallback from the kernel to the plain version.

The plain version repeats ``pt2tpu.ops.ternary_matmul.ternary_matmul_xla``:
unpack, one product per scale block, then the scales, all in f32.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ...core.packing import unpack_ternary
from . import _build

__all__ = [
    "ternary_matmul",
    "ternary_matmul_plain",
    "ternary_matmul_plain_a8",
    "normalize_rows_a8",
]


def normalize_rows_a8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row absmax normalisation for W2A8: x ~= x_norm * sx with
    |x_norm| <= 127. x_norm is cast to bf16 BEFORE the kernel rounds it to
    int8 (as pallas_ternary.normalize_rows_a8 does)."""
    x32 = x.float()
    sx = x32.abs().amax(dim=-1, keepdim=True) / 127.0
    sx = sx.clamp_min(1e-12)
    return (x32 / sx).to(torch.bfloat16), sx


def ternary_matmul_plain(
    x: torch.Tensor,  # (B, K) activations in visit-lane order
    packed: torch.Tensor,  # (K//4, n) int8 planes
    alpha: torch.Tensor,  # (nb, n)
    mu: torch.Tensor,  # (nb, n)
    block_size: int = 128,
) -> torch.Tensor:
    """out = x @ (alpha * T + mu), blockwise, in f32. Returns (B, n) f32."""
    K4, n = packed.shape
    K = K4 * 4
    nb = K // block_size
    B = x.shape[0]
    T = unpack_ternary(packed, block_size).float().reshape(nb, block_size, n)
    xb = x.float().reshape(B, nb, block_size)
    t = torch.einsum("bkc,kcn->bkn", xb, T)  # per-block code products
    s = xb.sum(dim=2)  # (B, nb)
    out = torch.einsum("bkn,kn->bn", t, alpha.float())
    return out + s @ mu.float()


def ternary_matmul_plain_a8(
    x: torch.Tensor,
    packed: torch.Tensor,
    alpha: torch.Tensor,
    mu: torch.Tensor,
    block_size: int = 128,
) -> torch.Tensor:
    """W2A8 emulation (``ternary_matmul_xla_a8``): bf16-normalised rows,
    round half-to-even to int8, integer-valued products, output times sx."""
    xn, sx = normalize_rows_a8(x)
    xq = torch.clamp(torch.round(xn.float()), -127, 127)
    return ternary_matmul_plain(xq, packed, alpha, mu, block_size) * sx


_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("ternary_matmul")
        fn = lib.pt2_ternary_matmul
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(x, packed, alpha, mu, block_size):
    K4, n = packed.shape
    K = K4 * 4
    nb = alpha.shape[0]
    dev = x.device
    for name, t in (("packed", packed), ("alpha", alpha), ("mu", mu)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if packed.dtype != torch.int8:
        raise TypeError(f"packed must be int8, got {packed.dtype}")
    if alpha.dtype != torch.bfloat16 or mu.dtype != torch.bfloat16:
        raise TypeError(f"the kernel takes bf16 scales, got {alpha.dtype}/{mu.dtype}")
    if x.dim() != 2 or x.shape[1] != K:
        raise ValueError(f"x {tuple(x.shape)} does not match packed {tuple(packed.shape)}")
    if tuple(alpha.shape) != (nb, n) or tuple(mu.shape) != (nb, n) or nb * block_size != K:
        raise ValueError(
            f"bad shapes: packed {tuple(packed.shape)}, alpha {tuple(alpha.shape)}, "
            f"mu {tuple(mu.shape)}, block_size {block_size}"
        )
    if block_size % 4 or not 16 <= block_size <= 2048:
        raise ValueError(f"the kernel takes block sizes 16..2048 divisible by 4, got {block_size}")
    if n % 32:
        raise ValueError(f"the kernel takes out_features divisible by 32, got {n}")
    if packed.data_ptr() % 4:
        raise ValueError("packed must be 4-byte aligned")


def ternary_matmul(
    x: torch.Tensor,
    packed: torch.Tensor,
    alpha: torch.Tensor,
    mu: torch.Tensor,
    block_size: int = 128,
    a8: bool = False,
) -> torch.Tensor:
    """out = x @ dequant(packed, alpha, mu): (B, K) x (K//4, n) -> (B, n) f32.

    CUDA: launches K1 on the current stream (x cast to bf16, or normalised
    for W2A8) and counts the launch in ``ternary_matmul.launches``. CPU:
    the plain version, with x as given (f32 compute, as JAX on the CPU).
    """
    if x.device.type == "cpu":
        fn = ternary_matmul_plain_a8 if a8 else ternary_matmul_plain
        return fn(x, packed, alpha, mu, block_size)
    if x.device.type != "cuda":
        raise ValueError(f"no K1 for device {x.device}")
    _check(x, packed, alpha, mu, block_size)
    B, K = x.shape
    n = packed.shape[1]
    if a8:
        xk, sx = normalize_rows_a8(x)
    else:
        xk = x.to(torch.bfloat16)
    xk = xk.contiguous()
    out = torch.empty((B, n), dtype=torch.float32, device=x.device)
    if B == 0:
        return out
    rc = _kernel_lib().pt2_ternary_matmul(
        xk.data_ptr(), packed.data_ptr(), alpha.data_ptr(), mu.data_ptr(),
        out.data_ptr(), B, K, n, block_size, int(bool(a8)),
        x.device.index if x.device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {rc}")
    ternary_matmul.launches += 1
    return out * sx if a8 else out


ternary_matmul.launches = 0
