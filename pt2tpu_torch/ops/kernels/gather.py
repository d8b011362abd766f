"""K4: the SSR input gather, its plain version and its wrapper.

``onehot_gather`` is the one entry point. On a CUDA tensor it launches the
hand-written kernel in ``csrc/onehot_gather.cu`` (which replaces
``pt2tpu/ops/kernels/pallas_gather.py:onehot_iota_pallas`` and its
``_stacked`` variant: a stacked layer is the zero-copy view ``perm[li]``) or
raises; on a CPU tensor it runs the plain version below. There is no
fallback from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["onehot_gather", "onehot_gather_plain"]


def onehot_gather_plain(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Index form: out[..., k] = x[..., perm[k]], and 0 where perm[k] >= m
    (pad lanes point at m). A zero column is appended at index m, so the
    result is bit-exact in any dtype."""
    m = x.shape[-1]
    idx = perm.to(device=x.device, dtype=torch.long).clamp(max=m)
    return torch.index_select(F.pad(x, (0, 1)), -1, idx)


_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("onehot_gather")
        fn = lib.pt2_onehot_gather
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


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
