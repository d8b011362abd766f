"""SSR input gather (counterpart of ``pt2tpu.ops.gather``).

A layer quantized with SSR consumes its input in visit-lane order. Its
permutation is stored as a :class:`PackedGather`: 2-bit one-hot planes (the
artifact's bytes) plus the index vector ``perm``. On CUDA the gather runs as
kernel K4 (x[:, perm]: x's rows staged in shared memory and gathered; an
indexed load per lane for the shapes that path refuses) or K5 (x @ G over the
planes), as :data:`GATHER_KERNEL` selects (``ops/kernels/gather.py``), or fused into the
projection as K3 or K6 (``ops/ternary_matmul.py``); on the CPU it takes the
index form, as JAX does off the TPU.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from ..core.packing import pack_ternary
from .kernels.gather import (
    onehot_gather,
    onehot_gather_idx,
    onehot_gather_plain,
    onehot_matmul,
    onehot_matmul_idx,
    slot_view,
)

__all__ = ["PackedGather", "make_packed_gather", "gather_apply", "gather_kernel", "GATHER_KERNEL"]

GATHER_KERNEL = os.environ.get("PT2TPU_GATHER", "iota")
"""The CUDA gather kernel, read at each call (``pt2tpu.ops.gather``'s flag,
same variable and default): "iota" runs K4, "packed" runs K5, which streams
the packed one-hot planes."""


def gather_kernel() -> str:
    """The wrapper :data:`GATHER_KERNEL` names: "onehot_gather" (K4) or
    "onehot_matmul" (K5)."""
    if GATHER_KERNEL == "iota":
        return "onehot_gather"
    if GATHER_KERNEL == "packed":
        return "onehot_matmul"
    raise ValueError(f"GATHER_KERNEL must be 'iota' or 'packed', got {GATHER_KERNEL!r}")


@dataclasses.dataclass
class PackedGather:
    """One feature permutation, packed as 2-bit one-hot planes.

    packed: (D//4, K) int8, D = in_features padded to 128 (optionally with a
            leading stacked n_layers dim). Column k is one-hot at row
            perm[k]; all-zero for pad lanes.
    perm:   (K,) int32 visit lane -> original feature; pad lanes -> m.
    """

    packed: torch.Tensor
    perm: torch.Tensor
    in_features: int

    @property
    def out_lanes(self) -> int:
        return self.packed.shape[-1]


def make_packed_gather(perm: torch.Tensor, in_features: int) -> PackedGather:
    """Freeze a visit-lane permutation into the packed one-hot layout, on
    perm's device, with the same bytes as ``pt2tpu.ops.gather.make_packed_gather``."""
    K = perm.shape[0]
    if K % 128 != 0:
        raise ValueError(f"lane count {K} must be a multiple of 128")
    D = -(-in_features // 128) * 128
    p = perm.to(torch.long)
    # codes in {-1, 0}: the pack layout stores T + 1, so the planes hold the
    # one-hot {0, 1}. Pad lanes scatter into a spare column D that is dropped.
    col = torch.where((p >= 0) & (p < in_features), p, torch.full_like(p, D))
    codes = torch.full((K, D + 1), -1, dtype=torch.int8, device=perm.device)
    codes.scatter_(1, col[:, None], 0)
    return PackedGather(
        packed=pack_ternary(codes[:, :D], block_size=128),
        perm=perm.to(torch.int32),
        in_features=in_features,
    )


def gather_apply(g: PackedGather, x: torch.Tensor, impl: str = "auto", layer_idx=None,
                 base: int = 0) -> torch.Tensor:
    """Permute (..., m) features into visit-lane order (..., K) in x's dtype:
    on CUDA the kernel :func:`gather_kernel` names (K4 or K5), the index
    form on the CPU or with ``impl="plain"``.

    A stacked ``g`` ((S, D//4, K) planes, (S, K) perm) takes slot
    ``base + layer_idx``, as ``pt2tpu.ops.gather.gather_apply`` takes
    ``layer_idx``: a host int gathers through the zero-copy view of that
    slot; a 0-d or 1-element integer tensor on x's device (a routed
    expert's index) through the device-index entries, K4s
    (``onehot_gather_idx``) or K5s (``onehot_matmul_idx``), which read the
    slot from device memory (on CPU tensors their plain versions); with
    ``impl="plain"`` the index form takes the slot with ``index_select`` on
    the device."""
    m = x.shape[-1]
    if m != g.in_features:
        raise ValueError(f"input features {m} != gather in_features {g.in_features}")
    stacked = g.perm.dim() == 2
    if g.packed.dim() != g.perm.dim() + 1 or g.perm.dim() not in (1, 2):
        raise ValueError(f"gather leaves: planes {tuple(g.packed.shape)}, perm "
                         f"{tuple(g.perm.shape)}")
    if stacked and layer_idx is None:
        raise ValueError("a stacked gather needs layer_idx (the slot to gather through)")
    if not stacked and layer_idx is not None:
        raise ValueError("layer_idx selects a slot of a stacked gather; this one has one")
    x2 = x.reshape(-1, m)
    if not stacked or not isinstance(layer_idx, torch.Tensor):
        perm, planes = g.perm, g.packed
        if stacked:
            perm, planes = perm[base + layer_idx], planes[base + layer_idx]
        if impl == "plain" or x.device.type == "cpu":
            out = onehot_gather_plain(x2, perm)
        elif gather_kernel() == "onehot_matmul":
            out = onehot_matmul(x2, planes)
        else:
            out = onehot_gather(x2, perm)
        return out.reshape(*x.shape[:-1], out.shape[-1])
    sel = layer_idx
    if sel.numel() != 1 or sel.dtype.is_floating_point or sel.dtype == torch.bool:
        raise ValueError(f"a device index is one integer, got {sel.dtype} {tuple(sel.shape)}")
    if impl == "plain":
        out = onehot_gather_plain(x2, slot_view(g.perm, sel, base))
    else:  # the entries run their plain versions on CPU tensors
        sel32 = sel.reshape(()) if sel.dtype == torch.int32 else sel.to(torch.int32).reshape(())
        if gather_kernel() == "onehot_matmul":
            out = onehot_matmul_idx(x2, g.packed, sel32, base)
        else:
            out = onehot_gather_idx(x2, g.perm, sel32, base)
    return out.reshape(*x.shape[:-1], out.shape[-1])
