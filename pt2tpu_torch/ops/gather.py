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
from .kernels.gather import onehot_gather, onehot_gather_plain, onehot_matmul

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


def gather_apply(g: PackedGather, x: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """Permute (..., m) features into visit-lane order (..., K) in x's dtype:
    on CUDA the kernel :func:`gather_kernel` names (K4 or K5), the index
    form on the CPU or with ``impl="plain"``."""
    m = x.shape[-1]
    if m != g.in_features:
        raise ValueError(f"input features {m} != gather in_features {g.in_features}")
    if g.perm.dim() != 1 or g.packed.dim() != 2:
        raise ValueError("a stacked gather needs its layer view (PackedTernaryLinear.layer)")
    x2 = x.reshape(-1, m)
    if impl == "plain" or x.device.type == "cpu":
        out = onehot_gather_plain(x2, g.perm)
    elif gather_kernel() == "onehot_matmul":
        out = onehot_matmul(x2, g.packed)
    else:
        out = onehot_gather(x2, g.perm)
    return out.reshape(*x.shape[:-1], out.shape[-1])
