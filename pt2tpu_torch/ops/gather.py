"""SSR input gather (counterpart of ``pt2tpu.ops.gather``).

A layer quantized with SSR consumes its input in visit-lane order. Its
permutation is stored as a :class:`PackedGather`: 2-bit one-hot planes (the
artifact's bytes, which the JAX package's TPU kernel K5 streams) plus the
index vector ``perm``. On CUDA the gather runs as kernel K4
(``ops/kernels/gather.py``, an indexed load per lane) or fused into the
projection as K3; on the CPU it takes the index form, as JAX does off the
TPU.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.packing import pack_ternary
from .kernels.gather import onehot_gather, onehot_gather_plain

__all__ = ["PackedGather", "make_packed_gather", "gather_apply"]


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
    """Permute (..., m) features into visit-lane order (..., K): K4 on CUDA,
    the index form on the CPU or with ``impl="plain"``."""
    m = x.shape[-1]
    if m != g.in_features:
        raise ValueError(f"input features {m} != gather in_features {g.in_features}")
    if g.perm.dim() != 1:
        raise ValueError("a stacked gather needs its layer view (PackedTernaryLinear.layer)")
    fn = onehot_gather_plain if impl == "plain" else onehot_gather
    out = fn(x.reshape(-1, m), g.perm)
    return out.reshape(*x.shape[:-1], out.shape[-1])
