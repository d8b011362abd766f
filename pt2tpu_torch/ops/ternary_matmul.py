"""Packed ternary linear layers: container, packing and apply.

Counterpart of ``pt2tpu.ops.ternary_matmul``. The weights stay packed as
2-bit planes and the product consumes them directly:

    out[b, j] = sum_k  alpha[blk(k), j] * T[k, j] * x[b, perm[k]]
              + sum_blk mu[blk, j] * sum_{k in blk} x[b, perm[k]]

``impl`` selects the route of every apply:

  * ``"auto"`` — kernel K1 on CUDA (``ops/kernels/ternary.py``), its plain
    version on the CPU;
  * ``"a8"``   — the same in W2A8 mode (int8 activations);
  * ``"plain"``— the plain version on any device: an explicit choice, the
    counterpart of JAX's ``impl="xla"``, never a fallback.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from ..core.packing import pack_ternary
from .gather import PackedGather, apply_input_perm, gather_apply
from .kernels.ternary import (
    normalize_rows_a8,
    ternary_matmul,
    ternary_matmul_plain,
    ternary_matmul_plain_a8,
)

__all__ = [
    "PackedTernaryLinear",
    "make_packed_linear",
    "ternary_linear_apply",
    "ternary_linear_apply_stacked",
    "ternary_matmul_plain",
    "ternary_matmul_plain_a8",
    "normalize_rows_a8",
    "IMPLS",
]

IMPLS = ("auto", "a8", "plain")


@dataclasses.dataclass
class PackedTernaryLinear:
    """Inference-time packed parameters for one ternarized linear layer.

    Shapes (K = num_blocks * block_size lanes in visit order), optionally
    with a leading stacked n_layers dim:
      packed: (K // 4, n) int8 2-bit planes (core/packing.py layout)
      alpha:  (nb, n) scale per (block, out_feature)
      mu:     (nb, n) offset per (block, out_feature)
      perm:   (K,) int32 visit-lane -> original in_feature; pad lanes -> m
      bias:   (n,) or None
      gather: optional PackedGather (SSR layouts; CPU only in this port)
    """

    packed: torch.Tensor
    alpha: torch.Tensor
    mu: torch.Tensor
    perm: torch.Tensor
    bias: Optional[torch.Tensor]
    in_features: int
    identity_perm: bool = False
    gather: Optional[PackedGather] = None
    input_folded: bool = False
    out_folded: bool = False

    @property
    def block_size(self) -> int:
        return (self.packed.shape[-2] * 4) // self.alpha.shape[-2]

    @property
    def out_features(self) -> int:
        return self.packed.shape[-1]

    def layer(self, li: int) -> "PackedTernaryLinear":
        """Layer ``li`` of a stacked container, as zero-copy views."""
        g = self.gather
        if g is not None:
            g = PackedGather(packed=g.packed[li], perm=g.perm[li], in_features=g.in_features)
        return dataclasses.replace(
            self,
            packed=self.packed[li],
            alpha=self.alpha[li],
            mu=self.mu[li],
            perm=self.perm[li],
            bias=None if self.bias is None else self.bias[li],
            gather=g,
        )


def make_packed_linear(
    codes: torch.Tensor,  # (n, K) int8 in {-1,0,1}, visit order
    alpha: torch.Tensor,  # (nb, n)
    mu: torch.Tensor,  # (nb, n)
    perm: torch.Tensor,  # (K,)
    bias: Optional[torch.Tensor],
    in_features: int,
    block_size: int,
) -> PackedTernaryLinear:
    """Pack codes + scales (stored bf16) into the inference layout.

    The scale-block count is padded to a multiple of 16 (as the JAX package
    does for its TPU tiles, so artifacts agree). Pad blocks get zero
    alpha/mu and their perm lanes point at the zero slot (index m).
    """
    nb = alpha.shape[0]
    nbp = -(-nb // 16) * 16
    pad_blocks = nbp - nb
    if pad_blocks:
        codes = F.pad(codes, (0, pad_blocks * block_size))
        alpha = F.pad(alpha, (0, 0, 0, pad_blocks))
        mu = F.pad(mu, (0, 0, 0, pad_blocks))
        perm = F.pad(perm, (0, pad_blocks * block_size), value=in_features)
    packed = pack_ternary(codes, block_size=block_size)
    perm_h = perm.cpu()
    identity = bool(
        torch.equal(perm_h[:in_features], torch.arange(in_features, dtype=perm_h.dtype))
        and bool((perm_h[in_features:] == in_features).all())
    )
    return PackedTernaryLinear(
        packed=packed,
        alpha=alpha.to(torch.bfloat16),
        mu=mu.to(torch.bfloat16),
        perm=perm.to(torch.int32),
        bias=bias,
        in_features=in_features,
        identity_perm=identity,
    )


def _input_lanes(p: PackedTernaryLinear, x2: torch.Tensor, K: int) -> torch.Tensor:
    """Present activations in visit-lane order (B, K): fold / identity need
    only a zero pad to K; a PackedGather or a perm needs the gather."""
    m = x2.shape[-1]
    if p.identity_perm or p.input_folded:
        return x2 if K == m else F.pad(x2, (0, K - m))
    if p.gather is not None:
        return gather_apply(p.gather, x2)
    return apply_input_perm(x2, p.perm, m)


def ternary_linear_apply(
    p: PackedTernaryLinear,
    x: torch.Tensor,
    impl: str = "auto",
    out_dtype=None,
) -> torch.Tensor:
    """Full layer: input lanes -> packed product -> bias. (..., m) -> (..., n).

    The product is f32; the bias is added to it before the cast to
    ``out_dtype`` (default: x's dtype)."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    m = x.shape[-1]
    if m != p.in_features:
        raise ValueError(f"input features {m} != layer in_features {p.in_features}")
    x2 = x.reshape(-1, m)
    K = p.packed.shape[-2] * 4
    xk = _input_lanes(p, x2, K)
    bs = p.block_size
    if impl == "plain":
        out = ternary_matmul_plain(xk, p.packed, p.alpha, p.mu, bs)
    else:
        out = ternary_matmul(xk, p.packed, p.alpha, p.mu, bs, a8=impl == "a8")
    if p.bias is not None:
        out = out + p.bias.to(out.dtype)
    return out.to(out_dtype).reshape(*lead, p.out_features)


def ternary_linear_apply_stacked(
    p: PackedTernaryLinear,
    x: torch.Tensor,
    layer_idx: int,
    impl: str = "auto",
    out_dtype=None,
) -> torch.Tensor:
    """Apply layer ``layer_idx`` of a stacked container. In PyTorch the
    slice is a view, so this is :func:`ternary_linear_apply` on
    ``p.layer(layer_idx)`` — one kernel serves both cases."""
    return ternary_linear_apply(p.layer(layer_idx), x, impl=impl, out_dtype=out_dtype)
