"""Inference-prep layout transform (``pad_gateup_blocks`` of ``pt2tpu.quant.fold``).

The quantizer and the rest of the fold module are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..ops.ternary_matmul import PackedTernaryLinear

__all__ = ["pad_gateup_blocks"]


def pad_gateup_blocks(lp: Dict[str, Any]) -> Dict[str, Any]:
    """Pad a folded gateup's gate/up halves with zero-scale columns to a
    multiple-of-8 count of 128-column blocks (llama-2-7b: 2 x 11008 ->
    2 x 11264 = 22528 lanes).

    Exact: pad columns carry alpha = mu = 0, so gate = up = 0 there. The
    decoder splits gate/up at ``out_features // 2``. Works on per-layer
    (2-D) and layer-stacked (3-D) leaves, and is idempotent.
    """
    gu, dn = lp.get("gateup"), lp.get("down")
    if lp.get("router") is not None:
        return lp
    if not (isinstance(gu, PackedTernaryLinear) and isinstance(dn, PackedTernaryLinear)):
        return lp
    if gu.packed.dim() not in (2, 3) or not dn.input_folded:
        return lp
    I = dn.in_features
    if gu.out_features != 2 * I or I % 128 != 0:
        return lp
    nv = I // 128
    nv8 = -(-nv // 8) * 8
    if nv8 == nv:
        return lp
    if nv8 * 128 > dn.packed.shape[-2] * 4:
        return lp  # down lacks the pad rows; keep the narrow layout
    pad = (nv8 - nv) * 128

    def padded(a: torch.Tensor) -> torch.Tensor:
        gate, up = a[..., :I], a[..., I:]
        return torch.cat([F.pad(gate, (0, pad)), F.pad(up, (0, pad))], dim=-1)

    lp = dict(lp)
    lp["gateup"] = dataclasses.replace(
        gu,
        packed=padded(gu.packed),
        alpha=padded(gu.alpha),
        mu=padded(gu.mu),
        bias=None if gu.bias is None else padded(gu.bias),
    )
    return lp
