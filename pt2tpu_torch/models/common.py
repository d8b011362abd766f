"""Shared building blocks of the decoder: linears, norms, RoPE, attention.

Counterpart of ``pt2tpu.models.common`` for the llama family. Attention is
plain matmul + softmax, as the JAX package's XLA path computes it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from ..ops.ternary_matmul import (
    PackedTernaryLinear,
    ternary_linear_apply,
    ternary_linear_apply_stacked,
)

__all__ = [
    "DenseLinear",
    "apply_linear",
    "rms_norm",
    "rope_tables",
    "apply_rope",
    "causal_mask",
    "attention",
]


@dataclasses.dataclass
class DenseLinear:
    """Plain (out, in) linear weights. ``y = x @ w.T + b``."""

    w: torch.Tensor  # (out_features, in_features)
    b: Optional[torch.Tensor] = None  # (out_features,)


def apply_linear(lin: Any, x: torch.Tensor, impl: str = "auto", layer_idx=None) -> torch.Tensor:
    """Dispatch on the linear container type. ``layer_idx`` selects the
    layer of a stacked packed container."""
    if isinstance(lin, PackedTernaryLinear):
        if layer_idx is not None and lin.packed.dim() == 3:
            return ternary_linear_apply_stacked(lin, x, layer_idx, impl=impl)
        return ternary_linear_apply(lin, x, impl=impl)
    y = x @ lin.w.t().to(x.dtype)
    if lin.b is not None:
        y = y + lin.b.to(x.dtype)
    return y


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * weight.to(dt)


def rope_tables(
    head_dim: int,
    max_len: int,
    theta: float = 10000.0,
    scale: float = 1.0,
    llama3: Optional[Tuple[float, float, float, int]] = None,
    device=None,
):
    """RoPE cos/sin tables: (max_len, head_dim // 2) each, f32.

    ``scale`` > 1 is linear rope scaling; ``llama3`` is the llama-3.1
    frequency warp (factor, low_freq_factor, high_freq_factor,
    original_max_position_embeddings)."""
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim)
    )
    if llama3 is not None:
        factor, low_ff, high_ff, orig_len = llama3
        wavelen = 2.0 * math.pi / inv_freq
        low_wl = orig_len / low_ff  # longest wavelength kept scaled
        high_wl = orig_len / high_ff  # shortest wavelength left alone
        smooth = (orig_len / wavelen - low_ff) / (high_ff - low_ff)
        mid = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
        inv_freq = torch.where(
            wavelen > low_wl,
            inv_freq / factor,
            torch.where(wavelen < high_wl, inv_freq, mid),
        )
    t = torch.arange(max_len, dtype=torch.float32, device=device) / scale
    freqs = torch.outer(t, inv_freq)  # (max_len, hd/2)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate (B, L, H, hd) queries/keys with (L, hd/2) tables, half-split
    convention; the tables are cast to x's dtype first."""
    hd = x.shape[-1]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2 :]
    c = cos[None, :, None, :].to(x.dtype)
    s = sin[None, :, None, :].to(x.dtype)
    return torch.cat((x1 * c - x2 * s, x2 * c + x1 * s), dim=-1)


def causal_mask(q_len: int, kv_len: int, q_offset: int = 0, device=None) -> torch.Tensor:
    """(q_len, kv_len) additive mask: 0 where kv position <= query position."""
    q_pos = q_offset + torch.arange(q_len, device=device)[:, None]
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(kv_pos <= q_pos, zero, torch.tensor(float("-inf"), device=device))


def attention(
    q: torch.Tensor,  # (B, Lq, H, hd)
    k: torch.Tensor,  # (B, Lkv, Hkv, hd)
    v: torch.Tensor,  # (B, Lkv, Hkv, hd)
    mask: Optional[torch.Tensor] = None,  # (Lq, Lkv) additive
    kv_valid: Optional[torch.Tensor] = None,  # (B, Lkv) bool
    scale: Optional[float] = None,  # None -> 1/sqrt(hd)
) -> torch.Tensor:
    """Grouped-query attention; returns (B, Lq, H, hd) in q's dtype.

    Scores and softmax in f32 (the products of bf16 operands are exact in
    f32, as the JAX einsum with an f32 result type). Invalid cache slots get
    ``finfo(float32).min``, not -inf; the probabilities are cast to q's dtype
    before the product with v."""
    B, Lq, H, hd = q.shape
    Hkv = k.shape[2]
    rep = H // Hkv
    qg = q.reshape(B, Lq, Hkv, rep, hd)
    # 1/sqrt(hd) rounded through f32 as in JAX (sqrt and divide in f32)
    s = scale if scale is not None else (1.0 / torch.sqrt(torch.tensor(float(hd)))).item()
    scores = torch.einsum("blhrd,bmhd->bhrlm", qg.float(), k.to(q.dtype).float()) * s
    if mask is not None:
        if mask.dim() != 2:
            raise NotImplementedError("only a shared (Lq, Lkv) mask is ported")
        scores = scores + mask[None, None, None, :, :]
    if kv_valid is not None:
        neg = torch.finfo(torch.float32).min
        scores = scores.masked_fill(~kv_valid[:, None, None, None, :], neg)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhrlm,bmhd->blhrd", probs, v.to(q.dtype))
    return out.reshape(B, Lq, H, hd)
