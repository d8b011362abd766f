"""Shared building blocks of the decoder: linears, norms, RoPE, ALiBi,
attention.

Counterpart of ``pt2tpu.models.common``. Attention is plain matmul +
softmax, as the JAX package's XLA path computes it, except single-query
cache reads that K7 takes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from ..ops.kernels.attention import decode_attention, supported as decode_attention_supported
from ..ops.ternary_matmul import (
    PackedTernaryLinear,
    ternary_linear_apply,
    ternary_linear_apply_stacked,
)
from ..utils.device import quotient_f32

__all__ = [
    "DenseLinear",
    "apply_linear",
    "rms_norm",
    "layer_norm",
    "rope_tables",
    "apply_rope",
    "causal_mask",
    "attention",
    "alibi_slopes",
    "alibi_bias",
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


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, statistics in f32; the normalised x is
    rounded to x's dtype before the affine part, as in the JAX package."""
    dt = x.dtype
    x32 = x.float()
    mean = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return y.to(dt) * weight.to(dt) + bias.to(dt)


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
    """Rotate (B, L, H, hd) queries/keys with (L, hd/2) tables (shared
    positions) or (B, L, hd/2) tables (a position per row, continuous
    batching), half-split convention; the tables are cast to x's dtype
    first."""
    hd = x.shape[-1]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2 :]
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return torch.cat((x1 * c - x2 * s, x2 * c + x1 * s), dim=-1)


def causal_mask(q_len: int, kv_len: int, q_offset: int = 0, device=None) -> torch.Tensor:
    """(q_len, kv_len) additive mask: 0 where kv position <= query position."""
    q_pos = q_offset + torch.arange(q_len, device=device)[:, None]
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(kv_pos <= q_pos, zero, torch.tensor(float("-inf"), device=device))


# Route single-query cache attention through K7 (ops/kernels/attention.py)
# when the tensors lie on the card: bf16 KV (DECODE_ATTN_KERNEL) and int8 KV
# (INT8_DECODE_ATTN_KERNEL). Both are on by default in the port. The JAX
# package keeps both off, a choice made from measurements on its TPU that
# say nothing about this card; here the plain route upcasts the whole cache
# to f32 on every layer and step. Read at each call (PyTorch runs eagerly);
# ``attn_kernel=`` overrides both for one call.
DECODE_ATTN_KERNEL = True
INT8_DECODE_ATTN_KERNEL = True

# Integer-domain int8-KV attention on the plain route: q absmax-int8 so the
# score product is s8 x s8, probabilities absmax-int8 for the product with
# v (the JAX package's flag of the same name, off there and here).
INT8_INTEGER_DOMAIN = False


def _int_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An integer product, exact: f64 holds every partial sum of int8
    operands over any realistic length (JAX's s8 x s8 -> s32 einsum)."""
    return torch.einsum(eq, a.double(), b.double())


def attention(
    q: torch.Tensor,  # (B, Lq, H, hd)
    k: torch.Tensor,  # (B, Lkv, Hkv, hd): bf16 (or f32), or int8 with k_scale
    v: torch.Tensor,  # (B, Lkv, Hkv, hd)
    mask: Optional[torch.Tensor] = None,  # additive: (Lq, Lkv), (H, Lq, Lkv) or per row
    kv_valid: Optional[torch.Tensor] = None,  # (B, Lkv) bool
    scale: Optional[float] = None,  # None -> 1/sqrt(hd)
    softcap: float = 0.0,
    k_scale: Optional[torch.Tensor] = None,  # (B, Lkv, Hkv, 1) f32 int8-KV scales
    v_scale: Optional[torch.Tensor] = None,
    attn_kernel: Optional[bool] = None,  # None: the module flags decide
) -> torch.Tensor:
    """Grouped-query attention; returns (B, Lq, H, hd) in q's dtype.

    Scores and softmax in f32 (the products of bf16 operands are exact in
    f32, as the JAX einsum with an f32 result type). ``softcap`` > 0 caps the
    scores as ``softcap * tanh(s / softcap)`` before the mask (gemma2). The
    additive ``mask`` is shared (Lq, Lkv), per head (H, Lq, Lkv: ALiBi), or
    per row (B, 1, Lq, Lkv) or (B, H, Lq, Lkv). Invalid cache slots get
    ``finfo(float32).min``, not -inf; the probabilities are cast to q's dtype
    before the product with v.

    With ``k_scale``/``v_scale`` the cache is raw int8: k converts exactly
    to q's dtype and its scales multiply the f32 scores, v's scales multiply
    the probabilities (the JAX package's native int8 route).

    A single query (Lq == 1) with ``kv_valid``, no mask, no softcap, both
    scales or neither, shapes that the TPU kernel's ``supported`` accepts
    and tensors on CUDA goes to K7 when the flags (or ``attn_kernel``) say
    so; K7 raises for a head width it is not built for."""
    B, Lq, H, hd = q.shape
    Hkv = k.shape[2]
    rep = H // Hkv
    quant = k_scale is not None
    use_kernel = (
        attn_kernel
        if attn_kernel is not None
        else (DECODE_ATTN_KERNEL or (quant and INT8_DECODE_ATTN_KERNEL))
    )
    if (use_kernel and Lq == 1 and mask is None and not softcap
            and (v_scale is not None) == quant
            and q.is_cuda and kv_valid is not None
            and decode_attention_supported(k.shape[1], hd, quant)):
        s = float(scale) if scale is not None else 1.0 / float(hd) ** 0.5
        return decode_attention(q, k, v, kv_valid, s, k_scale=k_scale, v_scale=v_scale)

    qg = q.reshape(B, Lq, Hkv, rep, hd)
    # 1/sqrt(hd) rounded through f32 as in JAX (sqrt and divide in f32)
    s = scale if scale is not None else (1.0 / torch.sqrt(torch.tensor(float(hd)))).item()
    int_domain = quant and INT8_INTEGER_DOMAIN and k.dtype == torch.int8
    if int_domain:
        qf32 = qg.float()
        qs = quotient_f32(qf32.abs().amax(dim=-1, keepdim=True), 127.0).clamp_min(1e-20)
        q8 = torch.round(qf32 / qs).clamp(-127, 127)
        s32 = _int_einsum("blhrd,bmhd->bhrlm", q8, k)
        scores = s32.float() * (s * qs.permute(0, 2, 3, 1, 4))  # (B, Hkv, rep, Lq, 1)
    else:
        scores = torch.einsum("blhrd,bmhd->bhrlm", qg.float(), k.to(q.dtype).float()) * s
    if quant:
        # (B, M, Hkv, 1) -> (B, Hkv, 1, 1, M) on the f32 scores
        scores = scores * k_scale.permute(0, 2, 3, 1)[:, :, :, None, :]
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    if mask is not None:
        Lkv = k.shape[1]
        if mask.dim() == 2:
            scores = scores + mask[None, None, None, :, :]
        elif mask.dim() == 3:  # (H, Lq, Lkv)
            scores = scores + mask.reshape(Hkv, rep, Lq, Lkv)[None]
        elif mask.shape[1] == 1:  # (B, 1, Lq, Lkv): shared across heads
            scores = scores + mask[:, :, None]
        else:  # (B, H, Lq, Lkv)
            scores = scores + mask.reshape(B, Hkv, rep, Lq, Lkv)
    if kv_valid is not None:
        neg = torch.finfo(torch.float32).min
        scores = scores.masked_fill(~kv_valid[:, None, None, None, :], neg)
    probs = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        probs = probs * v_scale.permute(0, 2, 3, 1)[:, :, :, None, :]
    if int_domain and v.dtype == torch.int8:
        ps = quotient_f32(probs.amax(dim=-1, keepdim=True), 127.0).clamp_min(1e-30)
        p8 = torch.round(probs / ps)  # in [0, 127]
        c32 = _int_einsum("bhrlm,bmhd->blhrd", p8, v)
        out = c32.float() * ps.permute(0, 3, 1, 2, 4)
        return out.reshape(B, Lq, H, hd).to(q.dtype)
    out = torch.einsum("bhrlm,bmhd->blhrd", probs.to(q.dtype), v.to(q.dtype))
    return out.reshape(B, Lq, H, hd)


def alibi_slopes(n_heads: int, device=None) -> torch.Tensor:
    """ALiBi's per-head slopes (f32): a geometric sequence from 2^(-8/n) for
    the largest power of two n <= n_heads, then every other slope of the
    next power's sequence for the remaining heads (HF Bloom's
    build_alibi_tensor, the JAX package's order)."""

    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start**i) for i in range(n)]

    if math.log2(n_heads).is_integer():
        s = pow2_slopes(n_heads)
    else:
        base = 2 ** math.floor(math.log2(n_heads))
        s = pow2_slopes(base) + pow2_slopes(2 * base)[0::2][: n_heads - base]
    return torch.tensor(s, dtype=torch.float32, device=device)


def alibi_bias(n_heads: int, q_pos: torch.Tensor, kv_len: int) -> torch.Tensor:
    """Additive ALiBi bias (H, Lq, kv_len): slope_h * (k_pos - q_pos); the
    causal mask excludes k_pos > q_pos separately."""
    dev = q_pos.device
    slopes = alibi_slopes(n_heads, device=dev)
    k_pos = torch.arange(kv_len, dtype=torch.float32, device=dev)
    rel = k_pos[None, :] - q_pos.float()[:, None]  # (Lq, kv)
    return slopes[:, None, None] * rel[None, :, :]
