"""Decoder-only transformer, llama family (counterpart of ``pt2tpu.models.decoder``).

Parameters keep the JAX package's layout so artifacts and tests compare like
with like: a dict whose ``"layers"`` entry holds every per-layer leaf stacked
along a leading ``n_layers`` axis. The forward is a Python loop over layers
where JAX uses ``lax.scan``; a stacked packed linear is applied to the
zero-copy view of its layer.

Only the llama family is ported: :func:`check_supported` raises
``NotImplementedError`` naming any other feature a config asks for.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.ternary_matmul import PackedTernaryLinear, fused_mlp_apply, fused_mlp_ok
from .common import DenseLinear, apply_linear, apply_rope, attention, causal_mask, rms_norm, rope_tables

__all__ = [
    "ModelConfig",
    "check_supported",
    "pos_tables",
    "embed_tokens",
    "layer_view",
    "layer_forward",
    "unembed",
    "forward",
]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters; the same fields as the JAX package's
    ModelConfig, so an artifact's ``model_config`` loads in either."""

    family: str
    vocab_size: int
    dim: int
    n_layers: int
    n_heads: int
    intermediate: int
    n_kv_heads: Optional[int] = None
    head_dim: Optional[int] = None
    max_seq_len: int = 2048
    norm: str = "rmsnorm"
    norm_eps: float = 1e-5
    pos: str = "rope"
    rope_theta: float = 10000.0
    pos_offset: int = 0
    act: str = "silu"
    gated_mlp: bool = True
    linear_bias: bool = False
    qkv_bias: bool = False
    tie_embeddings: bool = False
    embed_scale: float = 1.0
    norm_plus_one: bool = False
    embed_norm: bool = False
    qk_norm: bool = False
    sandwich_norm: bool = False
    sliding_window: int = 0
    layer_globals: Optional[Tuple[bool, ...]] = None
    rope_local_theta: Optional[float] = None
    rope_scale: float = 1.0
    rope_llama3: Optional[Tuple[float, float, float, int]] = None
    attn_scale: Optional[float] = None
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    n_experts: int = 0
    experts_per_token: int = 2
    moe_inter: Optional[int] = None
    norm_topk: bool = True

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ModelConfig":
        """Build from JSON, where tuples arrive as lists."""
        d = dict(d)
        for k in ("layer_globals", "rope_llama3"):
            if d.get(k) is not None:
                d[k] = tuple(d[k])
        return cls(**d)

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def hd(self) -> int:
        return self.head_dim or self.dim // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def has_sliding(self) -> bool:
        return self.sliding_window > 0 and (
            self.layer_globals is None or not all(self.layer_globals)
        )

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for any feature outside the llama slice."""
    missing = [
        name
        for name, bad in (
            (f"norm={cfg.norm!r}", cfg.norm != "rmsnorm"),
            (f"pos={cfg.pos!r}", cfg.pos != "rope"),
            (f"act={cfg.act!r}", cfg.act != "silu"),
            ("non-gated MLP", not cfg.gated_mlp),
            ("mixture of experts", cfg.is_moe),
            ("qk_norm", cfg.qk_norm),
            ("sandwich_norm", cfg.sandwich_norm),
            ("sliding-window attention", cfg.has_sliding),
            ("attention softcap", cfg.attn_softcap != 0.0),
            ("final softcap", cfg.final_softcap != 0.0),
            ("embed_scale", cfg.embed_scale != 1.0),
            ("norm_plus_one", cfg.norm_plus_one),
            ("embed_norm", cfg.embed_norm),
        )
        if bad
    ]
    if missing:
        raise NotImplementedError(
            f"family {cfg.family!r} needs {', '.join(missing)}: not ported "
            "(only the llama family is)"
        )


def pos_tables(cfg: ModelConfig, max_len: int, device=None):
    """RoPE (cos, sin) tables for positions [0, max_len)."""
    return rope_tables(
        cfg.hd, max_len, cfg.rope_theta, cfg.rope_scale, cfg.rope_llama3, device=device
    )


def embed_tokens(cfg: ModelConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    """(B, L) ids -> (B, L, D) hidden."""
    return F.embedding(tokens, params["embed"])


def layer_view(stacked: Dict[str, Any], li: int) -> Dict[str, Any]:
    """Layer ``li`` of the stacked layer dict: small leaves are sliced,
    stacked packed linears stay whole (applied with ``layer_idx``)."""
    out = {}
    for k, v in stacked.items():
        if v is None or isinstance(v, PackedTernaryLinear):
            out[k] = v
        elif isinstance(v, DenseLinear):
            out[k] = DenseLinear(w=v.w[li], b=None if v.b is None else v.b[li])
        else:
            out[k] = v[li]
    return out


def layer_forward(
    cfg: ModelConfig,
    lp: Dict[str, Any],
    x: torch.Tensor,  # (B, L, D)
    cos: torch.Tensor,  # (L, hd/2) or per-row (B, L, hd/2) tables
    sin: torch.Tensor,
    mask: Optional[torch.Tensor],  # (L, Lkv) additive
    cache=None,  # serve.kvcache.KVCache, updated in place at layer_idx
    cache_pos=None,  # int, or a (B,) tensor of per-row positions
    kv_valid: Optional[torch.Tensor] = None,  # (B, M) bool
    impl: str = "auto",
    layer_idx: Optional[int] = None,
) -> torch.Tensor:
    """One decoder layer. With ``cache`` the new k/v are written at
    ``cache_pos`` of layer ``layer_idx`` (one position for all rows, or a
    position per row) and attention runs over the whole cache; an int8
    cache hands its raw values and scales to attention. Without a cache,
    attention runs over the local sequence."""
    B, L, D = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.kv_heads, cfg.hd

    h = rms_norm(x, lp["ln1_w"], cfg.norm_eps)
    if lp.get("qkv") is not None:
        qkv = apply_linear(lp["qkv"], h, impl, layer_idx)
        nq, nkv = H * hd, Hkv * hd
        q = qkv[..., :nq].reshape(B, L, H, hd)
        k = qkv[..., nq : nq + nkv].reshape(B, L, Hkv, hd)
        v = qkv[..., nq + nkv :].reshape(B, L, Hkv, hd)
    else:
        q = apply_linear(lp["q"], h, impl, layer_idx).reshape(B, L, H, hd)
        k = apply_linear(lp["k"], h, impl, layer_idx).reshape(B, L, Hkv, hd)
        v = apply_linear(lp["v"], h, impl, layer_idx).reshape(B, L, Hkv, hd)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if cache is not None:
        if isinstance(cache_pos, torch.Tensor):
            cache.write_rows(layer_idx, k, v, cache_pos)
        else:
            cache.write(layer_idx, k, v, cache_pos)
        if cache.quantized:
            ck, cv, ks, vs = cache.read_raw(layer_idx)
            ctx = attention(q, ck, cv, mask, kv_valid, scale=cfg.attn_scale,
                            k_scale=ks, v_scale=vs)
        else:
            ck, cv = cache.read(layer_idx, q.dtype)
            ctx = attention(q, ck, cv, mask, kv_valid, scale=cfg.attn_scale)
    else:
        ctx = attention(q, k, v, mask, scale=cfg.attn_scale)

    x = x + apply_linear(lp["o"], ctx.reshape(B, L, H * hd), impl, layer_idx)

    h = rms_norm(x, lp["ln2_w"], cfg.norm_eps)
    I = cfg.intermediate
    if lp.get("gateup") is not None:
        if fused_mlp_ok(lp["gateup"], lp["down"], impl, B * L, h.device):
            # One launch for the whole MLP: gather + gateup + act*mul + down (K2).
            return x + fused_mlp_apply(lp["gateup"], lp["down"], h, cfg.act, layer_idx)
        gu = apply_linear(lp["gateup"], h, impl, layer_idx)
        # gate/up halves split at the STORED width: pad_gateup_blocks may
        # have widened each half past cfg.intermediate with zero columns.
        half = gu.shape[-1] // 2
        mid = F.silu(gu[..., :I]) * gu[..., half : half + I]
    else:
        mid = F.silu(apply_linear(lp["gate"], h, impl, layer_idx)) * apply_linear(
            lp["up"], h, impl, layer_idx
        )
    return x + apply_linear(lp["down"], mid, impl, layer_idx)


def unembed(cfg: ModelConfig, params, h: torch.Tensor) -> torch.Tensor:
    h = rms_norm(h, params["lnf_w"], cfg.norm_eps)
    if params.get("lm_head") is not None:
        return apply_linear(params["lm_head"], h)
    return h @ params["embed"].t().to(h.dtype)


def forward(cfg: ModelConfig, params, tokens: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """Full causal forward to logits (B, L, V), no cache."""
    check_supported(cfg)
    B, L = tokens.shape
    h = embed_tokens(cfg, params, tokens)
    mask = causal_mask(L, L, device=h.device)
    cos, sin = pos_tables(cfg, L, device=h.device)
    for li in range(cfg.n_layers):
        lp = layer_view(params["layers"], li)
        h = layer_forward(cfg, lp, h, cos, sin, mask, impl=impl, layer_idx=li)
    return unembed(cfg, params, h)
