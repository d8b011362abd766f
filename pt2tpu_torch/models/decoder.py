"""Decoder-only transformer (counterpart of ``pt2tpu.models.decoder``).

Parameters keep the JAX package's layout so artifacts and tests compare like
with like: a dict whose ``"layers"`` entry holds every per-layer leaf stacked
along a leading ``n_layers`` axis. The forward is a Python loop over layers
where JAX uses ``lax.scan``; a stacked packed linear is applied to the
zero-copy view of its layer.

The port serves the llama and gemma (v1) families: RMSNorm (gemma's scales by
1 + w), RoPE, a gated MLP with silu, gelu (tanh form) or relu, a scaled
embedding and tied embeddings. :func:`check_supported` raises
``NotImplementedError`` naming any other feature a config asks for.

Dense parameters (:func:`init_params`) are the quantizer's input: the same
tree as the JAX package's, drawn from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.kernels.ternary import mlp_activation
from ..ops.gather import PackedGather
from ..ops.ternary_matmul import PackedTernaryLinear, fused_mlp_apply, fused_mlp_ok
from ..utils.device import resolve_device
from .common import DenseLinear, apply_linear, apply_rope, attention, causal_mask, rms_norm, rope_tables

__all__ = [
    "ModelConfig",
    "check_supported",
    "LINEAR_NAMES",
    "TAP_OF_LINEAR",
    "num_layer_linears",
    "init_params",
    "stack_layers",
    "layer_slice",
    "set_layer",
    "pos_tables",
    "embed_tokens",
    "layer_view",
    "LayerIO",
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
    """Raise NotImplementedError naming every feature of ``cfg`` that the
    port does not compute."""
    missing = [
        name
        for name, bad in (
            (f"norm={cfg.norm!r}", cfg.norm != "rmsnorm"),
            (f"pos={cfg.pos!r}", cfg.pos != "rope"),
            (f"act={cfg.act!r}", cfg.act not in ("silu", "gelu", "relu")),
            ("non-gated MLP", not cfg.gated_mlp),
            ("mixture of experts", cfg.is_moe),
            ("qk_norm", cfg.qk_norm),
            ("sandwich_norm", cfg.sandwich_norm),
            ("sliding-window attention", cfg.has_sliding),
            ("attention softcap", cfg.attn_softcap != 0.0),
            ("final softcap", cfg.final_softcap != 0.0),
            ("embed_norm", cfg.embed_norm),
        )
        if bad
    ]
    if missing:
        raise NotImplementedError(
            f"family {cfg.family!r} needs {', '.join(missing)}: not ported"
        )


# The seven quantizable projections of a decoder layer, each with the tap
# whose activations feed it.
LINEAR_NAMES = ("q", "k", "v", "o", "gate", "up", "down")
TAP_OF_LINEAR = {
    "q": "attn_in",
    "k": "attn_in",
    "v": "attn_in",
    "o": "o_in",
    "gate": "mlp_in",
    "up": "mlp_in",
    "down": "down_in",
}


def num_layer_linears(cfg: ModelConfig) -> int:
    return 7 if cfg.gated_mlp else 6


# ------------------------------------------------------------ params ----
def _init_linear(gen, n_out, n_in, bias, dtype, device, scale=None):
    scale = scale if scale is not None else 1.0 / math.sqrt(n_in)
    w = torch.randn((n_out, n_in), generator=gen, device=device) * scale
    b = torch.zeros((n_out,), dtype=dtype, device=device) if bias else None
    return DenseLinear(w=w.to(dtype), b=b)


def _init_layer(cfg: ModelConfig, gen, dtype, device) -> Dict[str, Any]:
    D, I = cfg.dim, cfg.intermediate
    H, Hkv, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
    qb = cfg.linear_bias or cfg.qkv_bias
    ones = lambda: torch.ones((D,), dtype=dtype, device=device)  # noqa: E731
    return {
        "ln1_w": ones(),
        "ln1_b": None,
        "q": _init_linear(gen, H * hd, D, qb, dtype, device),
        "k": _init_linear(gen, Hkv * hd, D, qb, dtype, device),
        "v": _init_linear(gen, Hkv * hd, D, qb, dtype, device),
        "o": _init_linear(gen, D, H * hd, cfg.linear_bias, dtype, device),
        "ln2_w": ones(),
        "ln2_b": None,
        "router": None,
        "gate": _init_linear(gen, I, D, cfg.linear_bias, dtype, device),
        "up": _init_linear(gen, I, D, cfg.linear_bias, dtype, device),
        "down": _init_linear(gen, D, I, cfg.linear_bias, dtype, device),
        "q_norm_w": None,
        "k_norm_w": None,
        "post_attn_w": None,
        "post_mlp_w": None,
    }


def _map(fn, *trees):
    """Apply ``fn`` leaf by leaf over same-structured layer trees (dicts of
    tensors, None, DenseLinear, PackedTernaryLinear with its PackedGather);
    the containers' static fields come from the first tree."""
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, dict):
        return {k: _map(fn, *[t[k] for t in trees]) for k in t0}
    if isinstance(t0, DenseLinear):
        return DenseLinear(w=fn(*[t.w for t in trees]),
                           b=None if t0.b is None else fn(*[t.b for t in trees]))
    if isinstance(t0, PackedGather):
        return PackedGather(packed=fn(*[t.packed for t in trees]),
                            perm=fn(*[t.perm for t in trees]), in_features=t0.in_features)
    if isinstance(t0, PackedTernaryLinear):
        return dataclasses.replace(
            t0,
            packed=fn(*[t.packed for t in trees]),
            alpha=fn(*[t.alpha for t in trees]),
            mu=fn(*[t.mu for t in trees]),
            perm=fn(*[t.perm for t in trees]),
            bias=None if t0.bias is None else fn(*[t.bias for t in trees]),
            gather=_map(fn, *[t.gather for t in trees]),
        )
    return fn(*trees)


def stack_layers(layers: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Per-layer trees -> one tree with a leading n_layers axis."""
    return _map(lambda *xs: torch.stack(xs), *layers)


def layer_slice(stacked: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i`` of the stacked tree, every leaf sliced (views)."""
    return _map(lambda x: x[i], stacked)


def set_layer(stacked: Dict[str, Any], i: int, layer: Dict[str, Any]) -> Dict[str, Any]:
    """A copy of the stacked tree with layer ``i`` replaced."""

    def put(s, l):
        s = s.clone()
        s[i] = l
        return s

    return _map(put, stacked, layer)


def init_params(cfg: ModelConfig, gen: torch.Generator, dtype=torch.float32,
                device=None) -> Dict[str, Any]:
    """Random dense parameters in the JAX package's tree (layers stacked):
    N(0, 1/in) linears, N(0, 0.02^2) embedding, unit norms. The numbers are
    drawn from ``gen`` (on ``device``, default the card); they are not the
    JAX package's ``jax.random`` numbers for the same seed, so tests carry
    JAX's weights across instead."""
    check_supported(cfg)
    dev = resolve_device(device)
    layers = [_init_layer(cfg, gen, dtype, dev) for _ in range(cfg.n_layers)]
    lm_head = (None if cfg.tie_embeddings
               else _init_linear(gen, cfg.vocab_size, cfg.dim, False, dtype, dev))
    embed = (torch.randn((cfg.vocab_size, cfg.dim), generator=gen, device=dev) * 0.02).to(dtype)
    return {
        "embed": embed,
        "emb_ln_w": None,
        "emb_ln_b": None,
        "pos_embed": None,
        "layers": stack_layers(layers),
        "lnf_w": torch.ones((cfg.dim,), dtype=dtype, device=dev),
        "lnf_b": None,
        "lm_head": lm_head,
    }


def _norm(cfg: ModelConfig, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """RMSNorm by ``w``, or by 1 + w (gemma), which ``rms_norm`` rounds to
    x's dtype before the product, as the JAX package does."""
    if cfg.norm_plus_one:
        w = 1.0 + w.float()
    return rms_norm(x, w, cfg.norm_eps)


def _act(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The MLP activation, K2's set (gelu: jax.nn.gelu's default, the tanh
    form); ValueError for any other."""
    return mlp_activation(cfg.act, x)


def pos_tables(cfg: ModelConfig, max_len: int, device=None):
    """RoPE (cos, sin) tables for positions [0, max_len)."""
    return rope_tables(
        cfg.hd, max_len, cfg.rope_theta, cfg.rope_scale, cfg.rope_llama3, device=device
    )


def embed_tokens(cfg: ModelConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    """(B, L) ids -> (B, L, D) hidden; the scale (gemma: sqrt(dim)) is
    rounded to the hidden dtype before the product, as in the JAX package."""
    h = F.embedding(tokens, params["embed"])
    if cfg.embed_scale != 1.0:
        h = h * torch.tensor(cfg.embed_scale, dtype=h.dtype, device=h.device)
    return h


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


class LayerIO(NamedTuple):
    """A layer's auxiliary outputs: the cache (updated in place, so None
    here) and the linear-input activations by tap name."""

    kv: Optional[Any]
    taps: Optional[Dict[str, torch.Tensor]]


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
    return_taps: bool = False,
):
    """One decoder layer. With ``cache`` the new k/v are written at
    ``cache_pos`` of layer ``layer_idx`` (one position for all rows, or a
    position per row) and attention runs over the whole cache; an int8
    cache hands its raw values and scales to attention. Without a cache,
    attention runs over the local sequence.

    Returns the output hidden; with ``return_taps`` (output, LayerIO) whose
    taps hold each linear's input ("attn_in", "o_in", "mlp_in",
    "down_in"), and the MLP runs its two-call form."""
    B, L, D = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
    taps: Dict[str, torch.Tensor] = {}

    h = _norm(cfg, x, lp["ln1_w"])
    if return_taps:
        taps["attn_in"] = h
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

    ctx = ctx.reshape(B, L, H * hd)
    if return_taps:
        taps["o_in"] = ctx
    x = x + apply_linear(lp["o"], ctx, impl, layer_idx)

    h = _norm(cfg, x, lp["ln2_w"])
    if return_taps:
        taps["mlp_in"] = h
    I = cfg.intermediate
    if lp.get("gateup") is not None:
        if not return_taps and fused_mlp_ok(lp["gateup"], lp["down"], impl, B * L, h.device):
            # One launch for the whole MLP: gather + gateup + act*mul + down (K2).
            return x + fused_mlp_apply(lp["gateup"], lp["down"], h, cfg.act, layer_idx)
        gu = apply_linear(lp["gateup"], h, impl, layer_idx)
        # gate/up halves split at the STORED width: pad_gateup_blocks may
        # have widened each half past cfg.intermediate with zero columns.
        half = gu.shape[-1] // 2
        mid = _act(cfg, gu[..., :I]) * gu[..., half : half + I]
    else:
        mid = _act(cfg, apply_linear(lp["gate"], h, impl, layer_idx)) * apply_linear(
            lp["up"], h, impl, layer_idx
        )
    out = x + apply_linear(lp["down"], mid, impl, layer_idx)
    if return_taps:
        taps["down_in"] = mid
        return out, LayerIO(kv=None, taps=taps)
    return out


def unembed(cfg: ModelConfig, params, h: torch.Tensor) -> torch.Tensor:
    h = _norm(cfg, h, params["lnf_w"])
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
