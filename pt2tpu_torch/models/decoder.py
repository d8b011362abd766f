"""Decoder-only transformer (counterpart of ``pt2tpu.models.decoder``).

Parameters keep the JAX package's layout so artifacts and tests compare like
with like: a dict whose ``"layers"`` entry holds every per-layer leaf stacked
along a leading ``n_layers`` axis. The forward is a Python loop over layers
where JAX uses ``lax.scan``; a stacked packed linear is applied to the
zero-copy view of its layer.

One implementation serves every dense family of the JAX registry; their
differences are config switches: RMSNorm (gemma's by 1 + w) or LayerNorm,
RoPE (a local base on sliding layers, linear or llama-3.1 scaling), learned
positions (OPT's offset 2) or ALiBi, a gated MLP (silu, gelu in its tanh
form, relu) or an ungated one, biases, qk-norm, sandwich norms, sliding
windows on some layers, attention and final softcaps, an embedding scale,
an embedding norm and tied embeddings. A mixture-of-experts config
(mixtral, qwen3-moe) replaces the MLP with top-k routed experts
(:func:`moe_router_weights`, :func:`_moe_mlp`): one row runs its top-k
experts, the expert index staying on the device (K1s / K3s on CUDA); more
rows run every expert weighted by its (mostly zero) routing weight, as the
JAX package does.

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
from ..ops.ternary_matmul import (
    PackedTernaryLinear,
    fused_mlp_apply,
    fused_mlp_ok,
    ternary_linear_apply_stacked,
)
from ..utils.device import resolve_device
from .common import (
    DenseLinear,
    alibi_bias,
    apply_linear,
    apply_rope,
    attention,
    causal_mask,
    layer_norm,
    rms_norm,
    rope_tables,
)

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
    "build_mask",
    "embed_tokens",
    "embed_tokens_per_row",
    "sliding_adjust",
    "layer_view",
    "moe_router_weights",
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
    def expert_inter(self) -> int:
        return self.moe_inter or self.intermediate

    @property
    def has_sliding(self) -> bool:
        return self.sliding_window > 0 and (
            self.layer_globals is None or not all(self.layer_globals)
        )

    def globals_list(self) -> Tuple[bool, ...]:
        """Per-layer is-global-attention flags (all True without sliding)."""
        if not self.has_sliding:
            return (True,) * self.n_layers
        lg = self.layer_globals or (False,) * self.n_layers
        if len(lg) != self.n_layers:
            raise ValueError(f"layer_globals has {len(lg)} entries for {self.n_layers} layers")
        return tuple(bool(g) for g in lg)

    def with_(self, **kw) -> "ModelConfig":
        """A copy with ``kw`` replaced; a new ``n_layers`` cycles the
        per-layer global/local pattern (as the JAX package does)."""
        if "n_layers" in kw and "layer_globals" not in kw and self.layer_globals is not None:
            lg = self.layer_globals
            kw["layer_globals"] = tuple(lg[i % len(lg)] for i in range(kw["n_layers"]))
        return dataclasses.replace(self, **kw)


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError naming every feature of ``cfg`` that the
    port does not compute: a norm, position encoding or activation that no
    family has."""
    missing = [
        name
        for name, bad in (
            (f"norm={cfg.norm!r}", cfg.norm not in ("rmsnorm", "layernorm")),
            (f"pos={cfg.pos!r}", cfg.pos not in ("rope", "learned", "alibi")),
            (f"act={cfg.act!r}", cfg.act not in ("silu", "gelu", "relu")),
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
    ones = lambda n=D: torch.ones((n,), dtype=dtype, device=device)  # noqa: E731
    ln_b = (lambda: torch.zeros((D,), dtype=dtype, device=device)) if cfg.norm == "layernorm" \
        else (lambda: None)
    layer = {
        "ln1_w": ones(),
        "ln1_b": ln_b(),
        "q": _init_linear(gen, H * hd, D, qb, dtype, device),
        "k": _init_linear(gen, Hkv * hd, D, qb, dtype, device),
        "v": _init_linear(gen, Hkv * hd, D, qb, dtype, device),
        "o": _init_linear(gen, D, H * hd, cfg.linear_bias, dtype, device),
        "ln2_w": ones(),
        "ln2_b": ln_b(),
    }
    if cfg.is_moe:
        # routed experts: a router and (E, out, in) weights, no bias
        # (mixtral / qwen3-moe)
        E, Ie = cfg.n_experts, cfg.expert_inter

        def experts(n_out, n_in):
            w = torch.randn((E, n_out, n_in), generator=gen, device=device) / math.sqrt(n_in)
            return DenseLinear(w=w.to(dtype))

        layer["router"] = _init_linear(gen, E, D, False, dtype, device)
        layer["gate"], layer["up"], layer["down"] = experts(Ie, D), experts(Ie, D), experts(D, Ie)
    else:
        layer["router"] = None
        layer["gate"] = (_init_linear(gen, I, D, cfg.linear_bias, dtype, device)
                         if cfg.gated_mlp else None)
        layer["up"] = _init_linear(gen, I, D, cfg.linear_bias, dtype, device)
        layer["down"] = _init_linear(gen, D, I, cfg.linear_bias, dtype, device)
    layer["q_norm_w"] = ones(hd) if cfg.qk_norm else None
    layer["k_norm_w"] = ones(hd) if cfg.qk_norm else None
    layer["post_attn_w"] = ones() if cfg.sandwich_norm else None
    layer["post_mlp_w"] = ones() if cfg.sandwich_norm else None
    return layer


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
    pos_embed = None
    if cfg.pos == "learned":
        pos_embed = (torch.randn((cfg.max_seq_len + cfg.pos_offset, cfg.dim), generator=gen,
                                 device=dev) * 0.02).to(dtype)
    zeros = lambda: torch.zeros((cfg.dim,), dtype=dtype, device=dev)  # noqa: E731
    layernorm = cfg.norm == "layernorm"
    return {
        "embed": embed,
        "emb_ln_w": torch.ones((cfg.dim,), dtype=dtype, device=dev) if cfg.embed_norm else None,
        "emb_ln_b": zeros() if (cfg.embed_norm and layernorm) else None,
        "pos_embed": pos_embed,
        "layers": stack_layers(layers),
        "lnf_w": torch.ones((cfg.dim,), dtype=dtype, device=dev),
        "lnf_b": zeros() if layernorm else None,
        "lm_head": lm_head,
    }


def _norm(cfg: ModelConfig, x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The config's norm: RMSNorm by ``w``, or by 1 + w (gemma), which
    ``rms_norm`` rounds to x's dtype before the product, as the JAX package
    does; or LayerNorm by ``w`` and ``b``."""
    if cfg.norm == "rmsnorm":
        if cfg.norm_plus_one:
            w = 1.0 + w.float()
        return rms_norm(x, w, cfg.norm_eps)
    return layer_norm(x, w, b, cfg.norm_eps)


def _head_norm(cfg: ModelConfig, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """qk-norm: RMSNorm over head_dim of (B, L, H, hd) q or k (qwen3,
    gemma3; by 1 + w where the config's norms are)."""
    if cfg.norm_plus_one:
        w = 1.0 + w.float()
    return rms_norm(x, w, cfg.norm_eps)


def _act(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The MLP activation, K2's set (gelu: jax.nn.gelu's default, the tanh
    form); ValueError for any other."""
    return mlp_activation(cfg.act, x)


def pos_tables(cfg: ModelConfig, max_len: int, device=None):
    """RoPE tables for positions [0, max_len): (cos, sin, cos_loc, sin_loc),
    the local pair being the sliding layers' tables where the config has a
    distinct local base (gemma3: theta 1e6 with linear scale 8 on global
    layers, 1e4 on local ones), else None; zeros (max_len, 1) for a config
    without RoPE."""
    if cfg.pos != "rope":
        z = torch.zeros((max_len, 1), dtype=torch.float32, device=device)
        return z, z, None, None
    cos, sin = rope_tables(
        cfg.hd, max_len, cfg.rope_theta, cfg.rope_scale, cfg.rope_llama3, device=device
    )
    if cfg.rope_local_theta is None or not cfg.has_sliding:
        return cos, sin, None, None
    cos_l, sin_l = rope_tables(cfg.hd, max_len, cfg.rope_local_theta, device=device)
    return cos, sin, cos_l, sin_l


def build_mask(cfg: ModelConfig, q_len: int, kv_len: int, q_offset: int = 0,
               device=None) -> torch.Tensor:
    """Additive attention mask: causal, plus the per-head ALiBi bias when
    ``cfg.pos == "alibi"`` (then (H, Lq, Lkv), else (Lq, Lkv))."""
    mask = causal_mask(q_len, kv_len, q_offset, device=device)
    if cfg.pos == "alibi":
        q_pos = q_offset + torch.arange(q_len, device=device)
        mask = mask[None] + alibi_bias(cfg.n_heads, q_pos, kv_len)
    return mask


def _embed_finish(cfg: ModelConfig, params, h: torch.Tensor, pos: Optional[torch.Tensor]):
    """Learned positions (``pos`` already offset) and the embedding norm."""
    if cfg.pos == "learned":
        h = h + F.embedding(pos, params["pos_embed"])
    if cfg.embed_norm:
        h = _norm(cfg, h, params["emb_ln_w"], params["emb_ln_b"])
    return h


def _scaled_embedding(cfg: ModelConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    h = F.embedding(tokens, params["embed"])
    if cfg.embed_scale != 1.0:
        h = h * torch.tensor(cfg.embed_scale, dtype=h.dtype, device=h.device)
    return h


def embed_tokens(cfg: ModelConfig, params, tokens: torch.Tensor, pos0: int = 0) -> torch.Tensor:
    """(B, L) ids at positions [pos0, pos0 + L) -> (B, L, D) hidden: the
    scale (gemma: sqrt(dim)) rounded to the hidden dtype before the product,
    as in the JAX package, learned positions (after OPT's offset) and the
    embedding norm (bloom)."""
    h = _scaled_embedding(cfg, params, tokens)
    pos = None
    if cfg.pos == "learned":
        pos = pos0 + torch.arange(tokens.shape[1], device=tokens.device)[None] + cfg.pos_offset
    return _embed_finish(cfg, params, h, pos)


def embed_tokens_per_row(cfg: ModelConfig, params, tokens: torch.Tensor,
                         positions: torch.Tensor) -> torch.Tensor:
    """The continuous-batching embed: (B,) ids at per-row ``positions`` (B,)
    -> (B, 1, D), or (B, Lw) ids at (B, Lw) positions -> (B, Lw, D); the
    same steps as :func:`embed_tokens`."""
    if tokens.dim() == 1:
        tokens, positions = tokens[:, None], positions[:, None]
    h = _scaled_embedding(cfg, params, tokens)
    return _embed_finish(cfg, params, h, positions + cfg.pos_offset)


def sliding_adjust(cfg: ModelConfig, layer_idx: Optional[int], cos, sin, cos_loc, sin_loc,
                   mask, kv_valid, cache_pos, L: int, cached: bool):
    """Fold a layer's sliding window (gemma2/3) into its attention inputs;
    nothing to do for all-global configs. Returns (cos, sin, mask, kv_valid).

    A sliding layer takes the local RoPE tables (where the config has a
    local base) and sees only the trailing ``sliding_window`` positions:
    per-row decode (``cache_pos`` a (B,) tensor, ``cached``) narrows
    ``kv_valid`` row by row; a scalar-position single-token step masked by
    ``kv_valid`` alone narrows it at ``cache_pos``; every other path adds
    the window to its shared (Lq, Lkv) mask, queries at ``cache_pos`` + i
    (0 without a cache)."""
    if not cfg.has_sliding:
        return cos, sin, mask, kv_valid
    if layer_idx is None:
        raise ValueError("sliding-window configs need layer_idx")
    if cfg.globals_list()[layer_idx]:
        return cos, sin, mask, kv_valid
    if cos_loc is not None:
        cos, sin = cos_loc, sin_loc
    W = cfg.sliding_window
    if cached and isinstance(cache_pos, torch.Tensor) and cache_pos.dim() != 0:
        if kv_valid is None:
            raise ValueError("per-row decode of a sliding-window config needs kv_valid")
        M = kv_valid.shape[-1]
        kv_pos = torch.arange(M, device=cache_pos.device)
        win_ok = kv_pos[None, :] > (cache_pos[:, None] - W)  # (B, M)
        kv_valid = kv_valid & win_ok
    elif mask is None and kv_valid is not None and L == 1 and cache_pos is not None:
        kv_pos = torch.arange(kv_valid.shape[-1], device=kv_valid.device)
        kv_valid = kv_valid & (kv_pos[None, :] > (cache_pos - W))
    else:
        if mask is None or mask.dim() != 2:
            raise ValueError("sliding-window attention needs a shared (Lq, Lkv) mask")
        q0 = cache_pos if (cached and cache_pos is not None) else 0
        q_pos = q0 + torch.arange(L, device=mask.device)
        kv_pos = torch.arange(mask.shape[-1], device=mask.device)
        neg = torch.tensor(float("-inf"), device=mask.device)
        zero = torch.zeros((), dtype=torch.float32, device=mask.device)
        mask = mask + torch.where(kv_pos[None, :] > q_pos[:, None] - W, zero, neg)
    return cos, sin, mask, kv_valid


def layer_view(stacked: Dict[str, Any], li: int) -> Dict[str, Any]:
    """Layer ``li`` of the stacked layer dict: small leaves are sliced (a
    dense (n_layers, E, ...) expert stack to its (E, ...) view), stacked
    packed linears stay whole (applied with ``layer_idx``)."""
    out = {}
    for k, v in stacked.items():
        if v is None or isinstance(v, PackedTernaryLinear):
            out[k] = v
        elif isinstance(v, DenseLinear):
            out[k] = DenseLinear(w=v.w[li], b=None if v.b is None else v.b[li])
        else:
            out[k] = v[li]
    return out


def moe_router_weights(cfg: ModelConfig, router: DenseLinear, h: torch.Tensor):
    """Top-k routing (mixtral / qwen3-moe): f32 logits h @ router^T, a
    softmax over the experts, the top ``experts_per_token`` (renormalised to
    sum 1 with ``norm_topk``). Returns (wfull, topw, topi): ``wfull`` (B, L,
    E) the combine weights (zero for the experts not picked), topw (B, L, k)
    f32 and topi (B, L, k) int32, picks in descending weight. The top k come
    from a stable descending sort, so among equal weights the lower index
    comes first, as ``lax.top_k`` orders them. Nothing is read on the host."""
    logits = h.float() @ router.w.t().float()
    probs = torch.softmax(logits, dim=-1)
    k = cfg.experts_per_token
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = vals[..., :k], order[..., :k]
    if cfg.norm_topk:
        topw = topw / topw.sum(dim=-1, keepdim=True)
    wfull = torch.zeros_like(probs).scatter(-1, topi, topw)
    return wfull, topw, topi.to(torch.int32)


def _flatten_expert_stack(p: PackedTernaryLinear) -> PackedTernaryLinear:
    """(n_layers, E, ...) expert leaves -> (n_layers * E, ...) views, so that
    slot layer * E + expert is one index into the stack. Raises where a leaf
    is not contiguous (the merge would have to copy)."""

    def flat(a):
        if not a.is_contiguous():
            raise ValueError(f"expert stack {tuple(a.shape)} is not contiguous: flattening "
                             "(n_layers, E) would copy it")
        return a.view(-1, *a.shape[2:])

    return p.map_leaves(flat)


def _moe_expert_apply(lin, x: torch.Tensor, e, layer_idx: int, n_experts: int, impl: str):
    """Expert ``e`` of one projection: a DenseLinear with (E, out, in)
    weights, or a packed stack, (E, ...) for one layer or (n_layers, E, ...)
    (then slot layer_idx * E + e). ``e`` is a host int, or a 0-d int32 tensor
    on the device (the top-k plan's pick), which no step reads on the host."""
    if isinstance(lin, PackedTernaryLinear):
        if lin.packed.dim() == 4:
            return ternary_linear_apply_stacked(_flatten_expert_stack(lin), x, e, impl=impl,
                                                base=layer_idx * n_experts)
        return ternary_linear_apply_stacked(lin, x, e, impl=impl)
    we = lin.w.index_select(0, e.reshape(1))[0] if isinstance(e, torch.Tensor) else lin.w[e]
    return x @ we.t().to(x.dtype)


def _moe_mlp(cfg: ModelConfig, lp: Dict[str, Any], h: torch.Tensor, impl: str, layer_idx: int,
             taps: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """The routed-expert MLP, out = sum_e w_e * expert_e(h), with the JAX
    package's two plans and their f32 accumulation order: one row (B * L ==
    1, decode) runs its top-k experts in pick order, each index a device
    tensor; more rows run every expert e = 0..E-1 on every row, weighted by
    its routing weight (zero where not picked). ``taps`` receives "moe_w",
    the (B, L, E) weights."""
    E, Ie = cfg.n_experts, cfg.expert_inter
    wfull, topw, topi = moe_router_weights(cfg, lp["router"], h)
    if taps is not None:
        taps["moe_w"] = wfull

    def expert_out(e):
        if lp.get("gateup") is not None:
            gu = _moe_expert_apply(lp["gateup"], h, e, layer_idx, E, impl)
            mid = _act(cfg, gu[..., :Ie]) * gu[..., Ie:]
        else:
            g = _moe_expert_apply(lp["gate"], h, e, layer_idx, E, impl)
            u = _moe_expert_apply(lp["up"], h, e, layer_idx, E, impl)
            mid = _act(cfg, g) * u
        return _moe_expert_apply(lp["down"], mid, e, layer_idx, E, impl)

    B, L, D = h.shape
    acc = torch.zeros((B, L, D), dtype=torch.float32, device=h.device)
    if B * L == 1:
        for j in range(cfg.experts_per_token):
            acc = acc + topw[0, 0, j] * expert_out(topi[0, 0, j]).float()
    else:
        for e in range(E):
            acc = acc + wfull[..., e : e + 1] * expert_out(e).float()
    return acc.to(h.dtype)


class LayerIO(NamedTuple):
    """A layer's auxiliary outputs: the cache (updated in place, so None
    here) and the linear-input activations by tap name."""

    kv: Optional[Any]
    taps: Optional[Dict[str, torch.Tensor]]


def layer_forward(
    cfg: ModelConfig,
    lp: Dict[str, Any],
    x: torch.Tensor,  # (B, L, D)
    cos: torch.Tensor,  # (L, hd/2) or per-row (B, L, hd/2) tables (RoPE only)
    sin: torch.Tensor,
    mask: Optional[torch.Tensor],  # additive: (L, Lkv), (H, L, Lkv) or per row
    cache=None,  # serve.kvcache.KVCache, updated in place at layer_idx
    cache_pos=None,  # int, or a (B,) tensor of per-row positions
    kv_valid: Optional[torch.Tensor] = None,  # (B, M) bool
    impl: str = "auto",
    layer_idx: Optional[int] = None,
    return_taps: bool = False,
    cos_loc: Optional[torch.Tensor] = None,  # sliding layers' RoPE tables (gemma3)
    sin_loc: Optional[torch.Tensor] = None,
):
    """One decoder layer. With ``cache`` the new k/v are written at
    ``cache_pos`` of layer ``layer_idx`` (one position for all rows, or a
    position per row) and attention runs over the whole cache; an int8
    cache hands its raw values and scales to attention. Without a cache,
    attention runs over the local sequence. Sliding-window configs need
    ``layer_idx``: :func:`sliding_adjust` folds the window in.

    Returns the output hidden; with ``return_taps`` (output, LayerIO) whose
    taps hold each linear's input ("attn_in", "o_in", "mlp_in",
    "down_in"), and the MLP runs its two-call form."""
    B, L, D = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
    taps: Dict[str, torch.Tensor] = {}
    cos, sin, mask, kv_valid = sliding_adjust(cfg, layer_idx, cos, sin, cos_loc, sin_loc, mask,
                                              kv_valid, cache_pos, L, cache is not None)

    h = _norm(cfg, x, lp["ln1_w"], lp.get("ln1_b"))
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
    if cfg.qk_norm:
        q = _head_norm(cfg, q, lp["q_norm_w"])
        k = _head_norm(cfg, k, lp["k_norm_w"])
    if cfg.pos == "rope":
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    kw = dict(scale=cfg.attn_scale, softcap=cfg.attn_softcap)
    if cache is not None:
        if isinstance(cache_pos, torch.Tensor):
            cache.write_rows(layer_idx, k, v, cache_pos)
        else:
            cache.write(layer_idx, k, v, cache_pos)
        if cache.quantized:
            ck, cv, ks, vs = cache.read_raw(layer_idx)
            ctx = attention(q, ck, cv, mask, kv_valid, k_scale=ks, v_scale=vs, **kw)
        else:
            ck, cv = cache.read(layer_idx, q.dtype)
            ctx = attention(q, ck, cv, mask, kv_valid, **kw)
    else:
        ctx = attention(q, k, v, mask, **kw)

    ctx = ctx.reshape(B, L, H * hd)
    if return_taps:
        taps["o_in"] = ctx
    ao = apply_linear(lp["o"], ctx, impl, layer_idx)
    if cfg.sandwich_norm:
        ao = _norm(cfg, ao, lp["post_attn_w"])
    x = x + ao

    h = _norm(cfg, x, lp["ln2_w"], lp.get("ln2_b"))
    if return_taps:
        taps["mlp_in"] = h
    if cfg.is_moe:
        mo = _moe_mlp(cfg, lp, h, impl, layer_idx or 0, taps if return_taps else None)
        if cfg.sandwich_norm:
            mo = _norm(cfg, mo, lp["post_mlp_w"])
        return (x + mo, LayerIO(kv=None, taps=taps)) if return_taps else x + mo
    I = cfg.intermediate
    if lp.get("gateup") is not None:
        if not return_taps and fused_mlp_ok(lp["gateup"], lp["down"], impl, B * L, h.device):
            # One launch for the whole MLP: gather + gateup + act*mul + down (K2).
            mo = fused_mlp_apply(lp["gateup"], lp["down"], h, cfg.act, layer_idx)
            if cfg.sandwich_norm:
                mo = _norm(cfg, mo, lp["post_mlp_w"])
            return x + mo
        gu = apply_linear(lp["gateup"], h, impl, layer_idx)
        # gate/up halves split at the STORED width: pad_gateup_blocks may
        # have widened each half past cfg.intermediate with zero columns.
        half = gu.shape[-1] // 2
        mid = _act(cfg, gu[..., :I]) * gu[..., half : half + I]
    elif cfg.gated_mlp:
        mid = _act(cfg, apply_linear(lp["gate"], h, impl, layer_idx)) * apply_linear(
            lp["up"], h, impl, layer_idx
        )
    else:
        mid = _act(cfg, apply_linear(lp["up"], h, impl, layer_idx))
    mo = apply_linear(lp["down"], mid, impl, layer_idx)
    if cfg.sandwich_norm:
        mo = _norm(cfg, mo, lp["post_mlp_w"])
    out = x + mo
    if return_taps:
        taps["down_in"] = mid
        return out, LayerIO(kv=None, taps=taps)
    return out


def unembed(cfg: ModelConfig, params, h: torch.Tensor) -> torch.Tensor:
    """Final norm, then the lm_head (or the tied embedding), then the final
    softcap c * tanh(logits / c) in f32 (gemma2)."""
    h = _norm(cfg, h, params["lnf_w"], params.get("lnf_b"))
    if params.get("lm_head") is not None:
        logits = apply_linear(params["lm_head"], h)
    else:
        logits = h @ params["embed"].t().to(h.dtype)
    if cfg.final_softcap:
        c = cfg.final_softcap
        logits = (c * torch.tanh(logits.float() / c)).to(logits.dtype)
    return logits


def forward(cfg: ModelConfig, params, tokens: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """Full causal forward to logits (B, L, V), no cache."""
    check_supported(cfg)
    B, L = tokens.shape
    dev = tokens.device
    h = embed_tokens(cfg, params, tokens)
    mask = build_mask(cfg, L, L, device=dev)
    cos, sin, cos_l, sin_l = pos_tables(cfg, L, device=dev)
    for li in range(cfg.n_layers):
        lp = layer_view(params["layers"], li)
        h = layer_forward(cfg, lp, h, cos, sin, mask, impl=impl, layer_idx=li,
                          cos_loc=cos_l, sin_loc=sin_l)
    return unembed(cfg, params, h)
