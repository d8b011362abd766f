"""Manual tensor parallelism on ``torch.distributed``: the counterpart of
``pt2tpu/parallel/tp.py``.

JAX runs one program inside ``shard_map`` over the mesh's 'model' axis;
here each rank is a process with its own device, holding its shard of the
weights, and the collectives are explicit calls on the axis' process group
(:class:`..parallel.mesh.Axis`). The placement is JAX's (Megatron, with the
activations' collectives written out):

- qkv / gateup (and an ungated ``up``) are column-parallel. Their output
  lanes are relabelled shard-major at prepare time (:func:`shard_major_qkv`,
  :func:`shard_major_gateup`: a free permutation of columns), so a
  contiguous lane shard gives a rank whole heads of q, k and v and matched
  gate / up pairs. They run through ``apply_linear``'s route on the rank's
  columns (K3 for a gathered projection at decode rows, K4 / K5 + K1, or
  K1), on the replicated activation;
- attention is local to the rank's heads (K7 on the card at decode), with
  ALiBi's per-head bias sliced to them, and the KV cache holds only the
  rank's KV heads;
- o / down are row-parallel: the contraction lanes (packed rows and scale
  blocks) are cut into contiguous shards. A rank carves its lanes out of the
  ``all_gather``-ed activation, through its slice of the gather's planes
  (K5, as JAX's Pallas route, never K4 or K3) or a plain lane slice, then
  runs K1 per output chunk and issues each chunk's ``all_reduce`` before
  the next chunk's product (JAX's overlap);
- the MLP runs unfused, as JAX's does (K2 is not on this path).

Collectives: NCCL where every rank has its own card; gloo otherwise (gloo
takes CUDA tensors in ``broadcast`` and ``all_reduce`` only, so an
``all_gather`` over gloo is an ``all_reduce`` of a zero-padded buffer: each
rank writes its slice and zeros elsewhere, which sums to the gathered
tensor exactly).

:func:`shard_tp_params` takes the place of JAX's ``tp_param_specs`` /
``tp_layer_specs``: it cuts one rank's shard out of prepared params and puts
it on the rank's device. :func:`make_tp_engine_fns` gives the engine's
``prefill_fn`` / ``decode_fn`` on the rank's shard; the rank's engine pool
has its local KV heads (``ServeEngine(kv_heads=...)``), and with
``multihost=True`` rank 0 plans the admissions for every rank.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models import decoder as dec
from ..models.common import alibi_slopes, apply_linear, attention
from ..ops.gather import PackedGather
from ..ops.kernels.gather import onehot_gather_plain, onehot_matmul
from ..ops.kernels.ternary import ternary_matmul, ternary_matmul_plain
from ..ops.ternary_matmul import PackedTernaryLinear
from ..serve.kvcache import init_cache
from ..serve.sampling import sample_per_row
from .mesh import Axis

__all__ = [
    "tp_row_apply",
    "tp_layer_forward",
    "prepare_tp_layer",
    "prepare_tp_params",
    "shard_major_qkv",
    "shard_major_gateup",
    "shard_tp_layer",
    "shard_tp_params",
    "tp_generate",
    "make_tp_engine_fns",
    "collective_stats",
]

_COL = ("qkv", "gateup", "up")
_ROW = ("o", "down")

# What the collectives of this module did in this process: calls, and the
# host seconds spent issuing them and waiting for them (an all_reduce issued
# async counts its issue and its wait, not the product it overlaps).
collective_stats = {"all_reduce": 0, "all_gather": 0, "seconds": 0.0}


# ---------------------------------------------------------- collectives ----
def _gloo(axis: Axis) -> bool:
    return axis.backend == "gloo"


def _all_reduce(t: torch.Tensor, axis: Axis, async_op: bool = False):
    """Sum ``t`` in place over the axis (a Work to wait on with
    ``async_op``; None on an axis of one rank)."""
    if axis.size == 1:
        return None
    collective_stats["all_reduce"] += 1
    t0 = time.perf_counter()
    work = dist.all_reduce(t, group=axis.group, async_op=async_op)
    collective_stats["seconds"] += time.perf_counter() - t0
    return work


def _all_gather_last(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Concatenate every rank's ``x`` along the last dim, in axis order."""
    if axis.size == 1:
        return x
    collective_stats["all_gather"] += 1
    n = x.shape[-1]
    t0 = time.perf_counter()
    if _gloo(axis):
        out = torch.zeros((*x.shape[:-1], axis.size * n), dtype=x.dtype, device=x.device)
        out[..., axis.rank * n : (axis.rank + 1) * n] = x
        dist.all_reduce(out, group=axis.group)
    else:
        parts = torch.empty((axis.size, *x.shape), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(parts, x.contiguous(), group=axis.group)
        out = torch.cat(list(parts.unbind(0)), dim=-1)
    collective_stats["seconds"] += time.perf_counter() - t0
    return out


# --------------------------------------------------------------- apply ----
def _row_view(p: PackedTernaryLinear, layer_idx) -> PackedTernaryLinear:
    return p.layer(layer_idx) if p.packed.dim() == 3 else p


def tp_row_apply(
    p: PackedTernaryLinear,  # this rank's row shard (shard_tp_params)
    x_full: torch.Tensor,  # (..., m) the FULL activation (replicated / all-gathered)
    axis: Axis,
    chunks: int = 2,
    impl: str = "auto",
    layer_idx: Optional[int] = None,  # the layer of a stacked shard
) -> torch.Tensor:
    """Row-parallel packed ternary product with a chunked, overlapped sum.

    The rank's K_local visit lanes come from ``x_full`` through its slice of
    the one-hot gather's planes (K5 on the card: x @ G; its plain version
    on the CPU, or the index form with ``impl="plain"``) or a plain lane
    slice (identity / folded perms; pad blocks read zeros). The output
    features are computed in ``chunks`` groups of whole 128-lane tiles (K1
    each), and each group's ``all_reduce`` is issued before the next
    group's product. A stacked shard takes one group (a column slice of the
    stack would copy it), as JAX's does."""
    lead = x_full.shape[:-1]
    x2 = x_full.reshape(-1, x_full.shape[-1])
    stacked = p.packed.dim() == 3
    q = _row_view(p, layer_idx) if stacked else p
    K_local = q.packed.shape[-2] * 4
    if q.gather is not None:
        if impl == "plain":
            perm = q.gather.perm
            xk = onehot_gather_plain(x2, perm[axis.rank * K_local : (axis.rank + 1) * K_local])
        else:
            xk = onehot_matmul(x2, q.gather.packed)
    else:
        pad = axis.size * K_local - x2.shape[-1]
        x_pad = F.pad(x2, (0, pad)) if pad else x2
        xk = x_pad[:, axis.rank * K_local : (axis.rank + 1) * K_local].contiguous()

    n, bs = q.out_features, q.block_size
    if stacked:
        chunks = 1
    chunks = next((c for c in range(min(chunks, n // 128), 1, -1)
                   if n % c == 0 and (n // c) % 128 == 0), 1)
    step = n // chunks
    outs, works = [], []
    for c in range(chunks):
        if chunks == 1:
            pk, al, mu = q.packed, q.alpha, q.mu
        else:
            sl = slice(c * step, (c + 1) * step)
            pk, al, mu = (t[:, sl].contiguous() for t in (q.packed, q.alpha, q.mu))
        if impl == "plain":
            part = ternary_matmul_plain(xk, pk, al, mu, bs)
        else:
            part = ternary_matmul(xk, pk, al, mu, bs)
        works.append(_all_reduce(part, axis, async_op=True))  # overlaps the next chunk
        outs.append(part)
    t0 = time.perf_counter()
    for w in works:
        if w is not None:
            w.wait()
    collective_stats["seconds"] += time.perf_counter() - t0
    out = torch.cat(outs, dim=-1) if chunks > 1 else outs[0]
    if q.bias is not None:
        out = out + q.bias.to(out.dtype)
    return out.to(x_full.dtype).reshape(*lead, n)


# ------------------------------------------------------------- forward ----
def tp_layer_forward(
    cfg: dec.ModelConfig,
    lp: Dict[str, Any],  # this rank's layer (shard_tp_params; layer_view)
    x: torch.Tensor,  # (B, L, D) replicated hidden
    cos: torch.Tensor,
    sin: torch.Tensor,
    mask: Optional[torch.Tensor],
    cache=None,  # the rank's bf16 KVCache (its local kv heads), written in place
    cache_pos=None,
    kv_valid: Optional[torch.Tensor] = None,
    axis: Optional[Axis] = None,
    chunks: int = 2,
    impl: str = "auto",
    layer_idx: Optional[int] = None,
    cos_loc: Optional[torch.Tensor] = None,
    sin_loc: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One decoder layer on this rank's shard; every rank returns the same
    hidden. With ``cache`` the rank writes and reads only its own KV heads.
    The whole dense surface of JAX's: gated MLPs (norm_plus_one, the
    activation, qk-norm, sandwich norms, attention scale / softcap, sliding
    windows and the local RoPE tables) and ungated ones (a plain
    column-parallel ``up``, LayerNorm biases, ALiBi's per-head bias sliced
    to the rank's heads). The per-head and (D,) norms are replicated."""
    ways = axis.size
    H = cfg.n_heads // ways
    Hkv = cfg.kv_heads // ways
    hd = cfg.hd
    B, L, D = x.shape
    cos, sin, mask, kv_valid = dec.sliding_adjust(cfg, layer_idx, cos, sin, cos_loc, sin_loc,
                                                  mask, kv_valid, cache_pos, L, cache is not None)
    h0 = axis.rank * H
    if mask is not None and mask.dim() == 3 and mask.shape[0] == cfg.n_heads:
        mask = mask[h0 : h0 + H]  # ALiBi's (H, Lq, Lkv): this rank's heads
    elif mask is not None and mask.dim() == 4 and mask.shape[1] == cfg.n_heads:
        mask = mask[:, h0 : h0 + H]  # the engine's per-row (B, H, 1, M)

    h = dec._norm(cfg, x, lp["ln1_w"], lp.get("ln1_b"))
    qkv = apply_linear(lp["qkv"], h, impl, layer_idx)  # columns: this rank's heads
    nq, nkv = H * hd, Hkv * hd
    q = qkv[..., :nq].reshape(B, L, H, hd)
    k = qkv[..., nq : nq + nkv].reshape(B, L, Hkv, hd)
    v = qkv[..., nq + nkv :].reshape(B, L, Hkv, hd)
    if cfg.qk_norm:
        q = dec._head_norm(cfg, q, lp["q_norm_w"])
        k = dec._head_norm(cfg, k, lp["k_norm_w"])
    if cfg.pos == "rope":
        q = dec.apply_rope(q, cos, sin)
        k = dec.apply_rope(k, cos, sin)
    kw = dict(scale=cfg.attn_scale, softcap=cfg.attn_softcap)
    if cache is not None:
        if isinstance(cache_pos, torch.Tensor):
            cache.write_rows(layer_idx, k, v, cache_pos)
        else:
            cache.write(layer_idx, k, v, cache_pos)
        ck, cv = cache.read(layer_idx, q.dtype)  # a bf16 cache (an int8 one raises)
        ctx = attention(q, ck, cv, mask, kv_valid, **kw)
    else:
        ctx = attention(q, k, v, mask, **kw)
    # the full ctx for the row-parallel o (whose gather spans every head)
    ctx_full = _all_gather_last(ctx.reshape(B, L, H * hd), axis)
    ao = tp_row_apply(lp["o"], ctx_full, axis, chunks, impl, layer_idx)
    if cfg.sandwich_norm:
        ao = dec._norm(cfg, ao, lp["post_attn_w"])
    x = x + ao

    h = dec._norm(cfg, x, lp["ln2_w"], lp.get("ln2_b"))
    if lp.get("gateup") is not None:
        gu = apply_linear(lp["gateup"], h, impl, layer_idx)  # columns: [gate_r | up_r]
        i_loc = gu.shape[-1] // 2
        mid = dec._act(cfg, gu[..., :i_loc]) * gu[..., i_loc:]
    else:  # ungated (opt / gpt2 / bloom): a plain column-parallel fc1
        mid = dec._act(cfg, apply_linear(lp["up"], h, impl, layer_idx))
    mid_full = _all_gather_last(mid, axis)
    mo = tp_row_apply(lp["down"], mid_full, axis, chunks, impl, layer_idx)
    if cfg.sandwich_norm:
        mo = dec._norm(cfg, mo, lp["post_mlp_w"])
    return x + mo


# ------------------------------------------------------------- prepare ----
def _permute_lanes(p: PackedTernaryLinear, sigma: np.ndarray) -> PackedTernaryLinear:
    idx = torch.as_tensor(sigma, dtype=torch.long, device=p.packed.device)
    pick = lambda t: t.index_select(-1, idx)  # noqa: E731
    return dataclasses.replace(p, packed=pick(p.packed), alpha=pick(p.alpha), mu=pick(p.mu),
                               bias=None if p.bias is None else pick(p.bias))


def shard_major_qkv(p: PackedTernaryLinear, cfg: dec.ModelConfig, ways: int):
    """Reorder the fused qkv lanes [q | k | v] to [q_0 | k_0 | v_0 | q_1 | ...]
    so that a contiguous lane shard gives each rank whole heads of q, k and
    v (JAX's lane order)."""
    H, Hkv, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
    nq, nkv = H * hd, Hkv * hd
    idx = []
    for s in range(ways):
        idx.append(np.arange(s * nq // ways, (s + 1) * nq // ways))
        idx.append(nq + np.arange(s * nkv // ways, (s + 1) * nkv // ways))
        idx.append(nq + nkv + np.arange(s * nkv // ways, (s + 1) * nkv // ways))
    return _permute_lanes(p, np.concatenate(idx))


def shard_major_gateup(p: PackedTernaryLinear, intermediate: int, ways: int):
    """[gate | up] -> [gate_0 | up_0 | gate_1 | ...]: matched act(gate) * up
    pairs on each rank. The halves split at the STORED width (padded
    halves pair pad with pad, whose product is an exact zero), as JAX's."""
    I = p.out_features // 2
    if I % ways:
        raise ValueError(f"stored gate half {I} not divisible by ways={ways}")
    idx = []
    for s in range(ways):
        idx.append(np.arange(s * I // ways, (s + 1) * I // ways))
        idx.append(I + np.arange(s * I // ways, (s + 1) * I // ways))
    return _permute_lanes(p, np.concatenate(idx))


def prepare_tp_layer(cfg: dec.ModelConfig, lp: Dict[str, Any], ways: int) -> Dict[str, Any]:
    """The manual-TP lane order of one layer's (or a stacked layer dict's)
    linears: a pure relabelling. Needs the fused qkv / gateup layout, ways
    dividing the heads, the KV heads and the intermediate width, and the
    row-parallel linears' scale blocks."""
    if cfg.n_heads % ways or cfg.kv_heads % ways or cfg.intermediate % ways:
        raise ValueError(f"ways={ways} must divide heads and intermediate")
    if lp.get("qkv") is None:
        raise ValueError("manual TP needs the fused qkv layout")
    for name in _ROW:
        nbp = lp[name].alpha.shape[-2]
        if nbp % ways:
            raise ValueError(f"{name}: padded blocks {nbp} not divisible by {ways}")
    out = dict(lp)
    out["qkv"] = shard_major_qkv(lp["qkv"], cfg, ways)
    if cfg.gated_mlp:
        out["gateup"] = shard_major_gateup(lp["gateup"], cfg.intermediate, ways)
    return out


def prepare_tp_params(cfg: dec.ModelConfig, params: Dict[str, Any], ways: int) -> Dict[str, Any]:
    """Shard-major lanes for every layer of the stacked params (the lane
    permutation is the same for every layer, so it applies to the stacks
    at once; JAX's relabels layer by layer and restacks)."""
    out = dict(params)
    out["layers"] = prepare_tp_layer(cfg, params["layers"], ways)
    return out


def _shard(t: Optional[torch.Tensor], dim: int, rank: int, ways: int, device):
    if t is None:
        return None
    n = t.shape[dim]
    if n % ways:
        raise ValueError(f"a dimension of {n} does not split {ways} ways")
    w = n // ways
    return t.narrow(dim, rank * w, w).contiguous().to(device)


def _shard_linear(p: PackedTernaryLinear, kind: str, rank: int, ways: int, device):
    put = lambda t: None if t is None else t.contiguous().to(device)  # noqa: E731
    g = p.gather
    if kind == "col":  # output lanes; the input gather stays whole (replicated input)
        if g is not None:
            g = PackedGather(packed=put(g.packed), perm=put(g.perm), in_features=g.in_features)
        return dataclasses.replace(
            p, packed=_shard(p.packed, -1, rank, ways, device),
            alpha=_shard(p.alpha, -1, rank, ways, device), mu=_shard(p.mu, -1, rank, ways, device),
            perm=put(p.perm), bias=_shard(p.bias, -1, rank, ways, device), gather=g)
    # row: packed rows and scale blocks; the gather's output lanes follow
    if g is not None:
        g = PackedGather(packed=_shard(g.packed, -1, rank, ways, device), perm=put(g.perm),
                         in_features=g.in_features)
    return dataclasses.replace(
        p, packed=_shard(p.packed, -2, rank, ways, device),
        alpha=_shard(p.alpha, -2, rank, ways, device), mu=_shard(p.mu, -2, rank, ways, device),
        perm=put(p.perm), bias=put(p.bias), gather=g)


def _whole(v, dev):
    if isinstance(v, torch.Tensor):
        return v.to(dev)
    if isinstance(v, PackedTernaryLinear):
        return v.map_leaves(lambda t: t.to(dev))
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return dataclasses.replace(v, **{f.name: _whole(getattr(v, f.name), dev)
                                         for f in dataclasses.fields(v)})
    if isinstance(v, dict):
        return {k: _whole(x, dev) for k, x in v.items()}
    return v


def shard_tp_layer(lp: Dict[str, Any], axis: Axis, device) -> Dict[str, Any]:
    """This rank's shard of a prepared layer (or stacked layer dict) on
    ``device``: the column-parallel linears' output lanes, the row-parallel
    linears' packed rows and scale blocks (and their gathers' output
    lanes); every other leaf whole (JAX's ``tp_layer_specs``)."""
    out = {}
    for name, leaf in lp.items():
        if leaf is None:
            out[name] = None
        elif name in _COL:
            out[name] = _shard_linear(leaf, "col", axis.rank, axis.size, device)
        elif name in _ROW:
            out[name] = _shard_linear(leaf, "row", axis.rank, axis.size, device)
        else:
            out[name] = _whole(leaf, device)
    return out


def shard_tp_params(params: Dict[str, Any], axis: Axis, device=None) -> Dict[str, Any]:
    """This rank's shard of prepared params (:func:`prepare_tp_params`), on
    ``device`` (default: where the params lie): its layers' shards
    (:func:`shard_tp_layer`), the embedding, norms and head whole. JAX's
    ``tp_param_specs`` says the same to ``shard_map``."""
    dev = device if device is not None else params["embed"].device
    out = {k: _whole(v, dev) for k, v in params.items() if k != "layers"}
    out["layers"] = shard_tp_layer(params["layers"], axis, dev)
    return out


# ------------------------------------------------------ full-model TP ----
def _local_cfg(cfg: dec.ModelConfig, axis: Axis) -> dec.ModelConfig:
    return cfg.with_(n_kv_heads=cfg.kv_heads // axis.size)


def _forward(cfg, params, toks, cache, pos0: int, M: int, axis, chunks, impl):
    B, L = toks.shape
    dev = toks.device
    h = dec.embed_tokens(cfg, params, toks, pos0=pos0)
    cos_all, sin_all, cosl_all, sinl_all = dec.pos_tables(cfg, M, device=dev)
    cos, sin = cos_all[pos0 : pos0 + L], sin_all[pos0 : pos0 + L]
    cos_l = sin_l = None
    if cosl_all is not None:
        cos_l, sin_l = cosl_all[pos0 : pos0 + L], sinl_all[pos0 : pos0 + L]
    mask = dec.build_mask(cfg, L, M, q_offset=pos0, device=dev)
    for li in range(cfg.n_layers):
        lp = dec.layer_view(params["layers"], li)
        h = tp_layer_forward(cfg, lp, h, cos, sin, mask, cache=cache, cache_pos=pos0, axis=axis,
                             chunks=chunks, impl=impl, layer_idx=li, cos_loc=cos_l,
                             sin_loc=sin_l)
    return dec.unembed(cfg, params, h[:, -1:, :])[:, 0]


@torch.inference_mode()
def tp_generate(
    cfg: dec.ModelConfig,
    axis: Axis,
    params: Dict[str, Any],  # this rank's shard (shard_tp_params)
    prompt,  # (B, Lp) token ids, the same on every rank
    max_new: int,
    max_len: Optional[int] = None,
    chunks: int = 2,
    impl: str = "auto",
) -> torch.Tensor:
    """Greedy decode under manual TP, as JAX's ``tp_generate``: a bf16 cache
    of this rank's KV heads, the prompt in one prefill, then one token per
    step, every step attending through the causal mask (JAX's route: no
    ``kv_valid``). Every rank returns the same (B, max_new) int32 ids."""
    dec.check_supported(cfg)
    dev = params["embed"].device
    prompt = torch.as_tensor(prompt, device=dev).long()
    B, Lp = prompt.shape
    M = max_len or min(cfg.max_seq_len, Lp + max_new)
    if Lp + max_new > M:
        raise ValueError(f"prompt {Lp} + max_new {max_new} exceeds max_len {M}")
    cache = init_cache(_local_cfg(cfg, axis), B, M, device=dev)
    logits = _forward(cfg, params, prompt, cache, 0, M, axis, chunks, impl)
    tok = torch.argmax(logits, dim=-1)
    out = [tok]
    for pos in range(Lp, Lp + max_new - 1):
        logits = _forward(cfg, params, tok[:, None], cache, pos, M, axis, chunks, impl)
        tok = torch.argmax(logits, dim=-1)
        out.append(tok)
    return torch.stack(out, dim=1).to(torch.int32)


# ---------------------------------------------------- engine TP hooks ----
def make_tp_engine_fns(cfg: dec.ModelConfig, axis: Axis, params, chunks: int = 1,
                       impl: str = "auto") -> Tuple[Any, Any]:
    """(prefill_fn, decode_fn) for ``serve.ServeEngine`` on this rank's
    shard, with the engine's contracts: the same steps as its default
    programs with every layer through :func:`tp_layer_forward`. The pool
    holds this rank's KV heads: build the engine with ``kv_heads=`` the
    rank's count (``cfg.kv_heads // ways``), ``multihost=True`` across
    ranks. An unquantized pool only, as JAX's. ``params`` is the rank's
    shard; the fns take the engine's ``params`` and ignore the rest of
    their arguments' names, as JAX's do."""
    from ..serve.engine import _rope

    def decode_fn(cfg_, params_, tokens, cache, positions, active, impl_="auto", samp=None):
        if cache.quantized:
            raise ValueError("the TP engine fns take an unquantized pool")
        dev = tokens.device
        B = tokens.shape[0]
        M = cache.max_len
        pos = np.where(active, positions, np.minimum(positions, M - 1))
        pos_t = torch.as_tensor(pos, dtype=torch.long).to(dev, non_blocking=True)
        x = dec.embed_tokens_per_row(cfg, params_, tokens[:, None], pos_t[:, None])
        cos_all, sin_all, cosl_all, sinl_all = _rope(cfg, M, dev)
        cos, sin = cos_all[pos_t][:, None], sin_all[pos_t][:, None]
        cos_l = sin_l = None
        if cosl_all is not None:
            cos_l, sin_l = cosl_all[pos_t][:, None], sinl_all[pos_t][:, None]
        mask = None
        if cfg.pos == "alibi":  # every head's per-row bias; each rank slices its own
            rel = torch.arange(M, dtype=torch.float32, device=dev)[None, :] - pos_t.float()[:, None]
            mask = alibi_slopes(cfg.n_heads, device=dev)[None, :, None, None] * rel[:, None, None]
        views = cache.decode_views(pos_t, B)
        for li in range(cfg.n_layers):
            lp = dec.layer_view(params_["layers"], li)
            view, cache_pos, kv_valid = views(li)
            x = tp_layer_forward(cfg, lp, x, cos, sin, mask, cache=view, cache_pos=cache_pos,
                                 kv_valid=kv_valid, axis=axis, chunks=chunks, impl=impl,
                                 layer_idx=li, cos_loc=cos_l, sin_loc=sin_l)
        logits = dec.unembed(cfg, params_, x)[:, 0]
        if samp is None:
            nxt = torch.argmax(logits, dim=-1)
        else:
            seed, uids, temps, top_ks, top_ps = samp
            nxt = sample_per_row(logits, seed, uids, positions, temps, top_ks, top_ps)
        act = torch.as_tensor(active).to(dev, non_blocking=True)
        return torch.where(act, nxt, torch.zeros_like(nxt)), cache

    def prefill_fn(cfg_, params_, prompt, true_len, cache, slot, impl_="auto", samp=None):
        if cache.quantized:
            raise ValueError("the TP engine fns take an unquantized pool")
        M = cache.max_len
        Lb = prompt.shape[1]
        dev = prompt.device
        row = cache.prefill_view(slot, slot + 1, true_len)
        h = dec.embed_tokens(cfg, params_, prompt)
        cos_all, sin_all, cosl_all, sinl_all = _rope(cfg, M, dev)
        cos_l = None if cosl_all is None else cosl_all[:Lb]
        sin_l = None if sinl_all is None else sinl_all[:Lb]
        mask = dec.build_mask(cfg, Lb, M, device=dev)
        for li in range(cfg.n_layers):
            lp = dec.layer_view(params_["layers"], li)
            h = tp_layer_forward(cfg, lp, h, cos_all[:Lb], sin_all[:Lb], mask, cache=row,
                                 cache_pos=0, axis=axis, chunks=chunks, impl=impl, layer_idx=li,
                                 cos_loc=cos_l, sin_loc=sin_l)
        logits = dec.unembed(cfg, params_, h[:, true_len - 1 : true_len])[:, 0]
        if samp is None:
            return torch.argmax(logits[0]), cache
        seed, uid, sc = samp
        return sample_per_row(logits, seed, [uid], [true_len - 1], [sc.temperature],
                              [sc.top_k], [sc.top_p])[0], cache

    return prefill_fn, decode_fn
