"""Prefill + greedy decode (counterpart of ``pt2tpu.serve.generate``).

PyTorch runs eagerly: the decode loop is a Python loop over steps, each step
a loop over layers, and the KV cache is updated in place. The routing rules
(``kv_valid`` for single-token steps, an additive mask otherwise, the
automatic prefill chunk) are the JAX package's, so the same prompts take the
same route.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..models import decoder as dec
from ..models.common import causal_mask
from .kvcache import KVCache, init_cache

__all__ = ["forward_cached", "prefill", "chunked_prefill", "greedy_generate"]


def forward_cached(
    cfg: dec.ModelConfig,
    params,
    tokens: torch.Tensor,  # (B, L)
    cache: KVCache,
    pos0: int,  # first position of `tokens`
    impl: str = "auto",
    all_logits: bool = False,
) -> Tuple[torch.Tensor, KVCache]:
    """Run ``tokens`` at positions [pos0, pos0+L) against the cache, which
    is written in place. Returns (last-position logits (B, V), or (B, L, V)
    with ``all_logits``, and the cache)."""
    B, L = tokens.shape
    M = cache.max_len
    dev = tokens.device
    h = dec.embed_tokens(cfg, params, tokens)
    cos_all, sin_all = dec.pos_tables(cfg, M, device=dev)
    cos, sin = cos_all[pos0 : pos0 + L], sin_all[pos0 : pos0 + L]
    kv_valid = mask = None
    if L == 1:
        # single-token decode: causality over the cache is a validity row
        kv_valid = (torch.arange(M, device=dev)[None, :] <= pos0).expand(B, M)
    else:
        mask = causal_mask(L, M, q_offset=pos0, device=dev)
    for li in range(cfg.n_layers):
        lp = dec.layer_view(params["layers"], li)
        h = dec.layer_forward(
            cfg, lp, h, cos, sin, mask, cache=cache, cache_pos=pos0,
            kv_valid=kv_valid, impl=impl, layer_idx=li,
        )
    if all_logits:
        return dec.unembed(cfg, params, h), cache
    return dec.unembed(cfg, params, h[:, -1:, :])[:, 0], cache


def prefill(cfg, params, prompt: torch.Tensor, cache: KVCache, impl: str = "auto"):
    """Process the prompt; returns (next-token logits, filled cache)."""
    return forward_cached(cfg, params, prompt, cache, 0, impl)


def _auto_prefill_chunk(cfg, B: int, Lp: int, M: int) -> Optional[int]:
    """Prefill chunk length, or None for whole-prompt prefill — the JAX
    package's rule: at most 4096 token rows per chunk, and an f32 score
    tensor (B, H, chunk, M) of at most ~1 GB."""
    if B * Lp <= 4096:
        return None
    c_act = max(128, (4096 // max(1, B)) // 128 * 128)
    c_scr = max(128, (2**28 // max(1, cfg.n_heads * B * M)) // 128 * 128)
    c = min(c_act, c_scr)
    return c if c < Lp else None


def chunked_prefill(cfg, params, prompt: torch.Tensor, cache: KVCache, impl: str = "auto",
                    chunk: int = 512):
    """Prefill the prompt in ``chunk``-token slices against the cache."""
    B, Lp = prompt.shape
    logits = None
    for pos in range(0, Lp, chunk):
        logits, cache = forward_cached(cfg, params, prompt[:, pos : pos + chunk], cache, pos, impl)
    return logits, cache


@torch.inference_mode()
def greedy_generate(
    cfg: dec.ModelConfig,
    params,
    prompt,  # (B, Lp) int token ids
    max_new: int,
    max_len: Optional[int] = None,
    impl: str = "auto",
    kv_quant: bool = False,
    prefill_chunk: Optional[int] = None,  # None = auto; 0 = whole-prompt
) -> torch.Tensor:
    """Greedy decode ``max_new`` tokens after ``prompt`` on the device that
    holds ``params``, with a bf16 or (``kv_quant``) int8 KV cache. Returns
    (B, max_new) int32 token ids."""
    dec.check_supported(cfg)
    dev = params["embed"].device
    prompt = torch.as_tensor(prompt, device=dev).long()
    B, Lp = prompt.shape
    M = max_len or min(cfg.max_seq_len, Lp + max_new)
    if Lp + max_new > M:
        raise ValueError(f"prompt {Lp} + max_new {max_new} exceeds max_len {M}")
    cache = init_cache(cfg, B, M, quantized=kv_quant, device=dev)
    chunk = _auto_prefill_chunk(cfg, B, Lp, M) if prefill_chunk is None else (prefill_chunk or None)
    if chunk and chunk < Lp:
        logits, cache = chunked_prefill(cfg, params, prompt, cache, impl, chunk)
    else:
        logits, cache = prefill(cfg, params, prompt, cache, impl)
    tok = torch.argmax(logits, dim=-1)  # the first maximum, as jnp.argmax
    out = [tok]
    for pos in range(Lp, Lp + max_new - 1):
        logits, cache = forward_cached(cfg, params, tok[:, None], cache, pos, impl)
        tok = torch.argmax(logits, dim=-1)
        out.append(tok)
    return torch.stack(out, dim=1).to(torch.int32)
