"""Prefill + decode (counterpart of ``pt2tpu.serve.generate``): the
lockstep :func:`generate`, greedy or sampled, and :func:`greedy_generate`,
its greedy case.

PyTorch runs eagerly: the decode loop is a Python loop over steps, each step
a loop over layers, and the KV cache is updated in place. The routing rules
(``kv_valid`` for single-token steps, an additive mask otherwise, the
automatic prefill chunk) are the JAX package's, so the same prompts take the
same route. ALiBi configs take the additive mask (causal + per-head bias)
on single-token steps too, as in the JAX package; sliding layers narrow
``kv_valid`` or the mask (``decoder.sliding_adjust``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..models import decoder as dec
from .kvcache import KVCache, init_cache
from .sampling import SamplingConfig, sample

__all__ = ["forward_cached", "prefill", "chunked_prefill", "generate", "greedy_generate"]


def forward_cached(
    cfg: dec.ModelConfig,
    params,
    tokens: torch.Tensor,  # (B, L)
    cache,
    pos0: int,  # first position of `tokens`
    impl: str = "auto",
    all_logits: bool = False,
) -> Tuple[torch.Tensor, KVCache]:
    """Run ``tokens`` at positions [pos0, pos0+L) against the cache, which
    is written in place (a KVCache, a pool's ``prefill_view``, or on
    single-token steps any pool with ``decode_views``: each layer where the
    pool puts it). Returns (last-position logits (B, V), or (B, L, V) with
    ``all_logits``, and the cache)."""
    B, L = tokens.shape
    M = cache.max_len
    dev = tokens.device
    h = dec.embed_tokens(cfg, params, tokens, pos0=pos0)
    cos_all, sin_all, cosl_all, sinl_all = dec.pos_tables(cfg, M, device=dev)
    cos, sin = cos_all[pos0 : pos0 + L], sin_all[pos0 : pos0 + L]
    cos_l = sin_l = None
    if cosl_all is not None:
        cos_l, sin_l = cosl_all[pos0 : pos0 + L], sinl_all[pos0 : pos0 + L]
    mask = None
    if L == 1 and cfg.pos != "alibi":
        # single-token decode: causality over the cache is a validity row
        views = cache.decode_views(pos0, B)
    else:
        mask = dec.build_mask(cfg, L, M, q_offset=pos0, device=dev)
        views = lambda li: (cache, pos0, None)  # noqa: E731
    for li in range(cfg.n_layers):
        lp = dec.layer_view(params["layers"], li)
        view, cache_pos, kv_valid = views(li)
        h = dec.layer_forward(
            cfg, lp, h, cos, sin, mask, cache=view, cache_pos=cache_pos,
            kv_valid=kv_valid, impl=impl, layer_idx=li, cos_loc=cos_l, sin_loc=sin_l,
        )
    if all_logits:
        return dec.unembed(cfg, params, h), cache
    return dec.unembed(cfg, params, h[:, -1:, :])[:, 0], cache


def prefill(cfg, params, prompt: torch.Tensor, cache, impl: str = "auto"):
    """Process the prompt through the pool's ``prefill_view``; returns
    (next-token logits, filled cache)."""
    B, Lp = prompt.shape
    logits, _ = forward_cached(cfg, params, prompt, cache.prefill_view(0, B, Lp), 0, impl)
    return logits, cache


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
def generate(
    cfg: dec.ModelConfig,
    params,
    prompt,  # (B, Lp) int token ids
    max_new: int,
    max_len: Optional[int] = None,
    impl: str = "auto",
    kv_quant: bool = False,
    sampling: Optional[SamplingConfig] = None,
    generator: Optional[torch.Generator] = None,
    prefill_chunk: Optional[int] = None,  # None = auto; 0 = whole-prompt
) -> torch.Tensor:
    """Decode ``max_new`` tokens after ``prompt`` on the device that holds
    ``params``, with a bf16 or (``kv_quant``) int8 KV cache, every row in
    lockstep. ``sampling`` None or greedy takes the argmax; otherwise each
    token is one draw (:func:`sampling.sample`) from ``generator`` (a
    ``torch.Generator`` on that device; None: one seeded with 0, as JAX
    defaults to ``PRNGKey(0)``). Returns (B, max_new) int32 token ids."""
    return _lockstep(cfg, params, prompt, max_new, max_len, impl,
                    lambda B, M, dev: init_cache(cfg, B, M, quantized=kv_quant, device=dev),
                    sampling, generator, prefill_chunk)


def _lockstep(cfg, params, prompt, max_new: int, max_len: Optional[int], impl: str, make_cache,
              sampling: Optional[SamplingConfig] = None,
              generator: Optional[torch.Generator] = None,
              prefill_chunk: Optional[int] = None) -> torch.Tensor:
    """:func:`generate` over the pool ``make_cache(B, M, device)`` returns
    (``serve.ring.ring_generate``'s too): prefill (whole, or in chunks as
    :func:`generate` says), then one token per step for every row."""
    dec.check_supported(cfg)
    scfg = sampling or SamplingConfig()
    dev = params["embed"].device
    prompt = torch.as_tensor(prompt, device=dev).long()
    B, Lp = prompt.shape
    M = max_len or min(cfg.max_seq_len, Lp + max_new)
    if Lp + max_new > M:
        raise ValueError(f"prompt {Lp} + max_new {max_new} exceeds max_len {M}")
    if cfg.pos == "learned" and M > params["pos_embed"].shape[0] - cfg.pos_offset:
        raise ValueError(f"max_len {M} exceeds the model's learned positions")
    cache = make_cache(B, M, dev)
    chunk = _auto_prefill_chunk(cfg, B, Lp, M) if prefill_chunk is None else (prefill_chunk or None)
    if chunk and chunk < Lp:
        logits, cache = chunked_prefill(cfg, params, prompt, cache, impl, chunk)
    else:
        logits, cache = prefill(cfg, params, prompt, cache, impl)
    if not scfg.greedy and generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    tok = sample(logits, generator, scfg)  # greedy: the first maximum, as jnp.argmax
    out = [tok]
    for pos in range(Lp, Lp + max_new - 1):
        logits, cache = forward_cached(cfg, params, tok[:, None].long(), cache, pos, impl)
        tok = sample(logits, generator, scfg)
        out.append(tok)
    return torch.stack(out, dim=1).to(torch.int32)


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
    """Greedy decode: the common case of :func:`generate`. Returns
    (B, max_new) int32 token ids."""
    return generate(cfg, params, prompt, max_new, max_len=max_len, impl=impl,
                    kv_quant=kv_quant, prefill_chunk=prefill_chunk)
