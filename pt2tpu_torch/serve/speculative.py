"""Speculative decoding (counterpart of ``pt2tpu.serve.speculative``): a
small draft model proposes, the target verifies in one forward.

Greedy everywhere, which makes the method exact: the emitted tokens equal
the target's greedy decoding token for token. Each round drafts k tokens
greedily in k + 1 one-token draft steps (the last writes the draft's k/v at
position c + k, so a fully accepted round leaves no hole in the draft cache;
its token is unused), then runs the target over [last token, drafts) at
positions [c, c + k] and accepts the longest prefix of drafts that equals
the target's argmax votes, plus the vote after it. Rewinds are position
moves: a rejected draft's k/v is overwritten before it is attended.

JAX runs the rounds as one compiled ``lax.while_loop``; here they are a
Python loop with one host read a round (the number accepted). Single
sequence (B == 1): per-row acceptance is the continuous-batching engine's
(``serve.engine.ServeEngine(draft=...)``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..models import decoder as dec
from .generate import forward_cached, prefill
from .kvcache import init_cache

__all__ = ["speculative_generate", "SpecStats"]


class SpecStats:
    """The acceptance counters of a run."""

    def __init__(self, rounds: int, drafted: int, accepted: int):
        self.rounds = int(rounds)
        self.drafted = int(drafted)
        self.accepted = int(accepted)

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / max(self.drafted, 1)

    def __repr__(self):
        return (
            f"SpecStats(rounds={self.rounds}, drafted={self.drafted}, "
            f"accepted={self.accepted}, rate={self.acceptance_rate:.2f})"
        )


@torch.inference_mode()
def speculative_generate(
    cfg_t: dec.ModelConfig,
    params_t,
    cfg_d: dec.ModelConfig,
    params_d,
    prompt,  # (1, Lp) int token ids
    max_new: int,
    k: int = 4,
    max_len: Optional[int] = None,
    impl: str = "auto",
    kv_quant: bool = False,
) -> Tuple[torch.Tensor, SpecStats]:
    """Greedy speculative decode on the device that holds ``params_t``;
    returns ((1, max_new) int32 tokens, SpecStats). Exactness contract: the
    tokens of ``greedy_generate(cfg_t, params_t, ...)``. ``k`` is the draft
    length a round; both models share the vocabulary. The target's cache is
    int8 with ``kv_quant``, the draft's bf16."""
    dev = params_t["embed"].device
    prompt = torch.as_tensor(prompt, device=dev).long()
    B, Lp = prompt.shape
    if B != 1:
        raise ValueError("speculative decoding is single-sequence (B=1)")
    if cfg_t.vocab_size != cfg_d.vocab_size:
        raise ValueError("draft and target must share a vocabulary")
    M = max_len or min(min(cfg_t.max_seq_len, cfg_d.max_seq_len), Lp + max_new + k + 1)
    if Lp + max_new + k + 1 > M:
        raise ValueError(f"prompt {Lp} + max_new {max_new} + draft window {k + 1} "
                         f"exceeds max_len {M}")
    dec.check_supported(cfg_t)
    dec.check_supported(cfg_d)
    t_cache = init_cache(cfg_t, 1, M, quantized=kv_quant, device=dev)
    d_cache = init_cache(cfg_d, 1, M, device=dev)
    t_logits, t_cache = prefill(cfg_t, params_t, prompt, t_cache, impl)
    _, d_cache = prefill(cfg_d, params_d, prompt, d_cache, impl)
    t_last = torch.argmax(t_logits[0])  # the prefill's token is emission 1
    out = [t_last[None]]
    n_out, c = 1, Lp
    rounds = drafted = accepted = 0
    while n_out < max_new:
        tok, drafts = t_last, []
        for i in range(k + 1):
            lg, d_cache = forward_cached(cfg_d, params_d, tok.view(1, 1), d_cache, c + i, impl)
            tok = torch.argmax(lg[0])
            drafts.append(tok)
        drafts = torch.stack(drafts[:k])  # (k,)
        toks = torch.cat([t_last[None], drafts])[None]  # (1, k + 1)
        lg, t_cache = forward_cached(cfg_t, params_t, toks, t_cache, c, impl, all_logits=True)
        votes = torch.argmax(lg[0], dim=-1)  # (k + 1,)
        n_acc = int(torch.cumprod((drafts == votes[:k]).long(), dim=0).sum())
        emit = min(n_acc + 1, max_new - n_out)
        out.append(votes[:emit])
        t_last = votes[n_acc]
        n_out += emit
        c += n_acc + 1
        rounds += 1
        drafted += k
        accepted += n_acc
    return torch.cat(out)[None].to(torch.int32), SpecStats(rounds, drafted, accepted)
