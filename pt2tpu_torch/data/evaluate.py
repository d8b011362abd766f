"""Perplexity: counterpart of ``pt2tpu.data.evaluate``.

Non-overlapping ``seq_len`` windows over the evaluation stream, next-token
cross-entropy with the first token of each window unpredicted (L - 1
predictions per window), f32 logsumexp; ppl = exp(total nll / predicted
tokens). Runs the port's ``forward`` on the device the parameters lie on.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..models import decoder as dec

__all__ = ["evaluate_perplexity", "window_nll"]


@torch.inference_mode()
def window_nll(cfg, params, tokens: torch.Tensor, impl: str = "auto"):
    """Summed NLL over the next-token predictions of (B, L) windows:
    (total nll as an f32 0-dim tensor, count of predictions)."""
    logits = dec.forward(cfg, params, tokens, impl=impl)[:, :-1].float()
    targets = tokens[:, 1:].long()
    logz = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = logz - tgt
    return nll.sum(), nll.numel()


def evaluate_perplexity(
    cfg,
    params,
    tokens: np.ndarray,
    seq_len: int = 2048,
    batch_size: int = 4,
    max_windows: Optional[int] = None,
    impl: str = "auto",
) -> Dict[str, float]:
    """Strided-window perplexity over a 1-D token stream:
    {"ppl", "nll_per_token", "tokens"}."""
    seq_len = min(seq_len, len(tokens))
    n_win = len(tokens) // seq_len
    if max_windows is not None:
        n_win = min(n_win, max_windows)
    if n_win == 0:
        raise ValueError(f"stream of {len(tokens)} tokens < seq_len {seq_len}")
    windows = np.stack(
        [tokens[i * seq_len : (i + 1) * seq_len] for i in range(n_win)]
    ).astype(np.int64)
    dev = params["embed"].device
    total_nll, total_tok = 0.0, 0
    for i in range(0, n_win, batch_size):
        nll, cnt = window_nll(cfg, params, torch.from_numpy(windows[i : i + batch_size]).to(dev),
                              impl=impl)
        total_nll += float(nll)
        total_tok += int(cnt)
    nll_per_tok = total_nll / max(total_tok, 1)
    return {"ppl": float(np.exp(nll_per_tok)), "nll_per_token": nll_per_tok, "tokens": total_tok}
