"""Structural Similarity-based Reordering (SSR): counterpart of
``pt2tpu.core.ssr``.

Selection state is a fixed (m,) boolean ``available`` mask, as in the JAX
package: unavailable columns score ``-inf`` and one descending pick over all
m columns takes the next block, so every shape is static. The pick is a
stable descending sort, which puts the lower index first among equal scores,
as ``jax.lax.top_k`` does (``torch.topk`` promises no order among ties, and
on CUDA the order varies). When fewer than ``block_size`` columns remain, the
extra lanes point at exhausted columns and are flagged invalid.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = [
    "cosine_similarity_matrix",
    "similarity_to_mean",
    "select_block",
    "static_reorder_indices",
    "apply_permutation",
    "apply_permutation_to_input",
    "block_variance",
]

_EPS = 1e-8


def cosine_similarity_matrix(W: torch.Tensor) -> torch.Tensor:
    """Pairwise column cosine similarity S = Ŵ^T Ŵ."""
    norms = torch.clamp_min(torch.linalg.vector_norm(W, dim=0, keepdim=True), _EPS)
    Wn = W / norms
    return Wn.t() @ Wn


def similarity_to_mean(W: torch.Tensor, available: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cosine similarity of each available column of (n, m) ``W`` to the
    mean of the available columns; ``-inf`` on unavailable columns."""
    n, m = W.shape
    if available is None:
        available = torch.ones((m,), dtype=torch.bool, device=W.device)
    msk = available.to(W.dtype)
    count = torch.clamp_min(msk.sum(), 1.0)

    w_mean = (W * msk[None, :]).sum(dim=1, keepdim=True) / count  # (n, 1)
    w_mean_n = w_mean / torch.clamp_min(torch.linalg.vector_norm(w_mean), _EPS)
    col_norms = torch.clamp_min(torch.linalg.vector_norm(W, dim=0), _EPS)  # (m,)
    sims = (W.t() @ w_mean_n)[:, 0] / col_norms
    return torch.where(available, sims, torch.full_like(sims, float("-inf")))


def select_block(
    W: torch.Tensor,
    available: torch.Tensor,
    block_size: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The next SSR block: the ``block_size`` columns most similar to the
    mean of the available ones, best first, the lower index first on ties.

    Returns (block_indices (block_size,) int64, lane_valid (block_size,)
    bool, new_available (m,) bool)."""
    sims = similarity_to_mean(W, available)
    _, order = torch.sort(sims, descending=True, stable=True)
    idx = order[:block_size]
    lane_valid = available[idx]
    new_available = available.clone()
    new_available[idx] = False
    return idx, lane_valid, new_available


def static_reorder_indices(W: torch.Tensor, block_size: int = 128) -> torch.Tensor:
    """Greedy full-matrix reordering: seed at the column with the largest
    similarity row-sum, then repeatedly append the unselected column with
    the highest summed similarity to the selected set (argmax: the first
    index on ties, as in JAX). ``block_size`` is unused, as in the
    reference."""
    del block_size
    n, m = W.shape
    S = cosine_similarity_matrix(W)
    start = int(torch.argmax(S.sum(dim=1)))
    perm = [start]
    selected = torch.zeros((m,), dtype=torch.bool, device=W.device)
    selected[start] = True
    simsum = S[:, start].clone()
    neg = torch.full_like(simsum, float("-inf"))
    for _ in range(1, m):
        nxt = int(torch.argmax(torch.where(selected, neg, simsum)))
        perm.append(nxt)
        selected[nxt] = True
        simsum = simsum + S[:, nxt]
    return torch.tensor(perm, dtype=torch.int32, device=W.device)


def apply_permutation(W: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Column permutation W' = W P."""
    return W[:, perm.long()]


def apply_permutation_to_input(X: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Feature permutation of activations with any leading dims."""
    return torch.index_select(X, -1, perm.long())


def block_variance(W: torch.Tensor, block_size: int) -> torch.Tensor:
    """Per-block variance (unbiased, as ``torch.var``), a trailing ragged
    block over its true width: (ceil(m / block_size),)."""
    n, m = W.shape
    nb = -(-m // block_size)
    pad = nb * block_size - m
    Wp = torch.nn.functional.pad(W, (0, pad))
    msk = torch.nn.functional.pad(torch.ones((m,), dtype=W.dtype, device=W.device), (0, pad))
    msk = msk.reshape(nb, block_size)
    Wb = Wp.reshape(n, nb, block_size).permute(1, 0, 2)  # (nb, n, bs)
    cnt = torch.clamp_min(msk.sum(dim=1) * n, 1.0)
    mean = (Wb * msk[:, None, :]).sum(dim=(1, 2)) / cnt
    sq = ((Wb - mean[:, None, None]) ** 2 * msk[:, None, :]).sum(dim=(1, 2))
    return sq / torch.clamp_min(cnt - 1.0, 1.0)
