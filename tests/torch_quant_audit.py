"""Near-tie audit shared by the quantizer tests (not a test module).

Where the port's ternary codes differ from the JAX package's on the same
inputs, the two computed the same rounding decisions in f32 with operations
in different orders; a code can then differ only where some decision of that
row sat within a few f32 ulps of its threshold. :func:`row_margins` replays
the port's own block loop (its public functions, so the same bits as
``ternary_gptq``) and measures, for every row and block, the smallest
distance of any rounding decision to its threshold: ``ternary_init``'s
|W - mu| against delta (relative), and every ITF iteration's
Z = (W - mu) / alpha against +-0.5. The tests hold each differing row's
first differing block to a margin below ``NEAR_TIE`` (1e-5)."""

import numpy as np
import torch

from pt2tpu_torch.core import ssr as tssr
from pt2tpu_torch.core import ternary as tatq

NEAR_TIE = 1e-5


def block_margins(W, mask, max_iter=100):
    """(n,) smallest threshold distance of each row over ternary_init and
    every ITF iteration of this (n, bs) block, with the lane mask."""
    m = tatq._mask_or_ones(W, mask)
    valid = m > 0
    count = torch.clamp_min(m.sum(), 1.0)
    mu = (W * m).sum(dim=-1, keepdim=True) / count
    Wc = (W - mu) * m
    delta = 0.75 * Wc.abs().sum(dim=-1, keepdim=True) / count
    rel = (Wc.abs() - delta).abs() / torch.clamp_min(delta, 1e-30)
    best = torch.where(valid, rel, torch.full_like(rel, np.inf)).amin(dim=-1)
    alpha, mu, T = tatq.ternary_init(W, mask)
    T_prev = torch.zeros_like(T)
    it = 0
    while it < max_iter and bool((T != T_prev).any()):
        alpha, mu = tatq.optimal_grid(W, T, mask)
        Z = (W - mu) / torch.clamp_min(alpha, 1e-8)
        d = torch.minimum((Z - 0.5).abs(), (Z + 0.5).abs())
        best = torch.minimum(best, torch.where(valid, d, torch.full_like(d, np.inf)).amin(dim=-1))
        T, T_prev = tatq.flexible_round(W, alpha, mu, mask), T
        it += 1
    return best


def row_margins(W, H, H_inv, block_size=128, use_ssr=True, use_aga=True, aga_mode="exact"):
    """(n, nb) margins of every row in every visit block of the port's
    ternary_gptq on these inputs (f32, CPU)."""
    W = W.float().clone()
    n, m = W.shape
    bs = min(block_size, m)
    nb = -(-m // bs)
    available = torch.ones((m,), dtype=torch.bool)
    out = torch.empty((n, nb))
    for k in range(nb):
        if use_ssr:
            idx, lane_valid, new_avail = tssr.select_block(W, available, bs)
        else:
            pos = k * bs + torch.arange(bs)
            lane_valid = pos < m
            idx = torch.clamp_max(pos, m - 1)
            new_avail = available.clone()
            new_avail[idx] = False
        W_blk = W[:, idx]
        out[:, k] = block_margins(W_blk, lane_valid)
        res = tatq.atq_quantize(W_blk, H[idx[:, None], idx[None, :]] if use_aga else None,
                                mask=lane_valid, use_aga=use_aga, aga_mode=aga_mode)
        err = (W_blk - (res.alpha * res.T + res.mu)) * lane_valid.float()[None, :]
        diag = torch.clamp_min(H_inv[idx, idx], 1e-8)
        W = W - (err @ (H_inv[idx, :] / diag[:, None])) * new_avail.float()[None, :]
        available = new_avail
    return out


def audit(T_port, T_jax, margins, block_size):
    """Rows whose codes differ (visit order, (n, K)), each with its first
    differing block's margin. Returns [(row, block, margin)]."""
    diff = np.asarray(T_port) != np.asarray(T_jax)
    out = []
    for r in np.nonzero(diff.any(axis=1))[0]:
        b = int(np.argmax(diff[r])) // block_size
        out.append((int(r), b, float(margins[r, : b + 1].min())))
    return out
