"""GPTQ + SSR + ATQ ternarization engine: counterpart of ``pt2tpu.quant.gptq``.

The JAX package runs the block loop as one fixed-shape ``lax.fori_loop``;
here it is a Python loop over the ``nb`` blocks with the same fixed shapes:
an (m,) ``available`` mask, ``block_size`` lanes per block (the extra lanes
of the last block flagged invalid), and the error update over the full width
masked by the new availability. All products are f32 with TF32 off.

Layout (the JAX package's): codes ``T`` in visit order (column k of T is
original column ``perm[k]``), ``alpha``/``mu`` per (row, visit block); pad
lanes carry ``perm == m`` and ``lane_valid == False`` with T = 0 there.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import ssr as ssr_mod
from ..core import ternary as atq_mod
from ..utils.device import quotient_f32
from .hessian import damped_inverse, full_f32

__all__ = [
    "TernaryLayerQuant",
    "ternary_gptq",
    "quantize_layer_weights",
    "dequantize_layer",
]


class TernaryLayerQuant(NamedTuple):
    """Quantized parameters of one linear layer (visit-order layout)."""

    T: torch.Tensor  # (n, K) int8 codes in visit order, K = nb * block_size
    alpha: torch.Tensor  # (n, nb) f32 per-block scale
    mu: torch.Tensor  # (n, nb) f32 per-block offset
    perm: torch.Tensor  # (K,) int32 visit position -> original column; pad lanes -> m
    lane_valid: torch.Tensor  # (K,) bool

    @property
    def num_blocks(self) -> int:
        return self.alpha.shape[-1]

    @property
    def block_size(self) -> int:
        return self.T.shape[-1] // self.alpha.shape[-1]


def ternary_gptq(
    W: torch.Tensor,
    H: torch.Tensor,
    H_inv: torch.Tensor,
    *,
    block_size: int = 128,
    use_ssr: bool = True,
    use_aga: bool = True,
    max_iter: int = 100,
    aga_mode: str = "exact",
) -> TernaryLayerQuant:
    """Block-wise ternarization with Hessian error compensation.

    W (n, m) weights; H (m, m) the normalized, undamped Hessian X^T X / N
    (AGA's statistic); H_inv (m, m) the inverse of the damped Hessian
    (error propagation). Runs on W's device."""
    W = W.float()
    H = H.float().to(W.device)
    H_inv = H_inv.float().to(W.device)
    n, m = W.shape
    if H.shape != (m, m) or H_inv.shape != (m, m):
        raise ValueError(
            f"H/H_inv must be ({m}, {m}) to match W's in_features; "
            f"got H {tuple(H.shape)}, H_inv {tuple(H_inv.shape)}"
        )
    dev = W.device
    bs = min(block_size, m)
    nb = -(-m // bs)
    W_work = W.clone()
    available = torch.ones((m,), dtype=torch.bool, device=dev)
    T_out = torch.zeros((nb, n, bs), dtype=torch.int8, device=dev)
    alpha_out = torch.zeros((nb, n), dtype=torch.float32, device=dev)
    mu_out = torch.zeros((nb, n), dtype=torch.float32, device=dev)
    perm_out = torch.full((nb, bs), m, dtype=torch.int32, device=dev)
    valid_out = torch.zeros((nb, bs), dtype=torch.bool, device=dev)
    lanes = torch.arange(bs, device=dev)
    with full_f32():
        for k in range(nb):
            if use_ssr:
                idx, lane_valid, new_avail = ssr_mod.select_block(W_work, available, bs)
            else:
                pos = k * bs + lanes
                lane_valid = pos < m
                idx = torch.clamp_max(pos, m - 1)
                new_avail = available.clone()
                new_avail[idx] = False

            lane_mask = lane_valid.float()
            W_blk = W_work[:, idx]  # (n, bs)
            S_blk = H[idx[:, None], idx[None, :]] if use_aga else None
            res = atq_mod.atq_quantize(
                W_blk, S_blk, mask=lane_valid, use_aga=use_aga, max_iter=max_iter,
                aga_mode=aga_mode,
            )

            W_q = res.alpha * res.T + res.mu
            err = (W_blk - W_q) * lane_mask[None, :]
            # W[:, rem] -= err @ (H_inv[blk, rem] / H_inv[blk, blk])
            diag = torch.clamp_min(H_inv[idx, idx], 1e-8)
            coeff = H_inv[idx, :] / diag[:, None]
            W_work = W_work - (err @ coeff) * new_avail.float()[None, :]
            available = new_avail

            T_out[k] = res.T.to(torch.int8)
            alpha_out[k] = res.alpha[:, 0]
            mu_out[k] = res.mu[:, 0]
            perm_out[k] = torch.where(lane_valid, idx, torch.full_like(idx, m)).to(torch.int32)
            valid_out[k] = lane_valid

    return TernaryLayerQuant(
        T=T_out.permute(1, 0, 2).reshape(n, nb * bs),
        alpha=alpha_out.t().contiguous(),
        mu=mu_out.t().contiguous(),
        perm=perm_out.reshape(nb * bs),
        lane_valid=valid_out.reshape(nb * bs),
    )


def quantize_layer_weights(
    W: torch.Tensor,
    H_raw: torch.Tensor,
    nsamples: int,
    *,
    block_size: int = 128,
    percdamp: float = 0.01,
    use_ssr: bool = True,
    use_aga: bool = True,
    max_iter: int = 100,
    aga_mode: str = "exact",
) -> TernaryLayerQuant:
    """Normalize (H_raw / nsamples, the correctly rounded quotient), damp and
    invert the Hessian, then run :func:`ternary_gptq`."""
    H = quotient_f32(H_raw.float(), float(max(nsamples, 1)))
    _, H_inv = damped_inverse(H, percdamp)
    return ternary_gptq(
        W, H, H_inv, block_size=block_size, use_ssr=use_ssr, use_aga=use_aga,
        max_iter=max_iter, aga_mode=aga_mode,
    )


def dequantize_layer(q: TernaryLayerQuant, m: int) -> torch.Tensor:
    """The (n, m) dequantized weights in original column order: visit column
    k scatters to original column perm[k]; pad lanes go to slot m, dropped."""
    n, K = q.T.shape
    nb = q.alpha.shape[-1]
    bs = K // nb
    alpha_e = torch.repeat_interleave(q.alpha, bs, dim=1)
    mu_e = torch.repeat_interleave(q.mu, bs, dim=1)
    W_visit = (alpha_e * q.T.float() + mu_e) * q.lane_valid.float()[None, :]
    W_pad = torch.zeros((n, m + 1), dtype=torch.float32, device=q.T.device)
    W_pad[:, q.perm.long()] = W_visit
    return W_pad[:, :m]
