"""Hessian accumulation and damped inversion for GPTQ: counterpart of
``pt2tpu.quant.hessian``.

  * H += X^T X over calibration batches, in f32 (no TF32 on the card);
  * H / nsamples, the correctly rounded quotient on every device;
  * damping diag += percdamp * mean(diag), escalated x10 while the Cholesky
    factorisation fails or its inverse is not finite, up to ``max_retries``
    attempts, then pinv (the JAX package's own last resort, logged by the
    caller's ``MetricsLogger`` where one is given).

``torch.linalg.cholesky_ex`` reports a failed factorisation in ``info``
without raising; the inverse is ``torch.cholesky_inverse`` of the factor.
The JAX package's column-block solve is a workaround for the TPU compiler's
workspace and has no counterpart here.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

from ..utils.device import quotient_f32, resolve_device

__all__ = ["HessianAccumulator", "accumulate_hessian", "damped_inverse", "full_f32"]


@contextlib.contextmanager
def full_f32():
    """f32 products in full f32 on the card (TF32 off) for the block, as the
    JAX package computes Hessians and GPTQ; restores the settings after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def accumulate_hessian(H: torch.Tensor, X: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """One rank-k update H + X^T X over X's rows (leading dims flattened).
    Returns (updated H, rows added)."""
    X2 = X.reshape(-1, X.shape[-1]).float()
    with full_f32():
        H = H + X2.t() @ X2
    return H, X2.shape[0]


class HessianAccumulator:
    """Streaming H = X^T X for one linear layer, kept in f32 on ``device``
    (default: the card)."""

    def __init__(self, in_features: int, device=None):
        self.in_features = in_features
        self.H = torch.zeros((in_features, in_features), dtype=torch.float32,
                             device=resolve_device(device))
        self.nsamples = 0

    def update(self, X: torch.Tensor) -> None:
        self.H, n = accumulate_hessian(self.H, X.to(self.H.device))
        self.nsamples += int(n)

    def normalized(self) -> torch.Tensor:
        """H / nsamples, undamped."""
        return quotient_f32(self.H, float(max(self.nsamples, 1)))


def _attempt(H: torch.Tensor, damp: torch.Tensor, eye: torch.Tensor):
    Hd = H + damp * eye
    with full_f32():
        L, info = torch.linalg.cholesky_ex(Hd)
        Hinv = torch.cholesky_inverse(L)
    ok = (info == 0) & torch.isfinite(Hinv).all()
    return Hd, Hinv, ok


def damped_inverse(
    H: torch.Tensor,
    percdamp: float = 0.01,
    max_retries: int = 4,
    log: Optional[object] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Damp and invert a normalized Hessian: returns (H_damped, H_inv).

    Damping starts at ``percdamp * mean(diag(H))`` and is multiplied by 10
    while the factorisation fails, ``max_retries`` attempts in all; then the
    pseudo-inverse of the last damped H. ``log`` (a MetricsLogger) records
    that fallback."""
    H = H.float()
    eye = torch.eye(H.shape[0], dtype=torch.float32, device=H.device)
    damp = percdamp * torch.diagonal(H).mean()
    Hd, Hinv, ok = _attempt(H, damp, eye)
    k = 1
    while not bool(ok) and k < max_retries:
        damp = damp * 10.0
        Hd, Hinv, ok = _attempt(H, damp, eye)
        k += 1
    if bool(ok):
        return Hd, Hinv
    if log is not None:
        log.emit("damped_inverse_pinv", dim=int(H.shape[0]), attempts=k)
    with full_f32():
        return Hd, torch.linalg.pinv(Hd)
