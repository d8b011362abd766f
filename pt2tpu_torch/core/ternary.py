"""Asymmetric Ternary Quantizer (ATQ): counterpart of ``pt2tpu.core.ternary``.

  * ``ternary_init``   — asymmetric init: row mean, 0.75-mean-deviation
                         threshold, the scale that fits those codes;
  * ``optimal_grid``   — closed-form (alpha*, mu*) for fixed codes T;
  * ``flexible_round`` — nearest-ternary rounding on a grid;
  * ``itf``            — iterative ternary fitting until T is a fixed point;
  * ``aga`` / ``aga_exact`` — activation-aware grid alignment from
                         S = X^T X, with the degeneracy fallback;
  * ``atq_quantize``   — init, ITF, then AGA.

Every function takes an optional per-column validity ``mask`` so that a
fixed-width (padded) block gives the math of the unpadded one, as in the JAX
package. All math is f32; every division is tensor by tensor (a Python-scalar
divisor on CUDA is a product with a rounded reciprocal, an ulp off).

ITF is a host loop where JAX has ``lax.while_loop``: its stop test ("T
unchanged", over the whole block) is read on the host each iteration.
Iteration 0 compares against an all-zero T, as in JAX, so an all-zero
initial T returns untouched. (Reading the test only every few iterations,
which the body's idempotence at its fixed point allows, measured no faster
on an H100: PERF.md.)
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

__all__ = [
    "ternary_init",
    "optimal_grid",
    "flexible_round",
    "itf",
    "aga",
    "aga_exact",
    "atq_quantize",
    "dequantize",
    "quantization_error",
    "output_error",
    "ATQResult",
]

_EPS = 1e-8
_DEFAULT_MAX_ITER = 100


class ATQResult(NamedTuple):
    """Result of a full ATQ fit over a (n, m) weight block."""

    alpha: torch.Tensor  # (n, 1) row-wise scale
    mu: torch.Tensor  # (n, 1) row-wise offset
    T: torch.Tensor  # (n, m) ternary codes in {-1, 0, +1}, float32


def _mask_or_ones(W: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return torch.ones((W.shape[-1],), dtype=W.dtype, device=W.device)
    return mask.to(W.dtype)


def _ternary(Z: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """1 where Z > hi, -1 where Z < lo, else 0 (f32)."""
    return (Z > hi).to(Z.dtype) - (Z < lo).to(Z.dtype)


def ternary_init(
    W: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """mu = row mean; delta = 0.75 * row mean |W - mu|; T = sign(W - mu)
    where |W - mu| > delta; alpha = sum(T (W - mu)) / sum |T|. Invalid
    columns contribute nothing and get T = 0."""
    m = _mask_or_ones(W, mask)
    count = torch.clamp_min(m.sum(), 1.0)

    mu = (W * m).sum(dim=-1, keepdim=True) / count
    Wc = (W - mu) * m
    delta = 0.75 * Wc.abs().sum(dim=-1, keepdim=True) / count

    T = _ternary(Wc, -delta, delta) * m

    numer = (T * Wc).sum(dim=-1, keepdim=True)
    denom = torch.clamp_min(T.abs().sum(dim=-1, keepdim=True), _EPS)
    return numer / denom, mu, T


def optimal_grid(
    W: torch.Tensor, T: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form least-squares (alpha*, mu*) for fixed T over the valid
    columns (count m):

      alpha* = (m (W∘T)1 - (T1)(W1)) / (m (T∘T)1 - (T1)^2)
      mu*    = ((T∘T)1 (W1) - (T1)(W∘T)1) / (m (T∘T)1 - (T1)^2)
    """
    msk = _mask_or_ones(W, mask)
    count = torch.clamp_min(msk.sum(), 1.0)

    Wm = W * msk
    Tm = T * msk
    WT_sum = (Wm * Tm).sum(dim=-1, keepdim=True)
    T_sum = Tm.sum(dim=-1, keepdim=True)
    W_sum = Wm.sum(dim=-1, keepdim=True)
    T2_sum = (Tm * Tm).sum(dim=-1, keepdim=True)

    denom = torch.clamp_min(count * T2_sum - T_sum * T_sum, _EPS)
    alpha = (count * WT_sum - T_sum * W_sum) / denom
    mu = (T2_sum * W_sum - T_sum * WT_sum) / denom
    return alpha, mu


def flexible_round(
    W: torch.Tensor,
    alpha: torch.Tensor,
    mu: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Z = (W - mu) / max(alpha, eps); T = 1[Z > .5] - 1[Z < -.5]."""
    msk = _mask_or_ones(W, mask)
    Z = (W - mu) / torch.clamp_min(alpha, _EPS)
    half = torch.tensor(0.5, dtype=Z.dtype, device=Z.device)
    return _ternary(Z, -half, half) * msk


def itf(
    W: torch.Tensor,
    alpha: torch.Tensor,
    mu: torch.Tensor,
    T: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    max_iter: int = _DEFAULT_MAX_ITER,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Iterative Ternary Fitting: alternate ``optimal_grid`` and
    ``flexible_round`` until T is a fixed point or ``max_iter`` iterations
    ran. Returns the last grid and the last T."""
    T_prev = torch.zeros_like(T)
    it = 0
    while it < max_iter and bool((T != T_prev).any()):
        alpha, mu = optimal_grid(W, T, mask)
        T, T_prev = flexible_round(W, alpha, mu, mask), T
        it += 1
    return alpha, mu, T


def _solve_2x2(tSt, d, v, tSw, wS1, fallback):
    """alpha, mu of [[tSt, v], [v, d]] [alpha, mu] = [tSw, wS1] by Cramer's
    rule, the determinant clamped at eps; rows whose system degenerates
    (det <= 1e-6 of its scale) keep ``fallback``'s grid."""
    det_raw = tSt * d - v * v
    det = torch.clamp_min(det_raw, _EPS)
    alpha = (d * tSw - v * wS1) / det
    mu = (tSt * wS1 - v * tSw) / det
    if fallback is not None:
        scale = (tSt * d).abs() + v * v + _EPS
        ok = det_raw > 1e-6 * scale
        fa, fm = fallback
        alpha = torch.where(ok, alpha, fa)
        mu = torch.where(ok, mu, fm)
    return alpha, mu


def aga(
    W: torch.Tensor,
    T: torch.Tensor,
    S: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    fallback: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Activation-aware Grid Alignment, the reference's closed form, from
    S = X^T X (m, m): s1 = S 1, d = 1^T S 1, v = T s1,

      alpha* = (d (W∘T)s1 - v (W s1)) / (d (T∘T)s1 - v^2)
      mu*    = ((T∘T)s1 (W s1) - v (W∘T)s1) / (d (T∘T)s1 - v^2)

    Invalid rows/columns of S are masked to zero. With ``fallback`` (the ITF
    grid), near-singular rows keep it."""
    msk = _mask_or_ones(W, mask)
    Sm = S * msk[None, :] * msk[:, None]
    s1 = Sm.sum(dim=-1)[:, None]  # (m, 1)
    d = s1.sum()

    Tm = T * msk
    Wm = W * msk
    v = Tm @ s1
    WS1 = Wm @ s1
    WT_S1 = (Wm * Tm) @ s1
    T2_S1 = (Tm * Tm) @ s1
    return _solve_2x2(T2_S1, d, v, WT_S1, WS1, fallback)


def aga_exact(
    W: torch.Tensor,
    T: torch.Tensor,
    S: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    fallback: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact grid alignment: the per-row normal equations of
    min ||(w - alpha t - mu 1) X^T||^2,

        [ t S t^T   t S 1 ] [alpha]   [ t S w^T ]
        [ t S 1     1 S 1 ] [ mu  ] = [ 1 S w^T ]

    Degenerate rows (t proportional to 1 under S) keep ``fallback``."""
    msk = _mask_or_ones(W, mask)
    Sm = S * msk[None, :] * msk[:, None]
    s1 = Sm.sum(dim=-1)[:, None]
    d = s1.sum()

    Tm = T * msk
    Wm = W * msk
    TS = Tm @ Sm  # (n, m)
    tSt = (TS * Tm).sum(dim=-1, keepdim=True)
    tSw = (TS * Wm).sum(dim=-1, keepdim=True)
    v = Tm @ s1
    wS1 = Wm @ s1
    return _solve_2x2(tSt, d, v, tSw, wS1, fallback)


def atq_quantize(
    W: torch.Tensor,
    S: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    use_aga: bool = True,
    max_iter: int = _DEFAULT_MAX_ITER,
    aga_mode: str = "exact",
) -> ATQResult:
    """Full ATQ: init -> ITF -> AGA. AGA is skipped without ``S`` or with
    ``use_aga`` False. ``aga_mode``: "exact" (:func:`aga_exact`),
    "reference" (:func:`aga` with S as the covariance) or "reference_quirk"
    (:func:`aga` on S^T S, the reference code's use of the Hessian block as
    activations)."""
    if aga_mode not in ("exact", "reference", "reference_quirk"):
        raise ValueError(f"unknown aga_mode {aga_mode!r}")
    W = W.float()
    alpha, mu, T = ternary_init(W, mask)
    alpha, mu, T = itf(W, alpha, mu, T, mask, max_iter=max_iter)
    if use_aga and S is not None:
        S32 = S.float()
        if aga_mode == "reference_quirk":
            msk = _mask_or_ones(W, mask)
            Sm = S32 * msk[None, :] * msk[:, None]
            S32 = Sm.t() @ Sm
            fn = aga
        else:
            fn = aga_exact if aga_mode == "exact" else aga
        alpha, mu = fn(W, T, S32, mask, fallback=(alpha, mu))
    return ATQResult(alpha=alpha, mu=mu, T=T)


def dequantize(alpha: torch.Tensor, mu: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """W_c = alpha * T + mu."""
    return alpha * T.to(alpha.dtype) + mu


def quantization_error(W: torch.Tensor, W_c: torch.Tensor) -> torch.Tensor:
    """E_w = ||W - W_c||_F^2."""
    d = W - W_c
    return (d * d).sum()


def output_error(W: torch.Tensor, W_c: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """E_x = ||(W - W_c) X^T||_F^2."""
    X = X.reshape(-1, X.shape[-1])
    d = (W - W_c) @ X.t()
    return (d * d).sum()
