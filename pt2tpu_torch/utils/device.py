"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch

__all__ = ["quotient_f32", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The card unless the caller asks for another device. A CUDA request
    without a GPU raises; nothing carries on on the CPU instead."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but no GPU is available (pass device='cpu' to run on the CPU)"
        )
    return dev


def quotient_f32(t: torch.Tensor, divisor: float) -> torch.Tensor:
    """``t / divisor`` for an f32 tensor, the correctly rounded f32 quotient
    on every device, as JAX and the CPU give it. On CUDA, PyTorch divides by
    a Python scalar as a product with its rounded reciprocal, an ulp off for
    some values; the quotient taken in f64 and rounded to f32 is exact (f64
    carries more than twice f32's precision). Three launches (to f64, the
    division, back to f32), no state, so a CUDA graph may capture it."""
    return (t.double() / divisor).float()
