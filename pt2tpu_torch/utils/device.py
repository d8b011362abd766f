"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The card unless the caller asks for another device. A CUDA request
    without a GPU raises; nothing carries on on the CPU instead."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but no GPU is available (pass device='cpu' to run on the CPU)"
        )
    return dev
