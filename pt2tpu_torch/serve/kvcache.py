"""bf16 KV cache (counterpart of ``pt2tpu.serve.kvcache``).

The JAX cache is immutable: its layer scan threads the stacked arrays
through the carry and XLA aliases the buffers so a write touches one token
row. Here the cache is simply updated in place: :meth:`KVCache.write`
assigns the new rows into the preallocated (n_layers, B, M, Hkv, hd)
buffers, and nothing is copied per step.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..utils.device import resolve_device

__all__ = ["KVCache", "init_cache"]


@dataclasses.dataclass
class KVCache:
    """k/v: (n_layers, B, M, Hkv, hd) bf16."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    def write(self, li: int, k_new: torch.Tensor, v_new: torch.Tensor, pos: int) -> None:
        """Write (B, L, Hkv, hd) keys/values at positions [pos, pos+L) of
        layer ``li``, in place."""
        L = k_new.shape[1]
        if pos < 0 or pos + L > self.max_len:
            raise ValueError(f"write [{pos}, {pos + L}) outside cache of {self.max_len}")
        self.k[li, :, pos : pos + L] = k_new.to(self.k.dtype)
        self.v[li, :, pos : pos + L] = v_new.to(self.v.dtype)

    def read(self, li: int, dtype=torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
        """Layer ``li``'s full (B, M, Hkv, hd) keys/values in ``dtype``."""
        return self.k[li].to(dtype), self.v[li].to(dtype)


def init_cache(cfg, batch: int, max_len: int, quantized: bool = False, device=None) -> KVCache:
    """Allocate an empty cache for ``cfg`` on ``device`` (default: the card)."""
    if quantized:
        raise NotImplementedError("int8 KV cache not ported")
    shape = (cfg.n_layers, batch, max_len, cfg.kv_heads, cfg.hd)
    dev = resolve_device(device)
    return KVCache(
        k=torch.zeros(shape, dtype=torch.bfloat16, device=dev),
        v=torch.zeros(shape, dtype=torch.bfloat16, device=dev),
    )
