"""KV cache, bf16 or int8 (counterpart of ``pt2tpu.serve.kvcache``).

The JAX cache is immutable: its layer scan threads the stacked arrays
through the carry and XLA aliases the buffers so a write touches one token
row. Here the cache is a plain dataclass of preallocated
(n_layers, B, M, Hkv, hd) tensors updated in place: :meth:`KVCache.write`
assigns rows at one position for every batch row (prefill, lockstep decode),
:meth:`KVCache.write_rows` at a position per row (the continuous-batching
engine). Nothing is copied per step.

int8 scheme (the JAX package's): symmetric absmax per (row, position, head)
over the head dim, ``scale = max|x| / 127`` floored at 1e-8, f32 scales of
shape (n_layers, B, M, Hkv, 1). :meth:`KVCache.read_raw` hands the int8
values and their scales to attention, which folds the scales into the
scores and the probabilities instead of materialising a bf16 copy.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from ..utils.device import quotient_f32, resolve_device

__all__ = ["KVCache", "init_cache", "quantize_i8"]


def quantize_i8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., hd) -> (int8 values, (..., 1) f32 scales): absmax / 127, floored
    at 1e-8, round half to even (as ``jnp.round``), clipped to +-127.

    JAX's bytes and scales on every device: the scale is the correctly
    rounded quotient (``utils.device.quotient_f32``; on CUDA, PyTorch would
    divide by the scalar 127 as a product with its rounded reciprocal, an
    ulp off for some vectors and then a code off by one where a quotient
    sits at a half)."""
    x32 = x.float()
    scale = quotient_f32(x32.abs().amax(dim=-1, keepdim=True), 127.0).clamp_min(1e-8)
    q = torch.round(x32 / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


@dataclasses.dataclass
class KVCache:
    """k/v: (n_layers, B, M, Hkv, hd), bf16 or int8; k_scale/v_scale:
    (n_layers, B, M, Hkv, 1) f32 for int8, else None."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    def rows(self, start: int, stop: int) -> "KVCache":
        """A cache over batch rows [start, stop) that shares this one's
        storage: writes through it land in this cache."""
        sl = lambda t: None if t is None else t[:, start:stop]  # noqa: E731
        return KVCache(sl(self.k), sl(self.v), sl(self.k_scale), sl(self.v_scale))

    def _put(self, li: int, idx, k_new: torch.Tensor, v_new: torch.Tensor) -> None:
        if not self.quantized:
            self.k[li][idx] = k_new.to(self.k.dtype)
            self.v[li][idx] = v_new.to(self.v.dtype)
            return
        kq, ks = quantize_i8(k_new)
        vq, vs = quantize_i8(v_new)
        self.k[li][idx] = kq
        self.v[li][idx] = vq
        self.k_scale[li][idx] = ks
        self.v_scale[li][idx] = vs

    def write(self, li: int, k_new: torch.Tensor, v_new: torch.Tensor, pos: int) -> None:
        """Write (B, L, Hkv, hd) keys/values at positions [pos, pos+L) of
        layer ``li``, in place."""
        L = k_new.shape[1]
        if pos < 0 or pos + L > self.max_len:
            raise ValueError(f"write [{pos}, {pos + L}) outside cache of {self.max_len}")
        self._put(li, (slice(None), slice(pos, pos + L)), k_new, v_new)

    def write_rows(self, li: int, k_new: torch.Tensor, v_new: torch.Tensor,
                   positions: torch.Tensor) -> None:
        """Write (B, Lw, Hkv, hd) keys/values of row b at positions
        [positions[b], positions[b] + Lw) of layer ``li``, in place.
        ``positions`` is a (B,) integer tensor on the cache's device; every
        column must lie inside the cache (the caller clamps rows it does not
        use: JAX drops out-of-range writes, torch would not)."""
        B, Lw = k_new.shape[:2]
        rows = torch.arange(B, device=positions.device)[:, None]
        cols = positions.long()[:, None] + torch.arange(Lw, device=positions.device)[None, :]
        self._put(li, (rows, cols), k_new, v_new)

    def read(self, li: int, dtype=torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
        """Layer ``li``'s full (B, M, Hkv, hd) bf16 keys/values in ``dtype``.
        An int8 cache is read through :meth:`read_raw` only."""
        if self.quantized:
            raise ValueError("an int8 cache is read raw (read_raw), not dequantized")
        return self.k[li].to(dtype), self.v[li].to(dtype)

    def read_raw(self, li: int):
        """Layer ``li``'s (k, v, k_scale, v_scale) as stored: views, no
        dequantization (scales None for bf16)."""
        ks = None if self.k_scale is None else self.k_scale[li]
        vs = None if self.v_scale is None else self.v_scale[li]
        return self.k[li], self.v[li], ks, vs

    def leaves(self) -> List[torch.Tensor]:
        """The pool's tensors, in the order a snapshot stores them."""
        return [t for t in (self.k, self.v, self.k_scale, self.v_scale) if t is not None]

    def prefill_view(self, start: int, stop: int, true_len: int) -> "KVCache":
        """What a prefill of rows [start, stop) writes and attends through
        (``true_len`` tokens, right pads past them): those rows, in place."""
        return self.rows(start, stop)

    def decode_views(self, positions, batch: int):
        """The per-layer (cache, cache_pos, kv_valid) of a one-token decode
        step whose rows sit at ``positions`` (an int for every row, or a (B,)
        long tensor on the cache's device): every layer writes there and
        attends the whole pool up to its row's position (a sliding layer
        narrows that to its window, ``decoder.sliding_adjust``)."""
        valid = valid_slots(self.max_len, positions, batch, self.k.device)
        return lambda li: (self, positions, valid)


def valid_slots(n: int, positions, batch: int, device) -> torch.Tensor:
    """(batch, n) bool: slot j is valid where j <= its row's position (an
    int for every row, or a (B,) tensor)."""
    slots = torch.arange(n, device=device)[None, :]
    if isinstance(positions, torch.Tensor):
        return slots <= positions[:, None]
    return (slots <= positions).expand(batch, n)


def init_cache(cfg, batch: int, max_len: int, quantized: bool = False, device=None) -> KVCache:
    """Allocate an empty cache for ``cfg`` on ``device`` (default: the card)."""
    L, Hkv, hd = cfg.n_layers, cfg.kv_heads, cfg.hd
    shape = (L, batch, max_len, Hkv, hd)
    dev = resolve_device(device)
    if quantized:
        return KVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=dev),
            v=torch.zeros(shape, dtype=torch.int8, device=dev),
            k_scale=torch.zeros((L, batch, max_len, Hkv, 1), dtype=torch.float32, device=dev),
            v_scale=torch.zeros((L, batch, max_len, Hkv, 1), dtype=torch.float32, device=dev),
        )
    return KVCache(
        k=torch.zeros(shape, dtype=torch.bfloat16, device=dev),
        v=torch.zeros(shape, dtype=torch.bfloat16, device=dev),
    )
