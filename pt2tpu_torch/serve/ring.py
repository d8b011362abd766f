"""Ring KV caches: sliding-window layers keep only ``window`` cache slots
(counterpart of ``pt2tpu.serve.ring``).

A sliding layer never attends past its window, so its cache is a ring of W
slots, written at position ``p mod W``, instead of ``max_len``: gemma3 has 5
sliding layers of every 6 with W = 1024, so at long context its decode reads
and holds about a sixth of the flat cache's KV. Attention does not depend on
the order of the slots: a slot is either inside the window (valid) or
already overwritten. Keys are stored RoPE'd at their absolute positions, as
in the flat cache.

:class:`RingCaches` holds two stacks, the global layers'
(n_global, B, M, Hkv, hd) and the sliding layers' rings
(n_sliding, B, W, Hkv, hd), bf16, and is a pool the flat decode paths take
as they take a ``KVCache``: each layer writes and reads its kind's stack in
place. Its ``decode_views`` give a sliding layer its ring at ``pos % W``
with ``kv_valid = arange(W) <= pos`` (the window narrowing of
``decoder.sliding_adjust`` then keeps every slot: the ring is the window),
a global layer the full pool with ``kv_valid = arange(M) <= pos``, so both
go to K7 on the card where it takes the call. Its ``prefill_view`` attends
with the standard sliding mask over a one-layer staging cache and scatters
each layer's keys and values into its kind's stack.

:func:`ring_generate` is the greedy lockstep path (``generate``'s loop on
these pools); :func:`make_ring_engine_fns` plugs them into ``ServeEngine``
(per-row ring positions; a prompt longer than the window wraps). A config
with no sliding layer gets every layer in the global stack: the flat cache.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from ..models import decoder as dec
from ..utils.device import resolve_device
from .engine import _decode_step, _prefill_into_slot
from .generate import _lockstep
from .kvcache import KVCache, valid_slots

__all__ = ["RingCaches", "init_ring_caches", "ring_generate", "make_ring_engine_fns"]


@dataclasses.dataclass
class RingCaches:
    """Split stacked caches: full-length globals and window-length rings.

    glob: KVCache (n_global, B, M, Hkv, hd); ring: KVCache
    (n_sliding, B, W, Hkv, hd); either may hold no layer. ``is_global`` and
    ``kind_idx`` map the model's layer li to its stack and its index there:
    ``write``, ``write_rows`` and ``read`` take the model's li."""

    glob: KVCache
    ring: KVCache
    is_global: Tuple[bool, ...]
    kind_idx: Tuple[int, ...]

    quantized = False

    @property
    def max_len(self) -> int:
        return self.glob.max_len

    @property
    def window(self) -> int:
        return self.ring.max_len

    @property
    def nbytes(self) -> int:
        """The bytes of both stacks' keys and values."""
        return sum(t.numel() * t.element_size() for t in self.leaves())

    def leaves(self) -> List[torch.Tensor]:
        """The globals' tensors, then the rings'."""
        return self.glob.leaves() + self.ring.leaves()

    def _stack(self, li: int) -> Tuple[KVCache, int]:
        return (self.glob if self.is_global[li] else self.ring), self.kind_idx[li]

    def write(self, li, k_new, v_new, pos: int) -> None:
        stack, ki = self._stack(li)
        stack.write(ki, k_new, v_new, pos)

    def write_rows(self, li, k_new, v_new, positions: torch.Tensor) -> None:
        stack, ki = self._stack(li)
        stack.write_rows(ki, k_new, v_new, positions)

    def read(self, li, dtype=torch.bfloat16):
        stack, ki = self._stack(li)
        return stack.read(ki, dtype)

    def decode_views(self, positions, batch: int):
        """``KVCache.decode_views`` for the split pools: a global layer
        writes at its rows' positions and attends slots <= them; a sliding
        layer writes at position % W and attends the ring's slots that hold
        a position yet (all of them once a row passes W - 1)."""
        dev = self.glob.k.device
        pos_r = positions % self.window
        valid_g = valid_slots(self.max_len, positions, batch, dev)
        valid_r = valid_slots(self.window, positions, batch, dev)
        return lambda li: ((self, positions, valid_g) if self.is_global[li]
                           else (self, pos_r, valid_r))

    def prefill_view(self, start: int, stop: int, true_len: int) -> "_RingPrefill":
        return _RingPrefill(self, start, stop, true_len)


class _RingPrefill:
    """Rows [start, stop) of a :class:`RingCaches` seen by a prefill of
    ``true_len`` tokens at positions [0, Lb) (right pads past ``true_len``).
    Each layer's keys and values go to a one-layer staging cache of the
    pool's M slots, which its attention reads (the prefill's mask, causal
    and windowed, spans them all), and from there into its kind's stack: a
    global layer's rows take all M slots; slot s of a sliding layer's ring
    takes position t-1-((t-1-s) mod W), t = true_len, or zero where that is
    negative. A pad is never taken, and a prompt longer than the window
    leaves its newest W positions, rolled, as JAX's ``_ring_write_prefill``
    does."""

    quantized = False

    def __init__(self, caches: RingCaches, start: int, stop: int, true_len: int):
        self.caches, self.rows = caches, slice(start, stop)
        shape = (1, stop - start, caches.max_len) + tuple(caches.glob.k.shape[3:])
        dev = caches.glob.k.device
        # zeros: the masked slots past the prompt must hold finite values
        self.stage = KVCache(k=torch.zeros(shape, dtype=torch.bfloat16, device=dev),
                             v=torch.zeros(shape, dtype=torch.bfloat16, device=dev))
        t, W = int(true_len), caches.window
        p = (t - 1) - ((t - 1 - torch.arange(W, device=dev)) % W)  # (W,), < 0: no position
        self.held = (p >= 0)[:, None, None]
        self.taken = p.clamp(min=0)

    @property
    def max_len(self) -> int:
        return self.caches.max_len

    def write(self, li, k_new, v_new, pos: int) -> None:
        self.stage.write(0, k_new, v_new, pos)
        stack, ki = self.caches._stack(li)
        for dst, src in ((stack.k, self.stage.k[0]), (stack.v, self.stage.v[0])):
            if self.caches.is_global[li]:
                dst[ki, self.rows] = src
            else:
                dst[ki, self.rows] = torch.where(self.held, src[:, self.taken], 0)

    def read(self, li, dtype=torch.bfloat16):
        return self.stage.read(0, dtype)


def _kind_maps(cfg: dec.ModelConfig) -> Tuple[Tuple[bool, ...], Tuple[int, ...]]:
    """(is_global per layer, index of each layer within its kind's stack)."""
    gl = cfg.globals_list() if cfg.has_sliding else (True,) * cfg.n_layers
    idx, c = [], {True: 0, False: 0}
    for g in gl:
        idx.append(c[g])
        c[g] += 1
    return tuple(gl), tuple(idx)


def init_ring_caches(cfg: dec.ModelConfig, batch: int, max_len: int, device=None) -> RingCaches:
    """Zero bf16 stacks for ``cfg`` on ``device`` (default: the card): the
    global layers' of ``max_len`` slots, the sliding layers' rings of
    min(window, max_len). The flat cache is never allocated."""
    gl, idx = _kind_maps(cfg)
    n_g, n_s = sum(gl), len(gl) - sum(gl)
    dev = resolve_device(device)

    def make(n, m):
        shape = (n, batch, m, cfg.kv_heads, cfg.hd)
        return KVCache(k=torch.zeros(shape, dtype=torch.bfloat16, device=dev),
                       v=torch.zeros(shape, dtype=torch.bfloat16, device=dev))

    W = min(cfg.sliding_window or max_len, max_len)
    return RingCaches(glob=make(n_g, max_len), ring=make(n_s, W), is_global=gl, kind_idx=idx)


@torch.inference_mode()
def ring_generate(
    cfg: dec.ModelConfig,
    params,
    prompt,  # (B, Lp) int token ids
    max_new: int,
    max_len: Optional[int] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Greedy decode with ring caches on the sliding layers, on the device
    that holds ``params``: ``generate``'s lockstep loop on
    :func:`init_ring_caches`' pools, the prompt prefilled whole (as JAX's),
    the tokens of ``greedy_generate``. Returns (B, max_new) int32 ids."""
    return _lockstep(cfg, params, prompt, max_new, max_len, impl,
                     lambda B, M, dev: init_ring_caches(cfg, B, M, device=dev),
                     prefill_chunk=0)


def make_ring_engine_fns(cfg: dec.ModelConfig, impl: str = "auto", device=None):
    """(prefill_fn, decode_fn, cache_factory) for ``serve.ServeEngine``:
    continuous batching with window-sized ring pools on the sliding layers,
    bf16, the pools on ``device`` (default: the card); the engine's default
    prefill and decode on them, at this ``cfg`` and ``impl``. Usage::

        pf, df, factory = make_ring_engine_fns(cfg)
        eng = ServeEngine(cfg, params, prefill_fn=pf, decode_fn=df,
                          cache_factory=factory)
    """

    def prefill_fn(cfg_, params_, prompt, true_len, caches, slot, impl_=None, samp=None):
        return _prefill_into_slot(cfg, params_, prompt, true_len, caches, slot, impl, samp)

    def decode_fn(cfg_, params_, tokens, caches, positions, active, impl_=None, samp=None):
        return _decode_step(cfg, params_, tokens, caches, positions, active, impl, samp)

    def cache_factory(cfg_, max_batch, max_len):
        return init_ring_caches(cfg_, max_batch, max_len, device=device)

    return prefill_fn, decode_fn, cache_factory
