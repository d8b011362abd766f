"""Paged KV cache (counterpart of ``pt2tpu.serve.paged``): pooled pages of
fixed size and a page table per slot.

The flat slot pool (``serve.kvcache``) reserves ``max_len`` positions a
slot; under mixed request lengths most of that is dead memory. Paging pools
it:

  * one (n_layers, n_pages, page_size, Hkv, hd) pool per k and v (int8
    pools with f32 scales beside them): the total KV memory is chosen, not
    the memory a slot;
  * a (B, max_pages) int32 page table maps each slot's logical positions
    to pool pages; allocation and freeing are host bookkeeping (a stack of
    free pages), as slot scheduling is, so no tensor shape ever changes;
  * a decode step writes a row's token at (layer, table[row, pos // ps],
    pos % ps); attention gathers the row's pages back into logical order
    (M = max_pages * page_size positions) and runs as on the flat pool, K7
    on the card included. The gather is torch indexing, as JAX computes it
    outside Pallas; it copies a row's whole logical cache every layer of
    every step.

``PagedServeEngine`` drops in for ServeEngine: the same submit() / run(), the
same greedy tokens, but slots oversubscribe sequence capacity as long as
the live tokens fit the pool.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..models import decoder as dec
from ..utils.device import resolve_device
from .engine import ServeEngine, _bucket, _rope
from .kvcache import init_cache, quantize_i8, valid_slots
from .sampling import sample_per_row

__all__ = ["PagedKV", "PagedServeEngine", "init_paged"]


@dataclasses.dataclass
class PagedKV:
    """Pooled paged cache. k/v: (L, P, ps, Hkv, hd) bf16 or int8; k_scale /
    v_scale: (L, P, ps, Hkv, 1) f32 for int8, else None; table: (B, maxp)
    int32 page ids on the pool's device (unallocated entries point at page
    0, the scratch page, and are masked by position validity)."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]
    v_scale: Optional[torch.Tensor]
    table: torch.Tensor

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def page_size(self) -> int:
        return self.k.shape[2]

    @property
    def max_len(self) -> int:  # logical capacity of a slot
        return self.table.shape[1] * self.page_size

    def leaves(self) -> List[torch.Tensor]:
        """The pool's tensors, in the order a snapshot stores them (JAX's
        pytree order: k, v, scales, table)."""
        return [t for t in (self.k, self.v, self.k_scale, self.v_scale, self.table)
                if t is not None]

    def decode_views(self, positions, batch: int):
        """The per-layer (view, cache_pos, kv_valid) of a one-token decode
        step at per-row ``positions`` (a (B,) long tensor on the device)."""
        valid = valid_slots(self.max_len, positions, batch, self.k.device)
        view = _PagedView(self)
        return lambda li: (view, positions, valid)


class _PagedView:
    """What ``layer_forward`` writes and reads through on a decode step:
    per-row one-token writes through the page table; reads gather each
    row's pages into logical order, (B, M, Hkv, hd). An int8 pool is read
    raw (values and scales, as ``KVCache.read_raw``), never dequantised."""

    def __init__(self, pool: PagedKV):
        self.pool = pool

    @property
    def quantized(self) -> bool:
        return self.pool.quantized

    def write_rows(self, li: int, k_new: torch.Tensor, v_new: torch.Tensor,
                   positions: torch.Tensor) -> None:
        """(B, 1, Hkv, hd) keys / values at per-row ``positions`` (B,)."""
        if k_new.shape[1] != 1:
            raise ValueError(f"a paged pool takes one token a row per step, got {k_new.shape[1]}")
        p = self.pool
        ps = p.page_size
        rows = torch.arange(k_new.shape[0], device=positions.device)
        pos = positions.long()
        page = p.table[rows, pos // ps].long()
        off = pos % ps
        if not p.quantized:
            p.k[li, page, off] = k_new[:, 0].to(p.k.dtype)
            p.v[li, page, off] = v_new[:, 0].to(p.v.dtype)
            return
        kq, ks = quantize_i8(k_new[:, 0])
        vq, vs = quantize_i8(v_new[:, 0])
        p.k[li, page, off] = kq
        p.v[li, page, off] = vq
        p.k_scale[li, page, off] = ks
        p.v_scale[li, page, off] = vs

    def _gather(self, t: torch.Tensor, li: int) -> torch.Tensor:
        B, maxp = self.pool.table.shape
        g = t[li][self.pool.table.long()]  # (B, maxp, ps, ...)
        return g.reshape(B, maxp * g.shape[2], *g.shape[3:])

    def read(self, li: int, dtype=torch.bfloat16):
        if self.quantized:
            raise ValueError("an int8 paged pool is read raw (read_raw), not dequantized")
        return self._gather(self.pool.k, li).to(dtype), self._gather(self.pool.v, li).to(dtype)

    def read_raw(self, li: int):
        p = self.pool
        if not p.quantized:
            return self._gather(p.k, li), self._gather(p.v, li), None, None
        return (self._gather(p.k, li), self._gather(p.v, li), self._gather(p.k_scale, li),
                self._gather(p.v_scale, li))


def init_paged(cfg, n_pages: int, page_size: int, max_batch: int, max_pages_per_slot: int,
               quantized: bool = False, device=None) -> PagedKV:
    """An empty pool of ``n_pages`` pages (page 0 included) for ``cfg`` on
    ``device`` (default: the card), bf16 or int8 as ``init_cache`` makes
    them, the table all zeros."""
    L, Hkv, hd = cfg.n_layers, cfg.kv_heads, cfg.hd
    shape = (L, n_pages, page_size, Hkv, hd)
    dev = resolve_device(device)
    table = torch.zeros((max_batch, max_pages_per_slot), dtype=torch.int32, device=dev)
    if quantized:
        sshape = (L, n_pages, page_size, Hkv, 1)
        return PagedKV(k=torch.zeros(shape, dtype=torch.int8, device=dev),
                       v=torch.zeros(shape, dtype=torch.int8, device=dev),
                       k_scale=torch.zeros(sshape, dtype=torch.float32, device=dev),
                       v_scale=torch.zeros(sshape, dtype=torch.float32, device=dev),
                       table=table)
    return PagedKV(k=torch.zeros(shape, dtype=torch.bfloat16, device=dev),
                   v=torch.zeros(shape, dtype=torch.bfloat16, device=dev), k_scale=None,
                   v_scale=None, table=table)


def _paged_prefill(cfg, params, prompt: torch.Tensor, true_len: int, cache: PagedKV,
                   pages: torch.Tensor, impl="auto", samp=None):
    """Prefill a right-padded (1, Lb) prompt on a temporary flat cache of Lb
    positions, then scatter its k/v into ``pages`` (Lb / ps page ids, a long
    tensor on the device). ``samp`` None (greedy) or (seed, uid,
    SamplingConfig). Returns (the first token as a device scalar, the
    pool)."""
    ps = cache.page_size
    Lb = prompt.shape[1]
    M = cache.max_len
    dev = prompt.device
    tmp = init_cache(cfg, 1, Lb, quantized=cache.quantized, device=dev)
    h = dec.embed_tokens(cfg, params, prompt)
    cos_all, sin_all, cosl_all, sinl_all = _rope(cfg, M, dev)
    cos_l = None if cosl_all is None else cosl_all[:Lb]
    sin_l = None if sinl_all is None else sinl_all[:Lb]
    mask = dec.build_mask(cfg, Lb, Lb, device=dev)
    for li in range(cfg.n_layers):
        lp = dec.layer_view(params["layers"], li)
        h = dec.layer_forward(cfg, lp, h, cos_all[:Lb], sin_all[:Lb], mask, cache=tmp,
                              cache_pos=0, impl=impl, layer_idx=li, cos_loc=cos_l,
                              sin_loc=sin_l)
    logits = dec.unembed(cfg, params, h[:, true_len - 1 : true_len])[:, 0]  # (1, V)
    L = cfg.n_layers
    for dst, src in zip(cache.leaves()[:-1], tmp.leaves()):
        dst[:, pages] = src[:, 0].reshape(L, Lb // ps, ps, *src.shape[3:])
    if samp is None:
        return torch.argmax(logits[0]), cache
    seed, uid, sc = samp
    return sample_per_row(logits, seed, [uid], [true_len - 1], [sc.temperature], [sc.top_k],
                          [sc.top_p])[0], cache


class PagedServeEngine(ServeEngine):
    """Continuous batching over a paged KV pool.

    ``kv_pages`` pages of ``page_size`` tokens are shared by all slots (page
    0 beside them is the scratch page: idle slots and unallocated table
    entries point at it, so their don't-care writes never reach a live
    page); a slot's capacity is bounded by ``max_len`` (the table's width),
    but memory goes only to live tokens. Admission waits in the queue while
    the pool lacks a prefill bucket's pages (they free as requests retire);
    running out mid-decode raises.

    Before each quantum of q decode steps the engine allocates every page
    its active rows will write, up to position + q - 1, so any quantum gives
    the flat engine's tokens. (JAX allocates only the page of the current
    position, before admission: at quantum > 1 the later steps of a quantum
    that cross a page boundary write to the scratch page, and so does the
    first decode step of a prompt that fills its bucket exactly. At quantum
    1 the port allocates what JAX allocates, in the same order, and the
    second allocation finds nothing left to do but in that last case.)
    """

    def __init__(self, cfg, params, max_batch: int = 8, max_len: int = 2048,
                 kv_pages: Optional[int] = None, page_size: int = 64, impl: str = "auto",
                 seed: int = 0, kv_quant: bool = False, decode_quantum: int = 1):
        if max_len % page_size:
            raise ValueError("max_len must be a multiple of page_size")
        maxp = max_len // page_size
        kv_pages = kv_pages or max_batch * maxp  # default: the flat pool's positions
        device = params["embed"].device
        super().__init__(
            cfg, params, max_batch=max_batch, max_len=max_len, impl=impl, seed=seed,
            decode_quantum=decode_quantum, prefill_fn=self._pf,
            cache_factory=lambda c, b, m: init_paged(c, kv_pages + 1, page_size, b, maxp,
                                                     quantized=kv_quant, device=device),
        )
        self.ps = page_size
        self._bucket_lo = page_size  # prefill buckets stay page-aligned
        self._free: List[int] = list(range(kv_pages, 0, -1))
        self._pages: List[List[int]] = [[] for _ in range(max_batch)]
        self._table = np.zeros((max_batch, maxp), np.int32)
        self._table_dirty = False

    # -------------------------------------------------- page accounting --
    def _alloc(self, slot: int, n: int) -> bool:
        if len(self._free) < n:
            return False
        for _ in range(n):
            pg = self._free.pop()
            self._table[slot, len(self._pages[slot])] = pg
            self._pages[slot].append(pg)
        self._table_dirty = True
        return True

    def _release(self, slot: int) -> None:
        self._free.extend(reversed(self._pages[slot]))
        self._pages[slot] = []
        self._table[slot] = 0
        self._table_dirty = True

    def _reserve(self, slot: int, last_pos: int) -> None:
        """Allocate ``slot``'s pages up to the one holding ``last_pos``."""
        need = min(last_pos, self.M - 1) // self.ps + 1
        while len(self._pages[slot]) < need:
            if not self._alloc(slot, 1):
                raise RuntimeError(
                    "paged KV pool exhausted mid-decode; size kv_pages for worst-case live "
                    "tokens (eviction/preemption is future work)")

    def _maybe_finish(self, slot: int) -> None:
        req = self.slots[slot]
        super()._maybe_finish(slot)
        if req is not None and self.slots[slot] is None:
            self._release(slot)

    # ---------------------------------------------------- engine hooks --
    def _plan_admissions(self):
        """Admit only while the pool has the prefill bucket's pages
        (requests wait in the queue otherwise)."""
        plans = []
        for slot in range(self.B):
            if self.slots[slot] is not None or not self.queue:
                continue
            req = self.queue[0]
            Lp = len(req.prompt)
            if Lp + req.max_new > self.M:
                self.queue.pop(0)
                req.done = True
                req.out = []
                self.finished.append(req)
                continue
            need = min(_bucket(Lp, self.ps), self.M) // self.ps
            if not self._alloc(slot, need):
                break  # pool exhausted: wait for retirements
            plans.append((slot, self.queue.pop(0)))
        return plans

    def _pf(self, cfg, params, prompt, true_len, cache, slot, impl="auto", samp=None):
        pages = torch.as_tensor(self._table[slot, : prompt.shape[1] // self.ps].astype(np.int64))
        return _paged_prefill(cfg, params, prompt, true_len, cache, pages.to(prompt.device),
                              impl, samp)

    def _step(self) -> bool:
        # JAX's allocation: the page of each active row's current position
        for slot in range(self.B):
            if self.slots[slot] is not None:
                self._reserve(slot, int(self.positions[slot]))
        return super()._step()

    def _before_decode(self, q: int) -> None:
        """Every page the active rows write in this quantum, then the table
        on the device."""
        for slot in range(self.B):
            if self.slots[slot] is not None:
                self._reserve(slot, int(self.positions[slot]) + q - 1)
        if self._table_dirty:
            self.cache.table.copy_(torch.from_numpy(self._table))
            self._table_dirty = False

    # ------------------------------------------------ snapshot support --
    def _snapshot_extra(self):
        """The host page bookkeeping for ``save_engine_state`` (the device
        table rides the pool's leaves)."""
        return {"free": list(self._free), "pages": [list(p) for p in self._pages],
                "table": self._table.copy()}

    def _restore_extra(self, extra) -> None:
        self._free = list(extra["free"])
        self._pages = [list(p) for p in extra["pages"]]
        self._table[:] = extra["table"]
        self._table_dirty = True
