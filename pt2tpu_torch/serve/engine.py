"""Continuous-batching serving engine (counterpart of
``pt2tpu.serve.engine``).

The standard slot-based batcher:

  * a fixed pool of B slots shares one KV cache of max_len positions, so
    admission and retirement never change a tensor shape;
  * a new request prefills straight into its slot's row of the pool (JAX
    prefills a temporary one-row cache and scatters it; here the row is a
    view, written in place). Prompt lengths are bucketed to powers of two
    >= 16, capped at max_len; the right padding is inert under the causal
    mask, and entries a previous request left past the prompt stay masked
    (by causality in the prefill, by ``kv_valid`` in decode) until decode
    overwrites them;
  * all slots advance together through one per-row decode step (a position
    per slot, per-row RoPE or learned positions, per-row cache writes, a
    per-row validity mask narrowed to the window on sliding layers, a
    per-row ALiBi bias), whose attention runs K7 on the card where it takes
    the step (no ALiBi bias, no softcap);
  * ``decode_quantum`` q > 1 runs q steps with the tokens kept on the device
    and fetches them once; the host truncates a row that stopped mid-quantum;
  * the host loop admits, steps, detects EOS / max_new and frees slots.

Inactive slots keep stepping (their tokens are discarded). JAX drops their
cache writes once a stale position passes the end of the cache; here their
positions are clamped to the last slot, which an active row never reaches
before it retires, so active rows' results are unchanged.

Speculative decoding (``draft=(cfg_d, params_d)``, ``spec_k``): a draft pool
of the target's geometry (bf16) mirrors the target's; each step drafts
``spec_k`` tokens per row and verifies them in one (B, spec_k + 1) per-row
target forward (:func:`_spec_decode_step`), so rows advance 1 .. spec_k + 1
tokens each. Greedy rows are token-exact against the plain engine.

Strategy overrides (JAX's contracts): ``prefill_fn(cfg, params, prompt,
true_len, cache, slot, impl[, samp]) -> (token, cache)``,
``decode_fn(cfg, params, tokens, cache, positions, active, impl[, samp]) ->
(tokens, cache)`` and ``cache_factory(cfg, max_batch, max_len)``, which
replaces the pool: the engine threads the cache through the two fns as
opaque state, and snapshots it through its ``leaves()``. The default fns
take any pool that also has ``prefill_view`` and ``decode_views``
(``serve.kvcache.KVCache``; ``serve.ring.RingCaches``, window-sized ring
pools on sliding layers, which ``serve.ring.make_ring_engine_fns`` plugs
in; ``serve.paged.PagedServeEngine`` plugs in a paged pool). ``samp`` is
passed only when a row samples; the port's is host values (default prefill:
(seed, uid, SamplingConfig); decode: (seed, uids, temps, top_ks, top_ps)).

``kv_heads`` builds the pool with that many KV heads (a tensor-parallel
rank's local heads: ``parallel.tp.make_tp_engine_fns``). ``multihost=True``
across the ranks of a ``torch.distributed`` world (on only where the world
has more than one process, as JAX's ``process_count() > 1``): rank 0 plans
every admission and broadcasts the plan (the requests' ids, prompts, budgets
and sampling, and whether its queue holds more), and every rank runs the
same prefills and decode steps; submit on rank 0 only.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import pickle
import threading
import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models import decoder as dec
from ..models.common import alibi_slopes
from .kvcache import init_cache
from .sampling import (SamplingConfig, filtered_logits, sample_per_row, spec_accept_per_row,
                       spec_draw)

__all__ = ["Request", "ServeEngine", "save_engine_state", "load_engine_state"]


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (Lp,) int32
    max_new: int
    eos_id: Optional[int] = None
    sampling: Optional[SamplingConfig] = None  # None => greedy
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


def _bucket(n: int, lo: int = 16) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


@functools.lru_cache(maxsize=8)
def _rope(cfg, M: int, device):
    """RoPE tables of [0, M) on ``device`` (cos, sin, cos_loc, sin_loc),
    made once per (cfg, M, device)."""
    return dec.pos_tables(cfg, M, device=device)


def _rows_forward(cfg, params, tokens, cache, positions: torch.Tensor, impl="auto"):
    """Per-row windowed forward: ``tokens`` (B, Lw) sit at positions
    ``positions[b] .. positions[b] + Lw - 1`` of their rows (``positions`` a
    (B,) long tensor on the device). Writes the window's k/v into the pool in
    place and returns (B, Lw, V) logits.

    Lw == 1 is the continuous-batching decode step: each layer writes and
    attends where the pool's ``decode_views`` puts it (a KVCache,
    ``serve.ring.RingCaches`` or ``serve.paged.PagedKV``), validity a
    per-row ``kv_valid`` (K7 on the card). Lw == k + 1 is the speculative
    verify, on a KVCache: causality within the window and validity of the
    cache prefix are one additive (B, 1, Lw, M) mask of 0 / -inf, ALiBi's
    bias added on top, so attention takes the plain path (JAX's too runs
    outside any Pallas kernel there)."""
    B, Lw = tokens.shape
    M = cache.max_len
    dev = tokens.device
    pos2 = positions[:, None] + torch.arange(Lw, device=dev)[None, :]  # (B, Lw)
    x = dec.embed_tokens_per_row(cfg, params, tokens, pos2)
    cos_all, sin_all, cosl_all, sinl_all = _rope(cfg, M, dev)
    cos, sin = cos_all[pos2], sin_all[pos2]  # (B, Lw, hd/2)
    cos_l = sin_l = None
    if cosl_all is not None:
        cos_l, sin_l = cosl_all[pos2], sinl_all[pos2]
    mask = None
    if Lw == 1:
        views = cache.decode_views(positions, B)  # li -> (cache, cache_pos, kv_valid)
    else:
        ok = torch.arange(M, device=dev)[None, None, :] <= pos2[:, :, None]  # (B, Lw, M)
        mask = torch.zeros(ok.shape, dtype=torch.float32, device=dev).masked_fill_(
            ~ok, float("-inf"))[:, None]
        views = lambda li: (cache, positions, None)  # noqa: E731
    if cfg.pos == "alibi":
        rel = (torch.arange(M, dtype=torch.float32, device=dev)[None, None, :]
               - pos2.float()[:, :, None])  # (B, Lw, M)
        bias = alibi_slopes(cfg.n_heads, device=dev)[None, :, None, None] * rel[:, None]
        mask = bias if mask is None else bias + mask
    for li in range(cfg.n_layers):
        lp = dec.layer_view(params["layers"], li)
        view, cache_pos, kv_valid = views(li)
        x = dec.layer_forward(cfg, lp, x, cos, sin, mask, cache=view, cache_pos=cache_pos,
                              kv_valid=kv_valid, impl=impl, layer_idx=li, cos_loc=cos_l,
                              sin_loc=sin_l)
    return dec.unembed(cfg, params, x)


def _decode_step(cfg, params, tokens: torch.Tensor, cache, positions: np.ndarray,
                 active: np.ndarray, impl="auto", samp=None):
    """One decode step for all slots (the default ``decode_fn``). ``tokens``
    (B,) on the device; ``positions`` (B,) host ints, where each new token
    sits; ``active`` (B,) host bools; ``samp`` None (greedy) or (seed, uids,
    temps, top_ks, top_ps) host arrays. Returns (the next tokens (B,) on the
    device, 0 for inactive rows; the cache, written in place)."""
    dev = tokens.device
    pos = np.where(active, positions, np.minimum(positions, cache.max_len - 1))
    pos_t = torch.as_tensor(pos, dtype=torch.long).to(dev, non_blocking=True)
    logits = _rows_forward(cfg, params, tokens[:, None], cache, pos_t, impl)[:, 0]
    if samp is None:
        nxt = torch.argmax(logits, dim=-1)
    else:
        seed, uids, temps, top_ks, top_ps = samp
        nxt = sample_per_row(logits, seed, uids, positions, temps, top_ks, top_ps)
    act = torch.as_tensor(active).to(dev, non_blocking=True)
    return torch.where(act, nxt, torch.zeros_like(nxt)), cache


def _spec_decode_step(cfg_t, params_t, cfg_d, params_d, tokens: torch.Tensor, t_cache, d_cache,
                      positions: np.ndarray, active: np.ndarray, k: int, impl="auto",
                      samp=None):
    """One speculative step for all slots: k + 1 one-token draft steps per
    row (the last writes the draft's k/v at position + k, so a fully
    accepted round leaves no hole in the draft pool; its token is unused),
    then ONE (B, k + 1) per-row target forward over [token, drafts).
    ``positions`` (B,) and ``active`` (B,) are host arrays, ``samp`` None or
    (seed, uids, temps, top_ks, top_ps) host arrays. Greedy rows (samp None,
    or temperature <= 0) take argmax drafts and accept their longest prefix
    equal to the target's argmax votes: the non-speculative engine's
    tokens. Sampled rows draw their drafts from the draft's filtered
    distribution and accept by Leviathan / Chen rejection
    (:func:`sampling.spec_accept_per_row`), so their stream is distributed
    as the target's sampling.

    Returns (votes (B, k + 1), n_acc (B,)) on the device, 0 for inactive
    rows: row b emits ``votes[b, :n_acc[b] + 1]`` and feeds
    ``votes[b, n_acc[b]]`` next. Idle rows are clamped so that their window
    stays inside the pools (JAX drops writes past the end)."""
    dev = tokens.device
    B = tokens.shape[0]
    M = t_cache.max_len
    pos = np.where(active, positions, np.minimum(positions, M - (k + 1)))
    pos_t = torch.as_tensor(pos, dtype=torch.long).to(dev, non_blocking=True)
    sampled = [] if samp is None else [b for b in range(B) if samp[2][b] > 0.0]
    if sampled:
        seed, uids, temps, top_ks, top_ps = samp
        row_t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt).to(dev)  # noqa: E731
        temps_t, top_ks_t = row_t(temps, torch.float32), row_t(top_ks, torch.int64)
        top_ps_t = row_t(top_ps, torch.float32)
        is_s = row_t(np.asarray(temps) > 0.0, torch.bool)
    tok, drafts, pds = tokens, [], []
    for i in range(k + 1):
        lg = _rows_forward(cfg_d, params_d, tok[:, None], d_cache, pos_t + i, impl)[:, 0]
        tok = torch.argmax(lg, dim=-1)
        if sampled:
            pd_i = torch.softmax(filtered_logits(lg, temps_t, top_ks_t, top_ps_t), dim=-1)
            tok = torch.where(is_s, spec_draw(pd_i, seed, uids, pos + i, 1, sampled), tok)
            pds.append(pd_i)
        drafts.append(tok)
    drafts = torch.stack(drafts[:k], dim=1)  # (B, k)
    toks = torch.cat([tokens[:, None], drafts], dim=1)  # (B, k + 1)
    vlogits = _rows_forward(cfg_t, params_t, toks, t_cache, pos_t, impl)  # (B, k + 1, V)
    votes = torch.argmax(vlogits, dim=-1)
    n_acc = torch.cumprod((drafts == votes[:, :k]).long(), dim=1).sum(dim=1)  # leading matches
    if sampled:
        V = vlogits.shape[-1]
        flt_t = filtered_logits(vlogits.reshape(B * (k + 1), V), temps_t.repeat_interleave(k + 1),
                                top_ks_t.repeat_interleave(k + 1),
                                top_ps_t.repeat_interleave(k + 1)).reshape(B, k + 1, V)
        s_tok, s_nacc = spec_accept_per_row(seed, uids, pos, drafts,
                                            torch.stack(pds[:k], dim=1),
                                            torch.softmax(flt_t, dim=-1))
        votes = torch.where(is_s[:, None], s_tok, votes)
        n_acc = torch.where(is_s, s_nacc, n_acc)
    act = torch.as_tensor(active).to(dev, non_blocking=True)
    return (torch.where(act[:, None], votes, torch.zeros_like(votes)),
            torch.where(act, n_acc, torch.zeros_like(n_acc)))


def _decode_quantum(cfg, params, tokens, cache, positions, active, samp, q, impl,
                    decode_fn=_decode_step):
    """``q`` steps of ``decode_fn`` with the tokens kept on the device.
    Returns ((B, q) tokens on the device: the caller fetches them once; the
    cache). Rows keep decoding past an EOS emitted mid-quantum; the host
    truncates them."""
    seq = []
    for j in range(q):
        if samp is None:
            tokens, cache = decode_fn(cfg, params, tokens, cache, positions + j, active, impl)
        else:
            tokens, cache = decode_fn(cfg, params, tokens, cache, positions + j, active, impl,
                                      samp)
        seq.append(tokens)
    return torch.stack(seq, dim=1), cache


def _prefill_into_slot(cfg, params, prompt: torch.Tensor, true_len: int, cache, slot: int,
                       impl="auto", samp=None) -> torch.Tensor:
    """Prefill one right-padded (1, Lb) prompt into row ``slot`` of the pool
    (positions [0, Lb), written in place through the pool's
    ``prefill_view``; the default ``prefill_fn``). The
    next token comes from the hidden state at ``true_len - 1``. ``samp``
    None (greedy) or (seed, uid, SamplingConfig). Returns (the token as a
    device scalar, not fetched; the cache)."""
    M = cache.max_len
    Lb = prompt.shape[1]
    dev = prompt.device
    row = cache.prefill_view(slot, slot + 1, true_len)
    h = dec.embed_tokens(cfg, params, prompt)
    cos_all, sin_all, cosl_all, sinl_all = _rope(cfg, M, dev)
    cos_l = None if cosl_all is None else cosl_all[:Lb]
    sin_l = None if sinl_all is None else sinl_all[:Lb]
    mask = dec.build_mask(cfg, Lb, M, device=dev)
    for li in range(cfg.n_layers):
        lp = dec.layer_view(params["layers"], li)
        h = dec.layer_forward(cfg, lp, h, cos_all[:Lb], sin_all[:Lb], mask, cache=row,
                              cache_pos=0, impl=impl, layer_idx=li, cos_loc=cos_l,
                              sin_loc=sin_l)
    logits = dec.unembed(cfg, params, h[:, true_len - 1 : true_len])[:, 0]  # (1, V)
    if samp is None:
        return torch.argmax(logits[0]), cache
    seed, uid, sc = samp
    return sample_per_row(logits, seed, [uid], [true_len - 1], [sc.temperature], [sc.top_k],
                          [sc.top_p])[0], cache


class ServeEngine:
    """Host-side scheduler over the per-row prefill and decode steps, on the
    device that holds ``params``."""

    def __init__(
        self,
        cfg: dec.ModelConfig,
        params,
        max_batch: int = 8,
        max_len: int = 2048,
        kv_quant: bool = False,
        impl: str = "auto",
        prefill_fn=None,
        decode_fn=None,
        kv_heads: Optional[int] = None,
        cache_factory=None,
        seed: int = 0,
        draft=None,
        spec_k: int = 4,
        multihost: bool = False,
        decode_quantum: int = 1,
    ):
        """``seed`` keys per-request sampling (requests submitted with a
        SamplingConfig; greedy rows stay exact argmax). ``decode_quantum``
        > 1 runs up to that many decode steps per host fetch; the effective
        quantum is bounded by the smallest remaining budget among active
        rows, rounded down to a power of two, so no step is wasted past a
        row's max_new. Outputs are token-identical to quantum 1.
        ``prefill_fn`` / ``decode_fn`` / ``cache_factory`` replace the
        default programs and pool (the module's contracts); the pool must
        lie on the device that holds ``params``. ``draft=(cfg_d, params_d)``
        (params on the same device) turns on speculative decoding with
        ``spec_k`` drafted tokens a step; it needs the default programs, no
        sliding-window config and a shared vocabulary (JAX's refusals)."""
        if draft is not None:
            cfg_d, params_d = draft
            if prefill_fn or decode_fn or cache_factory:
                raise ValueError("speculative decoding requires the default engine programs "
                                 "(no prefill_fn/decode_fn/cache_factory)")
            if cfg.has_sliding or cfg_d.has_sliding:
                raise ValueError("speculative engine does not support sliding-window configs "
                                 "yet (per-row windowed verify vs window mask)")
            if cfg_d.vocab_size != cfg.vocab_size:
                raise ValueError("draft and target must share a vocabulary")
            if params_d["embed"].device != params["embed"].device:
                raise ValueError(f"the draft's params lie on {params_d['embed'].device}, the "
                                 f"target's on {params['embed'].device}")
        if cache_factory is not None and (kv_quant or kv_heads is not None):
            raise ValueError(
                "cache_factory replaces the KV pool entirely; kv_quant/kv_heads would be "
                "silently ignored — thread them into the factory instead")
        dec.check_supported(cfg)
        if cfg.pos == "learned" and max_len > params["pos_embed"].shape[0] - cfg.pos_offset:
            raise ValueError(f"max_len {max_len} exceeds the {cfg.family} model's "
                             f"{params['pos_embed'].shape[0] - cfg.pos_offset} learned positions")
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.B = max_batch
        self.M = max_len
        self.impl = impl
        self.seed = int(seed)
        self.draft = draft
        self.spec_k = int(spec_k)
        self.decode_quantum = max(1, int(decode_quantum))
        self._prefill_fn = prefill_fn or _prefill_into_slot
        self._decode_fn = decode_fn or _decode_step
        if cache_factory is not None:
            self.cache = cache_factory(cfg, max_batch, max_len)
            for t in self.cache.leaves():
                if t.device != self.device:
                    raise ValueError(f"cache_factory's pool lies on {t.device}, the params on "
                                     f"{self.device}")
        else:
            cache_cfg = cfg if kv_heads is None else cfg.with_(n_kv_heads=kv_heads)
            self.cache = init_cache(cache_cfg, max_batch, max_len, quantized=kv_quant,
                                    device=self.device)
        # the multi-process scheduler: on only in a world of several processes
        self._mh = bool(multihost) and dist.is_available() and dist.is_initialized() and (
            dist.get_world_size() > 1)
        self._proc0 = not self._mh or dist.get_rank() == 0
        self._mh_has_queue = False
        if draft is not None:  # the draft's pool: the target's geometry, bf16
            self.d_cache = init_cache(draft[0], max_batch, max_len, device=self.device)
            self.stats_spec = {"rounds": 0, "drafted": 0, "accepted": 0}
        self.temps = np.zeros(max_batch, np.float32)
        self.topks = np.zeros(max_batch, np.int32)
        self.topps = np.ones(max_batch, np.float32)
        self.uids = np.zeros(max_batch, np.int64)
        self._bucket_lo = 16
        self.finished: List[Request] = []  # retired requests, in order
        self.queue: List[Request] = []
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.positions = np.zeros(max_batch, np.int64)  # next write position
        self.tokens = torch.zeros(max_batch, dtype=torch.long, device=self.device)  # next feed
        self._uid = 0
        self._submit_lock = threading.Lock()
        self._t0 = time.perf_counter()
        self.stats = {
            "admitted": 0,
            "completed": 0,
            "steps": 0,
            "tokens": 0,
            "tokens_per_s": 0.0,
            # host wall time of the two device phases: admission prefills and
            # their first-token fetch, decode steps and their fetch
            "t_admit_s": 0.0,
            "t_decode_s": 0.0,
        }

    def submit(self, prompt, max_new: int, eos_id: Optional[int] = None,
               sampling: Optional[SamplingConfig] = None) -> Request:
        """Queue a request (safe from several threads)."""
        if sampling is not None and sampling.greedy:
            sampling = None
        with self._submit_lock:
            req = Request(uid=self._uid, prompt=np.asarray(prompt, np.int32).reshape(-1),
                          max_new=max_new, eos_id=eos_id, sampling=sampling)
            self._uid += 1
            self.queue.append(req)
        return req

    # ---------------------------------------------------- scheduling ----
    def _plan_admissions(self) -> List:
        """Pop the queue into free slots (no device work): [(slot, Request)].
        A request too long for the pool (with a draft, for its prompt,
        max_new and one more verify window) finishes at once with no
        tokens."""
        plans = []
        budget = self.spec_k + 1 if self.draft is not None else 0
        for slot in range(self.B):
            if self.slots[slot] is not None:
                continue
            while self.queue:
                req = self.queue.pop(0)
                if len(req.prompt) + req.max_new + budget > self.M:
                    req.done = True
                    req.out = []
                    self.finished.append(req)
                    continue
                plans.append((slot, req))
                break
        return plans

    def _dispatch_admission(self, slot: int, req: Request) -> torch.Tensor:
        """Prefill ``req`` into ``slot`` and set the slot's sampling state.
        Returns the first token on the device, not fetched."""
        Lp = len(req.prompt)
        Lb = min(_bucket(Lp, self._bucket_lo), self.M)
        padded = np.zeros(Lb, np.int64)
        padded[:Lp] = req.prompt
        sc = req.sampling
        self.uids[slot] = req.uid
        self.temps[slot] = sc.temperature if sc else 0.0
        self.topks[slot] = sc.top_k if sc else 0
        self.topps[slot] = sc.top_p if sc else 1.0
        prompt = torch.as_tensor(padded[None, :]).to(self.device)
        args = (self.cfg, self.params, prompt, Lp, self.cache, slot, self.impl)
        if sc is None:
            tok, self.cache = self._prefill_fn(*args)
        else:
            tok, self.cache = self._prefill_fn(*args, (self.seed, req.uid, sc))
        if self.draft is not None:
            cfg_d, params_d = self.draft
            _, self.d_cache = _prefill_into_slot(cfg_d, params_d, prompt, Lp, self.d_cache, slot,
                                                 self.impl)
        return tok

    def _finalize_admission(self, slot: int, req: Request, first: int) -> None:
        req.out.append(first)
        self.slots[slot] = req
        self.positions[slot] = len(req.prompt)
        self.tokens[slot] = first
        self.stats["admitted"] += 1
        self._maybe_finish(slot)

    def _admit(self) -> None:
        """Dispatch every planned prefill, then fetch all first tokens at
        once: one host round trip per wave of admissions. Across processes
        (``multihost``) rank 0's plan is every rank's."""
        t0 = time.perf_counter()
        plans = self._mh_plans() if self._mh else self._plan_admissions()
        pend = [(slot, req, self._dispatch_admission(slot, req)) for slot, req in plans]
        if pend:
            firsts = torch.stack([t for _, _, t in pend]).tolist()
            for (slot, req, _), first in zip(pend, firsts):
                self._finalize_admission(slot, req, int(first))
        self.stats["t_admit_s"] += time.perf_counter() - t0

    def _mh_plans(self) -> List:
        """Rank 0 plans this wave's admissions and broadcasts them with
        whether its queue holds more (JAX's record: slot, uid, prompt,
        max_new, eos and sampling of each); the other ranks rebuild the
        requests from it."""
        rec = [None]
        if self._proc0:
            plans = self._plan_admissions()
            rec[0] = {
                "has_queue": bool(self.queue),
                "plans": [(slot, r.uid, np.asarray(r.prompt, np.int32), r.max_new, r.eos_id,
                           None if r.sampling is None else dataclasses.asdict(r.sampling))
                          for slot, r in plans],
            }
        dist.broadcast_object_list(rec, src=0)
        self._mh_has_queue = rec[0]["has_queue"]
        if self._proc0:
            return plans
        return [(slot, Request(uid=uid, prompt=prompt, max_new=max_new, eos_id=eos,
                               sampling=None if sc is None else SamplingConfig(**sc)))
                for slot, uid, prompt, max_new, eos, sc in rec[0]["plans"]]

    def _maybe_finish(self, slot: int) -> None:
        req = self.slots[slot]
        if req is None:
            return
        if len(req.out) >= req.max_new or (
            req.eos_id is not None and req.out and req.out[-1] == req.eos_id
        ):
            req.done = True
            self.slots[slot] = None
            self.finished.append(req)
            self.stats["completed"] += 1

    def _quantum_q(self) -> int:
        """This step's quantum: at most the smallest remaining budget among
        active rows, rounded down to a power of two."""
        if self.decode_quantum <= 1:
            return 1
        rem = [r.max_new - len(r.out) for r in self.slots if r is not None]
        if not rem:
            return 1
        q = max(1, min(self.decode_quantum, min(rem)))
        return 1 << (q.bit_length() - 1)

    def step(self) -> bool:
        """Admit, then advance every active slot by one quantum (with a
        draft, by 1 .. spec_k + 1 tokens). False when there is nothing left
        to do."""
        with torch.inference_mode():
            return self._step()

    def _samp(self):
        """The decode step's ``samp``: None while every active row is greedy."""
        if any(r is not None and r.sampling is not None for r in self.slots):
            return (self.seed, self.uids.copy(), self.temps.copy(), self.topks.copy(),
                    self.topps.copy())
        return None

    def _before_decode(self, q: int) -> None:
        """Called after admission, before the decode of a quantum of ``q``
        steps: a pool that grows with its rows (the paged engine) reserves
        what they will write. Nothing to do for the flat pool."""

    def _step(self) -> bool:
        self._admit()
        active = np.array([r is not None for r in self.slots])
        if not active.any():
            if not self._proc0:
                return self._mh_has_queue
            return bool(self.queue)
        if self.draft is not None:
            return self._step_spec(active)
        samp = self._samp()
        q = self._quantum_q()
        self._before_decode(q)
        td0 = time.perf_counter()
        seq, self.cache = _decode_quantum(self.cfg, self.params, self.tokens, self.cache,
                                          self.positions.copy(), active, samp, q, self.impl,
                                          self._decode_fn)
        self.tokens = seq[:, q - 1].clone()
        seq = seq.cpu().numpy()  # the one fetch of the quantum
        self.stats["t_decode_s"] += time.perf_counter() - td0
        self.stats["steps"] += q
        for slot in range(self.B):
            req = self.slots[slot]
            if req is None:
                continue
            # the cache and position advanced q for every live row; a row
            # that stops mid-quantum has its tail dropped here
            self.positions[slot] += q
            for j in range(q):
                req.out.append(int(seq[slot, j]))
                self.stats["tokens"] += 1
                if len(req.out) >= req.max_new or (
                    req.eos_id is not None and req.out[-1] == req.eos_id
                ):
                    break
            self._maybe_finish(slot)
        elapsed = max(time.perf_counter() - self._t0, 1e-9)
        self.stats["tokens_per_s"] = self.stats["tokens"] / elapsed
        return True

    def _step_spec(self, active: np.ndarray) -> bool:
        """One speculative step: every active row advances by its accepted
        drafts and the verify's bonus token, 1 .. spec_k + 1 tokens."""
        cfg_d, params_d = self.draft
        td0 = time.perf_counter()
        votes, n_acc = _spec_decode_step(self.cfg, self.params, cfg_d, params_d, self.tokens,
                                         self.cache, self.d_cache, self.positions.copy(), active,
                                         self.spec_k, self.impl, self._samp())
        votes, n_acc = votes.cpu().numpy(), n_acc.cpu().numpy()  # the step's one fetch
        self.stats["t_decode_s"] += time.perf_counter() - td0
        self.stats["steps"] += 1
        self.stats_spec["rounds"] += int(active.sum())
        self.stats_spec["drafted"] += int(active.sum()) * self.spec_k
        nxt = np.zeros(self.B, np.int64)
        for slot in range(self.B):
            req = self.slots[slot]
            if req is None:
                continue
            take = int(n_acc[slot]) + 1
            self.stats_spec["accepted"] += int(n_acc[slot])
            # the pools advanced take tokens whatever the host keeps of them
            # (a request cut short retires and frees its slot)
            self.positions[slot] += take
            nxt[slot] = votes[slot, take - 1]
            for j in range(take):
                req.out.append(int(votes[slot, j]))
                self.stats["tokens"] += 1
                if len(req.out) >= req.max_new or (
                    req.eos_id is not None and req.out[-1] == req.eos_id
                ):
                    break
            self._maybe_finish(slot)
        self.tokens = torch.as_tensor(nxt).to(self.device)
        elapsed = max(time.perf_counter() - self._t0, 1e-9)
        self.stats["tokens_per_s"] = self.stats["tokens"] / elapsed
        return True

    def run(self, max_steps: int = 100000) -> None:
        """Drain the queue completely."""
        steps = 0
        while steps < max_steps and self.step():
            steps += 1


# ----------------------------------------------------------------------
# Snapshot / restore of the whole scheduler state: the KV pool, the per-slot
# host arrays, and the queued and in-flight requests.
def save_engine_state(eng: ServeEngine, path: str) -> None:
    """Write the engine's state under ``path`` (cache.npz, host.pkl) so a
    new engine of the same geometry continues token for token. bf16 is
    stored as its uint16 bit pattern (npz has no bf16). A speculative
    engine's draft pool is not stored, as JAX's snapshot leaves it out."""
    os.makedirs(path, exist_ok=True)
    arrays = {}
    for i, t in enumerate(eng.cache.leaves()):
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            arrays[f"leaf{i}"] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            arrays[f"leaf{i}"] = t.numpy()
    np.savez(os.path.join(path, "cache.npz"), **arrays)

    def req_state(r):
        return {
            "uid": r.uid, "prompt": np.asarray(r.prompt), "max_new": r.max_new,
            "eos_id": r.eos_id, "out": list(r.out), "done": r.done,
            "sampling": None if r.sampling is None else dataclasses.asdict(r.sampling),
        }

    host = {
        "slots": [None if r is None else req_state(r) for r in eng.slots],
        "queue": [req_state(r) for r in eng.queue],
        "positions": eng.positions.copy(),
        "tokens": eng.tokens.cpu().numpy(),
        "uids": eng.uids.copy(),
        "temps": eng.temps.copy(),
        "topks": eng.topks.copy(),
        "topps": eng.topps.copy(),
        "uid_counter": eng._uid,
        "stats": dict(eng.stats),
        # an engine subclass's own state (the paged engine's page lists)
        "extra": getattr(eng, "_snapshot_extra", lambda: None)(),
    }
    with open(os.path.join(path, "host.pkl"), "wb") as f:
        pickle.dump(host, f)


def load_engine_state(eng: ServeEngine, path: str) -> List[Request]:
    """Restore a snapshot into a freshly built engine (same cfg, params and
    pool geometry). Returns the restored in-flight and queued requests."""
    with np.load(os.path.join(path, "cache.npz")) as z:
        with torch.inference_mode():
            for i, cur in enumerate(eng.cache.leaves()):
                a = z[f"leaf{i}"]
                if cur.dtype == torch.bfloat16:
                    t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
                else:
                    t = torch.from_numpy(np.ascontiguousarray(a))
                if tuple(t.shape) != tuple(cur.shape) or t.dtype != cur.dtype:
                    raise ValueError(f"snapshot leaf {i} is {tuple(t.shape)} {t.dtype}, the "
                                     f"engine's {tuple(cur.shape)} {cur.dtype}")
                cur.copy_(t)

    with open(os.path.join(path, "host.pkl"), "rb") as f:
        host = pickle.load(f)

    def mk_req(s):
        sc = s["sampling"]
        return Request(uid=s["uid"], prompt=np.asarray(s["prompt"], np.int32),
                       max_new=s["max_new"], eos_id=s["eos_id"],
                       sampling=None if sc is None else SamplingConfig(**sc),
                       out=list(s["out"]), done=s["done"])

    eng.slots = [None if s is None else mk_req(s) for s in host["slots"]]
    eng.queue = [mk_req(s) for s in host["queue"]]
    eng.positions[:] = host["positions"]
    eng.tokens = torch.as_tensor(host["tokens"], dtype=torch.long).to(eng.device)
    eng.uids[:] = host["uids"]
    eng.temps[:] = host["temps"]
    eng.topks[:] = host["topks"]
    eng.topps[:] = host["topps"]
    eng._uid = host["uid_counter"]
    eng.stats.update(host["stats"])
    if host.get("extra") is not None:
        eng._restore_extra(host["extra"])
    return [r for r in eng.slots if r is not None] + list(eng.queue)
