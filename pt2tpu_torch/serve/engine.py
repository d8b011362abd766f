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
    per slot, per-row RoPE, per-row cache writes, a per-row validity mask),
    whose attention runs K7 on the card;
  * ``decode_quantum`` q > 1 runs q steps with the tokens kept on the device
    and fetches them once; the host truncates a row that stopped mid-quantum;
  * the host loop admits, steps, detects EOS / max_new and frees slots.

Inactive slots keep stepping (their tokens are discarded). JAX drops their
cache writes once a stale position passes the end of the cache; here their
positions are clamped to the last slot, which an active row never reaches
before it retires, so active rows' results are unchanged.

Not ported (they raise ``NotImplementedError``): speculative decoding
(``draft``), strategy overrides (``prefill_fn``, ``decode_fn``,
``cache_factory``), ``kv_heads`` and ``multihost``.
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

from ..models import decoder as dec
from ..models.common import causal_mask
from .kvcache import KVCache, init_cache
from .sampling import SamplingConfig, sample_per_row

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
    """RoPE tables of [0, M) on ``device``, made once per (cfg, M, device)."""
    return dec.pos_tables(cfg, M, device=device)


def _rows_forward(cfg, params, tokens, cache: KVCache, positions: torch.Tensor, impl="auto"):
    """Per-row decode forward: ``tokens`` (B, 1) sit at ``positions`` (B,)
    (a long tensor on the device) of their rows. Writes their k/v into the
    cache in place and returns (B, 1, V) logits."""
    B, Lw = tokens.shape
    if Lw != 1:
        raise NotImplementedError(
            "windows of more than one token per row (speculative verify) are not ported")
    M = cache.max_len
    dev = tokens.device
    x = dec.embed_tokens(cfg, params, tokens)  # llama: RoPE carries the positions
    cos_all, sin_all = _rope(cfg, M, dev)
    cos, sin = cos_all[positions][:, None], sin_all[positions][:, None]  # (B, 1, hd/2)
    kv_valid = torch.arange(M, device=dev)[None, :] <= positions[:, None]  # (B, M)
    for li in range(cfg.n_layers):
        lp = dec.layer_view(params["layers"], li)
        x = dec.layer_forward(cfg, lp, x, cos, sin, None, cache=cache, cache_pos=positions,
                              kv_valid=kv_valid, impl=impl, layer_idx=li)
    return dec.unembed(cfg, params, x)


def _decode_step(cfg, params, tokens: torch.Tensor, cache: KVCache, positions: np.ndarray,
                 active: np.ndarray, impl="auto", samp=None) -> torch.Tensor:
    """One decode step for all slots. ``tokens`` (B,) on the device;
    ``positions`` (B,) host ints, where each new token sits; ``active`` (B,)
    host bools; ``samp`` None (greedy) or (seed, uids, temps, top_ks,
    top_ps) host arrays. Returns the next tokens (B,) on the device, 0 for
    inactive rows."""
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
    return torch.where(act, nxt, torch.zeros_like(nxt))


def _decode_quantum(cfg, params, tokens, cache, positions, active, samp, q, impl):
    """``q`` decode steps with the tokens kept on the device. Returns the
    (B, q) tokens on the device: the caller fetches them once. Rows keep
    decoding past an EOS emitted mid-quantum; the host truncates them."""
    seq = []
    for j in range(q):
        tokens = _decode_step(cfg, params, tokens, cache, positions + j, active, impl, samp)
        seq.append(tokens)
    return torch.stack(seq, dim=1)


def _prefill_into_slot(cfg, params, prompt: torch.Tensor, true_len: int, cache: KVCache,
                       slot: int, impl="auto", samp=None) -> torch.Tensor:
    """Prefill one right-padded (1, Lb) prompt into row ``slot`` of the pool
    (positions [0, Lb), written in place). The next token comes from the
    hidden state at ``true_len - 1``. ``samp`` None (greedy) or (seed, uid,
    SamplingConfig). Returns the token as a device scalar, not fetched."""
    M = cache.max_len
    Lb = prompt.shape[1]
    dev = prompt.device
    row = cache.rows(slot, slot + 1)
    h = dec.embed_tokens(cfg, params, prompt)
    cos_all, sin_all = _rope(cfg, M, dev)
    mask = causal_mask(Lb, M, device=dev)
    for li in range(cfg.n_layers):
        lp = dec.layer_view(params["layers"], li)
        h = dec.layer_forward(cfg, lp, h, cos_all[:Lb], sin_all[:Lb], mask, cache=row,
                              cache_pos=0, impl=impl, layer_idx=li)
    logits = dec.unembed(cfg, params, h[:, true_len - 1 : true_len])[:, 0]  # (1, V)
    if samp is None:
        return torch.argmax(logits[0])
    seed, uid, sc = samp
    return sample_per_row(logits, seed, [uid], [true_len - 1], [sc.temperature], [sc.top_k],
                          [sc.top_p])[0]


_NOT_PORTED = {
    "draft": "speculative decoding (serve/speculative.py)",
    "prefill_fn": "strategy overrides (parallel/tp.py, serve/ring.py)",
    "decode_fn": "strategy overrides (parallel/tp.py, serve/ring.py)",
    "cache_factory": "custom cache pools (serve/ring.py, serve/paged.py)",
    "kv_heads": "head-sharded pools (parallel/tp.py)",
    "multihost": "the multi-process scheduler (parallel/)",
}


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
        multihost: bool = False,
        decode_quantum: int = 1,
    ):
        """``seed`` keys per-request sampling (requests submitted with a
        SamplingConfig; greedy rows stay exact argmax). ``decode_quantum``
        > 1 runs up to that many decode steps per host fetch; the effective
        quantum is bounded by the smallest remaining budget among active
        rows, rounded down to a power of two, so no step is wasted past a
        row's max_new. Outputs are token-identical to quantum 1."""
        given = dict(draft=draft, prefill_fn=prefill_fn, decode_fn=decode_fn,
                     cache_factory=cache_factory, kv_heads=kv_heads, multihost=multihost)
        for name, value in given.items():
            if value:
                raise NotImplementedError(
                    f"ServeEngine({name}=...) needs {_NOT_PORTED[name]}: not ported")
        dec.check_supported(cfg)
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.B = max_batch
        self.M = max_len
        self.impl = impl
        self.seed = int(seed)
        self.decode_quantum = max(1, int(decode_quantum))
        self.cache = init_cache(cfg, max_batch, max_len, quantized=kv_quant, device=self.device)
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
        A request too long for the pool finishes at once with no tokens."""
        plans = []
        for slot in range(self.B):
            if self.slots[slot] is not None:
                continue
            while self.queue:
                req = self.queue.pop(0)
                if len(req.prompt) + req.max_new > self.M:
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
        samp = None if sc is None else (self.seed, req.uid, sc)
        return _prefill_into_slot(self.cfg, self.params, prompt, Lp, self.cache, slot,
                                  self.impl, samp)

    def _finalize_admission(self, slot: int, req: Request, first: int) -> None:
        req.out.append(first)
        self.slots[slot] = req
        self.positions[slot] = len(req.prompt)
        self.tokens[slot] = first
        self.stats["admitted"] += 1
        self._maybe_finish(slot)

    def _admit(self) -> None:
        """Dispatch every planned prefill, then fetch all first tokens at
        once: one host round trip per wave of admissions."""
        t0 = time.perf_counter()
        pend = [(slot, req, self._dispatch_admission(slot, req))
                for slot, req in self._plan_admissions()]
        if pend:
            firsts = torch.stack([t for _, _, t in pend]).tolist()
            for (slot, req, _), first in zip(pend, firsts):
                self._finalize_admission(slot, req, int(first))
        self.stats["t_admit_s"] += time.perf_counter() - t0

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
        """Admit, then advance every active slot by one quantum. False when
        there is nothing left to do."""
        with torch.inference_mode():
            return self._step()

    def _step(self) -> bool:
        self._admit()
        active = np.array([r is not None for r in self.slots])
        if not active.any():
            return bool(self.queue)
        samp = None
        if any(r is not None and r.sampling is not None for r in self.slots):
            samp = (self.seed, self.uids.copy(), self.temps.copy(), self.topks.copy(),
                    self.topps.copy())
        q = self._quantum_q()
        td0 = time.perf_counter()
        seq = _decode_quantum(self.cfg, self.params, self.tokens, self.cache,
                              self.positions.copy(), active, samp, q, self.impl)
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

    def run(self, max_steps: int = 100000) -> None:
        """Drain the queue completely."""
        steps = 0
        while steps < max_steps and self.step():
            steps += 1


# ----------------------------------------------------------------------
# Snapshot / restore of the whole scheduler state: the KV pool, the per-slot
# host arrays, and the queued and in-flight requests.
def _cache_leaves(cache: KVCache):
    return [t for t in (cache.k, cache.v, cache.k_scale, cache.v_scale) if t is not None]


def save_engine_state(eng: ServeEngine, path: str) -> None:
    """Write the engine's state under ``path`` (cache.npz, host.pkl) so a
    new engine of the same geometry continues token for token. bf16 is
    stored as its uint16 bit pattern (npz has no bf16)."""
    os.makedirs(path, exist_ok=True)
    arrays = {}
    for i, t in enumerate(_cache_leaves(eng.cache)):
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
    }
    with open(os.path.join(path, "host.pkl"), "wb") as f:
        pickle.dump(host, f)


def load_engine_state(eng: ServeEngine, path: str) -> List[Request]:
    """Restore a snapshot into a freshly built engine (same cfg, params and
    pool geometry). Returns the restored in-flight and queued requests."""
    with np.load(os.path.join(path, "cache.npz")) as z:
        with torch.inference_mode():
            for i, cur in enumerate(_cache_leaves(eng.cache)):
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
    return [r for r in eng.slots if r is not None] + list(eng.queue)
