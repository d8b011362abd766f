"""Profiling, timing and roofline helpers: the counterparts of
``pt2tpu/utils/profiling.py``.

- :func:`trace` wraps ``torch.profiler`` and writes a Chrome trace;
- :func:`time_fn` times a call, waiting for the card where its output lies
  on one;
- :func:`model_weight_bytes` and :func:`ternary_decode_roofline` give the
  JAX package's numbers, field for field; the roofline's default bandwidth
  is the H100 SXM's (NVIDIA's data sheet: 3,350 GB/s of HBM3), where the
  JAX package's is a TPU v5e's.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict

import torch

__all__ = ["trace", "time_fn", "ternary_decode_roofline", "model_weight_bytes", "H100_HBM_GBPS"]

H100_HBM_GBPS = 3350.0  # H100 SXM, NVIDIA's data sheet


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the body with ``torch.profiler`` (CPU activity, and CUDA's
    where the card is there) and write the timeline to
    ``<log_dir>/trace.json`` (Chrome's trace format). Yields the profiler,
    whose ``key_averages()`` sums the time by operator and kernel."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for o in out:
            t = _first_tensor(o)
            if t is not None:
                return t
    return None


def time_fn(fn: Callable, *args, reps: int = 3) -> float:
    """Best of ``reps`` seconds for ``fn(*args)`` after one warm-up call;
    where the first tensor of the output lies on the card, each call ends in
    ``torch.cuda.synchronize()`` (PyTorch returns before the card is done)."""

    def run():
        out = fn(*args)
        t = _first_tensor(out)
        if t is not None and t.device.type == "cuda":
            torch.cuda.synchronize(t.device)

    run()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    return best


def model_weight_bytes(cfg, ternary: bool = True, scale_bytes: int = 2) -> Dict[str, int]:
    """Weight bytes one batch-1 decode token reads from device memory: the
    layers' linears (packed 2-bit codes and two bf16 scales per 128-block
    when ``ternary``, else bf16) and a bf16 head."""
    D, I = cfg.dim, cfg.intermediate
    H, Hkv, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
    per_layer_params = (D * H * hd + 2 * D * Hkv * hd + H * hd * D
                        + (3 if cfg.gated_mlp else 2) * D * I)
    layer_params = per_layer_params * cfg.n_layers
    if ternary:
        bs = 128
        layer_bytes = layer_params // 4 + 2 * scale_bytes * (layer_params // bs)
    else:
        layer_bytes = 2 * layer_params
    head_bytes = 2 * cfg.vocab_size * D  # lm_head / embedding stay bf16
    return {
        "layer_bytes": int(layer_bytes),
        "head_bytes": int(head_bytes),
        "total_bytes": int(layer_bytes + head_bytes),
        "params": int(layer_params),
    }


def ternary_decode_roofline(cfg, hbm_gbps: float = H100_HBM_GBPS) -> Dict[str, float]:
    """Tokens/s ceiling of batch-1 decode when every weight byte is read
    once a token, at ``hbm_gbps`` (default: the H100 SXM's 3,350 GB/s), for
    packed ternary and bf16 weights, and their ratio."""
    t = model_weight_bytes(cfg, ternary=True)["total_bytes"]
    d = model_weight_bytes(cfg, ternary=False)["total_bytes"]
    return {
        "ternary_tok_s": hbm_gbps * 1e9 / t,
        "bf16_tok_s": hbm_gbps * 1e9 / d,
        "ideal_speedup": d / t,
    }
