"""Structured metrics: counterpart of ``pt2tpu.utils.metrics``. A JSONL sink
with wall-clock stamps and a stderr mirror, and the artifact's size figures.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, Optional

import torch

__all__ = ["MetricsLogger", "model_bits_per_weight", "model_size_gb", "compression_ratio", "set_seed"]


class MetricsLogger:
    """Append-only JSONL metrics: ``log.emit("layer_quantized", layer=3,
    proj="o", rel_out_err=0.12)``. ``path=None``: the stderr mirror only,
    when ``verbose``."""

    def __init__(self, path: Optional[str] = None, verbose: bool = True):
        self.path = path
        self.verbose = verbose
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a")
        self._t0 = time.time()

    def emit(self, event: str, **fields: Any) -> Dict[str, Any]:
        rec = {"event": event, "t": round(time.time() - self._t0, 3), **fields}
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self.verbose:
            kv = " ".join(f"{k}={v}" for k, v in fields.items())
            print(f"[{rec['t']:9.2f}s] {event}: {kv}", file=sys.stderr)
        return rec

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def model_bits_per_weight(params) -> float:
    """Stored bits per quantized weight: 2-bit planes plus the scale bytes of
    the real scale blocks (ceil(m / bs); the 16-block pad of the in-memory
    layout is not counted), over every packed linear of the tree; 16.0 when
    there is none."""
    from ..ops.ternary_matmul import PackedTernaryLinear

    total_weights = 0
    total_bits = 0
    for leaf in _leaves(params):
        if isinstance(leaf, PackedTernaryLinear):
            n = leaf.packed.shape[-1]
            lead = leaf.packed.numel() // (leaf.packed.shape[-2] * n)
            bs = leaf.block_size
            real_nb = -(-leaf.in_features // bs)
            total_weights += lead * leaf.in_features * n
            total_bits += lead * real_nb * (bs // 4) * n * 8
            total_bits += 2 * lead * real_nb * n * leaf.alpha.element_size() * 8
    if total_weights == 0:
        return 16.0
    return total_bits / total_weights


def model_size_gb(params) -> float:
    """Bytes of every tensor of the tree (packed linears and dense leaves)
    in GiB."""
    import dataclasses

    total = 0

    def add(x):
        nonlocal total
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                add(getattr(x, f.name))
        elif isinstance(x, dict):
            for v in x.values():
                add(v)

    add(params)
    return total / (1024**3)


def compression_ratio(original_gb: float, quantized_gb: float) -> float:
    return original_gb / max(quantized_gb, 1e-12)


def set_seed(seed: int = 42) -> torch.Generator:
    """Seed Python's, numpy's and torch's global generators; returns a CPU
    ``torch.Generator`` seeded the same (randomness is explicit: the
    generator is the handle, as the JAX package returns a PRNGKey)."""
    import random

    import numpy as np

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
