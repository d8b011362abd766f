"""Process groups over named axes: the counterpart of
``pt2tpu/parallel/mesh.py`` on ``torch.distributed``.

JAX's mesh is one program over many devices; here each rank is one process
with one device, and a mesh axis is the process group of the ranks that
differ only in their index on that axis (ranks laid out row-major over the
axes, the last axis the fastest, as ``np.reshape`` lays out JAX's devices).

- :func:`initialize_distributed` starts the process group from torchrun's
  environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) or
  from explicit arguments; in one process it does nothing, as JAX's does;
- :func:`make_mesh` returns this rank's :class:`Axis` of every named axis;
- :func:`auto_mesh` keeps JAX's heuristic: the largest power-of-two model
  axis up to 8, the rest data.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Axis", "initialize_distributed", "make_mesh", "auto_mesh", "world"]


@dataclasses.dataclass(frozen=True)
class Axis:
    """This rank's place on one named mesh axis: the axis' size, this
    rank's index on it, the global ranks of its group (in axis order) and
    the process group (None for an axis of size 1)."""

    name: str
    size: int
    rank: int
    ranks: Tuple[int, ...]
    group: Optional[object] = None

    @property
    def backend(self) -> Optional[str]:
        return None if self.group is None else dist.get_backend(self.group)


def world() -> Tuple[int, int]:
    """(rank, world size): (0, 1) where no process group is initialized."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def initialize_distributed(backend: Optional[str] = None, init_method: Optional[str] = None,
                           rank: Optional[int] = None, world_size: Optional[int] = None,
                           timeout_s: float = 600.0) -> bool:
    """Start the default process group: ``rank`` / ``world_size`` and
    ``init_method`` as given, else torchrun's ``RANK`` / ``WORLD_SIZE`` and
    ``env://``. The backend defaults to NCCL where the card is there, else
    gloo. Does nothing where the world has one process or the group is up
    already (JAX's ``initialize_distributed``); returns whether a group is
    up after the call."""
    if dist.is_initialized():
        return True
    world_size = int(world_size if world_size is not None else os.environ.get("WORLD_SIZE", 1))
    if world_size <= 1:
        return False
    rank = int(rank if rank is not None else os.environ["RANK"])
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size, timeout=datetime.timedelta(seconds=timeout_s))
    return True


def make_mesh(axes: Dict[str, int]) -> Dict[str, Axis]:
    """This rank's :class:`Axis` of every named axis, e.g.
    ``make_mesh({"data": 2, "model": 4})`` over 8 ranks. The product of the
    sizes must be the world's size (1 without a process group). Every rank
    must call it with the same axes (each group is made by every rank)."""
    shape = tuple(int(n) for n in axes.values())
    rank, size = world()
    n = int(np.prod(shape))
    if n != size:
        raise ValueError(f"mesh {axes} needs {n} processes, the world has {size}")
    grid = np.arange(n).reshape(shape)
    coord = np.unravel_index(rank, shape)
    out = {}
    for a, name in enumerate(axes):
        mine = None
        # every group of this axis, in the same order on every rank
        for rest in np.ndindex(*(shape[:a] + shape[a + 1:])):
            idx = list(rest[:a]) + [slice(None)] + list(rest[a:])
            ranks = tuple(int(r) for r in grid[tuple(idx)])
            group = dist.new_group(list(ranks)) if size > 1 and len(ranks) > 1 else None
            if rank in ranks:
                mine = Axis(name, len(ranks), ranks.index(rank), ranks, group)
        out[name] = mine
    return out


def auto_mesh(n_devices: Optional[int] = None,
              model_parallel: Optional[int] = None) -> Dict[str, Axis]:
    """JAX's heuristic mesh: the largest power-of-two model axis up to 8
    that divides the world, the rest data."""
    n = n_devices or world()[1]
    if model_parallel is None:
        model_parallel = 1
        while model_parallel * 2 <= min(n, 8) and n % (model_parallel * 2) == 0:
            model_parallel *= 2
    return make_mesh({"data": n // model_parallel, "model": model_parallel})
