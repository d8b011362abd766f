"""Numerical-safety helpers: the counterparts of ``pt2tpu/utils/debug.py``.

- :func:`nan_debug` raises at the first operator whose floating output
  holds a NaN (the nearest counterpart of ``jax_debug_nans``: a
  ``TorchDispatchMode`` that looks at every operator's outputs);
- :func:`assert_finite_tree` names the non-finite leaves of nested dicts,
  lists, tuples and dataclasses of tensors;
- :func:`deterministic_mode` turns on ``torch.use_deterministic_algorithms``
  and cuBLAS's fixed workspace, and restores both.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Iterator, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["nan_debug", "assert_finite_tree", "deterministic_mode"]


class _NanCheck(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.is_floating_point() and bool(t.isnan().any()):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


@contextlib.contextmanager
def nan_debug() -> Iterator[None]:
    """Inside the context, an operator whose floating output holds a NaN
    raises ``FloatingPointError`` naming it (each check reads the output
    back to the host: slow, for debugging)."""
    with _NanCheck():
        yield


def _leaves(tree, path: str) -> Iterator[Tuple[str, object]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), f"{path}.{f.name}")
    else:
        yield path, tree


def assert_finite_tree(tree, name: str = "tree") -> None:
    """Raise ``FloatingPointError`` naming every floating tensor leaf of
    ``tree`` that holds a NaN or an infinity."""
    bad: List[str] = []
    for path, leaf in _leaves(tree, ""):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            if not bool(torch.isfinite(leaf).all()):
                bad.append(path)
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad}")


@contextlib.contextmanager
def deterministic_mode() -> Iterator[None]:
    """Bit-reproducible runs: ``torch.use_deterministic_algorithms(True)``
    (an operator without a deterministic kernel raises) and cuBLAS's fixed
    workspace (``CUBLAS_WORKSPACE_CONFIG=:4096:8``); both restored after."""
    prev = torch.are_deterministic_algorithms_enabled()
    prev_warn = torch.is_deterministic_algorithms_warn_only_enabled()
    prev_ws = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=prev_warn)
        if prev_ws is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = prev_ws
