"""SSR input gather: the index form of ``pt2tpu.ops.gather``.

A layer quantized with SSR consumes its input in visit-lane order. The JAX
package realises that gather as a packed one-hot kernel on the TPU (K4,
``onehot_iota_pallas``) or fused into the matmul (K3). Neither is ported
yet, so a :class:`PackedGather` is held for artifact compatibility and
applied in its index form on the CPU only; on CUDA it raises.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

__all__ = ["PackedGather", "apply_input_perm", "gather_apply"]


def apply_input_perm(x: torch.Tensor, perm: torch.Tensor, in_features: int) -> torch.Tensor:
    """Index-form gather: (..., m) -> (..., K); pad lanes (perm == m) read 0.

    A zero column is appended at index m so the per-block mu * sum(x_block)
    term stays exact on ragged layers."""
    x_pad = F.pad(x, (0, 1))
    return torch.index_select(x_pad, -1, perm.to(device=x.device, dtype=torch.long))


@dataclasses.dataclass
class PackedGather:
    """One feature permutation, packed as 2-bit one-hot planes.

    packed: (D//4, K) int8, D = in_features padded to 128 (optionally with a
            leading stacked n_layers dim).
    perm:   (K,) int32 visit lane -> original feature; pad lanes -> m.
    """

    packed: torch.Tensor
    perm: torch.Tensor
    in_features: int


def gather_apply(g: PackedGather, x: torch.Tensor) -> torch.Tensor:
    """Permute (..., m) features into visit-lane order (..., K)."""
    if x.device.type != "cpu":
        raise NotImplementedError(
            "K3/K4 not ported: the SSR input gather has no CUDA kernel yet"
        )
    if x.shape[-1] != g.in_features:
        raise ValueError(
            f"input features {x.shape[-1]} != gather in_features {g.in_features}"
        )
    return apply_input_perm(x, g.perm, g.in_features)
