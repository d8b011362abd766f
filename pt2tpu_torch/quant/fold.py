"""Offline SSR-permutation folding (counterpart of ``pt2tpu.quant.fold``).

SSR reorders each projection's input columns, so at inference the
activations must arrive in visit-lane order. Per projection:

  * ``down`` — its input ``mid = act(gate(h)) * up(h)`` is elementwise in
    the feature dim, so permuting the output lanes of gate/up makes ``mid``
    arrive already in down's visit order: exact and free at run time.
  * ``qkv`` / ``o`` / ``gateup`` (and unfused q/k/v/gate/up) — their inputs
    come from the residual stream, which keeps one feature order, so the
    permutation is realised at run time as an attached
    :class:`~pt2tpu_torch.ops.gather.PackedGather` (K4, or K3 fused into the
    projection).

Mixture-of-experts layers fold expert by expert (:func:`fold_moe_expert_perms`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from ..models.common import DenseLinear
from ..ops.gather import make_packed_gather
from ..ops.ternary_matmul import PackedTernaryLinear

__all__ = [
    "fold_layer_perms",
    "fold_moe_expert_perms",
    "fold_head_perm",
    "foldable_prefix_perm",
    "permute_out",
    "pad_gateup_blocks",
]

# Projections whose input permutation can only be realised at run time.
_GATHER_TARGETS = ("qkv", "q", "k", "v", "o", "gateup", "gate", "up")


def foldable_prefix_perm(p: PackedTernaryLinear) -> Optional[torch.Tensor]:
    """sigma = perm[:m] (int64) if the valid lanes form a contiguous prefix
    covering every original column exactly once; else None (ragged layers
    interleave pad lanes and cannot be folded into a producer)."""
    perm = p.perm
    m = p.in_features
    if perm.dim() != 1 or perm.shape[0] < m:
        return None
    if not bool((perm[m:] == m).all()):
        return None
    sigma = perm[:m].to(torch.long)
    if bool(((sigma < 0) | (sigma >= m)).any()):
        return None
    seen = torch.zeros(m, dtype=torch.bool, device=sigma.device)
    seen[sigma] = True
    return sigma if bool(seen.all()) else None


def permute_out(lin: Any, sigma: torch.Tensor) -> Any:
    """Relabel a projection's output features: new output j = old sigma[j]
    (packed planes, scales and bias permute along the lane axis; a
    DenseLinear permutes its weight rows)."""
    idx = sigma.to(torch.long)
    if isinstance(lin, DenseLinear):
        return DenseLinear(w=lin.w[idx, :], b=None if lin.b is None else lin.b[idx])
    if isinstance(lin, PackedTernaryLinear):
        if lin.packed.dim() != 2:
            raise ValueError("permute_out operates on pre-stack (2-D) layers")
        return dataclasses.replace(
            lin,
            packed=lin.packed[:, idx],
            alpha=lin.alpha[:, idx],
            mu=lin.mu[:, idx],
            bias=None if lin.bias is None else lin.bias[idx],
            out_folded=True,
        )
    raise TypeError(f"cannot permute outputs of {type(lin).__name__}")


def _attach_gather(p: PackedTernaryLinear) -> PackedTernaryLinear:
    # identity_perm is cleared so every layer of a stacked model has the same
    # structure; the one-hot of an identity perm is still exact.
    return dataclasses.replace(
        p, gather=make_packed_gather(p.perm, p.in_features), identity_perm=False
    )


def fold_layer_perms(cfg: Any, lp: Dict[str, Any]) -> Dict[str, Any]:
    """Fold or realise every SSR permutation of one (pre-stack) decoder
    layer. ``cfg`` needs only ``gated_mlp``. Identity-perm projections are
    left as they are."""
    lp = dict(lp)

    down = lp.get("down")
    if isinstance(down, PackedTernaryLinear) and down.packed.dim() != 2:
        down = None  # expert-stacked entries are folded per expert
    if isinstance(down, PackedTernaryLinear) and not (down.identity_perm or down.input_folded):
        sigma = foldable_prefix_perm(down)
        I = down.in_features
        producer_ok = False
        if sigma is not None:
            gu = lp.get("gateup")
            gate, up = lp.get("gate"), lp.get("up")
            if gu is not None and getattr(gu, "out_features", None) == 2 * I:
                lp["gateup"] = permute_out(gu, torch.cat([sigma, I + sigma]))
                producer_ok = True
            elif cfg.gated_mlp and gate is not None and up is not None:
                lp["gate"] = permute_out(gate, sigma)
                lp["up"] = permute_out(up, sigma)
                producer_ok = True
            elif not cfg.gated_mlp and up is not None:
                lp["up"] = permute_out(up, sigma)
                producer_ok = True
        if producer_ok:
            lp["down"] = dataclasses.replace(down, input_folded=True)
        else:
            lp["down"] = _attach_gather(down)

    for name in _GATHER_TARGETS:
        p = lp.get(name)
        if not isinstance(p, PackedTernaryLinear) or p.gather is not None:
            continue
        if p.identity_perm or p.input_folded or p.packed.dim() != 2:
            continue
        lp[name] = _attach_gather(p)
    return lp


def fold_moe_expert_perms(cfg: Any, expert_lps: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Fold each expert's {gateup, down} perms on its own (pre-stack,
    2-D layers), keeping the flags uniform across experts so that the
    experts stack into one (E, ...) leaf set: if the folds leave the experts
    with different flags (one expert's down perm not foldable), every
    expert's unfolded projection takes a packed one-hot gather instead."""
    folded = [fold_layer_perms(cfg, dict(lp)) for lp in expert_lps]

    def sig(lp):
        return tuple((k, v.identity_perm, v.input_folded, v.out_folded, v.gather is not None)
                     for k, v in sorted(lp.items()) if isinstance(v, PackedTernaryLinear))

    if len({sig(f) for f in folded}) == 1:
        return folded
    out = []
    for lp in expert_lps:
        lp = dict(lp)
        for k, v in list(lp.items()):
            if (isinstance(v, PackedTernaryLinear) and not v.identity_perm
                    and not v.input_folded and v.gather is None):
                lp[k] = _attach_gather(v)
        out.append(lp)
    return out


def fold_head_perm(packed: PackedTernaryLinear) -> PackedTernaryLinear:
    """Realise a quantized lm_head's SSR perm as a packed one-hot gather (the
    head has no downstream projection to fold into)."""
    if packed.identity_perm or packed.input_folded or packed.gather is not None:
        return packed
    return _attach_gather(packed)


def pad_gateup_blocks(lp: Dict[str, Any]) -> Dict[str, Any]:
    """Pad a folded gateup's gate/up halves with zero-scale columns to a
    multiple-of-8 count of 128-column blocks (llama-2-7b: 2 x 11008 ->
    2 x 11264 = 22528 lanes).

    Exact: pad columns carry alpha = mu = 0, so gate = up = 0 there. The
    decoder splits gate/up at ``out_features // 2``. Works on per-layer
    (2-D) and layer-stacked (3-D) leaves, and is idempotent.
    """
    gu, dn = lp.get("gateup"), lp.get("down")
    if lp.get("router") is not None:
        # expert stacks: the MoE MLP splits gate/up at expert_inter, unpadded
        return lp
    if not (isinstance(gu, PackedTernaryLinear) and isinstance(dn, PackedTernaryLinear)):
        return lp
    if gu.packed.dim() not in (2, 3) or not dn.input_folded:
        return lp
    I = dn.in_features
    if gu.out_features != 2 * I or I % 128 != 0:
        return lp
    nv = I // 128
    nv8 = -(-nv // 8) * 8
    if nv8 == nv:
        return lp
    if nv8 * 128 > dn.packed.shape[-2] * 4:
        return lp  # down lacks the pad rows; keep the narrow layout
    pad = (nv8 - nv) * 128

    def padded(a: torch.Tensor) -> torch.Tensor:
        gate, up = a[..., :I], a[..., I:]
        return torch.cat([F.pad(gate, (0, pad)), F.pad(up, (0, pad))], dim=-1)

    lp = dict(lp)
    lp["gateup"] = dataclasses.replace(
        gu,
        packed=padded(gu.packed),
        alpha=padded(gu.alpha),
        mu=padded(gu.mu),
        bias=None if gu.bias is None else padded(gu.bias),
    )
    return lp
