"""Packed ternary linear layers: container, packing and apply.

Counterpart of ``pt2tpu.ops.ternary_matmul``. The weights stay packed as
2-bit planes and the product consumes them directly:

    out[b, j] = sum_k  alpha[blk(k), j] * T[k, j] * x[b, perm[k]]
              + sum_blk mu[blk, j] * sum_{k in blk} x[b, perm[k]]

``impl`` selects the route of every apply:

  * ``"auto"`` — the kernels on CUDA (``ops/kernels/``), their plain
    versions on the CPU;
  * ``"a8"``   — the same in W2A8 mode (int8 activations);
  * ``"plain"``— the plain versions on any device: an explicit choice, the
    counterpart of JAX's ``impl="xla"``, never a fallback;
  * ``"floor8"`` — the floor probe, which ``"auto"`` never picks: on CUDA
    the route of ``"a8"`` with the FLOOR instances of K1, K3 and K6 (the
    2-bit unpack skipped, the raw bytes dotted: wrong by design, the same
    bytes and launches, so a8 - floor8 is the unpack's share of a step);
    on the CPU the exact route, as JAX's ``impl="floor8"`` takes XLA's
    exact route off the TPU.

On CUDA a layer with an SSR gather runs, at decode-size row counts
(<= 64), K3 (the gather fused into the matmul) or K6 (the packed one-hot
gather as the matmul's prologue), and otherwise the gather (K4 or K5) then
K1, as the JAX package routes on the TPU under the same flags
(:func:`linear_route`); the whole MLP runs as K2 where :func:`fused_mlp_ok`
holds. Which of its kernels K1 or K3 launches for the rows is its
wrapper's choice by shape (``kernels.ternary.k1_path`` / ``k3_path``):
decode rows (<= 8) take the split-K tensor-core GEMV, K3's with x staged
through perm; K3's rows 9-64 a one-pass gather then a split-K tensor-core
product; other shapes K3's CUDA-core kernel.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.packing import pack_ternary
from .gather import PackedGather, gather_apply, gather_kernel
from .kernels.gather import onehot_gather_plain, slot_view
from .kernels.ternary import (
    FLOOR,
    normalize_rows_a8,
    FUSED_MAX_ROWS,
    ternary_matmul,
    ternary_matmul_gathered,
    ternary_matmul_gathered_idx,
    ternary_matmul_idx,
    ternary_matmul_igathered,
    ternary_matmul_igathered_idx,
    ternary_matmul_plain,
    ternary_matmul_plain_a8,
    ternary_mlp,
)

__all__ = [
    "PackedTernaryLinear",
    "make_packed_linear",
    "pack_layer",
    "ternary_linear_apply",
    "ternary_linear_apply_stacked",
    "linear_route",
    "fused_mlp_ok",
    "fused_mlp_apply",
    "ternary_matmul_plain",
    "ternary_matmul_plain_a8",
    "normalize_rows_a8",
    "IMPLS",
]

IMPLS = ("auto", "a8", "plain", "floor8")

# The routing flags of ``pt2tpu.ops.ternary_matmul`` (same environment
# variables and defaults), read at each call.
IGATHER_FUSED = os.environ.get("PT2TPU_IGATHER_FUSED", "1") == "1"
"""Run a gathered layer's decode-size rows through K3 (the gather as an
indexed load inside the matmul)."""
FUSED_GATHER = os.environ.get("PT2TPU_FUSED_GATHER", "0") == "1"
"""With IGATHER_FUSED off, run them through K6 (x @ G as the matmul's
prologue) instead of the gather kernel then K1."""
FUSED_MLP = os.environ.get("PT2TPU_FUSED_MLP", "1") == "1"
"""Allow the one-launch MLP kernel K2 where :func:`fused_mlp_ok` holds."""


@dataclasses.dataclass
class PackedTernaryLinear:
    """Inference-time packed parameters for one ternarized linear layer.

    Shapes (K = num_blocks * block_size lanes in visit order), optionally
    with a leading stacked n_layers dim:
      packed: (K // 4, n) int8 2-bit planes (core/packing.py layout)
      alpha:  (nb, n) scale per (block, out_feature)
      mu:     (nb, n) offset per (block, out_feature)
      perm:   (K,) int32 visit-lane -> original in_feature; pad lanes -> m
      bias:   (n,) or None
      gather: optional PackedGather (SSR layouts)
    """

    packed: torch.Tensor
    alpha: torch.Tensor
    mu: torch.Tensor
    perm: torch.Tensor
    bias: Optional[torch.Tensor]
    in_features: int
    identity_perm: bool = False
    gather: Optional[PackedGather] = None
    input_folded: bool = False
    out_folded: bool = False

    @property
    def block_size(self) -> int:
        return (self.packed.shape[-2] * 4) // self.alpha.shape[-2]

    @property
    def out_features(self) -> int:
        return self.packed.shape[-1]

    def map_leaves(self, fn) -> "PackedTernaryLinear":
        """A copy with ``fn`` applied to every tensor leaf (its gather's too)."""
        g = self.gather
        if g is not None:
            g = PackedGather(packed=fn(g.packed), perm=fn(g.perm), in_features=g.in_features)
        return dataclasses.replace(
            self,
            packed=fn(self.packed),
            alpha=fn(self.alpha),
            mu=fn(self.mu),
            perm=fn(self.perm),
            bias=None if self.bias is None else fn(self.bias),
            gather=g,
        )

    def layer(self, li: int) -> "PackedTernaryLinear":
        """Layer ``li`` of a stacked container, as zero-copy views."""
        return self.map_leaves(lambda t: t[li])


def make_packed_linear(
    codes: torch.Tensor,  # (n, K) int8 in {-1,0,1}, visit order
    alpha: torch.Tensor,  # (nb, n)
    mu: torch.Tensor,  # (nb, n)
    perm: torch.Tensor,  # (K,)
    bias: Optional[torch.Tensor],
    in_features: int,
    block_size: int,
) -> PackedTernaryLinear:
    """Pack codes + scales (stored bf16) into the inference layout.

    The scale-block count is padded to a multiple of 16 (as the JAX package
    does for its TPU tiles, so artifacts agree). Pad blocks get zero
    alpha/mu and their perm lanes point at the zero slot (index m).
    """
    nb = alpha.shape[0]
    nbp = -(-nb // 16) * 16
    pad_blocks = nbp - nb
    if pad_blocks:
        codes = F.pad(codes, (0, pad_blocks * block_size))
        alpha = F.pad(alpha, (0, 0, 0, pad_blocks))
        mu = F.pad(mu, (0, 0, 0, pad_blocks))
        perm = F.pad(perm, (0, pad_blocks * block_size), value=in_features)
    packed = pack_ternary(codes, block_size=block_size)
    perm_h = perm.cpu()
    identity = bool(
        torch.equal(perm_h[:in_features], torch.arange(in_features, dtype=perm_h.dtype))
        and bool((perm_h[in_features:] == in_features).all())
    )
    return PackedTernaryLinear(
        packed=packed,
        alpha=alpha.to(torch.bfloat16),
        mu=mu.to(torch.bfloat16),
        perm=perm.to(torch.int32),
        bias=bias,
        in_features=in_features,
        identity_perm=identity,
    )


def pack_layer(q, in_features: int, bias: Optional[torch.Tensor] = None) -> PackedTernaryLinear:
    """Freeze a quantizer result (``quant.gptq.TernaryLayerQuant``) into the
    packed inference layout. Invalid lanes already carry T == 0 and perm ==
    m, so nothing is masked here."""
    return make_packed_linear(
        codes=q.T,
        alpha=q.alpha.t(),
        mu=q.mu.t(),
        perm=q.perm,
        bias=bias,
        in_features=in_features,
        block_size=q.block_size,
    )


def _a8_flag(impl: str, device) -> object:
    """The kernels' ``a8`` for ``impl`` on ``device``: True (W2A8), False
    (bf16), or "floor" for ``impl="floor8"`` on CUDA (JAX's ``_a8_flag``).
    On the CPU floor8 is the exact route: JAX's takes ``ternary_matmul_xla``
    off the TPU."""
    if impl == "floor8":
        return FLOOR if torch.device(device).type == "cuda" else False
    return impl == "a8"


def _input_lanes(p: PackedTernaryLinear, x2: torch.Tensor, K: int, impl: str) -> torch.Tensor:
    """Present activations in visit-lane order (B, K): fold / identity need
    only a zero pad to K; a PackedGather runs its gather kernel (K4 or K5 on
    CUDA); a bare perm takes the index
    form, as the JAX package's ``apply_input_perm`` (an XLA gather) does."""
    m = x2.shape[-1]
    if p.identity_perm or p.input_folded:
        return x2 if K == m else F.pad(x2, (0, K - m))
    if p.gather is not None:
        return gather_apply(p.gather, x2, impl)
    return onehot_gather_plain(x2, p.perm)


def linear_route(p: PackedTernaryLinear, rows: int, impl: str = "auto",
                 device="cuda", device_index: bool = False) -> Tuple[str, ...]:
    """The kernels :func:`ternary_linear_apply` launches for ``rows`` rows of
    layer ``p`` on ``device``, in launch order, by their wrappers' names; ()
    where it runs plain versions (``impl="plain"`` or the CPU).

    On CUDA this is the choice of the JAX package's ``ternary_linear_apply``
    on the TPU: a layer with a gather to realise, at <= FUSED_MAX_ROWS (64)
    rows and with the shapes the fused kernels take, runs K3 if
    :data:`IGATHER_FUSED`, else K6 if :data:`FUSED_GATHER`; otherwise the
    gather kernel (:func:`gather_kernel`: K4 or K5) and then K1. A layer
    without a gather runs K1 alone (a bare perm is the index form, not a
    kernel). The names are the wrappers'; which kernel a wrapper launches
    for ``rows`` is its own choice by shape (``k1_path``, ``k3_path``,
    ``k6_path``, ``k4_path``, ``k5_path``): K3 and K6 on three paths each,
    their decode rows on the split-K tensor-core GEMV, their rows 9-64 on a
    one-pass gather (K6's through the packed planes) and the split-K
    tensor-core product, other shapes on their CUDA-core kernels; K4, and K5
    from 16 rows, on their rows paths (x's rows staged in shared memory).

    ``device_index``: the slot of a stacked ``p`` is a tensor on the device
    (:func:`ternary_linear_apply_stacked`): every kernel of the route is
    then its device-index entry, "ternary_matmul_idx" (K1s),
    "ternary_matmul_igathered_idx" (K3s), "ternary_matmul_gathered_idx"
    (K6s), "onehot_gather_idx" (K4s) or "onehot_matmul_idx" (K5s).
    ``impl="floor8"`` routes as ``"a8"`` (its kernels' FLOOR instances)."""
    dev = torch.device(device)
    if impl == "plain" or dev.type == "cpu":
        return ()
    if p.identity_perm or p.input_folded or p.gather is None:
        route = ("ternary_matmul",)
    elif (dev.type == "cuda" and rows <= FUSED_MAX_ROWS and p.block_size % 128 == 0
            and p.out_features % 128 == 0 and (IGATHER_FUSED or FUSED_GATHER)):
        route = ("ternary_matmul_igathered",) if IGATHER_FUSED else ("ternary_matmul_gathered",)
    else:
        route = (gather_kernel(), "ternary_matmul")
    if device_index:
        return tuple(name + "_idx" for name in route)
    return route


def ternary_linear_apply(
    p: PackedTernaryLinear,
    x: torch.Tensor,
    impl: str = "auto",
    out_dtype=None,
) -> torch.Tensor:
    """Full layer: input lanes -> packed product -> bias. (..., m) -> (..., n).

    The product is f32; the bias is added to it before the cast to
    ``out_dtype`` (default: x's dtype)."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    m = x.shape[-1]
    if m != p.in_features:
        raise ValueError(f"input features {m} != layer in_features {p.in_features}")
    x2 = x.reshape(-1, m)
    K = p.packed.shape[-2] * 4
    bs = p.block_size
    a8 = _a8_flag(impl, x2.device)
    route = linear_route(p, x2.shape[0], impl, x2.device)
    if route == ("ternary_matmul_igathered",):
        out = ternary_matmul_igathered(x2, p.perm, p.packed, p.alpha, p.mu, bs, a8=a8)
    elif route == ("ternary_matmul_gathered",):
        out = ternary_matmul_gathered(x2, p.gather.packed, p.packed, p.alpha, p.mu, bs, a8=a8)
    else:
        xk = _input_lanes(p, x2, K, impl)
        if impl == "plain":
            out = ternary_matmul_plain(xk, p.packed, p.alpha, p.mu, bs)
        else:
            out = ternary_matmul(xk, p.packed, p.alpha, p.mu, bs, a8=a8)
    if p.bias is not None:
        out = out + p.bias.to(out.dtype)
    return out.to(out_dtype).reshape(*lead, p.out_features)


def ternary_linear_apply_stacked(
    p: PackedTernaryLinear,
    x: torch.Tensor,
    layer_idx,
    impl: str = "auto",
    out_dtype=None,
    base: int = 0,
) -> torch.Tensor:
    """Apply slot ``base + layer_idx`` of a stacked container.

    ``layer_idx`` a host int: :func:`ternary_linear_apply` on the zero-copy
    view ``p.layer(base + layer_idx)``. A 0-d or 1-element integer tensor on
    the layer's device (a routed expert's index): the slot is never read on
    the host. On CUDA every kernel of the route (:func:`linear_route` with
    ``device_index``) runs its device-index entry on the whole stack, with
    ``base`` passed to the kernel: K3s, K6s, or the gather (K4s or K5s)
    then K1s, as the flags and shapes choose, as JAX's stacked kernels take
    the traced index. The plain route gathers the slot's weights on the
    device; on the CPU the index is read."""
    if not isinstance(layer_idx, torch.Tensor):
        return ternary_linear_apply(p.layer(base + layer_idx), x, impl=impl, out_dtype=out_dtype)
    return _apply_device_index(p, x, layer_idx, base, impl, out_dtype)


def _apply_device_index(p, x, sel, base, impl, out_dtype):
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if sel.numel() != 1 or sel.dtype.is_floating_point or sel.dtype == torch.bool:
        raise ValueError(f"a device index is one integer, got {sel.dtype} {tuple(sel.shape)}")
    if sel.device != x.device or p.packed.device != x.device:
        raise ValueError(f"index on {sel.device}, x on {x.device}, weights on {p.packed.device}")
    if p.packed.dim() != 3:
        raise ValueError(f"a device index selects a slot of an (S, K/4, n) stack, got "
                         f"{tuple(p.packed.shape)}")
    out_dtype = out_dtype or x.dtype
    lead, m = x.shape[:-1], x.shape[-1]
    if m != p.in_features:
        raise ValueError(f"input features {m} != layer in_features {p.in_features}")
    x2 = x.reshape(-1, m)
    route = linear_route(p, x2.shape[0], impl, x2.device, device_index=True)
    if not route:
        if x.device.type == "cpu":
            return ternary_linear_apply(p.layer(base + int(sel.reshape(-1)[0])), x, impl=impl,
                                        out_dtype=out_dtype)
        # the plain route: the slot's weights gathered on the device (a copy),
        # never read on the host
        return ternary_linear_apply(p.map_leaves(lambda t: slot_view(t, sel, base)), x,
                                    impl="plain", out_dtype=out_dtype)
    bs = p.block_size
    a8 = _a8_flag(impl, x2.device)
    sel32 = sel.reshape(()) if sel.dtype == torch.int32 else sel.to(torch.int32).reshape(())
    if route == ("ternary_matmul_igathered_idx",):
        out = ternary_matmul_igathered_idx(x2, p.perm, p.packed, p.alpha, p.mu, sel32, base, bs,
                                           a8=a8)
    elif route == ("ternary_matmul_gathered_idx",):
        out = ternary_matmul_gathered_idx(x2, p.gather.packed, p.packed, p.alpha, p.mu, sel32,
                                          base, bs, a8=a8)
    else:  # K1s, after the gather kernel's device-index entry where there is one
        K = p.packed.shape[-2] * 4
        if len(route) == 2:
            xk = gather_apply(p.gather, x2, impl, sel32, base)
        elif p.identity_perm or p.input_folded:
            xk = x2 if K == m else F.pad(x2, (0, K - m))
        else:  # a bare perm: the index form, as the host-index route takes it
            xk = onehot_gather_plain(x2, slot_view(p.perm, sel, base))
        out = ternary_matmul_idx(xk, p.packed, p.alpha, p.mu, sel32, base, bs, a8=a8)
    if p.bias is not None:
        out = out + slot_view(p.bias, sel, base).to(out.dtype)
    return out.to(out_dtype).reshape(*lead, p.out_features)


def fused_mlp_ok(gu, dn, impl: str, rows: int, device) -> bool:
    """Routing predicate for the fused MLP kernel K2: the checks of
    ``pt2tpu.ops.ternary_matmul.fused_mlp_ok`` one by one, with CUDA in the
    place of the TPU: gated (gateup 2 x I wide) and ungated (I wide) alike.
    So on the CPU, or with :data:`FUSED_MLP` off, the MLP takes the two-call
    path, as the JAX package does there."""
    return (FUSED_MLP and torch.device(device).type == "cuda"
            and _fused_mlp_layout_ok(gu, dn, impl, rows))


def _fused_mlp_layout_ok(gu, dn, impl: str, rows: int) -> bool:
    """Everything in :func:`fused_mlp_ok` but the backend."""
    if impl != "auto":  # W2A8 keeps the two-call path, as in the JAX package
        return False
    if not isinstance(gu, PackedTernaryLinear) or not isinstance(dn, PackedTernaryLinear):
        return False
    if rows > 64:  # prefill rows: keep the wide two-call path
        return False
    if gu.bias is not None or dn.bias is not None:
        return False
    if not dn.input_folded:
        return False
    if not (gu.gather is not None or gu.identity_perm or gu.input_folded):
        return False
    I = dn.in_features
    bs = 128
    if I % bs != 0 or dn.out_features % 128 != 0:
        return False
    if gu.out_features not in (2 * I, I):  # gated or ungated
        return False
    if gu.block_size != bs or dn.block_size != bs:
        return False
    if gu.identity_perm or gu.input_folded:
        # without a gather x is zero-padded straight to gateup's lane count
        K = gu.packed.shape[-2] * 4
        if -(-gu.in_features // 128) * 128 != K:
            return False
    return True


def fused_mlp_apply(
    gu: PackedTernaryLinear,
    dn: PackedTernaryLinear,
    x: torch.Tensor,
    act: str,
    layer_idx: Optional[int] = None,
    out_dtype=None,
    impl: str = "auto",
) -> torch.Tensor:
    """One-call MLP: (..., m) -> (..., n) through K2 (its plain version on
    the CPU), with ``act`` silu, gelu (tanh form) or relu; an ungated
    gateup (up alone) goes through K2's ungated mode as it is. The caller
    has checked :func:`fused_mlp_ok`. ``impl`` only tells the floor probe
    apart, as JAX's: ``"floor8"`` runs K2's floor mode
    (``kernels.ternary.ternary_mlp_floor_plain``; no route picks it, since
    :func:`fused_mlp_ok` answers False for any impl but "auto"); every other
    value computes the bf16 MLP."""
    if layer_idx is not None and gu.packed.dim() == 3:
        gu, dn = gu.layer(layer_idx), dn.layer(layer_idx)
    out_dtype = out_dtype or x.dtype
    x2 = x.reshape(-1, x.shape[-1])
    has_gather = not (gu.identity_perm or gu.input_folded)
    floor = {"a8": FLOOR} if impl == "floor8" else {}  # the bf16 MLP's call unchanged
    out = ternary_mlp(
        x2, gu.perm if has_gather else None, gu.packed, gu.alpha, gu.mu,
        dn.packed, dn.alpha, dn.mu, intermediate=dn.in_features, act=act, **floor,
    )
    return out.to(out_dtype).reshape(*x.shape[:-1], dn.out_features)
