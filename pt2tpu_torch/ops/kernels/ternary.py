"""The packed-ternary kernels K1, K3, K6 and K2: plain versions and wrappers.

  * K1 ``ternary_matmul``: the fused 2-bit unpack + matmul (replaces
    ``pt2tpu/ops/kernels/pallas_ternary.py:ternary_matmul_pallas``), on four
    paths chosen by shape (:func:`k1_path`): a split-K tensor-core GEMV
    (``csrc/ternary_matmul_dec.cu``) for bf16 decode rows <=
    :data:`K1_DEC_MAX_ROWS` (W2A8 too with :data:`K1_DEC_A8`); the bf16
    tensor cores (``csrc/ternary_matmul_tc.cu``) for bf16 rows >=
    :data:`K1_TC_MIN_ROWS`; the int8 tensor cores
    (``csrc/ternary_matmul_tc_a8.cu``) for W2A8 rows >= :data:`K1_TC_MIN_ROWS`;
    the CUDA cores (``csrc/ternary_matmul.cu``) for every other shape.
  * K1s / K3s ``ternary_matmul_idx`` / ``ternary_matmul_igathered_idx``:
    K1 and K3 at decode rows on one slot of a whole stack, the slot read by
    the kernel from device memory (replace ``ternary_matmul_pallas_stacked``
    and ``ternary_matmul_pallas_igathered_stacked`` with a traced index: the
    mixture-of-experts decode's routed experts), on the decode kernel or the
    CUDA-core kernel as :func:`k1_path` / :func:`k3_path` choose.
  * K3 ``ternary_matmul_igathered``: K1 with the SSR input gather fused in
    (replaces ``ternary_matmul_pallas_igathered``), on three paths chosen by
    shape (:func:`k3_path`): K1's decode kernel with x staged through perm
    (``csrc/ternary_matmul_dec.cu``) where :func:`k1_path` says "dec"; a
    one-pass gather then a split-K tensor-core product
    (``csrc/ternary_matmul_igathered_tc.cu``) for rows
    :data:`K1_TC_MIN_ROWS` .. :data:`FUSED_MAX_ROWS`; the CUDA-core kernel
    (``csrc/ternary_matmul.cu``) for every other shape.
  * K6 ``ternary_matmul_gathered``: the packed one-hot gather x @ G, then
    the matmul (replaces ``ternary_matmul_pallas_gathered``), on three paths
    chosen by shape (:func:`k6_path`): the plane gather
    (``csrc/planes_gather.cuh``) into lane order, then K1's decode kernel
    (``csrc/ternary_matmul_gathered_dec.cu``) for rows 1 ..
    :data:`K6_DEC_MAX_ROWS`; the plane gather into fragment order, then K3's
    split-K tensor-core product (``csrc/ternary_matmul_gathered_tc.cu``) for
    rows :data:`K6_TC_MIN_ROWS` .. :data:`FUSED_MAX_ROWS`; the gather run as
    a CUDA-core matmul's prologue (``csrc/ternary_matmul_gathered.cu``) for
    every other shape.
  * K6s ``ternary_matmul_gathered_idx``: K6 at decode rows on one slot of
    whole stacks, the slot read by the kernels from device memory (replaces
    ``ternary_matmul_pallas_gathered_stacked`` with a traced index), on K6's
    decode path (both launches' IDX instances) or its CUDA-core kernel as
    :func:`k6_path` chooses.
  * K2 ``ternary_mlp``: the whole MLP, silu, gelu or relu (replaces
    ``ternary_mlp_pallas``), on three paths chosen by rows (:func:`k2_path`):
    K1's decode GEMV over gateup with x staged through perm, the gated
    epilogue in the last CTA of each gate/up tile pair, then K1's decode
    kernel over mid (``csrc/ternary_mlp_dec.cu``) for rows 1 ..
    :data:`K2_DEC_MAX_ROWS`; K3's one-pass gather, a split-K tensor-core
    gate/up product with the gated epilogue, then K3's product over mid
    (``csrc/ternary_mlp_tc.cu``) for rows :data:`K2_TC_MIN_ROWS` ..
    :data:`FUSED_MAX_ROWS`; one CUDA-core launch (``csrc/ternary_mlp.cu``)
    for the rows neither takes (the A/Bs' "off" turns). An ungated gateup
    (up alone, :func:`_mlp_shapes`) takes each path's ungated instance, whose
    epilogue writes mid = act(up).

The floor probe (``a8="floor"``, reached by ``impl="floor8"``; replaces
the "floor" mode of ``pallas_ternary._accumulate_step``) runs K1, K3 and K6
on W2A8's paths in the FLOOR instances of their kernels: each plane's code
is the raw signed byte of its packed row in place of its 2-bit field, so the
unpack is skipped and the result is wrong by design, with the same bytes,
grids and launches (``ternary_matmul_floor_plain`` and its gathered forms
state it).

Each wrapper launches its hand-written kernel on a CUDA tensor or raises,
and runs the plain version beside it on a CPU tensor. There is no fallback
from a kernel to its plain version. The ``_stacked`` TPU variants at a host
index collapse into these: a stacked layer is the zero-copy view
``packed[li]``; at a device index they are K1s, K3s and K6s.

The plain versions repeat ``pt2tpu.ops.ternary_matmul.ternary_matmul_xla``:
unpack, one product per scale block, then the scales, all in f32.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ...core.packing import unpack_ternary
from . import _build
from .gather import onehot_gather_plain, onehot_matmul_plain, onehot_planes, slot_view

__all__ = [
    "K1_TC_MIN_ROWS",
    "K1_DEC_MAX_ROWS",
    "K1_DEC_A8",
    "FUSED_MAX_ROWS",
    "K2_TC_MIN_ROWS",
    "K2_DEC_MAX_ROWS",
    "k1_path",
    "k3_path",
    "k2_path",
    "dec_splits",
    "igtc_splits",
    "ternary_matmul",
    "ternary_matmul_plain",
    "ternary_matmul_plain_a8",
    "FLOOR",
    "ternary_matmul_floor_plain",
    "ternary_matmul_igathered_floor_plain",
    "ternary_matmul_gathered_floor_plain",
    "quantize_rows_a8_lanes_plain",
    "ternary_matmul_lanes_plain",
    "ternary_matmul_dec_plain",
    "ternary_matmul_igathered_dec_plain",
    "igathered_tc_gather_plain",
    "ternary_matmul_igathered_tc_plain",
    "ternary_matmul_igathered",
    "ternary_matmul_igathered_plain",
    "ternary_matmul_idx",
    "ternary_matmul_idx_plain",
    "ternary_matmul_igathered_idx",
    "ternary_matmul_igathered_idx_plain",
    "ternary_matmul_gathered",
    "ternary_matmul_gathered_plain",
    "ternary_matmul_gathered_idx",
    "ternary_matmul_gathered_idx_plain",
    "K6_DEC_MAX_ROWS",
    "K6_TC_MIN_ROWS",
    "k6_path",
    "planes_gather_plain",
    "ternary_matmul_gathered_dec_plain",
    "ternary_matmul_gathered_tc_plain",
    "MLP_ACTS",
    "mlp_act_code",
    "mlp_activation",
    "ternary_mlp",
    "ternary_mlp_plain",
    "mlp_tc_gather_plain",
    "mlp_tc_mid_plain",
    "ternary_mlp_tc_plain",
    "ternary_mlp_dec_plain",
    "normalize_rows_a8",
]


def normalize_rows_a8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row absmax normalisation for W2A8: x ~= x_norm * sx with
    |x_norm| <= 127. x_norm is cast to bf16 BEFORE the kernel rounds it to
    int8 (as pallas_ternary.normalize_rows_a8 does)."""
    x32 = x.float()
    sx = x32.abs().amax(dim=-1, keepdim=True) / 127.0
    sx = sx.clamp_min(1e-12)
    return (x32 / sx).to(torch.bfloat16), sx


def ternary_matmul_plain(
    x: torch.Tensor,  # (B, K) activations in visit-lane order
    packed: torch.Tensor,  # (K//4, n) int8 planes
    alpha: torch.Tensor,  # (nb, n)
    mu: torch.Tensor,  # (nb, n)
    block_size: int = 128,
) -> torch.Tensor:
    """out = x @ (alpha * T + mu), blockwise, in f32. Returns (B, n) f32."""
    K4, n = packed.shape
    K = K4 * 4
    nb = K // block_size
    B = x.shape[0]
    T = unpack_ternary(packed, block_size).float().reshape(nb, block_size, n)
    xb = x.float().reshape(B, nb, block_size)
    t = torch.einsum("bkc,kcn->bkn", xb, T)  # per-block code products
    s = xb.sum(dim=2)  # (B, nb)
    out = torch.einsum("bkn,kn->bn", t, alpha.float())
    return out + s @ mu.float()


def ternary_matmul_plain_a8(
    x: torch.Tensor,
    packed: torch.Tensor,
    alpha: torch.Tensor,
    mu: torch.Tensor,
    block_size: int = 128,
) -> torch.Tensor:
    """W2A8 emulation (``ternary_matmul_xla_a8``): bf16-normalised rows,
    round half-to-even to int8, integer-valued products, output times sx."""
    xn, sx = normalize_rows_a8(x)
    xq = torch.clamp(torch.round(xn.float()), -127, 127)
    return ternary_matmul_plain(xq, packed, alpha, mu, block_size) * sx


def quantize_rows_a8_lanes_plain(xn: torch.Tensor, block_size: int = 128):
    """The prepass of K1's int8 tensor-core path (``csrc/ternary_matmul_tc_a8.cu``):
    xn (B, K) -> (xq, S). xq is int8 clip(round(xn), -127, 127) (half to
    even) in the lane order of the packed bytes: within a scale block,
    position 4r + p holds lane p*bs/4 + r. S (nb, B) int32 holds the exact
    per-block sums of xq."""
    B, K = xn.shape
    bs = block_size
    nb = K // bs
    xq = torch.clamp(torch.round(xn.float()), -127, 127).to(torch.int8)
    lanes = xq.reshape(B, nb, 4, bs // 4).transpose(2, 3).reshape(B, K)
    S = xq.reshape(B, nb, bs).sum(dim=2, dtype=torch.int32).T.contiguous()
    return lanes.contiguous(), S


def ternary_matmul_lanes_plain(
    xq: torch.Tensor,  # (B, K) int8 in lane order
    S: torch.Tensor,  # (nb, B) int32 block sums
    packed: torch.Tensor,
    alpha: torch.Tensor,
    mu: torch.Tensor,
    block_size: int = 128,
) -> torch.Tensor:
    """The integer algorithm of K1's int8 tensor-core path on its prepass's
    output, before the row scales: d = xq . u - S per block, exact in
    integers (u = T + 1, each packed byte's planes in place: lane order),
    then out = S @ mu + sum_blk alpha * d in f32. Returns (B, n) f32."""
    B, K = xq.shape
    n = packed.shape[1]
    nb = K // block_size
    pk = packed.to(torch.int32) & 0xFF
    u = torch.stack([(pk >> (2 * p)) & 3 for p in range(4)], dim=1).reshape(K, n)
    d = torch.einsum("bkc,kcn->bkn", xq.to(torch.int64).reshape(B, nb, block_size),
                     u.to(torch.int64).reshape(nb, block_size, n))
    d = d - S.T.to(torch.int64)[:, :, None]  # (B, nb, n) = xq_blk . T_blk
    out = torch.einsum("bkn,kn->bn", d.float(), alpha.float())
    return out + S.T.float() @ mu.float()


def ternary_matmul_igathered_plain(
    x: torch.Tensor,  # (B, m) activations in feature order
    perm: torch.Tensor,  # (K,) visit lane -> feature; pad lanes -> m
    packed: torch.Tensor,
    alpha: torch.Tensor,
    mu: torch.Tensor,
    block_size: int = 128,
    a8: bool = False,
) -> torch.Tensor:
    """out = x[:, perm] @ dequant(packed) in f32. W2A8 normalises the rows
    before the gather, as ``ternary_matmul_pallas_igathered`` does (absmax
    does not depend on the order of the columns). ``a8`` "floor": :func:`ternary_matmul_igathered_floor_plain`."""
    if _a8_mode(a8) == 2:
        return ternary_matmul_igathered_floor_plain(x, perm, packed, alpha, mu, block_size)
    if not a8:
        return ternary_matmul_plain(onehot_gather_plain(x, perm), packed, alpha, mu, block_size)
    xn, sx = normalize_rows_a8(x)
    xq = torch.clamp(torch.round(onehot_gather_plain(xn, perm).float()), -127, 127)
    return ternary_matmul_plain(xq, packed, alpha, mu, block_size) * sx


def ternary_matmul_gathered_plain(
    x: torch.Tensor,  # (B, m) activations in feature order
    gpacked: torch.Tensor,  # (D//4, K) packed one-hot planes, D >= m
    packed: torch.Tensor,
    alpha: torch.Tensor,
    mu: torch.Tensor,
    block_size: int = 128,
    a8: bool = False,
) -> torch.Tensor:
    """out = (x @ G) @ dequant(packed) in f32, as
    ``ternary_matmul_pallas_gathered`` computes it: the gather is the f32
    product with G's raw fields (``onehot_matmul_plain``). W2A8 normalises
    the rows before the gather (absmax does not depend on the order of the
    columns) and rounds the gathered values to int8. ``a8`` "floor":
    :func:`ternary_matmul_gathered_floor_plain`."""
    if _a8_mode(a8) == 2:
        return ternary_matmul_gathered_floor_plain(x, gpacked, packed, alpha, mu, block_size)
    if not a8:
        return ternary_matmul_plain(onehot_matmul_plain(x.float(), gpacked), packed, alpha, mu,
                                    block_size)
    xn, sx = normalize_rows_a8(x)
    xq = torch.clamp(torch.round(onehot_matmul_plain(xn.float(), gpacked)), -127, 127)
    return ternary_matmul_plain(xq, packed, alpha, mu, block_size) * sx


FLOOR = "floor"
"""The ``a8`` value of the floor probe (``impl="floor8"``), as the JAX
package's ``_a8_flag`` gives it: W2A8 with the 2-bit unpack skipped."""


def _a8_mode(a8) -> int:
    """The C entries' ``a8``: 0 bf16, 1 W2A8, 2 the floor probe."""
    if isinstance(a8, str):
        if a8 != FLOOR:
            raise ValueError(f"a8 is a bool or {FLOOR!r}, got {a8!r}")
        return 2
    return int(bool(a8))


def _floor_plain(xq: torch.Tensor, packed: torch.Tensor, alpha: torch.Tensor, mu: torch.Tensor,
                 block_size: int) -> torch.Tensor:
    """The floor's product on rounded rows xq (B, K): per scale block the
    dot of xq with the raw signed bytes (lane r of block blk reads byte
    packed[blk * bs/4 + r % (bs/4)]: the block's packed rows replicated four
    times), times alpha, plus sum(xq_blk) * (mu - alpha); in f32, the dots
    exact (integers below 2^24)."""
    B, K = xq.shape
    n, bs = packed.shape[1], block_size
    nb = K // bs
    raw = packed.float().reshape(nb, 1, bs // 4, n).expand(nb, 4, bs // 4, n)
    xb = xq.float().reshape(B, nb, bs)
    d = torch.einsum("bkc,kcn->bkn", xb, raw.reshape(nb, bs, n))
    out = xb.sum(dim=2) @ (mu.float() - alpha.float())
    return out + torch.einsum("bkn,kn->bn", d, alpha.float())


def _rounded(xn: torch.Tensor) -> torch.Tensor:
    """W2A8's rounding of normalised values: half to even, clipped to +-127."""
    return torch.clamp(torch.round(xn.float()), -127, 127)


def ternary_matmul_floor_plain(
    x: torch.Tensor,  # (B, K) activations in visit-lane order
    packed: torch.Tensor,  # (K//4, n) int8 planes
    alpha: torch.Tensor,
    mu: torch.Tensor,
    block_size: int = 128,
) -> torch.Tensor:
    """The floor probe (``pallas_ternary._accumulate_step``'s "floor" mode,
    reached by ``impl="floor8"``): W2A8's normalised and rounded rows dotted
    with the raw packed bytes, the 2-bit unpack skipped, so the result is
    wrong by design; the offset term and the alpha product are kept, and the
    output is multiplied by the row scales. Returns (B, n) f32."""
    xn, sx = normalize_rows_a8(x)
    return _floor_plain(_rounded(xn), packed, alpha, mu, block_size) * sx


def ternary_matmul_igathered_floor_plain(x, perm, packed, alpha, mu, block_size=128):
    """The floor probe of K3 (``ternary_matmul_pallas_igathered`` with
    ``a8="floor"``): the rows normalised, gathered through perm, rounded,
    then :func:`ternary_matmul_floor_plain`'s product."""
    xn, sx = normalize_rows_a8(x)
    return _floor_plain(_rounded(onehot_gather_plain(xn, perm)), packed, alpha, mu,
                        block_size) * sx


def ternary_matmul_gathered_floor_plain(x, gpacked, packed, alpha, mu, block_size=128):
    """The floor probe of K6 (``ternary_matmul_pallas_gathered`` with
    ``a8="floor"``): the rows normalised, gathered by the product with G's
    raw fields, rounded, then :func:`ternary_matmul_floor_plain`'s
    product."""
    xn, sx = normalize_rows_a8(x)
    return _floor_plain(_rounded(onehot_matmul_plain(xn.float(), gpacked)), packed, alpha, mu,
                        block_size) * sx


def _check_floor(a8, block_size: int) -> None:
    """The floor's kernels keep their block dots exact up to scale blocks of
    256 (K1's int8 tensor cores sum them under a float bias of 1.5 * 2^23)."""
    if _a8_mode(a8) == 2 and block_size > 256:
        raise ValueError(f"the floor probe takes scale blocks of at most 256, got {block_size}")


def _mlp_shapes(gu_packed, gu_alpha, dn_packed, dn_alpha, intermediate, block_size):
    """The checks of ``pallas_ternary._mlp_common``, gated and ungated.
    Returns (Kg, half, nv, n, gated): gated (gateup at least 2 x I wide, a
    multiple of 2 x block_size), gate lanes [0, half) and up lanes
    [half, 2 * half); ungated (at least I wide, a multiple of block_size),
    up alone, half = its width. nv = half // block_size visited k-blocks of
    down, which must hold them and the superblock of 8 scale rows that the
    last of them starts."""
    Kg4, gu_n = gu_packed.shape[-2:]
    Kg = Kg4 * 4
    Kd4, n = dn_packed.shape[-2:]
    nbd = dn_alpha.shape[-2]
    bs, I = block_size, intermediate
    if gu_n >= 2 * I and gu_n % (2 * bs) == 0:
        gated, half = True, gu_n // 2
    elif gu_n >= I and gu_n % bs == 0:
        gated, half = False, gu_n
    else:
        raise ValueError(f"gateup width {gu_n} vs intermediate {I}")
    if bs % 128 or gu_alpha.shape[-2] * bs != Kg or nbd * bs != Kd4 * 4:
        raise ValueError(
            f"bad shapes: gu {tuple(gu_packed.shape)}, dn {tuple(dn_packed.shape)}, bs {bs}"
        )
    if I % bs:
        raise ValueError(f"intermediate {I} not a multiple of block {bs}")
    nv = half // bs
    if nv > nbd:
        raise ValueError(f"gate-half blocks {nv} exceed down blocks {nbd}")
    if -(-nv // 8) * 8 > nbd:
        raise ValueError(f"down scale rows {nbd} < {-(-nv // 8) * 8} (superblock bound)")
    if n % 128:
        raise ValueError(f"out_features {n} must be a multiple of 128")
    return Kg, half, nv, n, gated


MLP_ACTS = ("silu", "gelu", "relu")
"""K2's activations (``pallas_ternary._act_fn``'s), by the code that the C
entry takes: gelu is the tanh form, jax.nn.gelu's default."""


def mlp_act_code(act: str) -> int:
    """``act``'s code in :data:`MLP_ACTS`; ValueError for any other, as
    ``pallas_ternary._act_fn`` raises."""
    if act not in MLP_ACTS:
        raise ValueError(f"unsupported fused-MLP activation {act!r}")
    return MLP_ACTS.index(act)


def mlp_activation(act: str, v: torch.Tensor) -> torch.Tensor:
    """``act`` (one of :data:`MLP_ACTS`) applied to ``v``: the decoder's
    two-call MLP and K2's plain version both use it."""
    mlp_act_code(act)
    if act == "silu":
        return F.silu(v)
    if act == "gelu":
        return F.gelu(v, approximate="tanh")
    return F.relu(v)


def _mid_plain(act: str, gu: torch.Tensor, half: int, gated: bool, dtype) -> torch.Tensor:
    """mid from the f32 gateup product: act(gate) * up (gated) or act(up)
    (ungated), in f32, cast to ``dtype``."""
    if gated:
        return (mlp_activation(act, gu[:, :half]) * gu[:, half:]).to(dtype)
    return mlp_activation(act, gu).to(dtype)


def ternary_mlp_plain(
    x: torch.Tensor,  # (B, m) post-norm hidden, feature order
    gu_perm: Optional[torch.Tensor],  # (Kg,) gateup's visit perm, or None
    gu_packed: torch.Tensor,  # (Kg//4, 2*half): [gate | up], or (Kg//4, half): up (ungated)
    gu_alpha: torch.Tensor,
    gu_mu: torch.Tensor,
    dn_packed: torch.Tensor,  # (Kd//4, n), Kd >= half (pad blocks zero-scaled)
    dn_alpha: torch.Tensor,
    dn_mu: torch.Tensor,
    intermediate: int,
    block_size: int = 128,
    act: str = "silu",
) -> torch.Tensor:
    """The whole MLP, (B, m) -> (B, n) f32, as ``ternary_mlp_pallas``
    computes it: the gather (or a zero pad to Kg), gate and up at the stored
    half width, mid = act(gate) * up in f32 cast to x's dtype (the kernel's
    operand type), then down over its first half // block_size blocks; for
    an ungated gateup (up alone, :func:`_mlp_shapes`) mid = act(up).
    ``act`` is one of :data:`MLP_ACTS`."""
    mlp_act_code(act)
    Kg, half, nv, _, gated = _mlp_shapes(gu_packed, gu_alpha, dn_packed, dn_alpha,
                                         intermediate, block_size)
    xg = _mlp_input(x, gu_perm, Kg)
    bs = block_size
    if gated:
        gate = ternary_matmul_plain(xg, gu_packed[:, :half], gu_alpha[:, :half], gu_mu[:, :half],
                                    bs)
        up = ternary_matmul_plain(xg, gu_packed[:, half:], gu_alpha[:, half:], gu_mu[:, half:],
                                  bs)
        mid = (mlp_activation(act, gate) * up).to(x.dtype)
    else:
        mid = mlp_activation(act, ternary_matmul_plain(xg, gu_packed, gu_alpha, gu_mu, bs)).to(
            x.dtype)
    return ternary_matmul_plain(mid, dn_packed[: half // 4], dn_alpha[:nv], dn_mu[:nv], bs)


def _mlp_input(x: torch.Tensor, gu_perm: Optional[torch.Tensor], Kg: int) -> torch.Tensor:
    """K2's gateup input: x gathered through ``gu_perm``, or zero-padded to
    the Kg lanes of the layout without a gather."""
    if gu_perm is not None:
        return onehot_gather_plain(x, gu_perm)
    if x.shape[-1] > Kg:
        raise ValueError(f"x width {x.shape[-1]} exceeds lane count {Kg}")
    return F.pad(x, (0, Kg - x.shape[-1]))


def ternary_mlp_floor_plain(
    x: torch.Tensor,  # (B, m) post-norm hidden, feature order
    gu_perm: Optional[torch.Tensor],
    gu_packed: torch.Tensor,
    gu_alpha: torch.Tensor,
    gu_mu: torch.Tensor,
    dn_packed: torch.Tensor,
    dn_alpha: torch.Tensor,
    dn_mu: torch.Tensor,
    intermediate: int,
    block_size: int = 128,
    act: str = "silu",
) -> torch.Tensor:
    """K2's floor probe (``ternary_mlp_pallas`` / ``_stacked`` with
    ``a8="floor"``, reached by ``fused_mlp_apply(..., impl="floor8")``), (B,
    m) -> (B, n) f32: the layout of :func:`ternary_mlp_plain`, with
    ``_accumulate_step``'s floor branch for gate, up and down alike. The
    gathered (or zero-padded) x is rounded half to even and clipped to +-127,
    with no row normalisation (the TPU kernel's MLP wrapper has none); gate
    and up are :func:`_floor_plain`'s products of it (the raw packed bytes
    replicated to the block's depth, times alpha, plus the block sums times
    mu - alpha); mid = act(gate) * up (ungated: act(up)) in f32 is rounded
    and clipped the same way, and down takes the same product of it. Wrong
    by design: the 2-bit unpack is skipped."""
    mlp_act_code(act)
    Kg, half, nv, _, gated = _mlp_shapes(gu_packed, gu_alpha, dn_packed, dn_alpha,
                                         intermediate, block_size)
    xq = _rounded(_mlp_input(x, gu_perm, Kg))
    bs = block_size
    if gated:
        gate = _floor_plain(xq, gu_packed[:, :half], gu_alpha[:, :half], gu_mu[:, :half], bs)
        up = _floor_plain(xq, gu_packed[:, half:], gu_alpha[:, half:], gu_mu[:, half:], bs)
        mid = mlp_activation(act, gate) * up
    else:
        mid = mlp_activation(act, _floor_plain(xq, gu_packed, gu_alpha, gu_mu, bs))
    return _floor_plain(_rounded(mid), dn_packed[: half // 4], dn_alpha[:nv], dn_mu[:nv], bs)


K1_TC_MIN_ROWS = 9
"""The fewest rows K1 runs on its prefill tensor-core kernels, bf16 and
W2A8 alike, and K3 on its tensor-core path (up to :data:`FUSED_MAX_ROWS`
rows). Decode rows (<= :data:`K1_DEC_MAX_ROWS`: the engine's 8 slots,
lockstep batches) run the decode kernel, whose tiles are made for them, in
bf16 (and in W2A8 with :data:`K1_DEC_A8`). Rebound above 64,
it sends K3's rows 9-64 to the CUDA-core K3 (``chip_smoke.py``'s "off"
turns). Read at each call."""

FUSED_MAX_ROWS = 64
"""The most rows for which the SSR gather runs fused into the matmul (K3,
or K6 under the JAX flags: ``ops.ternary_matmul.linear_route``), and the
most K3's tensor-core path takes; more rows gather first (K4 or K5), then
run K1."""

K1_DEC_MAX_ROWS = 8
"""The most rows K1 and K3 run on the decode kernel
(``csrc/ternary_matmul_dec.cu``); at most 8, the kernel's N tile. 0 sends
decode rows back to the CUDA-core kernels (``chip_smoke.py``'s "off"
turns). Read at each call."""

K1_DEC_A8 = False
"""Whether W2A8 decode rows take the decode kernel too (its W2A8 mode),
K1's and K3's alike. Off, they stay on the CUDA-core kernels: with K1's on
the decode kernel, ``chip_smoke.py``'s 32-layer W2A8 answers under the P2
routing flags trail their teacher-forced reference by more than the
answer gate it holds them to (TOKEN_TOL, 2e-2 of max|logit|), although
every call agrees with its plain version to ~1e-7. ``scripts/torch_a8_pick_gaps.py`` measures that
gap over prompt sets: on an H100 both kernels crossed 2e-2 on some of
them. ``chip_smoke.py``'s decode A/Bs set it for their "on" turns. Read at
each call."""

DEC_CTAS_PER_SM = 4  # the decode kernel's resident CTAs per SM (it keeps to 128 registers)
DEC_WARPS = 4  # its warps per CTA, each taking whole scale blocks
DEC_SLICE_LANES = 2048  # the most x lanes one of its CTAs stages in shared memory


def k1_path(rows: int, n: int, block_size: int, a8: bool) -> str:
    """Which of K1's kernels :func:`ternary_matmul` launches on CUDA (K3's
    :func:`ternary_matmul_igathered` takes the decode kernel where this says
    "dec", its CUDA-core kernel elsewhere). With
    scale blocks and out_features that are multiples of 128: "dec"
    (``pt2_ternary_matmul_dec``, a split-K mma.sync GEMV) for rows <=
    K1_DEC_MAX_ROWS in bf16, and in W2A8 with K1_DEC_A8; for rows >=
    K1_TC_MIN_ROWS "tc"
    (``pt2_ternary_matmul_tc``, bf16 mma.sync) in bf16, "tc_a8"
    (``pt2_ternary_matmul_tc_a8``, s8 mma.sync) in W2A8. Else "cuda_core"
    (``pt2_ternary_matmul``)."""
    if block_size % 128 == 0 and n % 128 == 0:
        if rows <= K1_DEC_MAX_ROWS and (K1_DEC_A8 or not a8):
            return "dec"
        if rows >= K1_TC_MIN_ROWS:
            return "tc_a8" if a8 else "tc"
    return "cuda_core"


def k3_path(rows: int, n: int, block_size: int, a8: bool) -> str:
    """Which of K3's kernels :func:`ternary_matmul_igathered` launches on
    CUDA: "dec" (``pt2_ternary_matmul_dec_igathered``, K1's decode kernel
    with x staged through perm) where :func:`k1_path` says "dec"; "tc"
    (``pt2_ternary_matmul_igathered_tc``, a one-pass gather then a split-K
    tensor-core product) for K1_TC_MIN_ROWS <= rows <= FUSED_MAX_ROWS with
    scale blocks and out_features that are multiples of 128, bf16 and W2A8;
    else "cuda_core" (``pt2_ternary_matmul_igathered``: more rows on a
    direct call, other shapes, W2A8 decode rows while K1_DEC_A8 is off)."""
    if k1_path(rows, n, block_size, a8) == "dec":
        return "dec"
    if (K1_TC_MIN_ROWS <= rows <= FUSED_MAX_ROWS and block_size % 128 == 0
            and n % 128 == 0):
        return "tc"
    return "cuda_core"


K6_DEC_MAX_ROWS = 8
"""The most rows K6 runs on its decode path (``csrc/ternary_matmul_gathered_dec.cu``:
the plane gather, then K1's decode kernel), where :func:`k1_path` says
"dec"; at most 8, that kernel's N tile. 0 sends decode rows back to the
CUDA-core K6 (``chip_smoke.py``'s "off" turns). Read at each call."""

K6_TC_MIN_ROWS = 9
"""The fewest rows K6 runs on its tensor-core path
(``csrc/ternary_matmul_gathered_tc.cu``: the plane gather, then K3's split-K
product), up to :data:`FUSED_MAX_ROWS` and not below :data:`K1_TC_MIN_ROWS`.
Rebound to ``1 << 30``, it sends rows 9-64 back to the CUDA-core K6
(``chip_smoke.py``'s "off" turns). Read at each call."""


def k6_path(rows: int, n: int, block_size: int, a8: bool) -> str:
    """Which of K6's kernels :func:`ternary_matmul_gathered` launches on
    CUDA, as :func:`k3_path` chooses K3's: "dec"
    (``pt2_ternary_matmul_gathered_dec``, the plane gather into lane order,
    then K1's decode kernel) where :func:`k1_path` says "dec" and rows <=
    K6_DEC_MAX_ROWS; "tc" (``pt2_ternary_matmul_gathered_tc``, the plane
    gather into fragment order, then K3's split-K tensor-core product) for
    max(K1_TC_MIN_ROWS, K6_TC_MIN_ROWS) <= rows <= FUSED_MAX_ROWS with scale
    blocks and out_features that are multiples of 128, bf16 and W2A8; else
    "cuda_core" (``pt2_ternary_matmul_gathered``: W2A8 decode rows while
    K1_DEC_A8 is off, other shapes, the A/Bs' "off" turns)."""
    if rows <= K6_DEC_MAX_ROWS and k1_path(rows, n, block_size, a8) == "dec":
        return "dec"
    if (max(K1_TC_MIN_ROWS, K6_TC_MIN_ROWS) <= rows <= FUSED_MAX_ROWS
            and block_size % 128 == 0 and n % 128 == 0):
        return "tc"
    return "cuda_core"


K2_TC_MIN_ROWS = 9
"""The fewest rows K2 runs on its tensor-core path (``csrc/ternary_mlp_tc.cu``,
up to :data:`FUSED_MAX_ROWS` rows); fewer run its decode path
(:data:`K2_DEC_MAX_ROWS`). Rebound to ``1 << 30``, it sends rows 9-64 to the
CUDA-core K2 (``chip_smoke.py``'s "off" turns). Read at each call."""

K2_DEC_MAX_ROWS = 8
"""The most rows K2 runs on its decode path (``csrc/ternary_mlp_dec.cu``: K1's
decode GEMV over gateup, the gated epilogue, K1's decode kernel over mid); at
most 8, the GEMV's N tile. 0 sends decode rows back to the CUDA-core K2
(``csrc/ternary_mlp.cu``; ``chip_smoke.py``'s "off" turns). Read at each
call."""


def k2_path(rows: int) -> str:
    """Which of K2's kernels :func:`ternary_mlp` launches on CUDA for
    ``rows`` rows: "dec" (``pt2_ternary_mlp_dec``: the gate/up decode GEMV
    with the gated epilogue, then K1's decode kernel over mid) for 1 <= rows
    <= K2_DEC_MAX_ROWS; "tc" (``pt2_ternary_mlp_tc``: the gather, the gate/up
    product with the gated epilogue, the down product, all on the tensor
    cores) for K2_TC_MIN_ROWS <= rows <= FUSED_MAX_ROWS; else "cc"
    (``pt2_ternary_mlp``, the CUDA cores). Every shape that K2 takes (bf16,
    scale blocks of 128, half and n multiples of 128) suits all three."""
    if 1 <= rows <= K2_DEC_MAX_ROWS:
        return "dec"
    return "tc" if K2_TC_MIN_ROWS <= rows <= FUSED_MAX_ROWS else "cc"


def dec_wave(device) -> int:
    """The decode kernel's CTAs in one wave on a CUDA ``device``:
    DEC_CTAS_PER_SM on each of its SMs (528 on an H100 SXM's 132)."""
    return DEC_CTAS_PER_SM * torch.cuda.get_device_properties(device).multi_processor_count


def dec_splits(K: int, n: int, block_size: int, wave: int) -> int:
    """The decode kernel's K slices for a (K, n) projection: as many as keep
    its CTAs (n / 128 per slice) within one ``wave`` (:func:`dec_wave`), but
    none that would leave fewer than DEC_WARPS blocks (one per warp) to a
    slice, and enough to keep a slice within DEC_SLICE_LANES lanes. The
    kernel cuts K into slices of ceil(nb / splits) blocks; the last may be
    shorter, none is empty."""
    nb = K // block_size
    most = max(1, wave // (n // 128))
    bpc = max(-(-nb // most), DEC_WARPS)
    bpc = min(bpc, DEC_SLICE_LANES // block_size, nb)
    return -(-nb // bpc)


IGTC_CTAS_PER_SM = 2  # K3's tensor-core product: resident CTAs per SM (128 registers, 8 warps)


def igtc_wave(device) -> int:
    """K3's tensor-core product's CTAs in one wave on a CUDA ``device``:
    IGTC_CTAS_PER_SM on each of its SMs (264 on an H100 SXM's 132)."""
    return IGTC_CTAS_PER_SM * torch.cuda.get_device_properties(device).multi_processor_count


def igtc_splits(K: int, n: int, block_size: int, wave: int) -> int:
    """K3's tensor-core product's K slices for a (K, n) projection: as many
    as keep its CTAs (n / 128 per slice) within one ``wave``
    (:func:`igtc_wave`). The kernel streams each slice through a ring, so
    no slice is too long for shared memory. It cuts K into slices of
    ceil(nb / splits) blocks; the last may be shorter, none is empty."""
    nb = K // block_size
    most = max(1, wave // (n // 128))
    bpc = -(-nb // most)
    return -(-nb // bpc)


def igtc_rows_pad(rows: int) -> int:
    """The rows of K3's tensor-core path's gather scratch for ``rows`` (9 to
    64) rows: its product's n8 row tiles, 2, 4 or 8 of them; pad rows are
    zero."""
    return 16 if rows <= 16 else 32 if rows <= 32 else 64


def _bf16(bits: int) -> float:
    """The value of a bf16 bit pattern."""
    return struct.unpack("<f", struct.pack("<I", bits << 16))[0]


# codes_bf16x2's (SCALE, BIAS) for a code at bits 2q..2q+1 of 128's mantissa
_DEC_CODE_FMA = [(_bf16(sc), _bf16(bi)) for sc, bi in
                 ((0x3F80, 0xC301), (0x3E80, 0xC204), (0x3D80, 0xC110))]


def ternary_matmul_dec_plain(
    x: torch.Tensor,
    packed: torch.Tensor,
    alpha: torch.Tensor,
    mu: torch.Tensor,
    block_size: int = 128,
    a8: bool = False,
    *,
    wave: int,
) -> torch.Tensor:
    """The algorithm of K1's decode kernel (``csrc/ternary_matmul_dec.cu``)
    in f32, index for index. Per scale block, load set s (packed rows 8s ..
    8s + 7) and plane pair pp, and for each of the 16 mma's j of a 128-column
    tile: the A fragment of lane (g, t) holds rows g and g + 8 (columns
    16g + j and 16g + j + 8), k 2t + i plane 2pp of packed row r + i and k
    2t + 8 + i plane 2pp + 1, r = 8s + 2t, each code made by the kernel's
    bf16 fma; the B fragment holds k 2t, 2t + 1 (k 2t + 8, 2t + 9) of x row
    g from the staged x, whose lane (g, t) word P holds lanes
    blk*bs + P*bs/4 + r, r + 1 (rows >= B zero; W2A8: the normalised rows
    rounded to int8). A fresh d per block, S from the same B with A = 1;
    each warp sums alpha * d + mu * S (alpha and mu read from the staged
    16-byte chunks) over its blocks w, w + DEC_WARPS, ...; the warps and
    then the :func:`dec_splits` slices of ``wave`` are summed in order, and
    value 4j + e of lane (g, t) is written to row 2t + (e & 1), column
    16g + j + 8 * (e >> 1). W2A8 multiplies by sx last, as the wrapper does.
    Returns (B, n) f32."""
    if a8:
        xn, sx = normalize_rows_a8(x)
        return _dec_plain(torch.clamp(torch.round(xn.float()), -127, 127), packed, alpha, mu,
                          block_size, wave) * sx
    return _dec_plain(x.float(), packed, alpha, mu, block_size, wave)


def ternary_matmul_igathered_dec_plain(
    x: torch.Tensor,  # (B, m) activations in feature order
    perm: torch.Tensor,  # (K,) visit lane -> feature; pad lanes -> m
    packed: torch.Tensor,
    alpha: torch.Tensor,
    mu: torch.Tensor,
    block_size: int = 128,
    a8: bool = False,
    *,
    wave: int,
) -> torch.Tensor:
    """The algorithm of K3's decode rows (``pt2_ternary_matmul_dec_igathered``,
    the decode kernel with x staged through perm) in f32, index for index:
    :func:`ternary_matmul_dec_plain`'s on the staged values x[b, perm[k]],
    0 for a pad lane (perm[k] >= m). W2A8 normalises the rows first (absmax
    does not depend on the order of the columns), gathers the normalised
    bf16 values, rounds them to int8 and multiplies by sx last, as the
    wrapper does. Returns (B, n) f32."""
    if a8:
        xn, sx = normalize_rows_a8(x)
        xk = torch.clamp(torch.round(onehot_gather_plain(xn, perm).float()), -127, 127)
        return _dec_plain(xk, packed, alpha, mu, block_size, wave) * sx
    return _dec_plain(onehot_gather_plain(x, perm).float(), packed, alpha, mu, block_size, wave)


def _dec_plain(xk, packed, alpha, mu, block_size, wave):
    """The decode kernel's algorithm on the values it stages, xk (B, K) f32
    (W2A8: already rounded); see :func:`ternary_matmul_dec_plain`."""
    B, K = xk.shape
    n = packed.shape[1]
    bs = block_size
    nb, bs4, ls, tiles = K // bs, bs // 4, bs // 32, n // 128
    dev = xk.device
    # the kernel's codes: plane P of each byte into 128's mantissa, then fma
    by = packed.to(torch.int32) & 0xFF
    codes = []
    for P in range(4):
        q = min(P, 2)
        u = ((by >> 2 if P == 3 else by) >> (2 * q)) & 3
        scale, bias = _DEC_CODE_FMA[q]
        codes.append((128 + u * 4**q).float() * scale + bias)
    codes = torch.stack(codes)  # (4, K/4, n)
    ar = lambda m: torch.arange(m, device=dev)  # noqa: E731
    blk, s_, pp, tile, j, h, g, hk, t, i = (
        ar(m).view([m if a == b else 1 for b in range(10)])
        for a, m in enumerate((nb, ls, 2, tiles, 8, 2, 8, 2, 4, 2)))
    # A[blk, s, pp, tile, j, m = g + 8h, k = 2t + i + 8hk]
    A = codes[2 * pp + hk, blk * bs4 + 8 * s_ + 2 * t + i, tile * 128 + 16 * g + j + 8 * h]
    A = A.reshape(nb, ls, 2, tiles, 8, 16, 16)
    # staged x: xs[blk, s, g, t, P, i] = x[g, blk*bs + P*bs/4 + 8s + 2t + i]
    x8 = torch.zeros((8, K), dtype=torch.float32, device=dev)
    x8[:B] = xk
    v = lambda m, a: ar(m).view([m if b == a else 1 for b in range(6)])  # noqa: E731
    xs = x8[v(8, 2), v(nb, 0) * bs + v(4, 4) * bs4 + 8 * v(ls, 1) + 2 * v(4, 3) + v(2, 5)]
    # B[blk, s, pp, k = 2t + i + 8hk, n = g]: b0 word 2pp, b1 word 2pp + 1
    Bf = xs.reshape(nb, ls, 8, 4, 2, 2, 2).permute(0, 1, 4, 5, 3, 6, 2).reshape(nb, ls, 2, 16, 8)
    d = torch.einsum("bspcjmk,bspkn->bcjmn", A, Bf)  # (nb, tiles, j, m, row)
    S = Bf.sum(dim=(1, 2, 3))  # (nb, row): the ones mma
    # fragments: value (j, e) of lane (g, t) is d[.., j, g + 8(e >> 1), 2t + (e & 1)]
    e_hi, e_lo = ar(2).view(2, 1), ar(2).view(1, 2)
    gg, tt = ar(8).view(8, 1, 1, 1, 1), ar(4).view(1, 4, 1, 1, 1)
    jj = ar(8).view(1, 1, 8, 1, 1)
    frag = d[:, :, jj, gg + 8 * e_hi, 2 * tt + e_lo]  # (nb, tiles, g, t, j, 2, 2)
    srow = S[:, 2 * tt + e_lo][:, None]  # (nb, 1, 1, t, 1, 1, 2)
    # alpha and mu as staged: chunk k of a block, 8 columns from 8(k & 15)
    am = torch.cat([alpha.float(), mu.float()], dim=1).reshape(nb, 2, tiles, 16, 8)
    am = am.permute(0, 2, 1, 3, 4).reshape(nb, tiles, 32, 8)
    a_w = am[:, :, (2 * gg + e_hi)[..., 0], jj[..., 0]]  # (nb, tiles, g, 1, j, 2)
    m_w = am[:, :, (16 + 2 * gg + e_hi)[..., 0], jj[..., 0]]
    a_w, m_w = a_w[..., None], m_w[..., None]
    splits = dec_splits(K, n, bs, wave)
    bpc = -(-nb // splits)
    total = None
    for sp in range(splits):
        blocks = range(sp * bpc, min(nb, (sp + 1) * bpc))
        part = None
        for w in range(DEC_WARPS):
            acc = torch.zeros(frag.shape[1:], dtype=torch.float32, device=dev)
            for b in blocks[w::DEC_WARPS]:
                acc = acc + a_w[b] * frag[b]
                acc = acc + m_w[b] * srow[b]
            part = acc if part is None else part + acc
        total = part if total is None else total + part
    # the write-back: value i = 4j + e to row 2t + (i & 1), column
    # 16g + (i >> 2) + 8 * ((i >> 1) & 1)
    out = torch.zeros((8, n), dtype=torch.float32, device=dev)
    vals = total.reshape(tiles, 8, 4, 32)  # (tile, g, t, i)
    ii = ar(32)
    rows = 2 * ar(4).view(4, 1) + (ii & 1)
    cols = (ar(tiles).view(tiles, 1, 1, 1) * 128 + 16 * ar(8).view(1, 8, 1, 1)
            + (ii >> 2) + 8 * ((ii >> 1) & 1))
    out[rows.expand(tiles, 8, 4, 32), cols.expand(tiles, 8, 4, 32)] = vals
    return out[:B]


def igathered_tc_gather_plain(
    xk: torch.Tensor,  # (B, m) bf16 rows in feature order (W2A8: normalised)
    perm: torch.Tensor,  # (K,) visit lane -> feature; pad lanes -> m
    block_size: int = 128,
    a8: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gather of K3's tensor-core path (its C entry
    ``pt2_ternary_matmul_igathered_tc_gather``): (xg, S). xg (Bp, K) bf16,
    Bp = :func:`igtc_rows_pad` (B), rows >= B zero, holds x[:, perm] (0 for
    a pad lane; W2A8: rounded half to even and clipped to +-127, exact in
    bf16) in fragment order: within a scale block, position 8h + 2p + i
    holds lane p*bs/4 + 2h + i. S (nb, Bp) f32 holds each block's sum of
    the gathered values (the kernel adds them in another order: f32
    rounding only; exact in W2A8)."""
    xl = onehot_gather_plain(xk.to(torch.bfloat16), perm)
    if a8:
        xl = torch.clamp(torch.round(xl.float()), -127, 127).to(torch.bfloat16)
    return _igtc_scratch_plain(xl, block_size)


def _fragment_order(xl: torch.Tensor, block_size: int) -> torch.Tensor:
    """(R, K) in lane order -> the tensor-core paths' fragment order: within
    a scale block, position 8h + 2p + i holds lane p*bs/4 + 2h + i."""
    R, K = xl.shape
    bs = block_size
    return xl.reshape(R, K // bs, 4, bs // 8, 2).permute(0, 1, 3, 2, 4).reshape(R, K)


def _lane_order(xg: torch.Tensor, block_size: int) -> torch.Tensor:
    """The inverse of :func:`_fragment_order`."""
    R, K = xg.shape
    bs = block_size
    return xg.reshape(R, K // bs, bs // 8, 4, 2).permute(0, 1, 3, 2, 4).reshape(R, K)


def _igtc_scratch_plain(xl: torch.Tensor, block_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gather's scratch for (B, K) values xl in lane order: (xg, S), xg
    (Bp, K) in xl's dtype and fragment order with zero pad rows, S (nb, Bp)
    f32 each block's sum of xl."""
    B, K = xl.shape
    nb, Bp = K // block_size, igtc_rows_pad(B)
    xg = torch.zeros((Bp, K), dtype=xl.dtype, device=xl.device)
    xg[:B] = _fragment_order(xl, block_size)
    S = torch.zeros((nb, Bp), dtype=torch.float32, device=xl.device)
    S[:, :B] = xl.float().reshape(B, nb, block_size).sum(dim=2).T
    return xg, S


def _igtc_product_plain(xg, S, packed, alpha, mu, block_size, wave):
    """K3's tensor-core product in f32 on its scratch (xg (Bp, K) in
    fragment order, S (nb, Bp)): per scale block the f32 products d =
    xg_blk @ T_blk; per :func:`igtc_splits` slice of ``wave``, acc += alpha
    * d then acc += mu * S block by block in order; the slices summed in
    slice order. Returns (Bp, n) f32."""
    Bp, K = xg.shape
    n, bs = packed.shape[1], block_size
    nb = K // bs
    xl = _lane_order(xg, bs).float().reshape(Bp, nb, bs)
    T = unpack_ternary(packed, bs).float().reshape(nb, bs, n)
    d = torch.einsum("bkc,kcn->kbn", xl, T)  # (nb, Bp, n): each block's products
    splits = igtc_splits(K, n, bs, wave)
    bpc = -(-nb // splits)
    total = None
    for sp in range(splits):
        acc = torch.zeros((Bp, n), dtype=torch.float32, device=xg.device)
        for blk in range(sp * bpc, min(nb, (sp + 1) * bpc)):
            acc = acc + alpha[blk].float() * d[blk]
            acc = acc + mu[blk].float() * S[blk][:, None]
        total = acc if total is None else total + acc
    return total


def ternary_matmul_igathered_tc_plain(
    x: torch.Tensor,  # (B, m) activations in feature order
    perm: torch.Tensor,  # (K,) visit lane -> feature; pad lanes -> m
    packed: torch.Tensor,
    alpha: torch.Tensor,
    mu: torch.Tensor,
    block_size: int = 128,
    a8: bool = False,
    *,
    wave: int,
) -> torch.Tensor:
    """The algorithm of K3's tensor-core path (its C entry
    ``pt2_ternary_matmul_igathered_tc``) in f32: the gather of
    :func:`igathered_tc_gather_plain` on bf16 x
    (W2A8: the normalised rows, rounded there), read back from its fragment
    order; per scale block the f32 products d = xg_blk @ T_blk; per
    :func:`igtc_splits` slice of ``wave``, acc += alpha * d then acc += mu *
    S block by block in order; the slices summed in slice order. W2A8
    multiplies by sx last, as the wrapper does. Returns (B, n) f32."""
    B = x.shape[0]
    if a8:
        xk, sx = normalize_rows_a8(x)
    else:
        xk = x.to(torch.bfloat16)
    xg, S = igathered_tc_gather_plain(xk, perm, block_size, a8)
    total = _igtc_product_plain(xg, S, packed, alpha, mu, block_size, wave)
    return total[:B] * sx if a8 else total[:B]


def planes_gather_plain(
    xk: torch.Tensor,  # (B, m) rows in feature order (W2A8: normalised), bf16 values
    gpacked: torch.Tensor,  # (D//4, K) packed one-hot planes, D >= m
    block_size: int = 128,
    a8: bool = False,
    order: str = "lanes",
):
    """The plane gather of K6's decode and tensor-core paths
    (``csrc/planes_gather.cuh``, C entry ``pt2_planes_gather``), bit for bit.
    Lane k's value is the f32 sum over its nonzero fields (i, u) with i < m
    of u * x[b, i], the fields in increasing i, the first product the sum's
    start (a lane with one field of 1 gives x[b, i] exactly, -0 included;
    a lane with none gives 0); then rounded to bf16 (W2A8: first rounded
    half to even and clipped to +-127). ``order`` "lanes" returns xg (B, K)
    bf16 in lane order, the x of K1's decode kernel; "fragments" returns
    (xg, S) as :func:`igathered_tc_gather_plain` documents them (xg (Bp, K)
    in K3's fragment order, pad rows zero; S (nb, Bp) f32), S summed as the
    kernel sums it: per block, each quarter of 32 lanes by a warp's
    butterfly, then the quarters in order."""
    if block_size != 128:
        raise ValueError(f"the plane gather takes scale blocks of 128, got {block_size}")
    if order not in ("lanes", "fragments"):
        raise ValueError(f"order must be 'lanes' or 'fragments', got {order!r}")
    B, m = xk.shape
    u = onehot_planes(gpacked)[:m]  # (m, K): fields of features >= m are not read
    K = u.shape[1]
    nz = u != 0
    feat = torch.arange(m, dtype=torch.int32, device=u.device)[:, None]
    idx = torch.where(nz, feat, m).sort(dim=0).values  # each lane's features, ascending
    idx = idx[: int(nz.sum(dim=0).max()) if m else 0].long()  # (F, K), m past a lane's last
    uval = torch.gather(F.pad(u, (0, 0, 0, 1)), 0, idx).float()
    xp = F.pad(xk.float(), (0, 1))  # x[:, m] = 0
    t = torch.zeros((B, K), dtype=torch.float32, device=xk.device)
    for f in range(idx.shape[0]):
        v = uval[f] * xp[:, idx[f]]
        t = v if f == 0 else torch.where(idx[f] < m, t + v, t)
    if a8:
        t = torch.clamp(torch.round(t), -127, 127)
    xl = t.to(torch.bfloat16)
    if order == "lanes":
        return xl
    nb, Bp = K // 128, igtc_rows_pad(B)
    xg = torch.zeros((Bp, K), dtype=torch.bfloat16, device=xk.device)
    xg[:B] = _fragment_order(xl, 128)
    q = xl.float().reshape(B, nb, 4, 32)
    lane = torch.arange(32, device=xk.device)
    for o in (16, 8, 4, 2, 1):  # the warp's butterfly; lane 0 keeps the sum
        q = q + q[..., lane ^ o]
    q = q[..., 0]
    S = torch.zeros((nb, Bp), dtype=torch.float32, device=xk.device)
    S[:, :B] = (((q[..., 0] + q[..., 1]) + q[..., 2]) + q[..., 3]).T
    return xg, S


def _k6_rows(x, a8):
    """K6's operand rows: bf16 x, or W2A8's normalised rows and their scales
    (absmax does not depend on the order of the columns)."""
    if a8:
        return normalize_rows_a8(x)
    return x.to(torch.bfloat16), None


def ternary_matmul_gathered_dec_plain(
    x: torch.Tensor,  # (B, m) activations in feature order
    gpacked: torch.Tensor,  # (D//4, K) packed one-hot planes
    packed: torch.Tensor,
    alpha: torch.Tensor,
    mu: torch.Tensor,
    block_size: int = 128,
    a8: bool = False,
    *,
    wave: int,
) -> torch.Tensor:
    """The algorithm of K6's decode rows (its C entry
    ``pt2_ternary_matmul_gathered_dec``) in f32: :func:`planes_gather_plain`
    in lane order on bf16 x (W2A8: the normalised rows, rounded there), then
    :func:`ternary_matmul_dec_plain`'s schedule on it, index for index, in
    the :func:`dec_splits` slices of ``wave``. W2A8 multiplies by sx last,
    as the wrapper does. Returns (B, n) f32."""
    xk, sx = _k6_rows(x, a8)
    xl = planes_gather_plain(xk, gpacked, block_size, a8, "lanes")
    out = _dec_plain(xl.float(), packed, alpha, mu, block_size, wave)
    return out * sx if a8 else out


def ternary_matmul_gathered_tc_plain(
    x: torch.Tensor,  # (B, m) activations in feature order
    gpacked: torch.Tensor,  # (D//4, K) packed one-hot planes
    packed: torch.Tensor,
    alpha: torch.Tensor,
    mu: torch.Tensor,
    block_size: int = 128,
    a8: bool = False,
    *,
    wave: int,
) -> torch.Tensor:
    """The algorithm of K6's rows 9-64 (its C entry
    ``pt2_ternary_matmul_gathered_tc``) in f32: :func:`planes_gather_plain`
    in fragment order on bf16 x (W2A8: the normalised rows, rounded there),
    then K3's product (:func:`_igtc_product_plain`) on that scratch in the
    :func:`igtc_splits` slices of ``wave``. W2A8 multiplies by sx last, as
    the wrapper does. Returns (B, n) f32."""
    xk, sx = _k6_rows(x, a8)
    xg, S = planes_gather_plain(xk, gpacked, block_size, a8, "fragments")
    total = _igtc_product_plain(xg, S, packed, alpha, mu, block_size, wave)[: x.shape[0]]
    return total * sx if a8 else total


def mlp_tc_gather_plain(
    x: torch.Tensor,  # (B, m) feature order
    perm: Optional[torch.Tensor],  # (Kg,) gateup's visit perm, or None
    Kg: int,
    block_size: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first launch of K2's tensor-core path: (xg, S) as
    :func:`igathered_tc_gather_plain` writes them, in x's dtype (the kernel
    takes bf16): xg (Bp, Kg) holds x[:, perm] (0 for a pad lane) or, with
    no perm, x zero-padded to Kg lanes (the kernel gathers through the
    identity perm), in fragment order with zero pad rows; S (nb, Bp) f32
    each block's sum."""
    if perm is not None:
        xl = onehot_gather_plain(x, perm)
    else:
        if x.shape[-1] > Kg:
            raise ValueError(f"x width {x.shape[-1]} exceeds lane count {Kg}")
        xl = F.pad(x, (0, Kg - x.shape[-1]))
    return _igtc_scratch_plain(xl, block_size)


def mlp_tc_mid_plain(
    xg: torch.Tensor,  # (Bp, Kg) fragment order
    S: torch.Tensor,  # (Kg // bs, Bp) f32
    gu_packed: torch.Tensor,
    gu_alpha: torch.Tensor,
    gu_mu: torch.Tensor,
    act: str = "silu",
    block_size: int = 128,
    *,
    wave: int,
    gated: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The second launch of K2's tensor-core path, its gate/up product and
    gated epilogue: gate | up = K3's product (:func:`_igtc_product_plain`,
    slices of ``wave``) over all 2 * half columns; mid = act(gate) * up cast
    to xg's dtype, in down's fragment order; Smid (half // bs, Bp) f32 each
    down block's sum of mid as stored, its first 64 lanes then its last 64
    (a CTA's share each; ungated, the two halves of one CTA's), added in
    that order. ``gated`` False: the product over up's half columns and
    mid = act(up). Returns (mid, Smid)."""
    mlp_act_code(act)
    Bp = xg.shape[0]
    half = gu_packed.shape[1] // 2 if gated else gu_packed.shape[1]
    gu = _igtc_product_plain(xg, S, gu_packed, gu_alpha, gu_mu, block_size, wave)
    mid = _mid_plain(act, gu, half, gated, xg.dtype)
    halves = mid.float().reshape(Bp, half // 64, 64).sum(dim=2)
    Smid = (halves[:, 0::2] + halves[:, 1::2]).T.contiguous()
    return _fragment_order(mid, block_size), Smid


def ternary_mlp_tc_plain(
    x: torch.Tensor,
    gu_perm: Optional[torch.Tensor],
    gu_packed: torch.Tensor,
    gu_alpha: torch.Tensor,
    gu_mu: torch.Tensor,
    dn_packed: torch.Tensor,
    dn_alpha: torch.Tensor,
    dn_mu: torch.Tensor,
    intermediate: int,
    block_size: int = 128,
    act: str = "silu",
    *,
    wave: int,
) -> torch.Tensor:
    """The algorithm of K2's tensor-core path (its C entry
    ``pt2_ternary_mlp_tc``) in f32: :func:`mlp_tc_gather_plain`, then
    :func:`mlp_tc_mid_plain`, then K3's product over mid and Smid with K =
    half (down's first half // bs blocks), each product cut into the
    :func:`igtc_splits` slices of ``wave`` and summed in slice order; an
    ungated gateup (up alone) through the ungated epilogue. The scratches
    hold x's dtype: bf16 on the card (the wrapper casts x), f32 where a CPU
    test holds the algorithm against JAX's f32 interpret mode. Returns
    (B, n) f32."""
    mlp_act_code(act)
    Kg, half, nv, _, gated = _mlp_shapes(gu_packed, gu_alpha, dn_packed, dn_alpha,
                                         intermediate, block_size)
    if block_size != 128:
        raise ValueError(f"K2 takes scale blocks of 128, got {block_size}")
    xg, S = mlp_tc_gather_plain(x, gu_perm, Kg, block_size)
    mid, Smid = mlp_tc_mid_plain(xg, S, gu_packed, gu_alpha, gu_mu, act, block_size, wave=wave,
                                 gated=gated)
    out = _igtc_product_plain(mid, Smid, dn_packed[: half // 4], dn_alpha[:nv], dn_mu[:nv],
                              block_size, wave)
    return out[: x.shape[0]]


def ternary_mlp_dec_plain(
    x: torch.Tensor,
    gu_perm: Optional[torch.Tensor],
    gu_packed: torch.Tensor,
    gu_alpha: torch.Tensor,
    gu_mu: torch.Tensor,
    dn_packed: torch.Tensor,
    dn_alpha: torch.Tensor,
    dn_mu: torch.Tensor,
    intermediate: int,
    block_size: int = 128,
    act: str = "silu",
    *,
    wave: int,
) -> torch.Tensor:
    """The algorithm of K2's decode path (its C entry ``pt2_ternary_mlp_dec``)
    in f32, for 1 to 8 rows: gate | up are the decode GEMV's
    (:func:`ternary_matmul_igathered_dec_plain` through gu_perm, or
    :func:`ternary_matmul_dec_plain` on x zero-padded to Kg lanes) over the
    whole gateup in its :func:`dec_splits` slices of ``wave``, each column's
    slices summed in slice order (which CTA of a gate/up pair sums them does
    not change the sum); mid = act(gate) * up (ungated: act(up)) cast to x's
    dtype (bf16 on the card, f32 where a CPU test holds the algorithm
    against JAX's f32 interpret mode); then the decode GEMV over mid and
    down's first half // bs blocks. Returns (B, n) f32."""
    mlp_act_code(act)
    Kg, half, nv, _, gated = _mlp_shapes(gu_packed, gu_alpha, dn_packed, dn_alpha,
                                         intermediate, block_size)
    if block_size != 128:
        raise ValueError(f"K2 takes scale blocks of 128, got {block_size}")
    if gu_perm is not None:
        gu = ternary_matmul_igathered_dec_plain(x, gu_perm, gu_packed, gu_alpha, gu_mu,
                                                block_size, wave=wave)
    else:
        if x.shape[-1] > Kg:
            raise ValueError(f"x width {x.shape[-1]} exceeds lane count {Kg}")
        gu = ternary_matmul_dec_plain(F.pad(x, (0, Kg - x.shape[-1])), gu_packed, gu_alpha,
                                      gu_mu, block_size, wave=wave)
    mid = _mid_plain(act, gu, half, gated, x.dtype)
    return _dec_plain(mid.float(), dn_packed[: half // 4], dn_alpha[:nv], dn_mu[:nv], block_size,
                      wave)


_lib = None
_dec_lib = None
_igtc_lib = None
_tc_lib = None
_tc_a8_lib = None
_mlp_lib = None
_mlp_floor_lib = None
_mlp_tc_lib = None
_mlp_dec_lib = None
_gathered_lib = None
_gathered_dec_lib = None
_gathered_tc_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("ternary_matmul")
        fn = lib.pt2_ternary_matmul
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.pt2_ternary_matmul_igathered
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.pt2_ternary_matmul_idx
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.pt2_ternary_matmul_igathered_idx
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _dec_kernel_lib():
    global _dec_lib
    if _dec_lib is None:
        lib = _build.load("ternary_matmul_dec")
        fn = lib.pt2_ternary_matmul_dec
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.pt2_ternary_matmul_dec_igathered
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.pt2_ternary_matmul_dec_idx
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.pt2_ternary_matmul_dec_igathered_idx
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _dec_lib = lib
    return _dec_lib


def _igtc_kernel_lib():
    global _igtc_lib
    if _igtc_lib is None:
        lib = _build.load("ternary_matmul_igathered_tc")
        fn = lib.pt2_ternary_matmul_igathered_tc
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.pt2_ternary_matmul_igathered_tc_gather
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _igtc_lib = lib
    return _igtc_lib


def _tc_kernel_lib():
    global _tc_lib
    if _tc_lib is None:
        lib = _build.load("ternary_matmul_tc")
        fn = lib.pt2_ternary_matmul_tc
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _tc_lib = lib
    return _tc_lib


def _tc_a8_kernel_lib():
    global _tc_a8_lib
    if _tc_a8_lib is None:
        lib = _build.load("ternary_matmul_tc_a8")
        for fn in (lib.pt2_ternary_matmul_tc_a8, lib.pt2_ternary_matmul_tc_a8_floor):
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _tc_a8_lib = lib
    return _tc_a8_lib


def _mlp_kernel_lib():
    global _mlp_lib
    if _mlp_lib is None:
        lib = _build.load("ternary_mlp")
        fn = lib.pt2_ternary_mlp
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _mlp_lib = lib
    return _mlp_lib


def _mlp_floor_kernel_lib():
    global _mlp_floor_lib
    if _mlp_floor_lib is None:
        lib = _build.load("ternary_mlp_floor")
        fn = lib.pt2_ternary_mlp_floor
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _mlp_floor_lib = lib
    return _mlp_floor_lib


def _mlp_tc_kernel_lib():
    global _mlp_tc_lib
    if _mlp_tc_lib is None:
        lib = _build.load("ternary_mlp_tc")
        for fn in (lib.pt2_ternary_mlp_tc, lib.pt2_ternary_mlp_tc_ungated,
                   lib.pt2_ternary_mlp_tc_floor, lib.pt2_ternary_mlp_tc_floor_ungated):
            fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _mlp_tc_lib = lib
    return _mlp_tc_lib


def _mlp_dec_kernel_lib():
    global _mlp_dec_lib
    if _mlp_dec_lib is None:
        lib = _build.load("ternary_mlp_dec")
        for fn in (lib.pt2_ternary_mlp_dec, lib.pt2_ternary_mlp_dec_ungated,
                   lib.pt2_ternary_mlp_dec_floor, lib.pt2_ternary_mlp_dec_floor_ungated):
            fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _mlp_dec_lib = lib
    return _mlp_dec_lib


def _gathered_kernel_lib():
    global _gathered_lib
    if _gathered_lib is None:
        lib = _build.load("ternary_matmul_gathered")
        fn = lib.pt2_ternary_matmul_gathered
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.pt2_ternary_matmul_gathered_idx
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _gathered_lib = lib
    return _gathered_lib


def _bind_planes_gather(lib):
    fn = lib.pt2_planes_gather
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int


def _gathered_dec_kernel_lib():
    global _gathered_dec_lib
    if _gathered_dec_lib is None:
        lib = _build.load("ternary_matmul_gathered_dec")
        fn = lib.pt2_ternary_matmul_gathered_dec
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.pt2_ternary_matmul_gathered_dec_idx
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bind_planes_gather(lib)
        _gathered_dec_lib = lib
    return _gathered_dec_lib


def _gathered_tc_kernel_lib():
    global _gathered_tc_lib
    if _gathered_tc_lib is None:
        lib = _build.load("ternary_matmul_gathered_tc")
        fn = lib.pt2_ternary_matmul_gathered_tc
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bind_planes_gather(lib)
        _gathered_tc_lib = lib
    return _gathered_tc_lib


def _device_and_stream(x):
    idx = x.device.index if x.device.index is not None else torch.cuda.current_device()
    return idx, torch.cuda.current_stream(x.device).cuda_stream


def _check_perm(perm, x, K):
    if perm.dtype != torch.int32:
        raise TypeError(f"perm must be int32, got {perm.dtype}")
    if perm.device != x.device or not perm.is_contiguous():
        raise ValueError(f"perm must be contiguous on {x.device}")
    if tuple(perm.shape) != (K,):
        raise ValueError(f"perm {tuple(perm.shape)} does not match {K} lanes")


def _check(x, packed, alpha, mu, block_size, m=None):
    """Checks K1/K3's operands; x has m columns (K for K1)."""
    K4, n = packed.shape
    K = K4 * 4
    nb = alpha.shape[0]
    dev = x.device
    for name, t in (("packed", packed), ("alpha", alpha), ("mu", mu)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if packed.dtype != torch.int8:
        raise TypeError(f"packed must be int8, got {packed.dtype}")
    if alpha.dtype != torch.bfloat16 or mu.dtype != torch.bfloat16:
        raise TypeError(f"the kernel takes bf16 scales, got {alpha.dtype}/{mu.dtype}")
    if x.dim() != 2 or x.shape[1] != (K if m is None else m):
        raise ValueError(f"x {tuple(x.shape)} does not match packed {tuple(packed.shape)}")
    if tuple(alpha.shape) != (nb, n) or tuple(mu.shape) != (nb, n) or nb * block_size != K:
        raise ValueError(
            f"bad shapes: packed {tuple(packed.shape)}, alpha {tuple(alpha.shape)}, "
            f"mu {tuple(mu.shape)}, block_size {block_size}"
        )
    if block_size % 4 or not 16 <= block_size <= 2048:
        raise ValueError(f"the kernel takes block sizes 16..2048 divisible by 4, got {block_size}")
    if n % 32:
        raise ValueError(f"the kernel takes out_features divisible by 32, got {n}")
    if packed.data_ptr() % 4:
        raise ValueError("packed must be 4-byte aligned")


def ternary_matmul(
    x: torch.Tensor,
    packed: torch.Tensor,
    alpha: torch.Tensor,
    mu: torch.Tensor,
    block_size: int = 128,
    a8: bool = False,
) -> torch.Tensor:
    """out = x @ dequant(packed, alpha, mu): (B, K) x (K//4, n) -> (B, n) f32.

    CUDA: launches K1 on the current stream (x cast to bf16, or normalised
    for W2A8) on the path :func:`k1_path` names, and counts the launch in
    ``ternary_matmul.launches`` (the decode path also in
    ``ternary_matmul.launches_dec``, the bf16 tensor-core path in
    ``ternary_matmul.launches_tc``, the int8 one in
    ``ternary_matmul.launches_tc_a8``). ``a8`` "floor" (the floor probe,
    :func:`ternary_matmul_floor_plain`) takes W2A8's path in its FLOOR
    instance, counted also in ``ternary_matmul.launches_floor``. CPU: the
    plain version, with x as given (f32 compute, as JAX on the CPU).
    """
    mode = _a8_mode(a8)
    if x.device.type == "cpu":
        fn = (ternary_matmul_floor_plain if mode == 2
              else ternary_matmul_plain_a8 if a8 else ternary_matmul_plain)
        return fn(x, packed, alpha, mu, block_size)
    if x.device.type != "cuda":
        raise ValueError(f"no K1 for device {x.device}")
    _check(x, packed, alpha, mu, block_size)
    _check_floor(a8, block_size)
    B, K = x.shape
    n = packed.shape[1]
    if a8:
        xk, sx = normalize_rows_a8(x)
    else:
        xk = x.to(torch.bfloat16)
    xk = xk.contiguous()
    out = torch.empty((B, n), dtype=torch.float32, device=x.device)
    if B == 0:
        return out
    path = k1_path(B, n, block_size, a8)
    if path == "dec":
        out = _ternary_matmul_dec(xk, packed, alpha, mu, out, block_size, a8)
        return out * sx if a8 else out
    if path == "tc":
        return _ternary_matmul_tc(xk, packed, alpha, mu, out, block_size)
    if path == "tc_a8":
        return _ternary_matmul_tc_a8(xk, packed, alpha, mu, out, block_size, mode == 2) * sx
    rc = _kernel_lib().pt2_ternary_matmul(
        xk.data_ptr(), packed.data_ptr(), alpha.data_ptr(), mu.data_ptr(),
        out.data_ptr(), B, K, n, block_size, _a8_mode(a8), *_device_and_stream(x),
    )
    if rc != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {rc}")
    ternary_matmul.launches += 1
    ternary_matmul.launches_floor += mode == 2
    return out * sx if a8 else out


ternary_matmul.launches = 0
ternary_matmul.launches_dec = 0
ternary_matmul.launches_tc = 0
ternary_matmul.launches_tc_a8 = 0
ternary_matmul.launches_floor = 0


_dec_counters: dict = {}
_sm_counts: dict = {}


def _sm_count(device: int) -> int:
    """The SM count of CUDA device ``device``, asked once per process: the
    split-K paths size their waves by it."""
    if device not in _sm_counts:
        _sm_counts[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _sm_counts[device]


def _dec_counter_buffer(device, stream, tiles, path="K1's decode path"):
    """The split-K kernels' per-column-tile counters for launches on
    ``stream`` (K1's and K3's decode rows and K3's and K2's tensor-core and
    decode paths share them): int32 zeros, kept between calls (each launch leaves them 0),
    grown on demand. Each stream has its own, so the launches that share a
    buffer are ordered by their stream and never overlap. A CUDA graph
    capture is refused (naming ``path``): its replays could overlap with the
    launches of the stream it was captured on."""
    if torch.cuda.is_current_stream_capturing():
        raise NotImplementedError(f"{path} inside a CUDA graph capture")
    buf = _dec_counters.get((device, stream))
    if buf is None or buf.numel() < tiles:
        buf = torch.zeros(max(tiles, 1024), dtype=torch.int32, device=device)
        _dec_counters[(device, stream)] = buf
    return buf


def _dec_scratch(xk, K, n, block_size, out, kernel):
    """What a decode-kernel launch of (B, .) rows into ``out`` needs beside
    its operands: (device, stream, splits, partial, counters), with the
    dec_splits K slices of the card's wave, their (splits, B, n) f32
    partials (out itself when there is one slice) and the stream's
    counters."""
    device, stream = _device_and_stream(xk)
    splits = dec_splits(K, n, block_size, DEC_CTAS_PER_SM * _sm_count(device))
    partial = (torch.empty((splits, xk.shape[0], n), dtype=torch.float32, device=xk.device)
               if splits > 1 else out)
    counters = _dec_counter_buffer(xk.device, stream, n // 128, f"{kernel}'s decode path")
    return device, stream, splits, partial, counters


def _ternary_matmul_dec(xk, packed, alpha, mu, out, block_size, a8):
    """K1's decode path: the split-K tensor-core GEMV over dec_splits K
    slices, whose partials go to a (splits, B, n) f32 scratch allocated
    here and are summed in slice order by the last CTA of each column tile
    (straight into out when there is one slice). xk is bf16 x, or W2A8's
    normalised rows (rounded in the kernel). Returns out before the row
    scales."""
    B, K = xk.shape
    n = packed.shape[1]
    xk = _tc_operands(xk, packed, alpha, mu)
    device, stream, splits, partial, counters = _dec_scratch(xk, K, n, block_size, out, "K1")
    rc = _dec_kernel_lib().pt2_ternary_matmul_dec(
        xk.data_ptr(), packed.data_ptr(), alpha.data_ptr(), mu.data_ptr(), partial.data_ptr(),
        out.data_ptr(), counters.data_ptr(), B, K, n, block_size, splits, _a8_mode(a8), device,
        stream,
    )
    if rc != 0:
        raise RuntimeError(f"K1 (decode, tensor cores) launch failed: cudaError {rc}")
    ternary_matmul.launches += 1
    ternary_matmul.launches_dec += 1
    ternary_matmul.launches_floor += _a8_mode(a8) == 2
    return out


def _ternary_matmul_igathered_dec(xk, perm, packed, alpha, mu, out, block_size, a8):
    """K3's decode path: K1's decode kernel with x staged through perm
    (``pt2_ternary_matmul_dec_igathered``), its K slices, scratch and
    counters as :func:`_ternary_matmul_dec`'s. xk is bf16 x (B, m) in
    feature order, or W2A8's normalised rows; perm is read as 16-byte
    vectors (a copy if it is not aligned so). Returns out before the row
    scales."""
    B, m = xk.shape
    K, n = packed.shape[0] * 4, packed.shape[1]
    if packed.data_ptr() % 16 or alpha.data_ptr() % 16 or mu.data_ptr() % 16:
        raise ValueError("K3's decode path needs 16-byte aligned packed, alpha and mu")
    if perm.data_ptr() % 16:
        perm = perm.clone()
    device, stream, splits, partial, counters = _dec_scratch(xk, K, n, block_size, out, "K3")
    rc = _dec_kernel_lib().pt2_ternary_matmul_dec_igathered(
        xk.data_ptr(), perm.data_ptr(), packed.data_ptr(), alpha.data_ptr(), mu.data_ptr(),
        partial.data_ptr(), out.data_ptr(), counters.data_ptr(), B, m, K, n, block_size, splits,
        _a8_mode(a8), device, stream,
    )
    if rc != 0:
        raise RuntimeError(f"K3 (decode, tensor cores) launch failed: cudaError {rc}")
    ternary_matmul_igathered.launches += 1
    ternary_matmul_igathered.launches_dec += 1
    ternary_matmul_igathered.launches_floor += _a8_mode(a8) == 2
    return out


def _ternary_matmul_igathered_tc(xk, perm, packed, alpha, mu, out, block_size, a8):
    """K3's tensor-core path (``pt2_ternary_matmul_igathered_tc``): the
    one-pass gather into a (Bp, K) bf16 scratch and its (nb, Bp) block sums,
    then the split-K product over igtc_splits K slices, whose partials go to
    a (splits, B, n) f32 scratch (out itself when there is one slice) summed
    in slice order by the last CTA of each column tile; all scratch is
    allocated here, the counters are the stream's (shared with the decode
    paths). xk is bf16 x (B, m) in feature order, or W2A8's normalised rows
    (rounded by the gather); perm is read as 8-byte vectors (a copy if it is
    not 16-byte aligned). Returns out before the row scales."""
    B, m = xk.shape
    K, n = packed.shape[0] * 4, packed.shape[1]
    if packed.data_ptr() % 16 or alpha.data_ptr() % 16 or mu.data_ptr() % 16:
        raise ValueError("K3's tensor-core path needs 16-byte aligned packed, alpha and mu")
    if perm.data_ptr() % 16:
        perm = perm.clone()
    device, stream = _device_and_stream(xk)
    splits = igtc_splits(K, n, block_size, IGTC_CTAS_PER_SM * _sm_count(device))
    Bp = igtc_rows_pad(B)
    xg = torch.empty((Bp, K), dtype=torch.bfloat16, device=xk.device)
    sums = torch.empty((K // block_size, Bp), dtype=torch.float32, device=xk.device)
    partial = (torch.empty((splits, B, n), dtype=torch.float32, device=xk.device)
               if splits > 1 else out)
    counters = _dec_counter_buffer(xk.device, stream, n // 128, "K3's tensor-core path")
    rc = _igtc_kernel_lib().pt2_ternary_matmul_igathered_tc(
        xk.data_ptr(), perm.data_ptr(), packed.data_ptr(), alpha.data_ptr(), mu.data_ptr(),
        xg.data_ptr(), sums.data_ptr(), partial.data_ptr(), out.data_ptr(), counters.data_ptr(),
        B, m, K, n, block_size, splits, _a8_mode(a8), device, stream,
    )
    if rc != 0:
        raise RuntimeError(f"K3 (rows 9-64, tensor cores) launch failed: cudaError {rc}")
    ternary_matmul_igathered.launches += 1
    ternary_matmul_igathered.launches_tc += 1
    ternary_matmul_igathered.launches_floor += _a8_mode(a8) == 2
    return out


def _tc_operands(xk, packed, alpha, mu):
    """xk (16-byte aligned: a copy if it is not) for K1's tensor-core
    kernels, which load every operand with 16-byte copies."""
    if xk.data_ptr() % 16:
        xk = xk.clone()
    if packed.data_ptr() % 16 or alpha.data_ptr() % 16 or mu.data_ptr() % 16:
        raise ValueError("K1's tensor-core paths need 16-byte aligned packed, alpha and mu")
    return xk


def _ternary_matmul_tc(xk, packed, alpha, mu, out, block_size):
    """K1's tensor-core path: x's per-block row sums into an f32 scratch,
    then the mma.sync kernel (16-byte cp.async loads of every operand)."""
    B, K = xk.shape
    xk = _tc_operands(xk, packed, alpha, mu)
    sums = torch.empty((K // block_size, -(-B // 128) * 128), dtype=torch.float32,
                       device=xk.device)
    rc = _tc_kernel_lib().pt2_ternary_matmul_tc(
        xk.data_ptr(), packed.data_ptr(), alpha.data_ptr(), mu.data_ptr(), sums.data_ptr(),
        out.data_ptr(), B, sums.shape[1], K, packed.shape[1], block_size,
        *_device_and_stream(xk),
    )
    if rc != 0:
        raise RuntimeError(f"K1 (tensor cores) launch failed: cudaError {rc}")
    ternary_matmul.launches += 1
    ternary_matmul.launches_tc += 1
    return out


def _ternary_matmul_tc_a8(xn, packed, alpha, mu, out, block_size, floor=False):
    """K1's W2A8 path on the int8 tensor cores: a prepass rounds the
    normalised rows xn to int8 (in the packed bytes' lane order) and writes
    their exact block sums, both into scratch allocated here; then the s8
    mma.sync kernel (``floor``: its FLOOR instance, the raw bytes as codes).
    Returns out before the row scales."""
    B, K = xn.shape
    xn = _tc_operands(xn, packed, alpha, mu)
    xq = torch.empty((B, K), dtype=torch.int8, device=xn.device)
    sums = torch.empty((K // block_size, -(-B // 128) * 128), dtype=torch.int32, device=xn.device)
    lib = _tc_a8_kernel_lib()
    entry = lib.pt2_ternary_matmul_tc_a8_floor if floor else lib.pt2_ternary_matmul_tc_a8
    rc = entry(
        xn.data_ptr(), packed.data_ptr(), alpha.data_ptr(), mu.data_ptr(), xq.data_ptr(),
        sums.data_ptr(), out.data_ptr(), B, sums.shape[1], K, packed.shape[1], block_size,
        *_device_and_stream(xn),
    )
    if rc != 0:
        raise RuntimeError(f"K1 (W2A8, integer tensor cores) launch failed: cudaError {rc}")
    ternary_matmul.launches += 1
    ternary_matmul.launches_tc_a8 += 1
    ternary_matmul.launches_floor += floor
    return out


def ternary_matmul_igathered(
    x: torch.Tensor,
    perm: torch.Tensor,
    packed: torch.Tensor,
    alpha: torch.Tensor,
    mu: torch.Tensor,
    block_size: int = 128,
    a8: bool = False,
) -> torch.Tensor:
    """out = x[:, perm] @ dequant(packed): (B, m) x (K,) perm -> (B, n) f32.

    CUDA: launches K3 on the path :func:`k3_path` names for its rows and
    shape, read at each call: "dec" (bf16 rows <= K1_DEC_MAX_ROWS, W2A8 ones
    too with K1_DEC_A8) runs K1's decode kernel with x staged through perm;
    "tc" (rows K1_TC_MIN_ROWS .. FUSED_MAX_ROWS) the one-pass gather into a
    scratch, then the split-K tensor-core product; every other shape the
    CUDA-core kernel (the gathered x staged in shared memory only). Counts
    the call in ``ternary_matmul_igathered.launches`` (the decode path also
    in ``ternary_matmul_igathered.launches_dec``, the tensor-core path in
    ``ternary_matmul_igathered.launches_tc``). ``a8`` "floor" (the floor
    probe, :func:`ternary_matmul_igathered_floor_plain`) takes W2A8's path in
    its FLOOR instance, counted also in
    ``ternary_matmul_igathered.launches_floor``. CPU: the plain version."""
    if x.device.type == "cpu":
        return ternary_matmul_igathered_plain(x, perm, packed, alpha, mu, block_size, a8)
    if x.device.type != "cuda":
        raise ValueError(f"no K3 for device {x.device}")
    if x.dim() != 2:
        raise ValueError(f"x must be (B, m), got {tuple(x.shape)}")
    B, m = x.shape
    _check(x, packed, alpha, mu, block_size, m=m)
    _check_floor(a8, block_size)
    K, n = packed.shape[0] * 4, packed.shape[1]
    _check_perm(perm, x, K)
    if a8:
        xk, sx = normalize_rows_a8(x)  # before the gather: absmax ignores order
    else:
        xk = x.to(torch.bfloat16)
    xk = xk.contiguous()
    out = torch.empty((B, n), dtype=torch.float32, device=x.device)
    if B == 0:
        return out
    path = k3_path(B, n, block_size, a8)
    if path == "dec":
        out = _ternary_matmul_igathered_dec(xk, perm, packed, alpha, mu, out, block_size, a8)
        return out * sx if a8 else out
    if path == "tc":
        out = _ternary_matmul_igathered_tc(xk, perm, packed, alpha, mu, out, block_size, a8)
        return out * sx if a8 else out
    rc = _kernel_lib().pt2_ternary_matmul_igathered(
        xk.data_ptr(), perm.data_ptr(), packed.data_ptr(), alpha.data_ptr(), mu.data_ptr(),
        out.data_ptr(), B, m, K, n, block_size, _a8_mode(a8), *_device_and_stream(x),
    )
    if rc != 0:
        raise RuntimeError(f"K3 launch failed: cudaError {rc}")
    ternary_matmul_igathered.launches += 1
    ternary_matmul_igathered.launches_floor += _a8_mode(a8) == 2
    return out * sx if a8 else out


ternary_matmul_igathered.launches = 0
ternary_matmul_igathered.launches_dec = 0
ternary_matmul_igathered.launches_tc = 0
ternary_matmul_igathered.launches_floor = 0


# ------------------------------------------------ device-index entries ----
# K1s and K3s (``ternary_matmul_pallas_stacked`` / ``_igathered_stacked``
# with a traced index): the weights are a whole contiguous stack of S slots
# and the slot, ``base`` + the int32 that ``sel`` points at, is read by the
# kernel from device memory, so a routed expert's index never goes to the
# host. Decode rows only: K1's and K3's decode kernel (``csrc/ternary_matmul_dec.cu``)
# where ``k1_path`` / ``k3_path`` say "dec", their CUDA-core kernels
# (``csrc/ternary_matmul.cu``) where they say "cuda_core" (W2A8 rows while
# K1_DEC_A8 is off). A slot outside [0, S) traps in the kernel.


def _slot_plain(sel: torch.Tensor, base: int, S: int) -> int:
    """The slot a plain version reads (a host read of ``sel``: the plain
    versions serve the CPU and the tests)."""
    slot = base + int(sel.reshape(-1)[0])
    if not 0 <= slot < S:
        raise IndexError(f"slot {slot} outside the stack's [0, {S})")
    return slot


def ternary_matmul_idx_plain(x, packed, alpha, mu, sel, base=0, block_size=128, a8=False):
    """K1s's plain version: K1's on ``packed[base + sel]``."""
    i = _slot_plain(sel, base, packed.shape[0])
    fn = (ternary_matmul_floor_plain if _a8_mode(a8) == 2
          else ternary_matmul_plain_a8 if a8 else ternary_matmul_plain)
    return fn(x, packed[i], alpha[i], mu[i], block_size)


def ternary_matmul_igathered_idx_plain(x, perm, packed, alpha, mu, sel, base=0, block_size=128,
                                       a8=False):
    """K3s's plain version: K3's on slot ``base + sel`` of perm and weights."""
    i = _slot_plain(sel, base, packed.shape[0])
    return ternary_matmul_igathered_plain(x, perm[i], packed[i], alpha[i], mu[i], block_size, a8)


def _check_stack(x, packed, alpha, mu, block_size, sel, m=None, perm=None):
    """Checks K1s / K3s operands: whole contiguous stacks whose every slot
    passes K1's checks (slot 0's views stand for all: the kernels offset by
    whole slots), slot strides that keep the kernels' 16-byte loads aligned,
    and ``sel`` one int32 on x's device."""
    if packed.dim() != 3 or alpha.dim() != 3 or mu.dim() != 3:
        raise ValueError(f"a device index takes (S, K/4, n) / (S, nb, n) stacks, got packed "
                         f"{tuple(packed.shape)}, alpha {tuple(alpha.shape)}")
    S = packed.shape[0]
    if alpha.shape[0] != S or mu.shape[0] != S:
        raise ValueError(f"stacks of {S} / {alpha.shape[0]} / {mu.shape[0]} slots")
    _check(x, packed[0], alpha[0], mu[0], block_size, m=m)
    K4, n = packed.shape[1:]
    if (K4 * n) % 16 or (alpha.shape[1] * n * 2) % 16:
        raise ValueError(f"slot strides of packed {tuple(packed.shape)} / alpha "
                         f"{tuple(alpha.shape)} break 16-byte alignment")
    if perm is not None:
        if perm.dtype != torch.int32 or perm.device != x.device or not perm.is_contiguous():
            raise ValueError(f"perm must be a contiguous int32 stack on {x.device}")
        if tuple(perm.shape) != (S, K4 * 4):
            raise ValueError(f"perm {tuple(perm.shape)} does not match {S} slots of {K4 * 4} "
                             "lanes")
    if sel.dtype != torch.int32 or sel.numel() != 1 or sel.device != x.device:
        raise ValueError(f"sel must be one int32 on {x.device}, got {sel.dtype} "
                         f"{tuple(sel.shape)} on {sel.device}")
    return S, K4 * 4, n


def _idx_operands(x, a8):
    """x cast to bf16 (or normalised for W2A8) and made contiguous, with
    the row scales (None in bf16)."""
    if a8:
        xk, sx = normalize_rows_a8(x)
    else:
        xk, sx = x.to(torch.bfloat16), None
    return xk.contiguous(), sx


def ternary_matmul_idx(
    x: torch.Tensor,
    packed: torch.Tensor,
    alpha: torch.Tensor,
    mu: torch.Tensor,
    sel: torch.Tensor,
    base: int = 0,
    block_size: int = 128,
    a8: bool = False,
) -> torch.Tensor:
    """K1s: out = x @ dequant(packed[base + sel]): (B, K) x (S, K//4, n) ->
    (B, n) f32, with ``sel`` one int32 on x's device that only the kernel
    reads.

    CUDA: on the path :func:`k1_path` names, "dec" through
    ``pt2_ternary_matmul_dec_idx``, "cuda_core" through
    ``pt2_ternary_matmul_idx``; the tensor-core paths (prefill rows) take no
    device index and raise. Counts the call in ``ternary_matmul_idx.launches``
    (the decode path also in ``ternary_matmul_idx.launches_dec``), not in
    K1's counters. ``a8`` "floor" runs the FLOOR instances (also in
    ``ternary_matmul_idx.launches_floor``). CPU: the plain version."""
    if x.device.type == "cpu":
        return ternary_matmul_idx_plain(x, packed, alpha, mu, sel, base, block_size, a8)
    if x.device.type != "cuda":
        raise ValueError(f"no K1s for device {x.device}")
    S, K, n = _check_stack(x, packed, alpha, mu, block_size, sel)
    _check_floor(a8, block_size)
    B = x.shape[0]
    path = k1_path(B, n, block_size, a8)
    if path not in ("dec", "cuda_core"):
        raise NotImplementedError(f"K1's {path} path takes no device index ({B} rows)")
    xk, sx = _idx_operands(x, a8)
    out = torch.empty((B, n), dtype=torch.float32, device=x.device)
    if B == 0:
        return out
    if path == "dec":
        xk = _tc_operands(xk, packed, alpha, mu)
        device, stream, splits, partial, counters = _dec_scratch(xk, K, n, block_size, out,
                                                                 "K1s")
        rc = _dec_kernel_lib().pt2_ternary_matmul_dec_idx(
            xk.data_ptr(), packed.data_ptr(), alpha.data_ptr(), mu.data_ptr(),
            partial.data_ptr(), out.data_ptr(), counters.data_ptr(), sel.data_ptr(), base, S, B,
            K, n, block_size, splits, _a8_mode(a8), device, stream,
        )
    else:
        rc = _kernel_lib().pt2_ternary_matmul_idx(
            xk.data_ptr(), packed.data_ptr(), alpha.data_ptr(), mu.data_ptr(), out.data_ptr(),
            sel.data_ptr(), base, S, B, K, n, block_size, _a8_mode(a8), *_device_and_stream(x),
        )
    if rc != 0:
        raise RuntimeError(f"K1s ({path}) launch failed: cudaError {rc}")
    ternary_matmul_idx.launches += 1
    ternary_matmul_idx.launches_dec += path == "dec"
    ternary_matmul_idx.launches_floor += _a8_mode(a8) == 2
    return out * sx if a8 else out


ternary_matmul_idx.launches = 0
ternary_matmul_idx.launches_dec = 0
ternary_matmul_idx.launches_floor = 0


def ternary_matmul_igathered_idx(
    x: torch.Tensor,
    perm: torch.Tensor,
    packed: torch.Tensor,
    alpha: torch.Tensor,
    mu: torch.Tensor,
    sel: torch.Tensor,
    base: int = 0,
    block_size: int = 128,
    a8: bool = False,
) -> torch.Tensor:
    """K3s: out = x[:, perm[s]] @ dequant(packed[s]), s = base + sel, with
    perm an (S, K) int32 stack and ``sel`` one int32 on x's device that only
    the kernel reads: (B, m) -> (B, n) f32.

    CUDA: on the path :func:`k3_path` names, "dec" through
    ``pt2_ternary_matmul_dec_igathered_idx``, "cuda_core" through
    ``pt2_ternary_matmul_igathered_idx``; its tensor-core path (rows 9-64)
    takes no device index and raises. Counts the call in
    ``ternary_matmul_igathered_idx.launches`` (the decode path also in
    ``ternary_matmul_igathered_idx.launches_dec``), not in K3's counters.
    ``a8`` "floor" runs the FLOOR instances (also in
    ``ternary_matmul_igathered_idx.launches_floor``). CPU: the plain version."""
    if x.device.type == "cpu":
        return ternary_matmul_igathered_idx_plain(x, perm, packed, alpha, mu, sel, base,
                                                  block_size, a8)
    if x.device.type != "cuda":
        raise ValueError(f"no K3s for device {x.device}")
    if x.dim() != 2:
        raise ValueError(f"x must be (B, m), got {tuple(x.shape)}")
    B, m = x.shape
    S, K, n = _check_stack(x, packed, alpha, mu, block_size, sel, m=m, perm=perm)
    _check_floor(a8, block_size)
    path = k3_path(B, n, block_size, a8)
    if path not in ("dec", "cuda_core"):
        raise NotImplementedError(f"K3's {path} path takes no device index ({B} rows)")
    xk, sx = _idx_operands(x, a8)
    out = torch.empty((B, n), dtype=torch.float32, device=x.device)
    if B == 0:
        return out
    if path == "dec":
        if packed.data_ptr() % 16 or alpha.data_ptr() % 16 or mu.data_ptr() % 16 \
                or perm.data_ptr() % 16:
            raise ValueError("K3s's decode path needs 16-byte aligned perm, packed, alpha and mu")
        device, stream, splits, partial, counters = _dec_scratch(xk, K, n, block_size, out,
                                                                 "K3s")
        rc = _dec_kernel_lib().pt2_ternary_matmul_dec_igathered_idx(
            xk.data_ptr(), perm.data_ptr(), packed.data_ptr(), alpha.data_ptr(), mu.data_ptr(),
            partial.data_ptr(), out.data_ptr(), counters.data_ptr(), sel.data_ptr(), base, S, B,
            m, K, n, block_size, splits, _a8_mode(a8), device, stream,
        )
    else:
        rc = _kernel_lib().pt2_ternary_matmul_igathered_idx(
            xk.data_ptr(), perm.data_ptr(), packed.data_ptr(), alpha.data_ptr(), mu.data_ptr(),
            out.data_ptr(), sel.data_ptr(), base, S, B, m, K, n, block_size, _a8_mode(a8),
            *_device_and_stream(x),
        )
    if rc != 0:
        raise RuntimeError(f"K3s ({path}) launch failed: cudaError {rc}")
    ternary_matmul_igathered_idx.launches += 1
    ternary_matmul_igathered_idx.launches_dec += path == "dec"
    ternary_matmul_igathered_idx.launches_floor += _a8_mode(a8) == 2
    return out * sx if a8 else out


ternary_matmul_igathered_idx.launches = 0
ternary_matmul_igathered_idx.launches_dec = 0
ternary_matmul_igathered_idx.launches_floor = 0


def ternary_matmul_gathered(
    x: torch.Tensor,
    gpacked: torch.Tensor,
    packed: torch.Tensor,
    alpha: torch.Tensor,
    mu: torch.Tensor,
    block_size: int = 128,
    a8: bool = False,
) -> torch.Tensor:
    """out = (x @ G) @ dequant(packed): (B, m) x (D//4, K) planes -> (B, n) f32.

    CUDA: launches K6 for 1 <= B <= 64 rows and scale blocks of 128 on the
    path :func:`k6_path` names for its rows and shape, read at each call:
    "dec" the plane gather into lane order, then K1's decode kernel; "tc"
    the plane gather into fragment order, then K3's split-K tensor-core
    product (both from one C entry, with the stream's scratch,
    :func:`_k6_plan`); "cuda_core" the gather as the prologue of a CUDA-core
    matmul (the gathered x in shared memory only; its split-K partials
    summed in a fixed order by a second kernel). Counts the call in
    ``ternary_matmul_gathered.launches`` (the decode path also in
    ``ternary_matmul_gathered.launches_dec``, the tensor-core path in
    ``ternary_matmul_gathered.launches_tc``). The decode and tensor-core
    paths keep the gathered x in bf16, as the TPU kernel's scratch does:
    for permutation planes that is the CUDA-core path's f32 value exactly.
    ``a8`` "floor" (the floor probe,
    :func:`ternary_matmul_gathered_floor_plain`) takes W2A8's path in its
    FLOOR instances, counted also in ``ternary_matmul_gathered.launches_floor``.
    CPU: the plain version."""
    if x.device.type == "cpu":
        return ternary_matmul_gathered_plain(x, gpacked, packed, alpha, mu, block_size, a8)
    if x.device.type != "cuda":
        raise ValueError(f"no K6 for device {x.device}")
    if x.dim() != 2 or not 1 <= x.shape[0] <= 64:
        raise ValueError(f"K6 takes x (B, m) with 1 <= B <= 64, got {tuple(x.shape)}")
    if block_size != 128:
        raise ValueError(f"K6 takes scale blocks of 128, got {block_size}")
    B, m = x.shape
    _check(x, packed, alpha, mu, block_size, m=m)
    K, n = packed.shape[0] * 4, packed.shape[1]
    if gpacked.dtype != torch.int8:
        raise TypeError(f"the gather planes must be int8, got {gpacked.dtype}")
    if gpacked.device != x.device or not gpacked.is_contiguous() or gpacked.data_ptr() % 4:
        raise ValueError(f"the gather planes must be contiguous and 4-byte aligned on {x.device}")
    if gpacked.dim() != 2 or gpacked.shape[1] != K or gpacked.shape[0] % 32 \
            or m > gpacked.shape[0] * 4:
        raise ValueError(f"gather planes {tuple(gpacked.shape)} do not match x width {m} and "
                         f"{K} lanes")
    if n % 128:
        raise ValueError(f"K6 takes out_features divisible by 128, got {n}")
    xk, sx = _k6_rows(x, a8)
    xk = xk.contiguous()
    out = torch.empty((B, n), dtype=torch.float32, device=x.device)
    path = k6_path(B, n, block_size, a8)
    if path != "cuda_core":
        _ternary_matmul_gathered_split(xk, gpacked, packed, alpha, mu, out, path, a8)
        return out * sx if a8 else out
    partial = torch.empty((K // 128, B, n), dtype=torch.float32, device=x.device)
    rc = _gathered_kernel_lib().pt2_ternary_matmul_gathered(
        xk.data_ptr(), gpacked.data_ptr(), packed.data_ptr(), alpha.data_ptr(), mu.data_ptr(),
        partial.data_ptr(), out.data_ptr(), B, m, gpacked.shape[0], K, n, _a8_mode(a8),
        *_device_and_stream(x),
    )
    if rc != 0:
        raise RuntimeError(f"K6 launch failed: cudaError {rc}")
    ternary_matmul_gathered.launches += 1
    ternary_matmul_gathered.launches_floor += _a8_mode(a8) == 2
    return out * sx if a8 else out


_k6_plans: dict = {}


def _k6_plan(xk, stream, device, path, K, n):
    """What a launch of K6's ``path`` ("dec" or "tc") for xk's rows on
    ``stream`` needs beside its operands, kept between calls (a decode step
    asks it once per projection): (splits, the xg scratch's pointer, the
    block sums' pointer (tc), the partials' pointer (None with one slice),
    the counters' pointer, and the tensors that own them). "dec": dec_splits
    of the card's decode wave, xg (B, K) bf16 in lane order; "tc":
    igtc_splits of its product's wave, xg (Bp, K) bf16 in fragment order
    and S (K/128, Bp) f32; both with (splits, B, n) f32 partials. The
    scratch is the stream's own, as the counters are, so the launches that
    share it are ordered by their stream and never overlap; a CUDA graph
    capture is refused."""
    if torch.cuda.is_current_stream_capturing():
        raise NotImplementedError(f"K6's {path!r} path inside a CUDA graph capture")
    B = xk.shape[0]
    key = (device, stream, path, B, K, n)
    plan = _k6_plans.get(key)
    if plan is None:
        if path == "dec":
            splits = dec_splits(K, n, 128, DEC_CTAS_PER_SM * _sm_count(device))
            rows = B
        else:
            splits = igtc_splits(K, n, 128, IGTC_CTAS_PER_SM * _sm_count(device))
            rows = igtc_rows_pad(B)
        xg = torch.empty((rows, K), dtype=torch.bfloat16, device=xk.device)
        f32 = torch.empty(((K // 128) * rows if path == "tc" else 0) + splits * B * n,
                          dtype=torch.float32, device=xk.device)
        counters = _dec_counter_buffer(xk.device, stream, n // 128, f"K6's {path!r} path")
        sums_at = f32.data_ptr() if path == "tc" else None
        part_at = f32.data_ptr() + 4 * (K // 128) * rows * (path == "tc") if splits > 1 else None
        plan = _k6_plans[key] = (splits, xg.data_ptr(), sums_at, part_at, counters.data_ptr(),
                                 (xg, f32, counters))
    return plan


def _ternary_matmul_gathered_split(xk, gpacked, packed, alpha, mu, out, path, a8):
    """K6's decode ("dec": ``pt2_ternary_matmul_gathered_dec``) or tensor-core
    ("tc": ``pt2_ternary_matmul_gathered_tc``) path: the plane gather, then
    K1's decode kernel or K3's product, one C entry, with the stream's
    scratch and counters (:func:`_k6_plan`). xk is bf16 x (B, m) in feature
    order, or W2A8's normalised rows (rounded by the gather); the planes are
    read as 16-byte vectors (a copy if they are not aligned so). Writes out
    before the row scales; a launch that fails raises."""
    B, m = xk.shape
    K, n = packed.shape[0] * 4, packed.shape[1]
    if packed.data_ptr() % 16 or alpha.data_ptr() % 16 or mu.data_ptr() % 16:
        raise ValueError(f"K6's {path!r} path needs 16-byte aligned packed, alpha and mu")
    if gpacked.data_ptr() % 16:
        gpacked = gpacked.clone()
    device, stream = _device_and_stream(xk)
    splits, xg, sums, partial, counters, _ = _k6_plan(xk, stream, device, path, K, n)
    head = (xk.data_ptr(), gpacked.data_ptr(), packed.data_ptr(), alpha.data_ptr(),
            mu.data_ptr(), xg)
    tail = (out.data_ptr() if partial is None else partial, out.data_ptr(), counters, B, m,
            gpacked.shape[0], K, n, splits, _a8_mode(a8), device, stream)
    if path == "dec":
        rc = _gathered_dec_kernel_lib().pt2_ternary_matmul_gathered_dec(*head, *tail)
    else:
        rc = _gathered_tc_kernel_lib().pt2_ternary_matmul_gathered_tc(*head, sums, *tail)
    if rc != 0:
        raise RuntimeError(f"K6 ({path!r} path, tensor cores) launch failed: cudaError {rc}")
    ternary_matmul_gathered.launches += 1
    ternary_matmul_gathered.launches_floor += _a8_mode(a8) == 2
    if path == "dec":
        ternary_matmul_gathered.launches_dec += 1
    else:
        ternary_matmul_gathered.launches_tc += 1


ternary_matmul_gathered.launches = 0
ternary_matmul_gathered.launches_dec = 0
ternary_matmul_gathered.launches_tc = 0
ternary_matmul_gathered.launches_floor = 0


def ternary_matmul_gathered_idx_plain(x, gpacked, packed, alpha, mu, sel, base=0,
                                      block_size=128, a8=False):
    """K6s's plain version: K6's on slot ``base + sel`` of the planes and
    weight stacks, the slot taken with ``index_select`` on the device (never
    read on the host)."""
    s = lambda t: slot_view(t, sel, base)  # noqa: E731
    return ternary_matmul_gathered_plain(x, s(gpacked), s(packed), s(alpha), s(mu), block_size,
                                         a8)


def ternary_matmul_gathered_idx(
    x: torch.Tensor,
    gpacked: torch.Tensor,
    packed: torch.Tensor,
    alpha: torch.Tensor,
    mu: torch.Tensor,
    sel: torch.Tensor,
    base: int = 0,
    block_size: int = 128,
    a8: bool = False,
) -> torch.Tensor:
    """K6s: out = (x @ G[s]) @ dequant(packed[s]), s = base + sel, with
    gpacked an (S, D//4, K) planes stack beside the (S, ...) weight stacks
    and ``sel`` one int32 on x's device that only the kernels read:
    (B, m) -> (B, n) f32.

    CUDA: on the path :func:`k6_path` names, "dec" through
    ``pt2_ternary_matmul_gathered_dec_idx`` (the plane gather's and K1's
    decode kernel's IDX instances, both reading the same int32, with the
    stream's scratch, :func:`_k6_plan`), "cuda_core" through
    ``pt2_ternary_matmul_gathered_idx`` (W2A8 decode rows while K1_DEC_A8 is
    off); its tensor-core path (rows 9-64) takes no device index and
    raises. Counts the call in ``ternary_matmul_gathered_idx.launches`` (the
    decode path also in ``ternary_matmul_gathered_idx.launches_dec``), not
    in K6's counters. ``a8`` "floor" runs the FLOOR instances (also in
    ``ternary_matmul_gathered_idx.launches_floor``). CPU: the plain version."""
    if x.device.type == "cpu":
        return ternary_matmul_gathered_idx_plain(x, gpacked, packed, alpha, mu, sel, base,
                                                 block_size, a8)
    if x.device.type != "cuda":
        raise ValueError(f"no K6s for device {x.device}")
    if x.dim() != 2 or not 1 <= x.shape[0] <= 64:
        raise ValueError(f"K6s takes x (B, m) with 1 <= B <= 64, got {tuple(x.shape)}")
    if block_size != 128:
        raise ValueError(f"K6s takes scale blocks of 128, got {block_size}")
    B, m = x.shape
    S, K, n = _check_stack(x, packed, alpha, mu, block_size, sel, m=m)
    if gpacked.dtype != torch.int8 or gpacked.device != x.device or not gpacked.is_contiguous():
        raise ValueError(f"the gather planes must be a contiguous int8 stack on {x.device}")
    if gpacked.dim() != 3 or gpacked.shape[0] != S or gpacked.shape[2] != K \
            or gpacked.shape[1] % 32 or m > gpacked.shape[1] * 4:
        raise ValueError(f"gather planes {tuple(gpacked.shape)} do not match {S} slots, x width "
                         f"{m} and {K} lanes")
    if n % 128:
        raise ValueError(f"K6s takes out_features divisible by 128, got {n}")
    D4 = gpacked.shape[1]
    path = k6_path(B, n, block_size, a8)
    if path == "tc":
        raise NotImplementedError(f"K6's 'tc' path takes no device index ({B} rows)")
    xk, sx = _k6_rows(x, a8)
    xk = xk.contiguous()
    out = torch.empty((B, n), dtype=torch.float32, device=x.device)
    device, stream = _device_and_stream(xk)
    if path == "dec":
        # the slots are 16-byte multiples (K and n multiples of 128): the bases decide
        if any(t.data_ptr() % 16 for t in (gpacked, packed, alpha, mu)):
            raise ValueError(f"K6s's decode path reads the stacks (planes "
                             f"{tuple(gpacked.shape)}, packed {tuple(packed.shape)}) as 16-byte "
                             "vectors: each must be 16-byte aligned")
        splits, xg, _, partial, counters, _ = _k6_plan(xk, stream, device, "dec", K, n)
        rc = _gathered_dec_kernel_lib().pt2_ternary_matmul_gathered_dec_idx(
            xk.data_ptr(), gpacked.data_ptr(), packed.data_ptr(), alpha.data_ptr(),
            mu.data_ptr(), xg, out.data_ptr() if partial is None else partial, out.data_ptr(),
            counters, sel.data_ptr(), base, S, B, m, D4, K, n, splits, _a8_mode(a8), device,
            stream)
    else:
        partial = torch.empty((K // 128, B, n), dtype=torch.float32, device=x.device)
        rc = _gathered_kernel_lib().pt2_ternary_matmul_gathered_idx(
            xk.data_ptr(), gpacked.data_ptr(), packed.data_ptr(), alpha.data_ptr(),
            mu.data_ptr(), partial.data_ptr(), out.data_ptr(), sel.data_ptr(), base, S, B, m, D4,
            K, n, _a8_mode(a8), device, stream)
    if rc != 0:
        raise RuntimeError(f"K6s ({path!r} path) launch failed: cudaError {rc}")
    ternary_matmul_gathered_idx.launches += 1
    ternary_matmul_gathered_idx.launches_dec += path == "dec"
    ternary_matmul_gathered_idx.launches_floor += _a8_mode(a8) == 2
    return out * sx if a8 else out


ternary_matmul_gathered_idx.launches = 0
ternary_matmul_gathered_idx.launches_dec = 0
ternary_matmul_gathered_idx.launches_floor = 0


def ternary_mlp(
    x: torch.Tensor,
    gu_perm: Optional[torch.Tensor],
    gu_packed: torch.Tensor,
    gu_alpha: torch.Tensor,
    gu_mu: torch.Tensor,
    dn_packed: torch.Tensor,
    dn_alpha: torch.Tensor,
    dn_mu: torch.Tensor,
    intermediate: int,
    block_size: int = 128,
    act: str = "silu",
    a8=False,
) -> torch.Tensor:
    """The whole MLP, (B, m) -> (B, n) f32, gated (gateup 2 x half wide) or
    ungated (gateup up alone, I or more wide; see :func:`_mlp_shapes`), with
    ``act`` silu, gelu (tanh form) or relu (see ternary_mlp_plain).

    CUDA: launches K2 for B <= 64 rows in bf16 on the path :func:`k2_path`
    names for B, read at each call: "dec" (rows 1 .. K2_DEC_MAX_ROWS) the
    gate/up and down launches of the decode path; "tc" (rows
    K2_TC_MIN_ROWS .. 64) the gather, gate/up and down launches of the
    tensor-core path; "cc" the CUDA-core MLP kernel, instantiated for the
    activation, and the fixed-order sum of its per-I-block partials; each
    path in its ungated instance for an ungated gateup. Counts the call
    once in ``ternary_mlp.launches`` (the decode path also in
    ``ternary_mlp.launches_dec``, the tensor-core path in
    ``ternary_mlp.launches_tc``, GeGLU also in ``ternary_mlp.launches_gelu``,
    the ungated MLP also in ``ternary_mlp.launches_ungated``; the decode
    path's down launch is not one of ``ternary_matmul``'s). CPU: the plain
    version.

    ``a8`` False, or :data:`FLOOR` (``ternary_mlp_pallas``'s ``a8="floor"``,
    the only W2A8 mode of the TPU kernel): the floor probe
    (:func:`ternary_mlp_floor_plain`) in each path's FLOOR instance, also
    counted in ``ternary_mlp.launches_floor``."""
    code = mlp_act_code(act)
    if a8 is not False and a8 != FLOOR:
        raise ValueError(f"K2's a8 is False or {FLOOR!r}, got {a8!r}")
    floor = a8 == FLOOR
    if x.device.type == "cpu":
        plain = ternary_mlp_floor_plain if floor else ternary_mlp_plain
        return plain(x, gu_perm, gu_packed, gu_alpha, gu_mu, dn_packed, dn_alpha, dn_mu,
                     intermediate, block_size, act)
    if x.device.type != "cuda":
        raise ValueError(f"no K2 for device {x.device}")
    if x.dim() != 2 or not 1 <= x.shape[0] <= 64:
        raise ValueError(f"K2 takes x (B, m) with 1 <= B <= 64, got {tuple(x.shape)}")
    if block_size != 128:
        raise ValueError(f"K2 takes scale blocks of 128, got {block_size}")
    Kg, half, nv, n, gated = _mlp_shapes(gu_packed, gu_alpha, dn_packed, dn_alpha,
                                         intermediate, block_size)
    gu_n = 2 * half if gated else half
    B, m = x.shape
    path = k2_path(B)
    for name, t, dt in (("gu_packed", gu_packed, torch.int8), ("gu_alpha", gu_alpha, torch.bfloat16),
                        ("gu_mu", gu_mu, torch.bfloat16), ("dn_packed", dn_packed, torch.int8),
                        ("dn_alpha", dn_alpha, torch.bfloat16), ("dn_mu", dn_mu, torch.bfloat16)):
        if t.device != x.device or not t.is_contiguous() or t.dim() != 2:
            raise ValueError(f"{name} must be a contiguous 2-D tensor on {x.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        # the tensor-core paths load codes and scales as 16-byte vectors
        if t.data_ptr() % (16 if path != "cc" else 4 if dt == torch.int8 else 8):
            raise ValueError(f"{name} is not aligned for K2's vector loads on its {path!r} path")
    if gu_alpha.shape != (Kg // 128, gu_n) or gu_mu.shape != gu_alpha.shape:
        raise ValueError(f"gateup scales {tuple(gu_alpha.shape)} do not match its planes")
    if dn_alpha.shape != (dn_packed.shape[0] // 32, n) or dn_mu.shape != dn_alpha.shape:
        raise ValueError(f"down scales {tuple(dn_alpha.shape)} do not match its planes")
    if gu_perm is not None:
        _check_perm(gu_perm, x, Kg)
    elif m > Kg:
        raise ValueError(f"x width {m} exceeds lane count {Kg}")
    xk = x.to(torch.bfloat16).contiguous()
    out = torch.empty((B, n), dtype=torch.float32, device=x.device)
    if path == "dec":
        _ternary_mlp_dec(xk, gu_perm, gu_packed, gu_alpha, gu_mu, dn_packed, dn_alpha, dn_mu,
                         out, half, code, gated, floor)
        ternary_mlp.launches_dec += 1
    elif path == "tc":
        _ternary_mlp_tc(xk, gu_perm, gu_packed, gu_alpha, gu_mu, dn_packed, dn_alpha, dn_mu,
                        out, half, code, gated, floor)
        ternary_mlp.launches_tc += 1
    else:
        partial = torch.empty((nv, B, n), dtype=torch.float32, device=x.device)
        rc = (_mlp_floor_kernel_lib().pt2_ternary_mlp_floor if floor
              else _mlp_kernel_lib().pt2_ternary_mlp)(
            xk.data_ptr(), None if gu_perm is None else gu_perm.data_ptr(),
            gu_packed.data_ptr(), gu_alpha.data_ptr(), gu_mu.data_ptr(),
            dn_packed.data_ptr(), dn_alpha.data_ptr(), dn_mu.data_ptr(),
            partial.data_ptr(), out.data_ptr(), B, m, Kg, gu_n, half,
            dn_packed.shape[0] * 4, n, code, *_device_and_stream(x),
        )
        if rc != 0:
            raise RuntimeError(f"K2 launch failed: cudaError {rc}")
    ternary_mlp.launches += 1
    ternary_mlp.launches_gelu += act == "gelu"
    ternary_mlp.launches_ungated += not gated
    ternary_mlp.launches_floor += floor
    return out


ternary_mlp.launches = 0
ternary_mlp.launches_floor = 0
ternary_mlp.launches_dec = 0
ternary_mlp.launches_tc = 0
ternary_mlp.launches_gelu = 0
ternary_mlp.launches_ungated = 0


_identity_perms: dict = {}


def _identity_perm(Kg: int, device) -> torch.Tensor:
    """arange(Kg) int32 on ``device``, kept between calls: K2's decode and
    tensor-core paths read the layout without a gather through it (lanes
    >= m read as 0, the zero pad)."""
    key = (device, Kg)
    perm = _identity_perms.get(key)
    if perm is None:
        perm = _identity_perms[key] = torch.arange(Kg, dtype=torch.int32, device=device)
    return perm


def _ternary_mlp_tc(xk, perm, gu_packed, gu_alpha, gu_mu, dn_packed, dn_alpha, dn_mu, out, half,
                    code, gated=True, floor=False):
    """K2's tensor-core path (``pt2_ternary_mlp_tc``, ungated
    ``pt2_ternary_mlp_tc_ungated``): K3's gather into a (Bp, Kg) bf16
    scratch and its block sums (through the identity perm without a gather),
    the gate/up product with the gated epilogue (ungated: the up product
    with act alone) into a (Bp, half) bf16 mid scratch and its block sums,
    then K3's product over mid, each product over igtc_splits K slices of
    the card's wave with its (splits, ., .) f32 partials; all scratch is
    allocated here, the counters are the stream's (shared with K1's and
    K3's split-K paths). xk is bf16 x (B, m); perm is read as 8-byte vectors
    (a copy if it is not 16-byte aligned). ``floor``: the FLOOR instances
    (``pt2_ternary_mlp_tc_floor`` / ``_floor_ungated``). Writes out; a launch
    that fails raises."""
    B, m = xk.shape
    Kg, n = gu_packed.shape[0] * 4, dn_packed.shape[1]
    gu_n = 2 * half if gated else half
    if perm is None:
        perm = _identity_perm(Kg, xk.device)
    elif perm.data_ptr() % 16:
        perm = perm.clone()
    device, stream = _device_and_stream(xk)
    wave = IGTC_CTAS_PER_SM * _sm_count(device)
    gu_splits = igtc_splits(Kg, gu_n, 128, wave)
    dn_splits = igtc_splits(half, n, 128, wave)
    Bp = igtc_rows_pad(B)
    bf16 = dict(dtype=torch.bfloat16, device=xk.device)
    f32 = dict(dtype=torch.float32, device=xk.device)
    xg = torch.empty((Bp, Kg), **bf16)
    sums = torch.empty((Kg // 128, Bp), **f32)
    gu_partial = torch.empty((gu_splits, Bp, gu_n), **f32) if gu_splits > 1 else None
    mid = torch.empty((Bp, half), **bf16)
    mid_sums = torch.empty((half // 64 + half // 128, Bp), **f32)
    dn_partial = torch.empty((dn_splits, B, n), **f32) if dn_splits > 1 else None
    counters = _dec_counter_buffer(xk.device, stream, max(half // 64 + half // 128, n // 128),
                                   "K2's tensor-core path")
    entry = getattr(_mlp_tc_kernel_lib(), "pt2_ternary_mlp_tc" + ("_floor" if floor else "")
                    + ("" if gated else "_ungated"))
    rc = entry(
        xk.data_ptr(), perm.data_ptr(), gu_packed.data_ptr(), gu_alpha.data_ptr(),
        gu_mu.data_ptr(), dn_packed.data_ptr(), dn_alpha.data_ptr(), dn_mu.data_ptr(),
        xg.data_ptr(), sums.data_ptr(), None if gu_partial is None else gu_partial.data_ptr(),
        mid.data_ptr(), mid_sums.data_ptr(), None if dn_partial is None else dn_partial.data_ptr(),
        out.data_ptr(), counters.data_ptr(), B, m, Kg, half, n, gu_splits, dn_splits, code, device,
        stream,
    )
    if rc != 0:
        raise RuntimeError(f"K2 (rows 9-64, tensor cores) launch failed: cudaError {rc}")


_mlp_dec_plans: dict = {}


def _mlp_dec_plan(xk, stream, device, Kg, half, n, gated=True):
    """What a launch of K2's decode path for xk's rows on ``stream`` needs
    beside its operands, kept between calls (a decode step asks it once per
    layer): (gu_splits, dn_splits, its three scratch pointers, the counters'
    pointer, the identity perm's pointer, and the tensors that own them).
    The splits are dec_splits' of the card's wave; one scratch holds gate/up's
    (gu_splits, B, gu_n) f32 partials (gu_n = 2 * half, ungated half),
    down's (dn_splits, B, n) and mid (B, half) bf16. It is the stream's own,
    as the counters are, so the launches that share it are ordered by their
    stream and never overlap; a CUDA graph capture is refused."""
    if torch.cuda.is_current_stream_capturing():
        raise NotImplementedError("K2's decode path inside a CUDA graph capture")
    B = xk.shape[0]
    key = (device, stream, B, Kg, half, n, gated)
    plan = _mlp_dec_plans.get(key)
    if plan is None:
        wave = DEC_CTAS_PER_SM * _sm_count(device)
        gu_n = 2 * half if gated else half
        gu_splits, dn_splits = dec_splits(Kg, gu_n, 128, wave), dec_splits(half, n, 128, wave)
        gu_len, dn_len = gu_splits * B * gu_n, dn_splits * B * n
        scratch = torch.empty(gu_len + dn_len + B * half // 2, dtype=torch.float32,
                              device=xk.device)
        counters = _dec_counter_buffer(xk.device, stream, max(half, n) // 128,
                                       "K2's decode path")
        ident = _identity_perm(Kg, xk.device)
        at = scratch.data_ptr()
        plan = _mlp_dec_plans[key] = (
            gu_splits, dn_splits, at, at + 4 * gu_len, at + 4 * (gu_len + dn_len),
            counters.data_ptr(), ident.data_ptr(), (scratch, counters, ident))
    return plan


def _ternary_mlp_dec(xk, perm, gu_packed, gu_alpha, gu_mu, dn_packed, dn_alpha, dn_mu, out, half,
                     code, gated=True, floor=False):
    """K2's decode path (``pt2_ternary_mlp_dec``, ungated
    ``pt2_ternary_mlp_dec_ungated``): the decode GEMV over gateup with x
    staged through perm (the identity perm without a gather) and the gated
    epilogue (ungated: act(up)), then K1's decode kernel over mid, each over
    dec_splits K slices of the card's wave, with the stream's scratch and
    counters (:func:`_mlp_dec_plan`). xk is bf16 x (B, m); perm is read as
    16-byte vectors (a copy if it is not aligned so). ``floor``: the FLOOR
    instances (``pt2_ternary_mlp_dec_floor`` / ``_floor_ungated``). Writes
    out; a launch that fails raises."""
    B, m = xk.shape
    Kg, n = gu_packed.shape[0] * 4, dn_packed.shape[1]
    if perm is not None and perm.data_ptr() % 16:
        perm = perm.clone()
    device, stream = _device_and_stream(xk)
    gu_splits, dn_splits, gu_part, dn_part, mid, counters, ident, _ = _mlp_dec_plan(
        xk, stream, device, Kg, half, n, gated)
    entry = getattr(_mlp_dec_kernel_lib(), "pt2_ternary_mlp_dec" + ("_floor" if floor else "")
                    + ("" if gated else "_ungated"))
    rc = entry(
        xk.data_ptr(), ident if perm is None else perm.data_ptr(), gu_packed.data_ptr(),
        gu_alpha.data_ptr(), gu_mu.data_ptr(), dn_packed.data_ptr(), dn_alpha.data_ptr(),
        dn_mu.data_ptr(), gu_part, dn_part, mid, out.data_ptr(), counters, B, m, Kg, half, n,
        gu_splits, dn_splits, code, device, stream,
    )
    if rc != 0:
        raise RuntimeError(f"K2 (decode rows, tensor cores) launch failed: cudaError {rc}")
