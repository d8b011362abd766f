"""The packed-ternary kernels K1, K3, K6 and K2: plain versions and wrappers.

  * K1 ``ternary_matmul``: the fused 2-bit unpack + matmul (replaces
    ``pt2tpu/ops/kernels/pallas_ternary.py:ternary_matmul_pallas``), on three
    paths chosen by shape (:func:`k1_path`): the CUDA cores
    (``csrc/ternary_matmul.cu``) for decode rows, the bf16 tensor cores
    (``csrc/ternary_matmul_tc.cu``) for bf16 rows >= :data:`K1_TC_MIN_ROWS`
    and the int8 tensor cores (``csrc/ternary_matmul_tc_a8.cu``) for W2A8
    rows >= :data:`K1_TC_MIN_ROWS`.
  * K3 ``ternary_matmul_igathered``: K1 with the SSR input gather fused in
    (same source; replaces ``ternary_matmul_pallas_igathered``).
  * K6 ``ternary_matmul_gathered``: the packed one-hot gather x @ G run as
    the matmul's prologue (``csrc/ternary_matmul_gathered.cu``; replaces
    ``ternary_matmul_pallas_gathered``).
  * K2 ``ternary_mlp``: the whole gated MLP in one launch
    (``csrc/ternary_mlp.cu``; replaces ``ternary_mlp_pallas``).

Each wrapper launches its hand-written kernel on a CUDA tensor or raises,
and runs the plain version beside it on a CPU tensor. There is no fallback
from a kernel to its plain version. The ``_stacked`` TPU variants collapse
into these: a stacked layer is the zero-copy view ``packed[li]``.

The plain versions repeat ``pt2tpu.ops.ternary_matmul.ternary_matmul_xla``:
unpack, one product per scale block, then the scales, all in f32.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ...core.packing import unpack_ternary
from . import _build
from .gather import onehot_gather_plain, onehot_matmul_plain

__all__ = [
    "K1_TC_MIN_ROWS",
    "k1_path",
    "ternary_matmul",
    "ternary_matmul_plain",
    "ternary_matmul_plain_a8",
    "quantize_rows_a8_lanes_plain",
    "ternary_matmul_lanes_plain",
    "ternary_matmul_igathered",
    "ternary_matmul_igathered_plain",
    "ternary_matmul_gathered",
    "ternary_matmul_gathered_plain",
    "ternary_mlp",
    "ternary_mlp_plain",
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
    does not depend on the order of the columns)."""
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
    columns) and rounds the gathered values to int8."""
    if not a8:
        return ternary_matmul_plain(onehot_matmul_plain(x.float(), gpacked), packed, alpha, mu,
                                    block_size)
    xn, sx = normalize_rows_a8(x)
    xq = torch.clamp(torch.round(onehot_matmul_plain(xn.float(), gpacked)), -127, 127)
    return ternary_matmul_plain(xq, packed, alpha, mu, block_size) * sx


def _mlp_shapes(gu_packed, gu_alpha, dn_packed, dn_alpha, intermediate, block_size):
    """The checks of ``pallas_ternary._mlp_common`` for the gated MLP.
    Returns (Kg, half, nv, n): gate lanes [0, half), up lanes [half, 2*half),
    nv = half // block_size visited k-blocks of down."""
    Kg4, gu_n = gu_packed.shape[-2:]
    Kg = Kg4 * 4
    Kd4, n = dn_packed.shape[-2:]
    bs, I = block_size, intermediate
    if not (gu_n >= 2 * I and gu_n % (2 * bs) == 0):
        if gu_n >= I and gu_n % bs == 0:
            raise NotImplementedError("the ungated MLP (act(up) alone) is not ported")
        raise ValueError(f"gateup width {gu_n} vs intermediate {I}")
    half = gu_n // 2
    if bs % 128 or gu_alpha.shape[-2] * bs != Kg or dn_alpha.shape[-2] * bs != Kd4 * 4:
        raise ValueError(
            f"bad shapes: gu {tuple(gu_packed.shape)}, dn {tuple(dn_packed.shape)}, bs {bs}"
        )
    if I % bs:
        raise ValueError(f"intermediate {I} not a multiple of block {bs}")
    nv = half // bs
    if nv > dn_alpha.shape[-2]:
        raise ValueError(f"gate-half blocks {nv} exceed down blocks {dn_alpha.shape[-2]}")
    if n % 128:
        raise ValueError(f"out_features {n} must be a multiple of 128")
    return Kg, half, nv, n


def ternary_mlp_plain(
    x: torch.Tensor,  # (B, m) post-norm hidden, feature order
    gu_perm: Optional[torch.Tensor],  # (Kg,) gateup's visit perm, or None
    gu_packed: torch.Tensor,  # (Kg//4, 2*half): [gate | up], lanes in down's visit order
    gu_alpha: torch.Tensor,
    gu_mu: torch.Tensor,
    dn_packed: torch.Tensor,  # (Kd//4, n), Kd >= half (pad blocks zero-scaled)
    dn_alpha: torch.Tensor,
    dn_mu: torch.Tensor,
    intermediate: int,
    block_size: int = 128,
) -> torch.Tensor:
    """The whole gated silu MLP, (B, m) -> (B, n) f32, as
    ``ternary_mlp_pallas`` computes it: the gather (or a zero pad to Kg),
    gate and up at the stored half width, mid = silu(gate) * up in f32 cast
    to x's dtype (the kernel's operand type), then down over its first
    half // block_size blocks."""
    Kg, half, nv, _ = _mlp_shapes(gu_packed, gu_alpha, dn_packed, dn_alpha,
                                  intermediate, block_size)
    if gu_perm is not None:
        xg = onehot_gather_plain(x, gu_perm)
    else:
        if x.shape[-1] > Kg:
            raise ValueError(f"x width {x.shape[-1]} exceeds lane count {Kg}")
        xg = F.pad(x, (0, Kg - x.shape[-1]))
    bs = block_size
    gate = ternary_matmul_plain(xg, gu_packed[:, :half], gu_alpha[:, :half], gu_mu[:, :half], bs)
    up = ternary_matmul_plain(xg, gu_packed[:, half:], gu_alpha[:, half:], gu_mu[:, half:], bs)
    mid = (F.silu(gate) * up).to(x.dtype)
    return ternary_matmul_plain(mid, dn_packed[: half // 4], dn_alpha[:nv], dn_mu[:nv], bs)


K1_TC_MIN_ROWS = 9
"""The fewest rows K1 runs on the tensor cores, bf16 and W2A8 alike.
``chip_smoke.py`` times the kernels at 1-512 rows; on an H100 both
tensor-core kernels were faster than the CUDA cores at every one. Decode
(<= 8 rows: the engine's 8 slots, lockstep batches) keeps the CUDA-core
kernel all the same, so that only prefill and admission rows move there;
routing decode rows there is a change of its own, with its own A/B of
decode. Read at each call."""


def k1_path(rows: int, n: int, block_size: int, a8: bool) -> str:
    """Which of K1's kernels :func:`ternary_matmul` launches on CUDA. For
    rows >= K1_TC_MIN_ROWS with scale blocks and out_features that are
    multiples of 128: "tc" (``pt2_ternary_matmul_tc``, bf16 mma.sync) in
    bf16, "tc_a8" (``pt2_ternary_matmul_tc_a8``, s8 mma.sync) in W2A8.
    Else "cuda_core" (``pt2_ternary_matmul``)."""
    if block_size % 128 == 0 and n % 128 == 0 and rows >= K1_TC_MIN_ROWS:
        return "tc_a8" if a8 else "tc"
    return "cuda_core"


_lib = None
_tc_lib = None
_tc_a8_lib = None
_mlp_lib = None
_gathered_lib = None


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
        _lib = lib
    return _lib


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
        fn = lib.pt2_ternary_matmul_tc_a8
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _tc_a8_lib = lib
    return _tc_a8_lib


def _mlp_kernel_lib():
    global _mlp_lib
    if _mlp_lib is None:
        lib = _build.load("ternary_mlp")
        fn = lib.pt2_ternary_mlp
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _mlp_lib = lib
    return _mlp_lib


def _gathered_kernel_lib():
    global _gathered_lib
    if _gathered_lib is None:
        lib = _build.load("ternary_matmul_gathered")
        fn = lib.pt2_ternary_matmul_gathered
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _gathered_lib = lib
    return _gathered_lib


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
    ``ternary_matmul.launches`` (the bf16 tensor-core path also in
    ``ternary_matmul.launches_tc``, the int8 one in
    ``ternary_matmul.launches_tc_a8``). CPU: the plain version, with x as
    given (f32 compute, as JAX on the CPU).
    """
    if x.device.type == "cpu":
        fn = ternary_matmul_plain_a8 if a8 else ternary_matmul_plain
        return fn(x, packed, alpha, mu, block_size)
    if x.device.type != "cuda":
        raise ValueError(f"no K1 for device {x.device}")
    _check(x, packed, alpha, mu, block_size)
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
    if path == "tc":
        return _ternary_matmul_tc(xk, packed, alpha, mu, out, block_size)
    if path == "tc_a8":
        return _ternary_matmul_tc_a8(xk, packed, alpha, mu, out, block_size) * sx
    rc = _kernel_lib().pt2_ternary_matmul(
        xk.data_ptr(), packed.data_ptr(), alpha.data_ptr(), mu.data_ptr(),
        out.data_ptr(), B, K, n, block_size, int(bool(a8)), *_device_and_stream(x),
    )
    if rc != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {rc}")
    ternary_matmul.launches += 1
    return out * sx if a8 else out


ternary_matmul.launches = 0
ternary_matmul.launches_tc = 0
ternary_matmul.launches_tc_a8 = 0


def _tc_operands(xk, packed, alpha, mu):
    """xk (16-byte aligned: a copy if it is not) for K1's tensor-core
    kernels, which load every operand with 16-byte cp.async copies."""
    if xk.data_ptr() % 16:
        xk = xk.clone()
    if packed.data_ptr() % 16 or alpha.data_ptr() % 16 or mu.data_ptr() % 16:
        raise ValueError("K1's tensor-core path needs 16-byte aligned packed, alpha and mu")
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


def _ternary_matmul_tc_a8(xn, packed, alpha, mu, out, block_size):
    """K1's W2A8 path on the int8 tensor cores: a prepass rounds the
    normalised rows xn to int8 (in the packed bytes' lane order) and writes
    their exact block sums, both into scratch allocated here; then the s8
    mma.sync kernel. Returns out before the row scales."""
    B, K = xn.shape
    xn = _tc_operands(xn, packed, alpha, mu)
    xq = torch.empty((B, K), dtype=torch.int8, device=xn.device)
    sums = torch.empty((K // block_size, -(-B // 128) * 128), dtype=torch.int32, device=xn.device)
    rc = _tc_a8_kernel_lib().pt2_ternary_matmul_tc_a8(
        xn.data_ptr(), packed.data_ptr(), alpha.data_ptr(), mu.data_ptr(), xq.data_ptr(),
        sums.data_ptr(), out.data_ptr(), B, sums.shape[1], K, packed.shape[1], block_size,
        *_device_and_stream(xn),
    )
    if rc != 0:
        raise RuntimeError(f"K1 (W2A8, integer tensor cores) launch failed: cudaError {rc}")
    ternary_matmul.launches += 1
    ternary_matmul.launches_tc_a8 += 1
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

    CUDA: launches K3 (the gathered x is staged in shared memory only) and
    counts it in ``ternary_matmul_igathered.launches``. CPU: the plain
    version."""
    if x.device.type == "cpu":
        return ternary_matmul_igathered_plain(x, perm, packed, alpha, mu, block_size, a8)
    if x.device.type != "cuda":
        raise ValueError(f"no K3 for device {x.device}")
    if x.dim() != 2:
        raise ValueError(f"x must be (B, m), got {tuple(x.shape)}")
    B, m = x.shape
    _check(x, packed, alpha, mu, block_size, m=m)
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
    rc = _kernel_lib().pt2_ternary_matmul_igathered(
        xk.data_ptr(), perm.data_ptr(), packed.data_ptr(), alpha.data_ptr(), mu.data_ptr(),
        out.data_ptr(), B, m, K, n, block_size, int(bool(a8)), *_device_and_stream(x),
    )
    if rc != 0:
        raise RuntimeError(f"K3 launch failed: cudaError {rc}")
    ternary_matmul_igathered.launches += 1
    return out * sx if a8 else out


ternary_matmul_igathered.launches = 0


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

    CUDA: launches K6 (the gathered x is staged in shared memory only; its
    split-K partials are summed in a fixed order by a second kernel) for
    1 <= B <= 64 rows and scale blocks of 128, and counts it once in
    ``ternary_matmul_gathered.launches``. CPU: the plain version."""
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
    if a8:
        xk, sx = normalize_rows_a8(x)  # before the gather: absmax ignores order
    else:
        xk = x.to(torch.bfloat16)
    xk = xk.contiguous()
    partial = torch.empty((K // 128, B, n), dtype=torch.float32, device=x.device)
    out = torch.empty((B, n), dtype=torch.float32, device=x.device)
    rc = _gathered_kernel_lib().pt2_ternary_matmul_gathered(
        xk.data_ptr(), gpacked.data_ptr(), packed.data_ptr(), alpha.data_ptr(), mu.data_ptr(),
        partial.data_ptr(), out.data_ptr(), B, m, gpacked.shape[0], K, n, int(bool(a8)),
        *_device_and_stream(x),
    )
    if rc != 0:
        raise RuntimeError(f"K6 launch failed: cudaError {rc}")
    ternary_matmul_gathered.launches += 1
    return out * sx if a8 else out


ternary_matmul_gathered.launches = 0


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
) -> torch.Tensor:
    """The whole gated silu MLP, (B, m) -> (B, n) f32 (see ternary_mlp_plain).

    CUDA: launches K2 (its MLP kernel and the fixed-order sum of the
    per-I-block partials) for B <= 64 rows in bf16 and counts it once in
    ``ternary_mlp.launches``. CPU: the plain version."""
    if x.device.type == "cpu":
        return ternary_mlp_plain(x, gu_perm, gu_packed, gu_alpha, gu_mu,
                                 dn_packed, dn_alpha, dn_mu, intermediate, block_size)
    if x.device.type != "cuda":
        raise ValueError(f"no K2 for device {x.device}")
    if x.dim() != 2 or not 1 <= x.shape[0] <= 64:
        raise ValueError(f"K2 takes x (B, m) with 1 <= B <= 64, got {tuple(x.shape)}")
    if block_size != 128:
        raise ValueError(f"K2 takes scale blocks of 128, got {block_size}")
    Kg, half, nv, n = _mlp_shapes(gu_packed, gu_alpha, dn_packed, dn_alpha,
                                  intermediate, block_size)
    B, m = x.shape
    for name, t, dt in (("gu_packed", gu_packed, torch.int8), ("gu_alpha", gu_alpha, torch.bfloat16),
                        ("gu_mu", gu_mu, torch.bfloat16), ("dn_packed", dn_packed, torch.int8),
                        ("dn_alpha", dn_alpha, torch.bfloat16), ("dn_mu", dn_mu, torch.bfloat16)):
        if t.device != x.device or not t.is_contiguous() or t.dim() != 2:
            raise ValueError(f"{name} must be a contiguous 2-D tensor on {x.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.data_ptr() % (4 if dt == torch.int8 else 8):
            raise ValueError(f"{name} is not aligned for K2's vector loads")
    if gu_alpha.shape != (Kg // 128, 2 * half) or gu_mu.shape != gu_alpha.shape:
        raise ValueError(f"gateup scales {tuple(gu_alpha.shape)} do not match its planes")
    if dn_alpha.shape != (dn_packed.shape[0] // 32, n) or dn_mu.shape != dn_alpha.shape:
        raise ValueError(f"down scales {tuple(dn_alpha.shape)} do not match its planes")
    if gu_perm is not None:
        _check_perm(gu_perm, x, Kg)
    elif m > Kg:
        raise ValueError(f"x width {m} exceeds lane count {Kg}")
    xk = x.to(torch.bfloat16).contiguous()
    partial = torch.empty((nv, B, n), dtype=torch.float32, device=x.device)
    out = torch.empty((B, n), dtype=torch.float32, device=x.device)
    rc = _mlp_kernel_lib().pt2_ternary_mlp(
        xk.data_ptr(), None if gu_perm is None else gu_perm.data_ptr(),
        gu_packed.data_ptr(), gu_alpha.data_ptr(), gu_mu.data_ptr(),
        dn_packed.data_ptr(), dn_alpha.data_ptr(), dn_mu.data_ptr(),
        partial.data_ptr(), out.data_ptr(), B, m, Kg, 2 * half, half,
        dn_packed.shape[0] * 4, n, *_device_and_stream(x),
    )
    if rc != 0:
        raise RuntimeError(f"K2 launch failed: cudaError {rc}")
    ternary_mlp.launches += 1
    return out


ternary_mlp.launches = 0
