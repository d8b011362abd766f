"""K7: single-query decode attention over the KV cache, its plain versions
and its wrapper.

``decode_attention`` is the one entry point. On CUDA tensors it launches a
hand-written kernel that replaces
``pt2tpu/ops/kernels/pallas_attention.py:decode_attention_pallas``, or
raises; on CPU tensors it runs :func:`decode_attention_plain`. There is no
fallback from a kernel to another or to the plain version. With ``K7_TC``
(on; read at each call) the kernel is ``csrc/decode_attention_tc.cu``: one
launch that reads each row's K/V only up to its last valid slot, in tiles
staged by TMA copies, with scores and P.V on the tensor cores and the
splits of a row (``k7_plan``) combined in a thread-block cluster. With it
off, ``csrc/decode_attention.cu``, the first port (all of M, the CUDA cores,
a chunk kernel and a combine): kept for A/Bs.

Each kernel has compile-time instances for the head widths ``HEAD_DIMS``
(128-512) and one wide instance for every other multiple of 128 up to
``WIDE_MAX_HD`` (2048), which takes the width at run time: in the
tensor-core kernel, tiles of 16 positions, one CTA an SM, each warp
streaming its own 128-lane chunks of K and V, the warps' partial scores
summed in warp order and P.V writing only the warp's own output lanes
(``MAX_ACTIVE_CLUSTERS_WIDE``); in the CUDA-core kernel, P.V one 128-dim
piece at a time.

The function (the TPU kernel's semantics): one query token per row,
q (B, 1, H, hd) against the cache k/v (B, M, Hkv, hd), grouped heads
(query head h reads kv head h // (H / Hkv)), slots with ``kv_valid`` false
excluded.

- bf16 cache: s = q.k in f32, times ``scale``; invalid slots get
  ``NEG`` = -0.7 * f32max; softmax in f32; the unnormalised probabilities
  are rounded to bf16 before the product with v (f32 sums); the output is
  acc / max(l, 1e-30) in q's dtype.
- int8 cache (with (B, M, Hkv, 1) f32 ``k_scale``/``v_scale``): q is
  quantised per (row, head) to int8 (absmax / 127 floored at 1e-20, round
  half to even, clip +-127; the kernel does this itself, the plain version
  through :func:`quantize_query`); the s8 x s8 score is exact in int32 and is
  multiplied by k_scale * (q_scale * scale), where a zero factor marks an
  invalid slot; p * v_scale is rounded to bf16 and multiplied by the int8 v.

Where they differ: the kernels round p to bf16 relative to a running
maximum (the tensor-core kernel's of each tile, PR 3's of each chunk of M),
:func:`decode_attention_plain` relative to the row's global maximum, so the
two agree to about 1e-2 of max|out|, not bit for bit.
:func:`decode_attention_split_plain` follows the tensor-core kernel's
schedule (tiles, split ranges, the running maximum, the combine's order) and
so agrees with it up to f32 summation order; with ``splits=1`` and the TPU
kernel's block as ``tile`` it follows the TPU kernel's own schedule.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ...utils.device import quotient_f32
from . import _build

__all__ = ["NEG", "HEAD_DIMS", "WIDE_MAX_HD", "K7_TC", "K7Plan", "k7_plan", "k7_tile",
           "supported", "decode_attention", "decode_attention_plain",
           "decode_attention_split_plain", "quantize_query", "wide_max_active_clusters"]

NEG = -0.7 * torch.finfo(torch.float32).max
HEAD_DIMS = (128, 256, 384, 512)  # the head widths both CUDA kernels have an instance for
# The wide instances take every other multiple of 128 up to this width: a
# CTA's 8 heads x 2048 lanes of accumulators (64 floats a thread in the
# tensor-core kernel) are what one SM's registers hold.
WIDE_MAX_HD = 2048
MAX_HEADS_PER_BLOCK = 8  # query heads of one kv head handled by one block
_TARGET_BLOCKS = 264  # two blocks for each of the H100's 132 SMs
_CHUNK_STEP, _CHUNK_MAX = 64, 512
_CHUNK_MAX_WIDE = 256  # the CUDA-core kernel above hd 256 (its chunk_cap: static shared memory)

# The tensor-core kernel (csrc/decode_attention_tc.cu). K7_TC off sends every
# K7 call to PR 3's kernel (the A/Bs' "off" turns); it is read at each call.
K7_TC = True
SMS = 132  # the H100 SXM's streaming multiprocessors
MAX_SPLITS = 16  # the largest thread-block cluster the card takes (non-portable above 8)
# Clusters of each size that the H100 SXM holds at once with this kernel's
# shared memory (two CTAs an SM), from cudaOccupancyMaxActiveClusters: the
# SMs sit in GPCs of unequal size, so 4-CTA clusters reach 62, not 66.
MAX_ACTIVE_CLUSTERS = {1: 264, 2: 132, 3: 79, 4: 62, 5: 47, 6: 39, 7: 32, 8: 30, 9: 23, 10: 21,
                       11: 16, 12: 16, 13: 14, 14: 14, 15: 14, 16: 14}
# The same for the wide instance (hd > 512; one CTA an SM: its shared memory
# is padded past half an SM's), from cudaOccupancyMaxActiveClusters on the
# H100 SXM (wide_max_active_clusters; the card tests hold this table to it).
MAX_ACTIVE_CLUSTERS_WIDE = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15, 9: 9,
                            10: 7, 11: 7, 12: 7, 13: 7, 14: 7, 15: 7, 16: 7}
WIDE_TILE = 16  # the wide instance's positions per tile
_STAGE_DATA = 32768  # bytes of K and V per stage of the kernel's ring (its STAGE_DATA)


class K7Plan(NamedTuple):
    tile: int  # positions per tile of the ring
    splits: int  # CTAs per (row, kv head, head group): one cluster


def _block_m(M: int, quant: bool) -> int:
    for bm in (512 if quant else 256, 256, 128):
        if M % bm == 0:
            return bm
    return 0


def supported(M: int, hd: int, quant: bool) -> bool:
    """The shapes the TPU kernel takes (its predicate, kept for routing)."""
    return hd % 128 == 0 and _block_m(M, quant) > 0


def quantize_query(q: torch.Tensor):
    """(B, 1, H, hd) -> (int8 (B, H, hd), f32 (B, H) per-head scales).

    max|q| / 127 is the correctly rounded f32 quotient on every device, as
    in JAX and in the kernels (:func:`quotient_f32`: on CUDA, PyTorch
    divides by a Python scalar as a product with its reciprocal, an ulp off
    for some heads, and then a code off by one)."""
    qf = q[:, 0].float()
    qs = quotient_f32(qf.abs().amax(dim=-1, keepdim=True), 127.0).clamp_min(1e-20)
    q8 = torch.round(qf / qs).clamp(-127, 127).to(torch.int8)
    return q8, qs[..., 0]


def decode_attention_plain(q, k, v, kv_valid, scale, k_scale=None, v_scale=None):
    """The kernel's function in PyTorch, over the whole of M at once."""
    B, _, H, hd = q.shape
    Hkv = k.shape[2]
    rep = H // Hkv
    valid = kv_valid[:, None, None, :]  # (B, 1, 1, M)
    if k_scale is None:
        qg = q[:, 0].float().reshape(B, Hkv, rep, hd)
        s = torch.einsum("bhrd,bmhd->bhrm", qg, k.float()) * scale
        ok = valid.expand_as(s)
    else:
        q8, qs = quantize_query(q)
        # s8 x s8 products summed in f32: exact integers at hd <= 1024 (the
        # kernels' int32 sums, rounded once to f32, agree to an ulp above)
        s32 = torch.einsum("bhrd,bmhd->bhrm", q8.float().reshape(B, Hkv, rep, hd), k.float())
        ks = torch.where(kv_valid[:, :, None], k_scale[..., 0].float(), 0.0)  # (B, M, Hkv)
        ks = ks.permute(0, 2, 1)[:, :, None, :] * (qs * scale).reshape(B, Hkv, rep, 1)
        ok = ks > 0.0
        s = s32 * ks
    s = torch.where(ok, s, NEG)
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG)
    p = torch.where(ok, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        p = p * v_scale[..., 0].float().permute(0, 2, 1)[:, :, None, :]
    pv = p.to(torch.bfloat16).float()
    acc = torch.einsum("bhrm,bmhd->bhrd", pv, v.float())
    out = acc / l.clamp_min(1e-30)
    return out.reshape(B, 1, H, hd).to(q.dtype)


def k7_tile(hd: int, quant: bool) -> int:
    """The tensor-core kernel's positions per tile (its Cfg::TILE): 32 KB of
    K and V a stage, in whole warps' rows of 16 (at least 16: 24 KB at bf16
    hd 384, 32 KB at hd 512); above hd 512 the wide instance's 16."""
    if hd > max(HEAD_DIMS):
        return WIDE_TILE
    t = _STAGE_DATA // (2 * hd * (1 if quant else 2))
    return t // 16 * 16 if t >= 16 else 16


def k7_plan(B: int, M: int, Hkv: int, rep: int, hd: int, quant: bool) -> K7Plan:
    """The tensor-core kernel's schedule for a shape: its tile (32 KB of K
    and V per stage) and the splits of each (row, kv head, group of <= 8
    query heads): the fewest that give every SM a CTA, within one wave of
    resident clusters (``MAX_ACTIVE_CLUSTERS``), ``MAX_SPLITS`` and the
    tiles of M. So llama-3-8b's 64 (b, kv head) pairs at B 8 split in 3
    (192 CTAs; 4-CTA clusters would need two waves), gemma-2b's 8 in 16 (the
    largest cluster), and llama-2-7b's 256 not at all. Above hd 512 the
    wide instance's table (one CTA an SM). A function of the shapes only."""
    tile = k7_tile(hd, quant)
    pairs = B * Hkv * -(-rep // MAX_HEADS_PER_BLOCK)
    tiles = -(-M // tile)
    table = MAX_ACTIVE_CLUSTERS_WIDE if hd > max(HEAD_DIMS) else MAX_ACTIVE_CLUSTERS
    fits = [s for s in range(1, min(MAX_SPLITS, tiles) + 1) if pairs <= table[s]]
    return K7Plan(tile, min(max(fits, default=1), max(1, -(-SMS // pairs))))


def decode_attention_split_plain(q, k, v, kv_valid, scale, k_scale=None, v_scale=None, *,
                                 tile: int, splits: int):
    """The tensor-core kernel's schedule in PyTorch. Each row's positions up
    to its last valid slot are cut into tiles of ``tile``; split s of
    ``splits`` takes tiles [s * n // splits, (s + 1) * n // splits) of the
    row's n. Each split runs the online softmax tile by tile (the tile's
    maximum joins the running one, p = exp(s - m) in f32, p (int8: p *
    v_scale) rounded to bf16 against it, l and acc rescaled by e^(m_old -
    m)); then the splits combine in split order: out = sum_s e^(m_s - M*)
    acc_s / max(sum_s e^(m_s - M*) l_s, 1e-30). Returns q's dtype."""
    B, _, H, hd = q.shape
    M, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    S = splits
    dev = q.device
    pos = torch.arange(M, device=dev)
    end = torch.where(kv_valid, pos + 1, 0).amax(dim=1)  # (B,): every valid slot lies below
    ntiles = -(-end // tile)
    srange = torch.arange(S, device=dev)
    t_lo = srange[None, :] * ntiles[:, None] // S  # (B, S)
    t_hi = (srange[None, :] + 1) * ntiles[:, None] // S
    quant = k_scale is not None
    if quant:
        q8, qs = quantize_query(q)
        qg = q8.float().reshape(B, Hkv, rep, hd)
        qsc = (qs * scale).reshape(B, 1, Hkv, rep, 1)
    else:
        qg = q[:, 0].float().reshape(B, Hkv, rep, hd)
    m = torch.full((B, S, Hkv, rep), NEG, device=dev)
    l = torch.zeros((B, S, Hkv, rep), device=dev)
    acc = torch.zeros((B, S, Hkv, rep, hd), device=dev)
    bidx = torch.arange(B, device=dev)[:, None, None]
    offs = torch.arange(tile, device=dev)
    for j in range(int((t_hi - t_lo).max()) if B else 0):
        p_ = ((t_lo + j)[..., None] * tile + offs).clamp(max=M - 1)  # (B, S, tile)
        live = ((t_lo + j < t_hi)[..., None] & ((t_lo + j)[..., None] * tile + offs < end[:, None, None])
                & kv_valid[bidx, p_])
        kt, vt = k[bidx, p_].float(), v[bidx, p_].float()  # (B, S, tile, Hkv, hd)
        sc = torch.einsum("bhrd,bsthd->bshrt", qg, kt)
        if quant:
            kst = k_scale[bidx, p_, :, 0].float()  # (B, S, tile, Hkv)
            kst = torch.where(live[..., None], kst, 0.0).permute(0, 1, 3, 2)[:, :, :, None, :]
            kq = kst * qsc  # (B, S, Hkv, rep, tile)
            ok = kq > 0.0
            sc = sc * kq
        else:
            ok = live[:, :, None, None, :].expand_as(sc)
            sc = sc * scale
        sc = torch.where(ok, sc, NEG)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.where(ok, torch.exp(sc - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        m = m_new
        if quant:
            p = p * v_scale[bidx, p_, :, 0].float().permute(0, 1, 3, 2)[:, :, :, None, :]
        pv = p.to(torch.bfloat16).float()
        acc = acc * corr[..., None] + torch.einsum("bshrt,bsthd->bshrd", pv, vt)
    mx = m.amax(dim=1)  # (B, Hkv, rep)
    w = torch.exp(m - mx[:, None])
    den = torch.zeros_like(mx)
    num = torch.zeros((B, Hkv, rep, hd), device=dev)
    for s in range(S):  # the combine's order
        den = den + w[:, s] * l[:, s]
        num = num + w[:, s, ..., None] * acc[:, s]
    out = num / den.clamp_min(1e-30)[..., None]
    return out.reshape(B, 1, H, hd).to(q.dtype)


_lib = None
_tc_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("decode_attention")
        fn = lib.pt2_decode_attention
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_float] + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _tc_kernel_lib():
    global _tc_lib
    if _tc_lib is None:
        lib = _build.load("decode_attention_tc")
        fn = lib.pt2_decode_attention_tc
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_float] + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        occ = lib.pt2_decode_attention_tc_wide_clusters
        occ.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
        occ.restype = ctypes.c_int
        _tc_lib = lib
    return _tc_lib


def chunk_len(B: int, M: int, Hkv: int, rep: int, hd: int) -> int:
    """Positions per block: enough blocks to fill the card (about two per
    SM), in steps of 64, at most 512 (256 above hd 256)."""
    groups = B * Hkv * -(-rep // MAX_HEADS_PER_BLOCK)
    n = -(-_TARGET_BLOCKS // groups)
    c = -(-M // n)
    cap = _CHUNK_MAX if hd <= 256 else _CHUNK_MAX_WIDE
    return min(cap, max(_CHUNK_STEP, -(-c // _CHUNK_STEP) * _CHUNK_STEP))


def _check(q, k, v, kv_valid, k_scale, v_scale):
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"K7 takes q (B, 1, H, hd) and k/v (B, M, Hkv, hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, _, H, hd = q.shape
    Bk, M, Hkv, hdk = k.shape
    if Bk != B or hdk != hd or H % Hkv or hd % 128 or tuple(kv_valid.shape) != (B, M):
        raise ValueError(f"K7 shapes do not fit: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"kv_valid {tuple(kv_valid.shape)} (hd a multiple of 128)")
    if hd > WIDE_MAX_HD:  # JAX's kernel takes any multiple of 128
        raise ValueError(f"K7 takes head widths up to {WIDE_MAX_HD}, not hd={hd}: a CTA's 8 "
                         "heads of accumulators would not fit one SM")
    if q.dtype != torch.bfloat16 or kv_valid.dtype != torch.bool:
        raise TypeError(f"K7 takes bf16 q and bool kv_valid, got {q.dtype}, {kv_valid.dtype}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale come together")
    if k_scale is None:
        if k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
            raise TypeError(f"K7 takes a bf16 cache without scales, got {k.dtype}")
    else:
        if k.dtype != torch.int8 or v.dtype != torch.int8:
            raise TypeError(f"K7 takes an int8 cache with scales, got {k.dtype}")
        for s in (k_scale, v_scale):
            if s.dtype != torch.float32 or tuple(s.shape) != (B, M, Hkv, 1):
                raise ValueError(f"scales must be f32 (B, M, Hkv, 1), got {s.dtype} "
                                 f"{tuple(s.shape)}")
    for t in (q, k, v, kv_valid) + (() if k_scale is None else (k_scale, v_scale)):
        if t.device != q.device:
            raise ValueError(f"K7 operands must all lie on {q.device}")
        if not t.is_contiguous():
            raise ValueError("K7 operands must be contiguous")
    if k.data_ptr() % 16 or v.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("K7 reads q and the cache in 16-byte pieces: they must be 16-byte "
                         "aligned")


def decode_attention(q, k, v, kv_valid, scale, k_scale=None, v_scale=None):
    """(B, 1, H, hd) q against the (B, M, Hkv, hd) cache -> (B, 1, H, hd) in
    q's dtype.

    CUDA: with ``K7_TC`` one launch of the tensor-core kernel on the current
    stream (counted in ``decode_attention.launches`` and
    ``decode_attention.launches_tc``); without, PR 3's chunk kernel and its
    combine (one count in ``launches``). Either counts in
    ``decode_attention.launches_hd256`` at hd 256, in
    ``decode_attention.launches_wide`` above hd 256, and in
    ``decode_attention.launches_wide_rt`` above hd 512 (the wide instances,
    the width at run time). CPU: the plain version."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, kv_valid, scale, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no K7 for device {q.device}")
    kv_valid = kv_valid.contiguous()  # (B, M) bytes; the lockstep decode expands one row
    _check(q, k, v, kv_valid, k_scale, v_scale)
    B, _, H, hd = q.shape
    M, Hkv = k.shape[1], k.shape[2]
    quant = k_scale is not None
    dev = q.device
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    didx = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty((B, 1, H, hd), dtype=q.dtype, device=dev)
    tc = K7_TC
    if tc:
        plan = k7_plan(B, M, Hkv, H // Hkv, hd, quant)
        rc = _tc_kernel_lib().pt2_decode_attention_tc(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_valid.data_ptr(), ptr(k_scale),
            ptr(v_scale), out.data_ptr(), float(scale), B, M, H, Hkv, hd, plan.splits,
            int(quant), didx, stream)
    else:
        chunk = chunk_len(B, M, Hkv, H // Hkv, hd)
        nchunk = -(-M // chunk)
        part_acc = torch.empty((B, H, nchunk, hd), dtype=torch.float32, device=dev)
        part_ml = torch.empty((B, H, nchunk, 2), dtype=torch.float32, device=dev)
        rc = _kernel_lib().pt2_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_valid.data_ptr(),
            ptr(k_scale), ptr(v_scale), part_acc.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
            float(scale), B, M, H, Hkv, hd, chunk, int(quant), didx, stream)
    if rc != 0:
        raise RuntimeError(f"K7 launch failed ({'tensor-core' if tc else 'CUDA-core'} kernel): "
                           f"cudaError {rc}")
    decode_attention.launches += 1
    decode_attention.launches_tc += tc
    decode_attention.launches_hd256 += hd == 256
    decode_attention.launches_wide += hd > 256
    decode_attention.launches_wide_rt += hd > max(HEAD_DIMS)
    return out


decode_attention.launches = 0
decode_attention.launches_tc = 0
decode_attention.launches_hd256 = 0
decode_attention.launches_wide = 0
decode_attention.launches_wide_rt = 0


def wide_max_active_clusters(M: int, hd: int, quant: bool, splits: int, device=None) -> int:
    """cudaOccupancyMaxActiveClusters of the tensor-core kernel's wide
    instance (hd > 512) for clusters of ``splits`` CTAs at this shape: what
    ``MAX_ACTIVE_CLUSTERS_WIDE`` records. Needs the card."""
    dev = torch.device("cuda" if device is None else device)
    didx = dev.index if dev.index is not None else torch.cuda.current_device()
    n = ctypes.c_int(0)
    rc = _tc_kernel_lib().pt2_decode_attention_tc_wide_clusters(
        M, hd, int(quant), splits, didx, ctypes.addressof(n))
    if rc != 0:
        raise RuntimeError(f"K7 wide occupancy query failed: cudaError {rc}")
    return n.value
