"""K7: single-query decode attention over the KV cache, its plain version
and its wrapper.

``decode_attention`` is the one entry point. On CUDA tensors it launches the
hand-written kernel in ``csrc/decode_attention.cu`` (which replaces
``pt2tpu/ops/kernels/pallas_attention.py:decode_attention_pallas``) or
raises; on CPU tensors it runs :func:`decode_attention_plain`. There is no
fallback from the kernel to the plain version.

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

Where the two differ: the kernel rounds p to bf16 relative to the running
maximum of each chunk of M, the plain version relative to the row's global
maximum, so the two agree to about 1e-2 of max|out|, not bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["NEG", "HEAD_DIMS", "supported", "decode_attention", "decode_attention_plain",
           "quantize_query"]

NEG = -0.7 * torch.finfo(torch.float32).max
HEAD_DIMS = (128, 256)  # the head widths the CUDA kernel is built for
MAX_HEADS_PER_BLOCK = 8  # query heads of one kv head handled by one block
_TARGET_BLOCKS = 264  # two blocks for each of the H100's 132 SMs
_CHUNK_STEP, _CHUNK_MAX = 64, 512


def _block_m(M: int, quant: bool) -> int:
    for bm in (512 if quant else 256, 256, 128):
        if M % bm == 0:
            return bm
    return 0


def supported(M: int, hd: int, quant: bool) -> bool:
    """The shapes the TPU kernel takes (its predicate, kept for routing)."""
    return hd % 128 == 0 and _block_m(M, quant) > 0


def quantize_query(q: torch.Tensor):
    """(B, 1, H, hd) -> (int8 (B, H, hd), f32 (B, H) per-head scales)."""
    qf = q[:, 0].float()
    qs = (qf.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-20)
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
        # s8 x s8 products summed in f32 are exact integers at hd <= 1024
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


_lib = None


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


def chunk_len(B: int, M: int, Hkv: int, rep: int) -> int:
    """Positions per block: enough blocks to fill the card (about two per
    SM), in steps of 64, at most 512."""
    groups = B * Hkv * -(-rep // MAX_HEADS_PER_BLOCK)
    n = -(-_TARGET_BLOCKS // groups)
    c = -(-M // n)
    return min(_CHUNK_MAX, max(_CHUNK_STEP, -(-c // _CHUNK_STEP) * _CHUNK_STEP))


def _check(q, k, v, kv_valid, k_scale, v_scale):
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"K7 takes q (B, 1, H, hd) and k/v (B, M, Hkv, hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, _, H, hd = q.shape
    Bk, M, Hkv, hdk = k.shape
    if Bk != B or hdk != hd or H % Hkv or hd % 128 or tuple(kv_valid.shape) != (B, M):
        raise ValueError(f"K7 shapes do not fit: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"kv_valid {tuple(kv_valid.shape)} (hd a multiple of 128)")
    if hd not in HEAD_DIMS:
        raise NotImplementedError(f"K7 is built for head widths {HEAD_DIMS}, not hd={hd}")
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
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("K7 reads the cache in 16-byte pieces: k/v must be 16-byte aligned")


def decode_attention(q, k, v, kv_valid, scale, k_scale=None, v_scale=None):
    """(B, 1, H, hd) q against the (B, M, Hkv, hd) cache -> (B, 1, H, hd) in
    q's dtype.

    CUDA: launches K7 (the chunk kernel and its combine, counted as one
    launch in ``decode_attention.launches``, and at hd 256 also in
    ``decode_attention.launches_hd256``) on the current stream. CPU: the
    plain version."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, kv_valid, scale, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no K7 for device {q.device}")
    kv_valid = kv_valid.contiguous()  # (B, M) bytes; the lockstep decode expands one row
    _check(q, k, v, kv_valid, k_scale, v_scale)
    B, _, H, hd = q.shape
    M, Hkv = k.shape[1], k.shape[2]
    quant = k_scale is not None
    chunk = chunk_len(B, M, Hkv, H // Hkv)
    nchunk = -(-M // chunk)
    dev = q.device
    part_acc = torch.empty((B, H, nchunk, hd), dtype=torch.float32, device=dev)
    part_ml = torch.empty((B, H, nchunk, 2), dtype=torch.float32, device=dev)
    out = torch.empty((B, 1, H, hd), dtype=q.dtype, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = _kernel_lib().pt2_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_valid.data_ptr(),
        ptr(k_scale), ptr(v_scale), part_acc.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
        float(scale), B, M, H, Hkv, hd, chunk, int(quant),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"K7 launch failed: cudaError {rc}")
    decode_attention.launches += 1
    decode_attention.launches_hd256 += hd == 256
    return out


decode_attention.launches = 0
decode_attention.launches_hd256 = 0
