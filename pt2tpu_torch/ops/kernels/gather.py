"""The SSR input gather kernels K4 and K5: plain versions and wrappers.

  * K4 ``onehot_gather``: x[:, perm] (replaces
    ``pt2tpu/ops/kernels/pallas_gather.py:onehot_iota_pallas``), on the path
    :func:`k4_path` names: ``csrc/onehot_gather_rows.cu`` (x's rows staged in
    shared memory by bulk copies, perm held in registers, 16-byte stores),
    ``csrc/onehot_gather.cu`` (an indexed load per lane) for the shapes it
    refuses (a row of x over 64 KB, K not a multiple of 8).
  * K5 ``onehot_matmul``: x @ G with G the packed one-hot planes
    (replaces ``onehot_matmul_pallas``), on the path :func:`k5_path` names:
    ``csrc/onehot_matmul_rows.cu`` at rows >= :data:`K5_ROWS_MIN_ROWS` (the
    planes decoded once into a lane map, then x's rows staged in shared
    memory and gathered), ``csrc/onehot_matmul.cu`` below.

  * K4s / K5s ``onehot_gather_idx`` / ``onehot_matmul_idx``: K4 and K5 on
    one slot of a whole stack, the slot read by the kernel from device
    memory (replace ``onehot_iota_pallas_stacked`` and
    ``onehot_matmul_pallas_stacked`` with a traced index: a routed expert's
    gather), on K4's two kernels as :func:`k4_path` chooses and on K5's
    first kernel (its rows path, from :data:`K5_ROWS_MIN_ROWS` rows, takes
    no device index).

On a CUDA tensor each wrapper launches its hand-written kernel or raises; on
a CPU tensor it runs the plain version below. There is no fallback from a
kernel to its plain version. The ``_stacked`` TPU variants at a host index
collapse into these: a stacked layer is the zero-copy view ``perm[li]`` /
``packed[li]``; at a device index they are K4s and K5s.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["K4_ROWS_MAX_ROW_BYTES", "K4_ROWS_MIN_ROWS", "K5_MAP_FIELDS", "K5_ROWS_MAX_ROW_BYTES",
           "K5_ROWS_MIN_ROWS", "k4_path", "k5_path", "onehot_gather", "onehot_gather_idx",
           "onehot_gather_idx_plain", "onehot_gather_plain", "onehot_lane_map_plain",
           "onehot_matmul", "onehot_matmul_idx", "onehot_matmul_idx_plain",
           "onehot_matmul_plain", "onehot_matmul_rows_plain", "onehot_planes", "slot_view"]

K4_ROWS_MIN_ROWS = 1
"""The fewest rows K4 runs on its rows path (``csrc/onehot_gather_rows.cu``).
On an H100 the rows path is no slower at 1 row and faster from 16 (PERF.md
§6), so every row count takes it; ``csrc/onehot_gather.cu`` serves the
shapes the rows path refuses. On the main path K4 runs at more than 64 rows
(K3 takes rows 1-64). Rebound to ``1 << 30``, it sends every call to the
first kernel (``chip_smoke.py``'s "off" turns). Read at each call."""

K4_ROWS_MAX_ROW_BYTES = 65536
"""The widest row of x (m x element bytes) the rows path stages in shared
memory."""

K5_ROWS_MIN_ROWS = 16
"""The fewest rows K5 runs on its rows path (``csrc/onehot_matmul_rows.cu``);
fewer take ``csrc/onehot_matmul.cu``. On an H100 the rows path's two
launches take less time than that kernel at every row count timed, 16 to 512
(``chip_smoke.py`` 18c, PERF.md §6); below 16 it was not timed. Rebound to
``1 << 30``, it sends every call to that kernel (``chip_smoke.py``'s "off"
turns). Read at each call."""

K5_ROWS_MAX_ROW_BYTES = 65536
"""The widest row of x (m x element bytes) the rows path stages in shared
memory: up to m = 8192 in f32 (llama-2-70b's width)."""

K5_MAP_FIELDS = 4
"""E: the fields per lane the rows path's lane map holds; a lane with more
walks its column of G."""


def k4_path(rows: int, m: int, K: int, elem_bytes: int) -> str:
    """Which of K4's kernels :func:`onehot_gather` launches on CUDA: "rows"
    (``pt2_onehot_gather_rows``: x's rows staged in shared memory, 8 lanes a
    thread) for rows >= K4_ROWS_MIN_ROWS with a row of x of at most
    K4_ROWS_MAX_ROW_BYTES and K % 8 == 0; else "cuda_core"
    (``pt2_onehot_gather``)."""
    if rows >= K4_ROWS_MIN_ROWS and m * elem_bytes <= K4_ROWS_MAX_ROW_BYTES and K % 8 == 0:
        return "rows"
    return "cuda_core"


def k5_path(rows: int, m: int, elem_bytes: int) -> str:
    """Which of K5's kernels :func:`onehot_matmul` launches on CUDA: "rows"
    (``pt2_onehot_matmul_rows``: the lane map, then the rows gathered from
    shared memory) for rows >= K5_ROWS_MIN_ROWS with a row of x of at most
    K5_ROWS_MAX_ROW_BYTES; else "cuda_core" (``pt2_onehot_matmul``)."""
    if rows >= K5_ROWS_MIN_ROWS and m * elem_bytes <= K5_ROWS_MAX_ROW_BYTES:
        return "rows"
    return "cuda_core"


def onehot_gather_plain(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Index form: out[..., k] = x[..., perm[k]], and +0 where perm[k] >= m
    (pad lanes point at m). A zero column is appended at index m, so the
    result copies x's bits in any dtype (-0.0 and NaN payloads included), as
    both of K4's kernels do."""
    m = x.shape[-1]
    idx = perm.to(device=x.device, dtype=torch.long).clamp(max=m)
    return torch.index_select(F.pad(x, (0, 1)), -1, idx)


def slot_view(stack: torch.Tensor, sel: torch.Tensor, base: int = 0) -> torch.Tensor:
    """Slot ``base + sel`` of a stacked leaf, taken with ``index_select`` on
    the stack's device (a copy; ``sel`` is never read on the host). The
    device-index plain versions and the plain route use it."""
    return stack.index_select(0, sel.reshape(1).to(torch.long) + base)[0]


def onehot_gather_idx_plain(x: torch.Tensor, perm: torch.Tensor, sel: torch.Tensor,
                            base: int = 0) -> torch.Tensor:
    """K4s's plain version: K4's on slot ``base + sel`` of an (S, K) perm
    stack."""
    return onehot_gather_plain(x, slot_view(perm, sel, base))


def onehot_matmul_idx_plain(x: torch.Tensor, gpacked: torch.Tensor, sel: torch.Tensor,
                            base: int = 0) -> torch.Tensor:
    """K5s's plain version: K5's on slot ``base + sel`` of an (S, D//4, K)
    planes stack."""
    return onehot_matmul_plain(x, slot_view(gpacked, sel, base))


def onehot_planes(gpacked: torch.Tensor) -> torch.Tensor:
    """(D//4, K) int8 packed planes -> (D, K) uint8 raw 2-bit fields u, row =
    feature. Byte [blk*32 + r, k] holds the fields of features
    blk*128 + p*32 + r in bits 2p..2p+1 (the pack layout at block 128). The
    field is the stored code + 1, so a one-hot plane holds u in {0, 1}."""
    D4, K = gpacked.shape
    if D4 % 32:
        raise ValueError(f"packed one-hot rows {D4} not a multiple of 32")
    pr = gpacked.view(torch.uint8).reshape(D4 // 32, 32, K)
    return torch.cat([(pr >> (2 * p)) & 3 for p in range(4)], dim=1).reshape(D4 * 4, K)


def onehot_matmul_plain(x: torch.Tensor, gpacked: torch.Tensor) -> torch.Tensor:
    """out = x @ u: (rows, m) x (D//4, K) planes -> (rows, K) in x's dtype,
    as ``onehot_matmul_pallas`` computes it: x zero-padded from m to D
    features, a real f32 product with the raw fields u (not the {-1, 0, +1}
    codes), so it is x @ G for any planes and, for a one-hot G and finite
    x, bit-exact to the index form."""
    D = gpacked.shape[0] * 4
    m = x.shape[-1]
    if m > D:
        raise ValueError(f"x width {m} exceeds the gather's {D} features")
    u = onehot_planes(gpacked).float()
    return (F.pad(x.float(), (0, D - m)) @ u).to(x.dtype)


def onehot_lane_map_plain(gpacked: torch.Tensor, m: int) -> torch.Tensor:
    """The lane map the rows path's first launch writes, int32 of (1 + E) * K
    (E = K5_MAP_FIELDS): lane k's count of nonzero fields (i, u) with i < m,
    then E entry planes, entry e of lane k = (i << 2) | u for the fields in
    increasing i while e < count <= E, else -1 (all E of a lane with more
    than E fields: it walks its column)."""
    E = K5_MAP_FIELDS
    u = onehot_planes(gpacked)[:m].to(torch.int32)  # (m, K)
    K = u.shape[1]
    nz = u != 0
    counts = nz.sum(0, dtype=torch.int32)
    # the first E features of each lane, in increasing i: the rank of each
    # nonzero field within its lane
    rank = torch.cumsum(nz.to(torch.int32), 0) - 1
    feat = torch.arange(u.shape[0], dtype=torch.int32, device=u.device)[:, None].expand_as(u)
    entries = torch.full((E, K), -1, dtype=torch.int32, device=u.device)
    keep = nz & (rank < E) & (counts <= E)[None, :]
    lane = torch.arange(K, device=u.device)[None, :].expand_as(u)
    entries[rank[keep].long(), lane[keep]] = (feat[keep] << 2) | u[keep]
    return torch.cat([counts, entries.reshape(-1)])


def onehot_matmul_rows_plain(x: torch.Tensor, gpacked: torch.Tensor) -> torch.Tensor:
    """x @ G as the rows path sums it: per lane, f32, the nonzero fields in
    increasing feature order, each product rounded before it is added, the
    first product the sum's start (a lane with no field gives +0.0); the
    result in x's dtype. Equal to :func:`onehot_matmul_plain` bit for bit on
    one-hot planes."""
    m = x.shape[-1]
    if m > gpacked.shape[0] * 4:
        raise ValueError(f"x width {m} exceeds the gather's {gpacked.shape[0] * 4} features")
    u = onehot_planes(gpacked)[:m]  # (m, K)
    K = u.shape[1]
    lane, feat = u.t().nonzero(as_tuple=True)  # by lane, then increasing feature
    counts = torch.bincount(lane, minlength=K)
    width = int(counts.max()) if lane.numel() else 0
    pos = torch.arange(lane.numel(), device=u.device) - (torch.cumsum(counts, 0) - counts)[lane]
    idx = torch.zeros((width, K), dtype=torch.long, device=u.device)
    val = torch.zeros((width, K), dtype=torch.float32, device=u.device)
    idx[pos, lane] = feat
    val[pos, lane] = u[feat, lane].float()
    xf = x.float()
    acc = torch.zeros((x.shape[0], K), dtype=torch.float32, device=x.device)
    for f in range(width):
        v = val[f] * xf[:, idx[f]]
        acc = torch.where(counts > 0, v, acc) if f == 0 else torch.where(counts > f, acc + v, acc)
    return acc.to(x.dtype)


_lib = None
_gather_rows_lib = None
_mm_lib = None
_rows_lib = None


# the device-index C entries: x, the stack, out, then 4 ints, sel, base, S,
# device, stream
_IDX_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p] + [ctypes.c_int] * 3 \
    + [ctypes.c_void_p]


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("onehot_gather")
        fn = lib.pt2_onehot_gather
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.pt2_onehot_gather_idx
        fn.argtypes = _IDX_ARGS
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _gather_rows_kernel_lib():
    global _gather_rows_lib
    if _gather_rows_lib is None:
        lib = _build.load("onehot_gather_rows")
        fn = lib.pt2_onehot_gather_rows
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.pt2_onehot_gather_rows_plan
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.pt2_onehot_gather_rows_idx
        fn.argtypes = _IDX_ARGS
        fn.restype = ctypes.c_int
        _gather_rows_lib = lib
    return _gather_rows_lib


def _mm_kernel_lib():
    global _mm_lib
    if _mm_lib is None:
        lib = _build.load("onehot_matmul")
        fn = lib.pt2_onehot_matmul
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.pt2_onehot_matmul_idx
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p] \
            + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _mm_lib = lib
    return _mm_lib


def _rows_kernel_lib():
    global _rows_lib
    if _rows_lib is None:
        lib = _build.load("onehot_matmul_rows")
        fn = lib.pt2_onehot_matmul_rows
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.pt2_onehot_lane_map
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _rows_lib = lib
    return _rows_lib


def onehot_gather(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """(rows, m) x (K,) int32 perm -> (rows, K) in x's dtype.

    CUDA: launches K4 on the current stream on the path :func:`k4_path`
    names, read at each call ("rows": ``csrc/onehot_gather_rows.cu``, perm
    read as 16-byte vectors, a copy if it is not aligned so; "cuda_core":
    ``csrc/onehot_gather.cu``), and counts the call in
    ``onehot_gather.launches`` (the rows path also in
    ``onehot_gather.launches_rows``); x must be bf16 or f32. Neither path
    keeps scratch or per-stream state, so a CUDA graph may capture it. A
    launch that fails raises. CPU: the plain version."""
    if x.device.type == "cpu":
        return onehot_gather_plain(x, perm)
    if x.device.type != "cuda":
        raise ValueError(f"no K4 for device {x.device}")
    if x.dim() != 2 or perm.dim() != 1:
        raise ValueError(f"K4 takes x (rows, m) and perm (K,), got {tuple(x.shape)}, "
                         f"{tuple(perm.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"K4 takes bf16 or f32 x, got {x.dtype}")
    if perm.dtype != torch.int32:
        raise TypeError(f"perm must be int32, got {perm.dtype}")
    if perm.device != x.device or not perm.is_contiguous():
        raise ValueError(f"perm must be contiguous on {x.device}")
    rows, m = x.shape
    K = perm.shape[0]
    x = x.contiguous()
    out = torch.empty((rows, K), dtype=x.dtype, device=x.device)
    if rows == 0 or K == 0:
        return out
    device = x.device.index if x.device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if k4_path(rows, m, K, x.element_size()) == "rows":
        if perm.data_ptr() % 16:
            perm = perm.clone()
        rc = _gather_rows_kernel_lib().pt2_onehot_gather_rows(
            x.data_ptr(), perm.data_ptr(), out.data_ptr(), rows, m, K, x.element_size(), device,
            stream)
        if rc != 0:
            raise RuntimeError(f"K4 ('rows' path) launch failed: cudaError {rc}")
        onehot_gather.launches += 1
        onehot_gather.launches_rows += 1
        return out
    rc = _kernel_lib().pt2_onehot_gather(
        x.data_ptr(), perm.data_ptr(), out.data_ptr(), rows, m, K, x.element_size(), device,
        stream)
    if rc != 0:
        raise RuntimeError(f"K4 launch failed: cudaError {rc}")
    onehot_gather.launches += 1
    return out


onehot_gather.launches = 0
onehot_gather.launches_rows = 0


def onehot_matmul(x: torch.Tensor, gpacked: torch.Tensor) -> torch.Tensor:
    """(rows, m) x (D//4, K) int8 packed one-hot planes -> (rows, K) in x's
    dtype: x @ G.

    CUDA: launches K5 on the current stream on the path :func:`k5_path`
    names, read at each call ("rows": the lane map, then the rows, from one C
    entry, with the stream's map scratch, :func:`_k5_map`; "cuda_core":
    ``csrc/onehot_matmul.cu``), and counts the call in
    ``onehot_matmul.launches`` (the rows path also in
    ``onehot_matmul.launches_rows``); x must be bf16 or f32. A launch that
    fails raises. CPU: the plain version."""
    if x.device.type == "cpu":
        return onehot_matmul_plain(x, gpacked)
    if x.device.type != "cuda":
        raise ValueError(f"no K5 for device {x.device}")
    if x.dim() != 2 or gpacked.dim() != 2:
        raise ValueError(f"K5 takes x (rows, m) and planes (D//4, K), got {tuple(x.shape)}, "
                         f"{tuple(gpacked.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"K5 takes bf16 or f32 x, got {x.dtype}")
    if gpacked.dtype != torch.int8:
        raise TypeError(f"the planes must be int8, got {gpacked.dtype}")
    if gpacked.device != x.device or not gpacked.is_contiguous() or gpacked.data_ptr() % 4:
        raise ValueError(f"the planes must be contiguous and 4-byte aligned on {x.device}")
    rows, m = x.shape
    D4, K = gpacked.shape
    if D4 % 32 or K % 128 or m > D4 * 4:
        raise ValueError(f"bad one-hot shapes: planes {tuple(gpacked.shape)} for x width {m}")
    x = x.contiguous()
    out = torch.empty((rows, K), dtype=x.dtype, device=x.device)
    if rows == 0:
        return out
    if k5_path(rows, m, x.element_size()) == "rows":
        _onehot_matmul_rows(x, gpacked, out)
        return out
    rc = _mm_kernel_lib().pt2_onehot_matmul(
        x.data_ptr(), gpacked.data_ptr(), out.data_ptr(), rows, m, D4, K, x.element_size(),
        x.device.index if x.device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"K5 launch failed: cudaError {rc}")
    onehot_matmul.launches += 1
    return out


onehot_matmul.launches = 0
onehot_matmul.launches_rows = 0

_k5_maps: dict = {}


def _k5_map(device, stream, K):
    """The rows path's lane map scratch for launches on ``stream``: int32 of
    (1 + K5_MAP_FIELDS) * K, kept between calls. It is the stream's own, so
    the launches that write and read it are ordered by their stream and
    never overlap; a CUDA graph capture is refused."""
    if torch.cuda.is_current_stream_capturing():
        raise NotImplementedError("K5's rows path inside a CUDA graph capture")
    buf = _k5_maps.get((device, stream))
    if buf is None or buf.numel() < (1 + K5_MAP_FIELDS) * K:
        buf = torch.empty((1 + K5_MAP_FIELDS) * K, dtype=torch.int32,
                          device=torch.device("cuda", device))
        _k5_maps[(device, stream)] = buf
    return buf


def _onehot_matmul_rows(x, gpacked, out):
    """K5's rows path into ``out``: x (rows, m) contiguous, bf16 or f32; the
    planes read as 16-byte vectors (a copy if they are not aligned so)."""
    rows, m = x.shape
    D4, K = gpacked.shape
    if gpacked.data_ptr() % 16:
        gpacked = gpacked.clone()
    device = x.device.index if x.device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _rows_kernel_lib().pt2_onehot_matmul_rows(
        x.data_ptr(), gpacked.data_ptr(), _k5_map(device, stream, K).data_ptr(), out.data_ptr(),
        rows, m, D4, K, x.element_size(), device, stream)
    if rc != 0:
        raise RuntimeError(f"K5 ('rows' path) launch failed: cudaError {rc}")
    onehot_matmul.launches += 1
    onehot_matmul.launches_rows += 1


# ------------------------------------------------ device-index entries ----
# K4s and K5s (``onehot_iota_pallas_stacked`` / ``onehot_matmul_pallas_stacked``
# with a traced index): the perm or planes are a whole contiguous stack of S
# slots and the slot, ``base`` + the int32 that ``sel`` points at, is read by
# the kernel from device memory, so a routed expert's index never goes to
# the host. A slot outside [0, S) traps in the kernel.


def _check_idx(x, stack, sel, what):
    """Checks the operands common to K4s and K5s: x (rows, m) bf16 or f32 on
    CUDA, a contiguous stack on x's device, ``sel`` one int32 there."""
    if x.dim() != 2:
        raise ValueError(f"{what} takes x (rows, m), got {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what} takes bf16 or f32 x, got {x.dtype}")
    if stack.device != x.device or not stack.is_contiguous():
        raise ValueError(f"{what}'s stack must be contiguous on {x.device}")
    if sel.dtype != torch.int32 or sel.numel() != 1 or sel.device != x.device:
        raise ValueError(f"sel must be one int32 on {x.device}, got {sel.dtype} "
                         f"{tuple(sel.shape)} on {sel.device}")


def onehot_gather_idx(x: torch.Tensor, perm: torch.Tensor, sel: torch.Tensor,
                      base: int = 0) -> torch.Tensor:
    """K4s: x[:, perm[base + sel]]: (rows, m) x (S, K) int32 perm stack ->
    (rows, K) in x's dtype, with ``sel`` one int32 on x's device that only
    the kernel reads.

    CUDA: on the path :func:`k4_path` names, "rows" through
    ``pt2_onehot_gather_rows_idx`` (the stack's base must be 16-byte
    aligned; each slot is, as K % 8 == 0), "cuda_core" through
    ``pt2_onehot_gather_idx``. Counts the call in
    ``onehot_gather_idx.launches`` (the rows path also in
    ``onehot_gather_idx.launches_rows``), not in K4's counters. No scratch:
    a CUDA graph may capture it. CPU: the plain version."""
    if x.device.type == "cpu":
        return onehot_gather_idx_plain(x, perm, sel, base)
    if x.device.type != "cuda":
        raise ValueError(f"no K4s for device {x.device}")
    _check_idx(x, perm, sel, "K4s")
    if perm.dim() != 2 or perm.dtype != torch.int32:
        raise ValueError(f"K4s takes an (S, K) int32 perm stack, got {perm.dtype} "
                         f"{tuple(perm.shape)}")
    rows, m = x.shape
    S, K = perm.shape
    x = x.contiguous()
    out = torch.empty((rows, K), dtype=x.dtype, device=x.device)
    if rows == 0 or K == 0:
        return out
    device = x.device.index if x.device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    path = k4_path(rows, m, K, x.element_size())
    if path == "rows":
        if perm.data_ptr() % 16:
            raise ValueError(f"K4s's rows path reads perm {tuple(perm.shape)} as 16-byte "
                             "vectors: its stack must be 16-byte aligned")
        fn = _gather_rows_kernel_lib().pt2_onehot_gather_rows_idx
    else:
        fn = _kernel_lib().pt2_onehot_gather_idx
    rc = fn(x.data_ptr(), perm.data_ptr(), out.data_ptr(), rows, m, K, x.element_size(),
            sel.data_ptr(), base, S, device, stream)
    if rc != 0:
        raise RuntimeError(f"K4s ({path!r} path) launch failed: cudaError {rc}")
    onehot_gather_idx.launches += 1
    onehot_gather_idx.launches_rows += path == "rows"
    return out


onehot_gather_idx.launches = 0
onehot_gather_idx.launches_rows = 0


def onehot_matmul_idx(x: torch.Tensor, gpacked: torch.Tensor, sel: torch.Tensor,
                      base: int = 0) -> torch.Tensor:
    """K5s: x @ G[base + sel]: (rows, m) x (S, D//4, K) int8 planes stack ->
    (rows, K) in x's dtype, with ``sel`` one int32 on x's device that only
    the kernel reads.

    CUDA: K5's first kernel, ``pt2_onehot_matmul_idx``, where :func:`k5_path`
    says "cuda_core" (rows 1 .. K5_ROWS_MIN_ROWS - 1: the decode rows); its
    rows path takes no device index and raises. Counts the call in
    ``onehot_matmul_idx.launches``, not in K5's. CPU: the plain version."""
    if x.device.type == "cpu":
        return onehot_matmul_idx_plain(x, gpacked, sel, base)
    if x.device.type != "cuda":
        raise ValueError(f"no K5s for device {x.device}")
    _check_idx(x, gpacked, sel, "K5s")
    if gpacked.dim() != 3 or gpacked.dtype != torch.int8:
        raise ValueError(f"K5s takes an (S, D//4, K) int8 planes stack, got {gpacked.dtype} "
                         f"{tuple(gpacked.shape)}")
    rows, m = x.shape
    S, D4, K = gpacked.shape
    if D4 % 32 or K % 128 or m > D4 * 4:
        raise ValueError(f"bad one-hot shapes: planes {tuple(gpacked.shape)} for x width {m}")
    if gpacked.data_ptr() % 4:
        raise ValueError(f"K5s reads the planes {tuple(gpacked.shape)} as 4-byte words: its "
                         "stack must be 4-byte aligned")
    path = k5_path(rows, m, x.element_size())
    if path != "cuda_core":
        raise NotImplementedError(f"K5's {path!r} path takes no device index ({rows} rows)")
    x = x.contiguous()
    out = torch.empty((rows, K), dtype=x.dtype, device=x.device)
    if rows == 0:
        return out
    rc = _mm_kernel_lib().pt2_onehot_matmul_idx(
        x.data_ptr(), gpacked.data_ptr(), out.data_ptr(), rows, m, D4, K, x.element_size(),
        sel.data_ptr(), base, S,
        x.device.index if x.device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"K5s launch failed: cudaError {rc}")
    onehot_matmul_idx.launches += 1
    return out


onehot_matmul_idx.launches = 0
