"""2-bit ternary plane packing — the same bytes as ``pt2tpu.core.packing``.

Layout contract ("contraction-major, plane-interleaved"):

  * Input codes ``T`` are (n, K) in visit order, values in {-1, 0, +1}.
  * ``packed`` is (K // 4, n) int8. For scale-block b and row r in
    [0, block_size // 4), byte ``packed[b * bs4 + r, j]`` holds the four
    codes for visit-columns ``b*bs + p*bs4 + r`` (p = plane 0..3) of output
    feature j, with code ``T + 1`` in {0, 1, 2} in bits 2p..2p+1.

The storage type is int8, so ``>>`` on it is an arithmetic shift: the bytes
are viewed as uint8 before unpacking (the mask alone would also do).
"""

from __future__ import annotations

import torch

__all__ = ["pack_ternary", "unpack_ternary"]


def pack_ternary(T: torch.Tensor, block_size: int = 128) -> torch.Tensor:
    """Pack (n, K) ternary codes {-1,0,+1} into (K//4, n) int8 planes."""
    n, K = T.shape
    if block_size % 4 != 0:
        raise ValueError(f"block_size must be divisible by 4, got {block_size}")
    if K % block_size != 0:
        raise ValueError(f"K={K} not a multiple of block_size={block_size}")
    bs4 = block_size // 4
    nb = K // block_size
    u = (T.to(torch.int16) + 1).to(torch.uint8)  # {-1,0,1} -> {0,1,2}
    # (K, n) contraction-major, split [b, p, r] with column = b*bs + p*bs4 + r.
    ut = u.t().reshape(nb, 4, bs4, n)
    packed = ut[:, 0] | (ut[:, 1] << 2) | (ut[:, 2] << 4) | (ut[:, 3] << 6)
    return packed.reshape(K // 4, n).contiguous().view(torch.int8)


def unpack_ternary(packed: torch.Tensor, block_size: int = 128) -> torch.Tensor:
    """Inverse of :func:`pack_ternary`: (K//4, n) int8 -> (K, n) int8 in
    {-1,0,+1}, rows in visit-column order."""
    K4, n = packed.shape
    bs4 = block_size // 4
    if K4 % bs4 != 0:
        raise ValueError(f"packed rows {K4} not a multiple of block_size/4={bs4}")
    nb = K4 // bs4
    pr = packed.view(torch.uint8).reshape(nb, bs4, n)
    planes = [(pr >> (2 * p)) & 3 for p in range(4)]
    stacked = torch.cat(planes, dim=1)  # (nb, bs, n), row = p*bs4 + r
    return (stacked.reshape(nb * block_size, n).to(torch.int8) - 1)

