// Single-query decode attention over the KV cache for Hopper (sm_90a), on
// the tensor cores: kernel K7 of the port, redesigned.
//
// Replaces pt2tpu/ops/kernels/pallas_attention.py:decode_attention_pallas
// (its bf16 kernel and its int8 kernels; the "hb" and "bh" layouts share
// one function). The contract is in pt2tpu_torch/ops/kernels/attention.py:
// q (B, 1, H, hd) bf16 against k/v (B, M, Hkv, hd) in bf16, or in int8 with
// f32 (B, M, Hkv) scales; query head h reads kv head h / rep; invalid slots
// are left out; p (int8: p * v_scale) is rounded to bf16 against the running
// maximum of each tile, as the TPU kernel rounds the operand of its P.V dot.
// csrc/decode_attention.cu (the first port: all of M, two passes on the CUDA
// cores, a second launch to combine) stays for A/Bs behind attention.K7_TC.
//
// What bounds it: bytes. A call must read the K/V slots up to each row's
// last valid slot once (4 flops per element and query head of the group,
// far below the card's flops per byte). So the design reads no tile past
// the one that holds a row's last valid slot, keeps 32 KB a stage in flight
// whatever the element width, and does the arithmetic on the tensor cores
// so that it hides under the copies.
//
// Design. Grid (S, Hkv * groups, B), one CTA per (split, kv head and group
// of <= 8 of its query heads, row); the S splits of a (row, kv head) form
// one thread-block cluster. S is the caller's plan (attention.py:k7_plan, a
// function of the shapes only: the fewest splits that give every SM a CTA,
// within one wave of resident clusters).
//   0. Every CTA reads its row's kv_valid (M bytes) into a bitmask in shared
//      memory and finds the last valid slot; the row's TILE-position tiles up
//      to it are cut into S even ranges. Nothing about the lengths goes back
//      to the host: a CUDA graph replays the same launch for any lengths. A
//      CTA with no tile contributes (m = NEG, l = 0, acc = 0); a row with no
//      valid slot gives 0. Meanwhile the query is read (int8: quantised
//      once for the CTA, into shared memory, as quantize_query does).
//   1. A producer warp fills a ring of STAGES tiles in shared memory with
//      bulk asynchronous tensor copies (TMA: cp.async.bulk.tensor + mbarrier
//      complete_tx). k and v are each described by a 4-D tensor map (hd,
//      Hkv, M, B) built on the host at each call; one copy moves a box of
//      128 bytes of each of TILE positions of one kv head (positions are
//      strided by Hkv * hd), so a tile is 2 x ROW / 128 copies. The box is
//      stored with the 128-byte swizzle (16-byte chunk c of row r at c ^ (r %
//      8)), so ldmatrix reads it without bank conflicts. Positions past M
//      are filled with zeros; those past the row's last valid slot are
//      masked. Each stage holds 32 KB of K and V (TILE = 64 positions at
//      bf16 hd 128, 128 at int8 hd 128, 32 / 64 at hd 256), or as near as
//      whole warps' tiles of 16 positions allow at the widths above 256
//      (16 / 32 positions, 24 KB at hd 384, 32 KB at hd 512).
//   2. CW = TILE / 16 consumer warps, 16 positions each, consume a tile in
//      one pass: scores by mma.sync (bf16 m16n8k16 with f32 sums; int8
//      m16n8k32 s8 x s8, exact in int32), positions as M and the group's
//      query heads as N (rep < 8 padded with zero queries), the query
//      fragment in registers for the whole CTA; int8: each thread's k and v
//      scales read a tile ahead; the tile's maximum per head through shared
//      memory; p = exp(s - m) with the online-softmax update; p (int8: p *
//      v_scale) rounded to bf16 and moved into the B operand by movmatrix;
//      then out^T += V^T P by mma.sync m16n8k16 with V^T read by
//      ldmatrix.trans (int8: the bytes of V^T come in pairs of dims, split
//      by even and odd dim and turned into bf16 exactly, |v| <= 128).
//   3. The warps' partials are summed in warp order. With S > 1 each CTA
//      sends every other its slice of (acc, m, l) through distributed shared
//      memory, and after one cluster barrier sums its slice in split order:
//      out = sum_s e^(m_s - M*) acc_s / max(sum_s e^(m_s - M*) l_s, 1e-30),
//      in bf16. No atomics but one max over the valid bitmask: the same bits
//      on every run, and no scratch in device memory.
//
// On an H100 (PERF.md §6, PR 17) the copies stream near the card's rate;
// what separates a call from its bytes bound is a CTA's fixed cost (the
// scan, the first tile's latency, the combine). Measured and not kept: one
// cp.async.bulk per position and operand (the copies' issue held it below
// PR 3's kernel at hd 128), 4-byte cp.async copies of the int8 scales
// counted on the ring's barrier (a wrong result once, not reproduced), a
// pull combine (a remote load per split and output), a 6-stage ring at one
// CTA an SM (no faster), and clusters of 4 for llama-3-8b's 64 pairs (the
// card holds 62 at once: two waves).
//
// decode_attention_split_plain (attention.py) does the same schedule in
// PyTorch: tiles, split ranges, the running maximum per tile, the combine.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {  // internal linkage: no other library's kernels of the same names interpose
namespace k7tc {

constexpr int STAGES = 3;             // the most tiles in the ring: two CTAs share an SM
constexpr int HEADS = 8;              // query heads per CTA: the mma's N
constexpr int MAX_SPLITS = 16;        // the largest cluster the card takes (non-portable above 8)
constexpr int STAGE_DATA = 32768;     // bytes of K and V per stage
constexpr float NEG = -0.7f * FLT_MAX;

constexpr int BOX = 128;              // bytes of a position in one tensor copy (the swizzle's span)

template <int HD, bool QUANT>
struct Cfg {
  static constexpr int EB = QUANT ? 1 : 2;
  static constexpr int ROW = HD * EB;              // bytes of one position of one kv head
  static constexpr int NBOX = ROW / BOX;           // tensor copies per operand and tile
  // positions per tile: STAGE_DATA of K and V, in whole warps' rows of 16
  static constexpr int TILE = STAGE_DATA / (2 * ROW) >= 16 ? STAGE_DATA / (2 * ROW) / 16 * 16 : 16;
  static constexpr int CW = TILE / 16;             // consumer warps
  static constexpr int THREADS = (CW + 1) * 32;    // + the producer warp
  static constexpr int HALF = NBOX * TILE * BOX;   // one operand's tile: NBOX boxes [TILE][BOX]
  static constexpr int STAGE_BYTES = 2 * HALF;    // K then V; stages start on 1 KB (the swizzle's period)
  // the ring's tiles: STAGES, or two above hd 256 where three would leave
  // no room for a second CTA on the SM (the static partial buffers grow
  // with HD; 227 KB an SM)
  static constexpr int NST = (HD <= 256 || STAGES * STAGE_BYTES <= 73728) ? STAGES : 2;
  static constexpr int RING = NST * STAGE_BYTES;
  static constexpr int KSTEPS = ROW / 32;          // 32-byte k steps of the score product
  static constexpr int DBLK = QUANT ? HD / 32 : HD / 16;  // P.V blocks of dims
  static constexpr int NACC = QUANT ? 2 * DBLK : DBLK;    // accumulator fragments
  static_assert(TILE % 16 == 0 && CW >= 1 && ROW % BOX == 0, "whole warps' rows and boxes");
  static_assert(CW * HEADS * HD * 4 <= RING, "the warps' partials fit in the ring");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// one box of a 4-D tensor map at coordinates (c0, c1, c2, c3), innermost first
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                         int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], "
      "[%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_addr(bar))
      : "memory");
}

// byte offset of (row r, 16-byte chunk c) in a box stored with the 128-byte swizzle
__device__ __forceinline__ int swz(int r, int c) { return r * BOX + ((c ^ (r & 7)) << 4); }

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t movmatrix_t(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Bytes 0 and 2 (sel 0) or 1 and 3 (sel 1) of x, signed int8, as bf16x2
// (byte 0 / 1 in the low half), exactly: 2^23 + (b + 128) built as f32 bits,
// less 2^23 + 128, and an integer of |b| <= 128 keeps all its bits in bf16.
__device__ __forceinline__ uint32_t s8pair_to_bf16x2(uint32_t x, int sel) {
  const uint32_t u = x ^ 0x80808080u;
  const float lo = __uint_as_float(__byte_perm(u, 0x4B000000u, sel ? 0x7541u : 0x7540u)) - 8388736.f;
  const float hi = __uint_as_float(__byte_perm(u, 0x4B000000u, sel ? 0x7543u : 0x7542u)) - 8388736.f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632u);
}

// Grid (S, Hkv * groups, B), cluster (S, 1, 1); Cfg::THREADS threads;
// dynamic shared memory 1024 + Cfg::RING + 4 * ceil(M / 32) bytes. tk / tv:
// k / v (B, M, Hkv, HD) as 4-D tensor maps, box (BOX / EB, 1, TILE, 1).
template <int HD, bool QUANT>
__global__ void __launch_bounds__(Cfg<HD, QUANT>::THREADS, 2)
decode_attention_tc(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                    const __nv_bfloat16* __restrict__ q,  // (B, H, HD)
                    const uint8_t* __restrict__ valid,    // (B, M)
                    const float* __restrict__ k_scale,    // int8: (B, M, Hkv)
                    const float* __restrict__ v_scale,
                    __nv_bfloat16* __restrict__ out,      // (B, H, HD)
                    float scale, int M, int H, int Hkv, int groups) {
  using C = Cfg<HD, QUANT>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the ring on a 1 KB boundary: the 128-byte swizzle repeats every 8 rows
  unsigned char* ring = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  uint32_t* bits = reinterpret_cast<uint32_t*>(ring + C::RING);
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  __shared__ float red[2][C::CW][HEADS];  // the warps' tile maxima, double-buffered
  __shared__ float sl_w[C::CW][HEADS], sm[HEADS];
  // the cluster's partials of this CTA's slice of the outputs, [S][per] and [S][HEADS][2]
  __shared__ __align__(16) float recv[HEADS * HD + 4 * MAX_SPLITS];
  __shared__ float recv_ml[MAX_SPLITS][HEADS][2];
  __shared__ float sw[MAX_SPLITS][HEADS], sden[HEADS];  // the combine's weights
  __shared__ __align__(16) int8_t sq8[QUANT ? HEADS : 1][QUANT ? HD : 16];  // int8: q's codes
  __shared__ float sqs[HEADS];  // int8: q_scale * scale per head
  __shared__ int s_last;

  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int split = (int)cluster.block_rank();
  // this CTA has started: the others may write its shared memory once they
  // have waited for the matching barrier (before their first remote store)
  if (S > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int hkv = blockIdx.y / groups, grp = blockIdx.y % groups;
  const int b = blockIdx.z;
  const int rep = H / Hkv;
  const int h0 = hkv * rep + grp * HEADS;
  const int nh = min(HEADS, rep - grp * HEADS);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  if (tid == 0) {
    for (int s = 0; s < C::NST; ++s) {
      mbar_init(&full[s], 1);  // the producer's arrival, with the copies' bytes
      mbar_init(&empty[s], C::CW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    s_last = -1;
  }

  // the query, loaded while the row's slots are scanned: bf16 pairs (k
  // 2t.., 2t + 8..) of every 32-byte k step into the registers of the
  // score's B operand (head g); int8: 16 values a thread, quantised below
  uint32_t qw[C::KSTEPS][2];
  if constexpr (!QUANT) {
    if (warp < C::CW) {
      const __nv_bfloat16* qrow = q + ((size_t)b * H + h0 + min(g, nh - 1)) * HD;
#pragma unroll
      for (int ks = 0; ks < C::KSTEPS; ++ks) {
        qw[ks][0] = g < nh ? *reinterpret_cast<const uint32_t*>(qrow + ks * 16 + 2 * t) : 0u;
        qw[ks][1] = g < nh ? *reinterpret_cast<const uint32_t*>(qrow + ks * 16 + 8 + 2 * t) : 0u;
      }
    }
  }
  // int8: threads per head (8 or 16 up to hd 256, 8 above, inside one
  // warp), VPT values each (16, or 48 / 64 at hd 384 / 512)
  constexpr int CPH = HD <= 256 ? HD / 16 : 8;
  constexpr int VPT = HD / CPH;
  static_assert(!QUANT || (HEADS * CPH <= C::CW * 32 && 32 % CPH == 0), "whole consumer warps");
  uint4 qraw[VPT / 8];
#pragma unroll
  for (int i = 0; i < VPT / 8; ++i) qraw[i] = make_uint4(0u, 0u, 0u, 0u);
  if constexpr (QUANT) {
    if (tid < HEADS * CPH) {
      const int h = tid / CPH;
      if (h < nh) {
        const uint4* src =
            reinterpret_cast<const uint4*>(q + ((size_t)b * H + h0 + h) * HD + VPT * (tid % CPH));
#pragma unroll
        for (int i = 0; i < VPT / 8; ++i) qraw[i] = src[i];
      }
    }
  }
  __syncthreads();

  // ---- 0. the row's valid slots as bits, and the last of them
  const int words = (M + 31) / 32;
  const uint8_t* vrow = valid + (size_t)b * M;
  const bool vec = reinterpret_cast<uintptr_t>(vrow) % 16 == 0;
  int last = -1;
  for (int w = tid; w < words; w += C::THREADS) {
    uint32_t word = 0;
    if (vec && 32 * w + 32 <= M) {
      const uint4* p = reinterpret_cast<const uint4*>(vrow + 32 * w);
      const uint4 a = __ldg(p), c = __ldg(p + 1);
      const uint32_t x[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint32_t nz = __vcmpne4(x[i], 0u);  // 0xff per nonzero byte
        word |= ((nz & 1u) | ((nz >> 7) & 2u) | ((nz >> 14) & 4u) | ((nz >> 21) & 8u)) << (4 * i);
      }
    } else {
      for (int i = 0; i < 32 && 32 * w + i < M; ++i) word |= (vrow[32 * w + i] != 0 ? 1u : 0u) << i;
    }
    bits[w] = word;
    if (word) last = 32 * w + 31 - __clz(word);
  }
  last = __reduce_max_sync(0xffffffffu, last);
  if (lane == 0 && last >= 0) atomicMax(&s_last, last);
  __syncthreads();
  const int end = s_last + 1;  // slots [0, end) hold every valid one
  const int ntiles = (end + C::TILE - 1) / C::TILE;
  const int t0 = split * ntiles / S, t1 = (split + 1) * ntiles / S;
  const int n = t1 - t0;

  if (warp == C::CW) {
    // ---- 1. the producer: a ring of tiles, NBOX tensor copies per operand
    if (lane == 0) {
      for (int i = 0; i < n; ++i) {
        const int st = i % C::NST;
        if (i >= C::NST) mbar_wait(&empty[st], (uint32_t)((i / C::NST - 1) & 1));
        unsigned char* sk = ring + st * C::STAGE_BYTES;
        const int p0 = (t0 + i) * C::TILE;
        mbar_arrive_tx(&full[st], 2u * C::HALF);
#pragma unroll
        for (int j = 0; j < C::NBOX; ++j) {
          tma_load(sk + j * C::TILE * BOX, &tk, j * (BOX / C::EB), hkv, p0, b, &full[st]);
          tma_load(sk + C::HALF + j * C::TILE * BOX, &tv, j * (BOX / C::EB), hkv, p0, b, &full[st]);
        }
      }
    }
  }

  // ---- 2. the consumers' state: heads 2t, 2t + 1 of the score fragments
  float m_run[2] = {NEG, NEG}, l_run[2] = {0.f, 0.f};
  float acc[C::NACC][4];
#pragma unroll
  for (int f = 0; f < C::NACC; ++f)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[f][j] = 0.f;

  if (warp < C::CW) {
    if constexpr (QUANT) {
      // once for the CTA, while the first copies land: per head q_scale =
      // max|q| / 127 floored at 1e-20, codes rint(q / q_scale) clipped to
      // +-127 (quantize_query's), into shared memory
      if (tid < HEADS * CPH) {
        const int h = tid / CPH, d0 = VPT * (tid % CPH);
        float x[VPT];
        float a = 0.f;
#pragma unroll
        for (int i = 0; i < VPT / 2; ++i) {
          const uint4& r = qraw[i / 4];
          const uint32_t w = (i & 3) == 0 ? r.x : (i & 3) == 1 ? r.y : (i & 3) == 2 ? r.z : r.w;
          x[2 * i] = __uint_as_float(w << 16);
          x[2 * i + 1] = __uint_as_float(w & 0xffff0000u);
          a = fmaxf(a, fmaxf(fabsf(x[2 * i]), fabsf(x[2 * i + 1])));
        }
#pragma unroll
        for (int off = CPH / 2; off > 0; off >>= 1)
          a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, off));
        const float qs = fmaxf(a / 127.f, 1e-20f);
        uint32_t c[VPT / 4];
#pragma unroll
        for (int i = 0; i < VPT / 4; ++i) c[i] = 0u;
#pragma unroll
        for (int i = 0; i < VPT; ++i) {
          const int c8 = (int)fminf(fmaxf(rintf(x[i] / qs), -127.f), 127.f);
          c[i / 4] |= (uint32_t)(c8 & 0xff) << (8 * (i % 4));
        }
#pragma unroll
        for (int i = 0; i < VPT / 16; ++i)
          *reinterpret_cast<uint4*>(&sq8[h][d0 + 16 * i]) =
              make_uint4(c[4 * i], c[4 * i + 1], c[4 * i + 2], c[4 * i + 3]);
        if (tid % CPH == 0) sqs[h] = h < nh ? qs * scale : 0.f;
      }
      asm volatile("bar.sync 1, %0;\n" ::"r"(C::CW * 32) : "memory");
    }
    // the scores' B operand (k x head g) and, int8, q_scale * scale of
    // heads 2t, 2t + 1 (the columns of the score fragments)
    uint32_t qf[C::KSTEPS][2];
    float qsc[2] = {scale, scale};
#pragma unroll
    for (int ks = 0; ks < C::KSTEPS; ++ks) {
      if constexpr (!QUANT) {
        qf[ks][0] = qw[ks][0], qf[ks][1] = qw[ks][1];
      } else {  // k 4t.., 4t + 16.. of each 32-byte step
        qf[ks][0] = *reinterpret_cast<const uint32_t*>(&sq8[g][ks * 32 + 4 * t]);
        qf[ks][1] = *reinterpret_cast<const uint32_t*>(&sq8[g][ks * 32 + 16 + 4 * t]);
      }
    }
    if constexpr (QUANT) qsc[0] = sqs[2 * t], qsc[1] = sqs[2 * t + 1];

    // int8: the k and v scales of this thread's positions (g, g + 8 of the
    // warp's 16), loaded a tile ahead
    const int r0 = 16 * warp;  // this warp's 16 positions of each tile
    float kv_s[4] = {0.f, 0.f, 0.f, 0.f};
    auto scales = [&](int i, float (&dst)[4]) {
      if constexpr (QUANT) {
        const int p0 = (t0 + i) * C::TILE + r0 + g;
        const size_t sg = ((size_t)b * M + min(p0, end - 1)) * Hkv + hkv;
        const size_t sg8 = ((size_t)b * M + min(p0 + 8, end - 1)) * Hkv + hkv;
        dst[0] = __ldg(k_scale + sg), dst[1] = __ldg(k_scale + sg8);
        dst[2] = __ldg(v_scale + sg), dst[3] = __ldg(v_scale + sg8);
      }
    };
    if (n > 0) scales(0, kv_s);

    for (int i = 0; i < n; ++i) {
      float next_s[4] = {0.f, 0.f, 0.f, 0.f};
      if (i + 1 < n) scales(i + 1, next_s);
      const int st = i % C::NST;
      mbar_wait(&full[st], (uint32_t)((i / C::NST) & 1));
      const unsigned char* sk = ring + st * C::STAGE_BYTES;
      const unsigned char* sv = sk + C::HALF;
      const int p0 = (t0 + i) * C::TILE + r0;

      // scores: rows = positions r0.., columns = heads
      float s[4];
      bool ok[4];
      {
        // k step ks: box ks / 4, chunks 2 (ks % 4) + (lane >> 4) of rows r0 + (lane & 15)
        const int arow = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int pg = p0 + g, pg8 = pg + 8;
        const bool vg = pg < end && ((bits[pg >> 5] >> (pg & 31)) & 1u);
        const bool vg8 = pg8 < end && ((bits[pg8 >> 5] >> (pg8 & 31)) & 1u);
        if constexpr (!QUANT) {
          float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int ks = 0; ks < C::KSTEPS; ++ks) {
            uint32_t a[4];
            ldsm_x4(a, sk + (ks / 4) * C::TILE * BOX + swz(arow, 2 * (ks % 4) + (lane >> 4)));
            mma_bf16(c, a, qf[ks][0], qf[ks][1]);
          }
          ok[0] = ok[1] = vg;
          ok[2] = ok[3] = vg8;
#pragma unroll
          for (int j = 0; j < 4; ++j) s[j] = ok[j] ? c[j] * scale : NEG;
        } else {
          int c[4] = {0, 0, 0, 0};
#pragma unroll
          for (int ks = 0; ks < C::KSTEPS; ++ks) {
            uint32_t a[4];
            ldsm_x4(a, sk + (ks / 4) * C::TILE * BOX + swz(arow, 2 * (ks % 4) + (lane >> 4)));
            mma_s8(c, a, qf[ks][0], qf[ks][1]);
          }
          const float kg = vg ? kv_s[0] : 0.f, kg8 = vg8 ? kv_s[1] : 0.f;
          const float kq[4] = {kg * qsc[0], kg * qsc[1], kg8 * qsc[0], kg8 * qsc[1]};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            ok[j] = kq[j] > 0.f;  // a zero factor marks an invalid slot
            s[j] = ok[j] ? static_cast<float>(c[j]) * kq[j] : NEG;
          }
        }
      }

      // the tile's maximum per head, over the CW warps
      float mx0 = fmaxf(s[0], s[2]), mx1 = fmaxf(s[1], s[3]);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      if (g == 0) {
        red[i & 1][warp][2 * t] = mx0;
        red[i & 1][warp][2 * t + 1] = mx1;
      }
      asm volatile("bar.sync 1, %0;\n" ::"r"(C::CW * 32) : "memory");
      float mn[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int w = 0; w < C::CW; ++w) {
        mn[0] = fmaxf(mn[0], red[i & 1][w][2 * t]);
        mn[1] = fmaxf(mn[1], red[i & 1][w][2 * t + 1]);
      }
      const float corr[2] = {expf(m_run[0] - mn[0]), expf(m_run[1] - mn[1])};
      m_run[0] = mn[0];
      m_run[1] = mn[1];
      float p[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) p[j] = ok[j] ? expf(s[j] - mn[j & 1]) : 0.f;
      l_run[0] = l_run[0] * corr[0] + (p[0] + p[2]);
      l_run[1] = l_run[1] * corr[1] + (p[1] + p[3]);
      if constexpr (QUANT) p[0] *= kv_s[2], p[1] *= kv_s[2], p[2] *= kv_s[3], p[3] *= kv_s[3];
      // P as the B operand of P.V: (positions 2t.., head g), by transposing
      // the 8 x 8 bf16 blocks (positions g / g + 8, heads 2t, 2t + 1)
      const uint32_t pb0 = movmatrix_t(pack_bf16(p[0], p[1]));
      const uint32_t pb1 = movmatrix_t(pack_bf16(p[2], p[3]));
#pragma unroll
      for (int f = 0; f < C::NACC; ++f) {
        acc[f][0] *= corr[0], acc[f][1] *= corr[1];
        acc[f][2] *= corr[0], acc[f][3] *= corr[1];
      }

      // out^T (dims x heads) += V^T (dims x positions) P; 32-byte block db
      // of the rows: box db / 4, chunk 2 (db % 4) + (j8 & 1)
      const int j8 = lane >> 3, r8 = lane & 7;
      const int vrow = r0 + r8 + (j8 >> 1) * 8;
#pragma unroll
      for (int db = 0; db < C::DBLK; ++db) {
        uint32_t r[4];
        ldsm_x4_t(r, sv + (db / 4) * C::TILE * BOX + swz(vrow, 2 * (db % 4) + (j8 & 1)));
        if constexpr (!QUANT) {
          mma_bf16(acc[db], r, pb0, pb1);
        } else {
          // a b16 transpose of int8 V: register j8 holds (dims 2g, 2g + 1) x
          // (positions 2t, 2t + 1) of its 8 x 16-byte block (positions 0-7 /
          // 8-15 by j8 >> 1, dims 0-15 / 16-31 by j8 & 1); A rows g / g + 8
          // are dims 2g / 16 + 2g (even) or 2g + 1 / 17 + 2g (odd)
          const uint32_t ae[4] = {s8pair_to_bf16x2(r[0], 0), s8pair_to_bf16x2(r[1], 0),
                                  s8pair_to_bf16x2(r[2], 0), s8pair_to_bf16x2(r[3], 0)};
          const uint32_t ao[4] = {s8pair_to_bf16x2(r[0], 1), s8pair_to_bf16x2(r[1], 1),
                                  s8pair_to_bf16x2(r[2], 1), s8pair_to_bf16x2(r[3], 1)};
          mma_bf16(acc[2 * db], ae, pb0, pb1);
          mma_bf16(acc[2 * db + 1], ao, pb0, pb1);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv_s[j] = next_s[j];
    }
  }

  // ---- 3. the warps' partials into the ring (every copy has landed and
  // been read), summed in warp order
  __syncthreads();
  float* part = reinterpret_cast<float*>(ring);  // [CW][HEADS][HD]
  if (warp < C::CW) {
    float* pw = part + warp * HEADS * HD;
#pragma unroll
    for (int f = 0; f < C::NACC; ++f) {
      int d0, d8;  // the fragment's dims of rows g and g + 8
      if constexpr (!QUANT) {
        d0 = 16 * f + g, d8 = d0 + 8;
      } else {
        d0 = 32 * (f / 2) + 2 * g + (f & 1), d8 = d0 + 16;
      }
      pw[(2 * t) * HD + d0] = acc[f][0];
      pw[(2 * t + 1) * HD + d0] = acc[f][1];
      pw[(2 * t) * HD + d8] = acc[f][2];
      pw[(2 * t + 1) * HD + d8] = acc[f][3];
    }
    float l0 = l_run[0], l1 = l_run[1];
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    if (g == 0) {
      sl_w[warp][2 * t] = l0;
      sl_w[warp][2 * t + 1] = l1;
      if (warp == 0) {
        sm[2 * t] = m_run[0];
        sm[2 * t + 1] = m_run[1];
      }
    }
  }
  __syncthreads();
  const int total = nh * HD;  // the group's outputs, (nh, HD)
  auto warp_sum = [&](int e) {
    float4 a = *reinterpret_cast<const float4*>(part + e);
    for (int w = 1; w < C::CW; ++w) {
      const float4 x = *reinterpret_cast<const float4*>(part + w * HEADS * HD + e);
      a.x += x.x, a.y += x.y, a.z += x.z, a.w += x.w;
    }
    return a;
  };
  auto l_sum = [&](int h) {
    float l = sl_w[0][h];
    for (int w = 1; w < C::CW; ++w) l += sl_w[w][h];
    return l;
  };
  __nv_bfloat16* obase = out + ((size_t)b * H + h0) * HD;
  if (S == 1) {  // one split: out = acc / max(l, 1e-30)
    for (int e = 4 * tid; e < total; e += 4 * C::THREADS) {
      const float4 a = warp_sum(e);
      const float den = fmaxf(l_sum(e / HD), 1e-30f);
      const float v[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) obase[e + j] = __float2bfloat16_rn(v[j] / den);
    }
    return;
  }

  // ---- 4. the splits: each CTA sends every other its slice of (acc, m, l)
  // through distributed shared memory, then sums its slice in split order
  const int per = ((total + S - 1) / S + 3) / 4 * 4;  // a CTA's slice, whole float4s
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // every CTA has started
  for (int e = 4 * tid; e < total; e += 4 * C::THREADS) {
    const int r = e / per;
    float* dst = cluster.map_shared_rank(recv, r) + split * per + (e - r * per);
    *reinterpret_cast<float4*>(dst) = warp_sum(e);
  }
  for (int i = tid; i < S * HEADS; i += C::THREADS) {
    const int r = i / HEADS, h = i % HEADS;
    float* dst = cluster.map_shared_rank(&recv_ml[split][h][0], r);
    dst[0] = sm[h];
    dst[1] = l_sum(h);
  }
  cluster.sync();  // every slice has arrived; no CTA writes another's memory after it
  if (tid < nh) {  // per head: e^(m_s - M*) and the denominator
    float mx = NEG;
    for (int s = 0; s < S; ++s) mx = fmaxf(mx, recv_ml[s][tid][0]);
    float den = 0.f;
    for (int s = 0; s < S; ++s) {
      const float w = expf(recv_ml[s][tid][0] - mx);
      sw[s][tid] = w;
      den += w * recv_ml[s][tid][1];
    }
    sden[tid] = fmaxf(den, 1e-30f);
  }
  __syncthreads();
  const int e0 = split * per, e1 = min(total, e0 + per);
  for (int e = e0 + tid; e < e1; e += C::THREADS) {
    const int h = e / HD;
    float num = 0.f;
    for (int s = 0; s < S; ++s) num += sw[s][h] * recv[s * per + (e - e0)];
    obase[e] = __float2bfloat16_rn(num / sden[h]);
  }
}


// ---- The wide instance: hd above 512, any multiple of 128 up to
// WIDE_MAX_HD, the width taken at run time as nc = hd / 128 lane chunks.
//
// At these widths a tile of the narrow design no longer fits: at bf16 hd 640
// a CTA takes ~103 KB, from hd 768 only one fits an SM, and P.V's
// accumulators would pass 255 registers a thread. So here:
//   - tiles of WT = 16 positions, one CTA an SM (its dynamic shared memory
//     is padded past half an SM's, so the occupancy table of the plan,
//     attention.py:MAX_ACTIVE_CLUSTERS_WIDE, holds for every width);
//   - NW = ceil(nc / CPW) warps, warp w owning lane chunks w, w + NW (CPW of
//     them, 1 up to hd 1024, 2 up to 2048). Each warp streams its own chunks
//     of K and V (16 positions x 128 lanes, 4 KB at bf16) by cp.async into a
//     ring of its own (NS slots: K of tile i, V of tile i, K of tile i + 1,
//     ...); no producer warp, no mbarrier;
//   - q.k is accumulated over the warp's chunks (mma.sync as the narrow
//     instance: positions as M, heads as N, the query fragments in
//     registers), the warps' partial scores summed through shared memory in
//     warp order (one barrier a tile), so every warp holds the whole tile's
//     scores and runs the same online softmax;
//   - P.V writes only the warp's own output lanes: each thread holds CPW x 8
//     fragments (32 or 64 floats), whatever hd;
//   - the splits of a (row, kv head) combine in their cluster as in the
//     narrow instance, the partials pushed into the ring's memory once every
//     CTA of the cluster has left its loop.
constexpr int WT = 16;                       // positions per tile
constexpr int WMAX_WARPS = 8;
constexpr int WIDE_MAX_HD = 2048;            // CPW 2 x 8 warps x 128 lanes
constexpr int WIDE_MIN_SMEM = 116 * 1024;    // past half an SM's shared memory: one CTA an SM

template <bool QUANT, int CPW>
struct WideCfg {
  static constexpr int EB = QUANT ? 1 : 2;
  static constexpr int CHUNK = WT * 128 * EB;  // bytes of a tile's 128-lane chunk of K or V
  static constexpr int UPR = 128 * EB / 16;    // 16-byte units of a position's chunk
  static constexpr int KS = 128 * EB / 32;     // 32-byte k steps of a chunk's scores
  static constexpr int DB = QUANT ? 4 : 8;     // P.V blocks of dims of a chunk (8 fragments)
  static constexpr int NS = CPW == 1 ? 4 : 3;  // ring slots of a warp (each CPW chunks)
};

// dynamic shared memory: the ring (the combine's receive buffer in its
// place), then the valid bits, then (int8) q's codes; before the padding
__host__ __device__ inline size_t wide_ring_bytes(int nw, int cpw, int ns, int chunk, int hd) {
  const size_t ring = (size_t)nw * ns * cpw * chunk;
  const size_t recv = ((size_t)HEADS * hd + 4 * MAX_SPLITS) * 4;
  return ring > recv ? ring : recv;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Grid (S, Hkv * groups, B), cluster (S, 1, 1), 32 * NW threads; k / v
// (B, M, Hkv, hd) bytes; nc = hd / 128.
template <bool QUANT, int CPW>
__global__ void __launch_bounds__(WMAX_WARPS * 32, 1)
decode_attention_wide(const __nv_bfloat16* __restrict__ q,   // (B, H, hd)
                      const unsigned char* __restrict__ k,    // (B, M, Hkv, hd)
                      const unsigned char* __restrict__ v,
                      const uint8_t* __restrict__ valid,      // (B, M)
                      const float* __restrict__ k_scale,      // int8: (B, M, Hkv)
                      const float* __restrict__ v_scale,
                      __nv_bfloat16* __restrict__ out,        // (B, H, hd)
                      float scale, int M, int H, int Hkv, int groups, int nc) {
  using W = WideCfg<QUANT, CPW>;
  constexpr int NS = W::NS;
  extern __shared__ __align__(128) unsigned char wsmem_raw[];
  unsigned char* ring = wsmem_raw + ((128 - smem_addr(wsmem_raw) % 128) % 128);
  const int nw = blockDim.x / 32;
  const int hd = nc * 128;
  const int words = (M + 31) / 32;
  const size_t region = wide_ring_bytes(nw, CPW, NS, W::CHUNK, hd);
  uint32_t* bits = reinterpret_cast<uint32_t*>(ring + region);
  int8_t* sq8 = reinterpret_cast<int8_t*>(ring + region + ((size_t)words * 4 + 15) / 16 * 16);
  float* recv = reinterpret_cast<float*>(ring);  // the combine's, once the ring is done
  __shared__ __align__(16) float red[2][WMAX_WARPS][128];  // the warps' partial scores
  __shared__ float recv_ml[MAX_SPLITS][HEADS][2];
  __shared__ float sw[MAX_SPLITS][HEADS], sden[HEADS], sqs[HEADS];
  __shared__ int s_last;

  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int split = (int)cluster.block_rank();
  const int hkv = blockIdx.y / groups, grp = blockIdx.y % groups;
  const int b = blockIdx.z;
  const int rep = H / Hkv;
  const int h0 = hkv * rep + grp * HEADS;
  const int nh = min(HEADS, rep - grp * HEADS);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  if (tid == 0) s_last = -1;

  if constexpr (QUANT) {
    // q quantised once for the CTA, a warp per head, as quantize_query:
    // q_scale = max|q| / 127 floored at 1e-20, codes rint(q / q_scale)
    // clipped to +-127; heads past the group's count get zeros
    for (int h = warp; h < HEADS; h += nw) {
      const __nv_bfloat16* qrow = q + ((size_t)b * H + h0 + min(h, nh - 1)) * hd;
      float a = 0.f;
      for (int d = lane; d < hd; d += 32) a = fmaxf(a, fabsf(__bfloat162float(qrow[d])));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, off));
      const float qs = fmaxf(a / 127.f, 1e-20f);
      for (int d = lane; d < hd; d += 32)
        sq8[h * hd + d] = h < nh ? static_cast<int8_t>(fminf(
                                       fmaxf(rintf(__bfloat162float(qrow[d]) / qs), -127.f), 127.f))
                                 : static_cast<int8_t>(0);
      if (lane == 0) sqs[h] = h < nh ? qs * scale : 0.f;
    }
  }
  __syncthreads();

  // ---- 0. the row's valid slots as bits, and the last of them
  const uint8_t* vrow = valid + (size_t)b * M;
  const bool vec = reinterpret_cast<uintptr_t>(vrow) % 16 == 0;
  int last = -1;
  for (int w = tid; w < words; w += blockDim.x) {
    uint32_t word = 0;
    if (vec && 32 * w + 32 <= M) {
      const uint4* p = reinterpret_cast<const uint4*>(vrow + 32 * w);
      const uint4 a = __ldg(p), c = __ldg(p + 1);
      const uint32_t x[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint32_t nz = __vcmpne4(x[i], 0u);
        word |= ((nz & 1u) | ((nz >> 7) & 2u) | ((nz >> 14) & 4u) | ((nz >> 21) & 8u)) << (4 * i);
      }
    } else {
      for (int i = 0; i < 32 && 32 * w + i < M; ++i) word |= (vrow[32 * w + i] != 0 ? 1u : 0u) << i;
    }
    bits[w] = word;
    if (word) last = 32 * w + 31 - __clz(word);
  }
  last = __reduce_max_sync(0xffffffffu, last);
  if (lane == 0 && last >= 0) atomicMax(&s_last, last);
  __syncthreads();
  const int end = s_last + 1;
  const int ntiles = (end + WT - 1) / WT;
  const int t0 = split * ntiles / S, t1 = (split + 1) * ntiles / S;
  const int n = t1 - t0;

  // the query fragments of this warp's chunks: the scores' B operand (k x head g)
  uint32_t qf[CPW][W::KS][2];
#pragma unroll
  for (int j = 0; j < CPW; ++j) {
    const int c = warp + nw * j;
#pragma unroll
    for (int ks = 0; ks < W::KS; ++ks) {
      qf[j][ks][0] = qf[j][ks][1] = 0u;
      if (c < nc) {
        if constexpr (!QUANT) {
          if (g < nh) {
            const __nv_bfloat16* qrow = q + ((size_t)b * H + h0 + g) * hd + c * 128;
            qf[j][ks][0] = *reinterpret_cast<const uint32_t*>(qrow + ks * 16 + 2 * t);
            qf[j][ks][1] = *reinterpret_cast<const uint32_t*>(qrow + ks * 16 + 8 + 2 * t);
          }
        } else {
          const int8_t* qr = sq8 + g * hd + c * 128;
          qf[j][ks][0] = *reinterpret_cast<const uint32_t*>(qr + ks * 32 + 4 * t);
          qf[j][ks][1] = *reinterpret_cast<const uint32_t*>(qr + ks * 32 + 16 + 4 * t);
        }
      }
    }
  }
  float qsc[2] = {scale, scale};
  if constexpr (QUANT) qsc[0] = sqs[2 * t], qsc[1] = sqs[2 * t + 1];

  // ---- 1. this warp's ring: slot j of its sequence holds K (j even) or V
  // (j odd) of tile j / 2, its chunks swizzled as the narrow instance's boxes
  // (16-byte unit u of position r at (u ^ (r % 8)) within each 128 bytes);
  // positions past the row's last valid slot are filled with zeros
  unsigned char* wring = ring + (size_t)warp * NS * CPW * W::CHUNK;
  const size_t row_bytes = (size_t)hd * W::EB;
  auto issue = [&](int j) {
    if (j < 2 * n) {
      const unsigned char* src0 = (j & 1) ? v : k;
      unsigned char* dst0 = wring + (size_t)(j % NS) * CPW * W::CHUNK;
      const int p0 = (t0 + (j >> 1)) * WT;
#pragma unroll
      for (int jc = 0; jc < CPW; ++jc) {
        const int c = warp + nw * jc;
        if (c < nc) {
#pragma unroll
          for (int it = 0; it < WT * W::UPR / 32; ++it) {
            const int u = lane + 32 * it;
            const int r = u / W::UPR, cu = u % W::UPR;
            const int p = p0 + r;
            const bool in = p < end;
            const unsigned char* src = src0 + (((size_t)b * M + (in ? p : 0)) * Hkv + hkv) * row_bytes +
                                       (size_t)c * 128 * W::EB + cu * 16;
            cp_async16(dst0 + jc * W::CHUNK + (cu / 8) * (WT * 128) + swz(r, cu % 8), src,
                       in ? 16 : 0);
          }
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < NS; ++j) issue(j);

  float m_run[2] = {NEG, NEG}, l_run[2] = {0.f, 0.f};
  float acc[CPW][8][4];
#pragma unroll
  for (int j = 0; j < CPW; ++j)
#pragma unroll
    for (int f = 0; f < 8; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][f][e] = 0.f;
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8;  // ldmatrix's row of the scores' A
  const int j8 = lane >> 3, r8 = lane & 7;
  const int vrow8 = r8 + (j8 >> 1) * 8;                // and of P.V's V^T

  for (int i = 0; i < n; ++i) {
    const int p0 = (t0 + i) * WT;
    const int pg = p0 + g, pg8 = pg + 8;
    float kv_s[4] = {0.f, 0.f, 0.f, 0.f};  // int8: k and v scales of positions g, g + 8
    if constexpr (QUANT) {
      const size_t sg = ((size_t)b * M + min(pg, end - 1)) * Hkv + hkv;
      const size_t sg8 = ((size_t)b * M + min(pg8, end - 1)) * Hkv + hkv;
      kv_s[0] = __ldg(k_scale + sg), kv_s[1] = __ldg(k_scale + sg8);
      kv_s[2] = __ldg(v_scale + sg), kv_s[3] = __ldg(v_scale + sg8);
    }

    // scores over this warp's chunks of the tile's K
    cp_async_wait<NS - 1>();
    __syncwarp();
    {
      const unsigned char* sk = wring + (size_t)((2 * i) % NS) * CPW * W::CHUNK;
      float4 part;
      if constexpr (!QUANT) {
        float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int jc = 0; jc < CPW; ++jc) {
          if (warp + nw * jc < nc) {
#pragma unroll
            for (int ks = 0; ks < W::KS; ++ks) {
              uint32_t a[4];
              ldsm_x4(a, sk + jc * W::CHUNK + (ks / 4) * (WT * 128) +
                             swz(arow, 2 * (ks % 4) + (lane >> 4)));
              mma_bf16(c, a, qf[jc][ks][0], qf[jc][ks][1]);
            }
          }
        }
        part = make_float4(c[0], c[1], c[2], c[3]);
      } else {
        int c[4] = {0, 0, 0, 0};
#pragma unroll
        for (int jc = 0; jc < CPW; ++jc) {
          if (warp + nw * jc < nc) {
#pragma unroll
            for (int ks = 0; ks < W::KS; ++ks) {
              uint32_t a[4];
              ldsm_x4(a, sk + jc * W::CHUNK + (ks / 4) * (WT * 128) +
                             swz(arow, 2 * (ks % 4) + (lane >> 4)));
              mma_s8(c, a, qf[jc][ks][0], qf[jc][ks][1]);
            }
          }
        }
        part = make_float4(__int_as_float(c[0]), __int_as_float(c[1]), __int_as_float(c[2]),
                           __int_as_float(c[3]));
      }
      *reinterpret_cast<float4*>(&red[i & 1][warp][4 * lane]) = part;
    }
    __syncwarp();
    issue(2 * i + NS);  // the K slot just read takes a later slot's copies
    __syncthreads();    // every warp's partial scores

    // the tile's scores, summed in warp order (the same in every warp)
    float s[4];
    bool ok[4];
    const bool vg = pg < end && ((bits[pg >> 5] >> (pg & 31)) & 1u);
    const bool vg8 = pg8 < end && ((bits[pg8 >> 5] >> (pg8 & 31)) & 1u);
    if constexpr (!QUANT) {
      float4 c = *reinterpret_cast<const float4*>(&red[i & 1][0][4 * lane]);
      for (int w = 1; w < nw; ++w) {
        const float4 x = *reinterpret_cast<const float4*>(&red[i & 1][w][4 * lane]);
        c.x += x.x, c.y += x.y, c.z += x.z, c.w += x.w;
      }
      const float cv[4] = {c.x, c.y, c.z, c.w};
      ok[0] = ok[1] = vg;
      ok[2] = ok[3] = vg8;
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j] = ok[j] ? cv[j] * scale : NEG;
    } else {
      int c[4] = {0, 0, 0, 0};
      for (int w = 0; w < nw; ++w) {
        const float4 x = *reinterpret_cast<const float4*>(&red[i & 1][w][4 * lane]);
        c[0] += __float_as_int(x.x), c[1] += __float_as_int(x.y);
        c[2] += __float_as_int(x.z), c[3] += __float_as_int(x.w);
      }
      const float kg = vg ? kv_s[0] : 0.f, kg8 = vg8 ? kv_s[1] : 0.f;
      const float kq[4] = {kg * qsc[0], kg * qsc[1], kg8 * qsc[0], kg8 * qsc[1]};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ok[j] = kq[j] > 0.f;  // a zero factor marks an invalid slot
        s[j] = ok[j] ? static_cast<float>(c[j]) * kq[j] : NEG;
      }
    }

    // the online softmax: every warp holds the tile's 16 positions
    float mx0 = fmaxf(s[0], s[2]), mx1 = fmaxf(s[1], s[3]);
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn[2] = {fmaxf(m_run[0], mx0), fmaxf(m_run[1], mx1)};
    const float corr[2] = {expf(m_run[0] - mn[0]), expf(m_run[1] - mn[1])};
    m_run[0] = mn[0];
    m_run[1] = mn[1];
    float p[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) p[j] = ok[j] ? expf(s[j] - mn[j & 1]) : 0.f;
    l_run[0] = l_run[0] * corr[0] + (p[0] + p[2]);
    l_run[1] = l_run[1] * corr[1] + (p[1] + p[3]);
    if constexpr (QUANT) p[0] *= kv_s[2], p[1] *= kv_s[2], p[2] *= kv_s[3], p[3] *= kv_s[3];
    const uint32_t pb0 = movmatrix_t(pack_bf16(p[0], p[1]));
    const uint32_t pb1 = movmatrix_t(pack_bf16(p[2], p[3]));
#pragma unroll
    for (int jc = 0; jc < CPW; ++jc)
#pragma unroll
      for (int f = 0; f < 8; ++f) {
        acc[jc][f][0] *= corr[0], acc[jc][f][1] *= corr[1];
        acc[jc][f][2] *= corr[0], acc[jc][f][3] *= corr[1];
      }

    // out^T (this warp's dims x heads) += V^T P over its chunks of the tile's V
    cp_async_wait<NS - 1>();
    __syncwarp();
    {
      const unsigned char* sv = wring + (size_t)((2 * i + 1) % NS) * CPW * W::CHUNK;
#pragma unroll
      for (int jc = 0; jc < CPW; ++jc) {
        if (warp + nw * jc < nc) {
#pragma unroll
          for (int db = 0; db < W::DB; ++db) {
            uint32_t r[4];
            ldsm_x4_t(r, sv + jc * W::CHUNK + (db / 4) * (WT * 128) +
                             swz(vrow8, 2 * (db % 4) + (j8 & 1)));
            if constexpr (!QUANT) {
              mma_bf16(acc[jc][db], r, pb0, pb1);
            } else {
              const uint32_t ae[4] = {s8pair_to_bf16x2(r[0], 0), s8pair_to_bf16x2(r[1], 0),
                                      s8pair_to_bf16x2(r[2], 0), s8pair_to_bf16x2(r[3], 0)};
              const uint32_t ao[4] = {s8pair_to_bf16x2(r[0], 1), s8pair_to_bf16x2(r[1], 1),
                                      s8pair_to_bf16x2(r[2], 1), s8pair_to_bf16x2(r[3], 1)};
              mma_bf16(acc[jc][2 * db], ae, pb0, pb1);
              mma_bf16(acc[jc][2 * db + 1], ao, pb0, pb1);
            }
          }
        }
      }
    }
    __syncwarp();
    issue(2 * i + 1 + NS);
  }
  cp_async_wait<0>();

  // ---- 2. l over the warp's 16 positions (every warp holds the same)
  float l0 = l_run[0], l1 = l_run[1];
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  // fragment f of chunk c: dims d0 (values 0, 1: heads 2t, 2t + 1) and d8 (values 2, 3)
  auto dims = [&](int c, int f, int& d0, int& d8) {
    if constexpr (!QUANT) {
      d0 = c * 128 + 16 * f + g, d8 = d0 + 8;
    } else {
      d0 = c * 128 + 32 * (f / 2) + 2 * g + (f & 1), d8 = d0 + 16;
    }
  };
  __nv_bfloat16* obase = out + ((size_t)b * H + h0) * hd;
  if (S == 1) {  // one split: out = acc / max(l, 1e-30)
    const float den[2] = {fmaxf(l0, 1e-30f), fmaxf(l1, 1e-30f)};
#pragma unroll
    for (int jc = 0; jc < CPW; ++jc) {
      const int c = warp + nw * jc;
      if (c >= nc) continue;
#pragma unroll
      for (int f = 0; f < 8; ++f) {
        int d0, d8;
        dims(c, f, d0, d8);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = 2 * t + (e & 1);
          if (h < nh) obase[h * hd + (e < 2 ? d0 : d8)] = __float2bfloat16_rn(acc[jc][f][e] / den[e & 1]);
        }
      }
    }
    return;
  }

  // ---- 3. the splits: once every CTA of the cluster has left its loop (its
  // ring read), each sends every other its slice of (acc, m, l) through
  // distributed shared memory; then each sums its slice in split order
  const int total = nh * hd;
  const int per = ((total + S - 1) / S + 3) / 4 * 4;
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
#pragma unroll
  for (int jc = 0; jc < CPW; ++jc) {
    const int c = warp + nw * jc;
    if (c >= nc) continue;
#pragma unroll
    for (int f = 0; f < 8; ++f) {
      int d0, d8;
      dims(c, f, d0, d8);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = 2 * t + (e & 1);
        if (h < nh) {
          const int el = h * hd + (e < 2 ? d0 : d8);
          const int r = el / per;
          *(cluster.map_shared_rank(recv, r) + split * per + (el - r * per)) = acc[jc][f][e];
        }
      }
    }
  }
  if (warp == 0 && g == 0) {
    for (int r = 0; r < S; ++r) {
      float* d0 = cluster.map_shared_rank(&recv_ml[split][2 * t][0], r);
      float* d1 = cluster.map_shared_rank(&recv_ml[split][2 * t + 1][0], r);
      d0[0] = m_run[0], d0[1] = l0;
      d1[0] = m_run[1], d1[1] = l1;
    }
  }
  cluster.sync();  // every slice has arrived
  if (tid < nh) {
    float mx = NEG;
    for (int s2 = 0; s2 < S; ++s2) mx = fmaxf(mx, recv_ml[s2][tid][0]);
    float den = 0.f;
    for (int s2 = 0; s2 < S; ++s2) {
      const float w = expf(recv_ml[s2][tid][0] - mx);
      sw[s2][tid] = w;
      den += w * recv_ml[s2][tid][1];
    }
    sden[tid] = fmaxf(den, 1e-30f);
  }
  __syncthreads();
  const int e0 = split * per, e1 = min(total, e0 + per);
  for (int e = e0 + tid; e < e1; e += blockDim.x) {
    const int h = e / hd;
    float num = 0.f;
    for (int s2 = 0; s2 < S; ++s2) num += sw[s2][h] * recv[s2 * per + (e - e0)];
    obase[e] = __float2bfloat16_rn(num / sden[h]);
  }
}

inline int use_device(int device) {
  int cur = -1;
  if (cudaGetDevice(&cur) != cudaSuccess || cur != device) return (int)cudaSetDevice(device);
  return 0;
}

// cuTensorMapEncodeTiled from the driver, found through the runtime (no link to libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res) ==
            cudaSuccess &&
        res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// x (B, M, Hkv, HD) as a 4-D map (HD, Hkv, M, B), box (BOX / EB, 1, TILE, 1),
// the 128-byte swizzle; positions past M read as zeros
template <int HD, bool QUANT>
int tensor_map(CUtensorMap* map, const void* x, int B, int M, int Hkv) {
  using C = Cfg<HD, QUANT>;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)Hkv, (cuuint64_t)M, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C::ROW, (cuuint64_t)Hkv * C::ROW,
                                 (cuuint64_t)M * Hkv * C::ROW};
  const cuuint32_t box[4] = {(cuuint32_t)(BOX / C::EB), 1, (cuuint32_t)C::TILE, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, QUANT ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                         4, const_cast<void*>(x), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int HD, bool QUANT>
int launch(const __nv_bfloat16* q, const void* k, const void* v, const uint8_t* valid,
           const float* ks, const float* vs, __nv_bfloat16* out, float scale, int B, int M,
           int H, int Hkv, int splits, int device, cudaStream_t s) {
  using C = Cfg<HD, QUANT>;
  CUtensorMap tk, tv;
  int rc = tensor_map<HD, QUANT>(&tk, k, B, M, Hkv);
  if (rc == 0) rc = tensor_map<HD, QUANT>(&tv, v, B, M, Hkv);
  if (rc != 0) return rc;
  const size_t smem = 1024 + C::RING + 4 * (size_t)((M + 31) / 32);
  auto kern = decode_attention_tc<HD, QUANT>;
  // above 48 KB of dynamic shared memory and clusters above 8: raised once per device
  static size_t raised[64] = {};
  if (device < 0 || device >= 64 || raised[device] < smem) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e == cudaSuccess)  // as much shared memory as the SM has: two CTAs share it
      e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    if (device >= 0 && device < 64) raised[device] = smem;
  }
  const int rep = H / Hkv;
  const int groups = (rep + HEADS - 1) / HEADS;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, Hkv * groups, B);
  cfg.blockDim = dim3(C::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, tk, tv, q, valid, ks, vs, out, scale, M,
                                           H, Hkv, groups);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}


// The wide instance's launch (or, with `clusters`, its occupancy at this
// shape instead: cudaOccupancyMaxActiveClusters for clusters of `splits`)
template <bool QUANT, int CPW>
int launch_wide(const __nv_bfloat16* q, const void* k, const void* v, const uint8_t* valid,
                const float* ks, const float* vs, __nv_bfloat16* out, float scale, int B, int M,
                int H, int Hkv, int hd, int splits, int device, cudaStream_t s, int* clusters) {
  using W = WideCfg<QUANT, CPW>;
  const int nc = hd / 128;
  const int nw = (nc + CPW - 1) / CPW;
  size_t smem = 128 + wide_ring_bytes(nw, CPW, W::NS, W::CHUNK, hd) +
                ((size_t)((M + 31) / 32) * 4 + 15) / 16 * 16 + (QUANT ? (size_t)HEADS * hd : 0);
  if (smem < (size_t)WIDE_MIN_SMEM) smem = WIDE_MIN_SMEM;
  auto kern = decode_attention_wide<QUANT, CPW>;
  static size_t raised[64] = {};
  if (device < 0 || device >= 64 || raised[device] < smem) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    if (device >= 0 && device < 64) raised[device] = smem;
  }
  const int rep = H / Hkv;
  const int groups = (rep + HEADS - 1) / HEADS;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, Hkv * groups, B);
  cfg.blockDim = dim3(32 * nw);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (clusters != nullptr) return (int)cudaOccupancyMaxActiveClusters(clusters, kern, &cfg);
  const unsigned char* kb = static_cast<const unsigned char*>(k);
  const unsigned char* vb = static_cast<const unsigned char*>(v);
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, kern, q, kb, vb, valid, ks, vs, out, scale, M, H, Hkv, groups, nc);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

inline int wide_dispatch(const __nv_bfloat16* q, const void* k, const void* v,
                         const uint8_t* valid, const float* ks, const float* vs,
                         __nv_bfloat16* out, float scale, int B, int M, int H, int Hkv, int hd,
                         int splits, int quant, int device, cudaStream_t s, int* clusters) {
  const bool two = hd > 1024;  // CPW: one chunk a warp up to hd 1024, two up to 2048
  if (quant)
    return two ? launch_wide<true, 2>(q, k, v, valid, ks, vs, out, scale, B, M, H, Hkv, hd,
                                      splits, device, s, clusters)
               : launch_wide<true, 1>(q, k, v, valid, ks, vs, out, scale, B, M, H, Hkv, hd,
                                      splits, device, s, clusters);
  return two ? launch_wide<false, 2>(q, k, v, valid, ks, vs, out, scale, B, M, H, Hkv, hd, splits,
                                     device, s, clusters)
             : launch_wide<false, 1>(q, k, v, valid, ks, vs, out, scale, B, M, H, Hkv, hd, splits,
                                     device, s, clusters);
}

}  // namespace k7tc
}  // namespace

// C entry point bound with ctypes (pt2tpu_torch/ops/kernels/attention.py).
// q bf16 (B, H, hd); k/v bf16, or (quant) int8 with k_scale/v_scale (B, M,
// Hkv) f32; valid (B, M) bytes; out (B, H, hd) bf16. hd 128, 256, 384 or 512
// (the narrow instances), or a multiple of 128 from 640 to 2048 (the wide
// one); splits 1..16 (the cluster size; attention.k7_plan); q, k and v
// 16-byte aligned. One launch on `stream`; returns its CUDA error, or 0.
extern "C" int pt2_decode_attention_tc(const void* q, const void* k, const void* v,
                                       const void* valid, const void* k_scale,
                                       const void* v_scale, void* out, float scale, int B, int M,
                                       int H, int Hkv, int hd, int splits, int quant, int device,
                                       void* stream) {
  if (B < 1 || B > 65535 || M < 1 || Hkv < 1 || H < Hkv || H % Hkv ||
      hd < 128 || hd % 128 || hd > k7tc::WIDE_MAX_HD ||
      splits < 1 || splits > k7tc::MAX_SPLITS || !q || !k || !v || !valid || !out ||
      (quant && (!k_scale || !v_scale)))
    return (int)cudaErrorInvalidValue;
  if (Hkv * ((H / Hkv + k7tc::HEADS - 1) / k7tc::HEADS) > 65535) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v) |
       reinterpret_cast<uintptr_t>(q)) % 16)
    return (int)cudaErrorMisalignedAddress;
  const int rc = k7tc::use_device(device);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(q);
  const uint8_t* vd = static_cast<const uint8_t*>(valid);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
#define PT2_K7_HD(HD_)                                                                        \
  if (hd == HD_)                                                                              \
    return quant ? k7tc::launch<HD_, true>(qb, k, v, vd, ks, vs, o, scale, B, M, H, Hkv,      \
                                           splits, device, s)                                 \
                 : k7tc::launch<HD_, false>(qb, k, v, vd, ks, vs, o, scale, B, M, H, Hkv,     \
                                            splits, device, s);
  PT2_K7_HD(128)
  PT2_K7_HD(256)
  PT2_K7_HD(384)
  PT2_K7_HD(512)
#undef PT2_K7_HD
  return k7tc::wide_dispatch(qb, k, v, vd, ks, vs, o, scale, B, M, H, Hkv, hd, splits, quant,
                             device, s, nullptr);
}

// The wide instance's occupancy (hd 640..2048): into *clusters, the clusters
// of `splits` CTAs that the card holds at once at this shape
// (cudaOccupancyMaxActiveClusters); attention.MAX_ACTIVE_CLUSTERS_WIDE is
// this table, measured. Returns a CUDA error, or 0.
extern "C" int pt2_decode_attention_tc_wide_clusters(int M, int hd, int quant, int splits,
                                                     int device, int* clusters) {
  if (hd <= 512 || hd % 128 || hd > k7tc::WIDE_MAX_HD || splits < 1 ||
      splits > k7tc::MAX_SPLITS || M < 1 || !clusters)
    return (int)cudaErrorInvalidValue;
  const int rc = k7tc::use_device(device);
  if (rc != 0) return rc;
  return k7tc::wide_dispatch(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1.f, 1,
                             M, 8, 1, hd, splits, quant, device, nullptr, clusters);
}
