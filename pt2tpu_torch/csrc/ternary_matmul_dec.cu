// K1's decode rows (1 to 8) on the tensor cores, for Hopper (sm_90a).
//
// Replaces pt2tpu/ops/kernels/pallas_ternary.py:ternary_matmul_pallas (and
// its _stacked variant: the caller passes the view packed[li]) at decode row
// counts, bf16 and W2A8. Prefill rows run csrc/ternary_matmul_tc.cu /
// ternary_matmul_tc_a8.cu, other shapes csrc/ternary_matmul.cu; the wrapper
// picks by shape (k1_path in pt2tpu_torch/ops/kernels/ternary.py), never
// after a failure.
//
// K3's decode rows run here too (the GATHER instances, C entry
// pt2_ternary_matmul_dec_igathered): they replace
// ternary_matmul_pallas_igathered (and its _stacked variant) at the same
// row counts and modes, out = x[:, perm] @ dequant(packed). It is this
// kernel with one change, as K3 is K1 with one change in
// csrc/ternary_matmul.cu: x is staged through perm, lane k reading
// x[b, perm[k]] (0 where perm[k] >= m, a pad lane). W2A8 normalises the
// rows before the gather (absmax does not depend on column order). Rows
// 9 to 64 stay on csrc/ternary_matmul.cu's K3.
//
// K1s / K3s (the _stacked variants with a traced index: the mixture-of-
// experts decode's routed experts) are the IDX instances, C entries
// pt2_ternary_matmul_dec_idx / pt2_ternary_matmul_dec_igathered_idx: the
// weights (and perm) are whole stacks of S slots and each CTA reads its slot,
// base + *sel, from device memory before its first load.
//
// The floor probe (impl="floor8": the FLOOR instances, mode 2 of the C
// entries' a8) replaces pallas_ternary.py:_accumulate_step's "floor" mode at
// these rows: W2A8, with the code of each plane the raw signed byte b of its
// packed row in place of the 2-bit field, T = b - 1 (so the epilogue is the
// same: alpha * x.(b - 1) + mu * S = alpha * x.b + (mu - alpha) * S). The
// same bytes, grid, splits and launches; one conversion of a register pair
// feeds all four planes, where the unpack makes one per plane. The block
// dots are integers below 127 * 129 * bs <= 2^24 at bs <= 1024, exact in f32.
//
// Contract (K1's): with T in {-1,0,1} unpacked from the plane-interleaved
// (K/4, n) int8 layout (byte [blk*bs/4 + r, j] holds lanes
// blk*bs + p*bs/4 + r in bits 2p..2p+1, as u = T + 1),
//
//   out[b, j] = sum_blk alpha[blk, j] * (x_blk . T_blk[:, j])
//             + mu[blk, j] * sum(x_blk)
//
// in f32, (B, n), 1 <= B <= 8, bs % 128 == 0, n % 128 == 0. bf16 mode: x is
// bf16. W2A8 mode: x is the bf16 output of normalize_rows_a8; the kernel
// rounds it half to even (rintf, as jnp.round) and clips it to [-127, 127],
// which is exact in bf16, so every per-block dot is an integer below
// 127 * bs < 2^24 and exact in f32. The wrapper multiplies by the row scales.
//
// What bounds it: at <= 8 rows a projection reads 0.25 B per weight of codes
// plus 4 B per (block, column) of alpha and mu and does 2 * 8 operations per
// weight, so it is bound by device-memory bytes. Design:
//   * Split-K over scale blocks. A CTA (4 warps) owns 128 output columns and
//     a slice of bpc blocks; each warp takes whole blocks (w, w + 4, ...).
//     The wrapper picks the number of slices (dec_splits) so that every
//     projection fills the card in one wave of CTAs (4 per SM: the kernel
//     keeps to 128 registers) where its blocks allow. The warps of a CTA are
//     summed in a fixed order in shared memory; each slice writes its own
//     (B, n) partial, and the last CTA of a column tile to finish (found by
//     an integer counter) sums the slices in slice order. No float atomics:
//     the result is the same bits on every run.
//   * Straight from device memory into registers, no staging of the codes:
//     a thread loads 16 neighbouring columns of two packed rows (two 16-byte
//     ld.global.nc), a warp one full 128-byte line per packed row. A warp
//     issues a whole stage of 128 lanes (8 x 16 bytes per thread) before its
//     first product, the first stage before the CTA stages x, alpha and mu
//     (as 16-byte vectors) in shared memory.
//   * The dots run on the tensor cores with the operands swapped: mma.sync
//     m16n8k16 bf16 -> f32 with A = 16 output columns x 16 lanes of codes
//     and B = 16 lanes x the <= 8 rows of x (N = 8 is the decode batch; pad
//     rows are zero). The M index is mapped so that lane (g, t)'s A rows g
//     and g + 8 are two of the 16 columns it loaded (column j and j + 8 of
//     its 16), and the k order within a block is permuted: k 2t + i of an
//     mma is plane P of packed row r + i, k 2t + 8 + i plane P + 1, with
//     r = 8s + 2t for load set s. So a register pair of codes is one prmt of
//     the thread's two packed rows and the mask / or / fma.rn.bf16x2 of
//     csrc/ternary_matmul_tc.cu (T exact in bf16), and x is staged in
//     shared memory once per CTA in the same order: one 16-byte shared load
//     gives a lane its B registers for four planes.
//   * Each scale block's products go to a fresh f32 fragment d; then
//     acc += alpha * d and acc += mu * S in f32 registers. S, the block's
//     row sums of x, is one more mma per plane pair with every A entry 1:
//     it lands in the registers that need it (rows 2t, 2t + 1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BN = 128;          // output columns per CTA
constexpr int MAX_ROWS = 8;      // the mma's N tile
constexpr int MAX_SLICE = 2048;  // x lanes a CTA stages (16 bytes each in shared memory)
constexpr int RED_BYTES = WARPS * 32 * 32 * 4;  // the warps' accumulators, for their sum

__device__ __forceinline__ uint4 ld_stream(const int8_t* p) {
  uint4 r;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Plane P of the two codes in bytes 0 and 2 of w, as the bf16 pair
// (T0, T1) = (u0 - 1, u1 - 1). The code sits at bits 2q..2q+1 of the
// mantissa of 0x4300 (128): v = 128 + u * 4^q exactly, and
// v * 4^-q - (128 * 4^-q + 1) = u - 1 is exact, so the fma rounds nothing.
template <int P>
__device__ __forceinline__ uint32_t codes_bf16x2(uint32_t w) {
  constexpr int Q = P < 3 ? P : 2;  // plane 3's bits 6-7 would reach the exponent
  constexpr uint32_t SCALE = Q == 0 ? 0x3f803f80u : Q == 1 ? 0x3e803e80u : 0x3d803d80u;
  constexpr uint32_t BIAS = Q == 0 ? 0xc301c301u : Q == 1 ? 0xc204c204u : 0xc110c110u;
  const uint32_t src = P < 3 ? w : w >> 2;
  const uint32_t v = (src & (0x00030003u << (2 * Q))) | 0x43004300u;
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(v), "r"(SCALE), "r"(BIAS));
  return r;
}

// The floor probe's codes of bytes 0 and 2 of w, each the raw signed byte b
// as b - 1 in a bf16 pair: 2^23 + (b + 128) built as f32 bits, less
// 2^23 + 129, is exact, and so is its bf16 (|b - 1| <= 129 needs 8 bits).
__device__ __forceinline__ uint32_t raw_bf16x2(uint32_t w) {
  const uint32_t u = w ^ 0x00800080u;
  const float lo = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u)) - 8388737.f;
  const float hi = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442u)) - 8388737.f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632u);
}

// W2A8's rounding of a normalised value: half to even, clipped to +-127
__device__ __forceinline__ float rounded(float f) { return fminf(fmaxf(rintf(f), -127.f), 127.f); }

// Grid (n / 128, splits). CTA (c, sp) sums blocks sp*bpc ..
// min(nb, (sp+1)*bpc) - 1 for columns 128c .. 128c + 127 into
// partial[sp, :B] (out when there is one slice); the last CTA of column
// tile c to finish, found by counters[c], sums partial[0 .. splits-1] in
// that order into out and sets counters[c] back to 0. With GATHER, x is
// (B, m) in feature order and lane k of the staged x is x[b, perm[k]].
// With IDX, packed, alpha, mu (and perm) are stacks of S slots and the CTA
// reads slot base + *sel from device memory (once, by thread 0; a slot
// outside [0, S) traps), so a routed expert's index never goes to the host.
// A8: 0 bf16, 1 W2A8, 2 the floor probe (W2A8's rounding, raw bytes as codes).
template <int A8, bool GATHER, bool IDX>
__global__ void __launch_bounds__(THREADS, 4)
ternary_matmul_dec_kernel(const __nv_bfloat16* __restrict__ x,      // (B, K), or (B, m) if GATHER
                          const int* __restrict__ perm,             // (K,) if GATHER
                          const int8_t* __restrict__ packed,        // (K/4, n)
                          const __nv_bfloat16* __restrict__ alpha,  // (nb, n)
                          const __nv_bfloat16* __restrict__ mu,     // (nb, n)
                          float* __restrict__ partial,              // (splits, B, n)
                          float* __restrict__ out,                  // (B, n)
                          int* __restrict__ counters,               // (n / 128,), zero
                          int B, int m, int K, int n, int bs, int bpc,
                          const int* __restrict__ sel, int base, int S) {  // if IDX
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  const int tid = threadIdx.x;
  if constexpr (IDX) {
    __shared__ int slot_s;
    if (tid == 0) {
      const int s = base + *sel;
      if (s < 0 || s >= S) __trap();
      slot_s = s;
    }
    __syncthreads();
    const size_t slot = (size_t)slot_s;
    packed += slot * (size_t)(K / 4) * n;
    alpha += slot * (size_t)(K / bs) * n;
    mu += slot * (size_t)(K / bs) * n;
    if constexpr (GATHER) perm += slot * (size_t)K;
  }
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int col0 = blockIdx.x * BN;
  const int sp = blockIdx.y;
  const int splits = gridDim.y;
  const int nb = K / bs;
  const int blk0 = sp * bpc;
  const int nblk = min(bpc, nb - blk0);
  const int ls = bs / 32;  // load sets of 8 packed rows per block
  const int bs4 = bs / 4;
  // xs: per (local block lb, load set s, lane (g, t)) 16 bytes = four words,
  // word P = (x[g, lane(P, r)], x[g, lane(P, r + 1)]) with r = 8s + 2t and
  // lane(P, r) = (blk0 + lb) * bs + P * bs/4 + r: lane (g, t)'s B registers
  // of plane pairs (0, 1) and (2, 3). The warps' sums alias it at the end.
  // am: per local block the tile's 128 alpha, then its 128 mu.
  uint32_t* xs = reinterpret_cast<uint32_t*>(smem);
  __nv_bfloat16* am =
      reinterpret_cast<__nv_bfloat16*>(smem + (bpc * bs * 16 > RED_BYTES ? bpc * bs * 16
                                                                          : RED_BYTES));

  // This warp's blocks lb = warp, warp + WARPS, ... of the slice, walked in
  // stages of 128 lanes (four load sets). The first stage's packed rows are
  // loaded before x is staged.
  const int spb = ls / 4;
  const int nst = warp < nblk ? ((nblk - 1 - warp) / WARPS + 1) * spb : 0;
  const int8_t* pcol = packed + col0 + 16 * g;
  uint4 v[4][2];
  auto load_stage = [&](int st) {
    const int lb = warp + (st / spb) * WARPS;
    const size_t r0 = (size_t)(blk0 + lb) * bs4 + 32 * (st % spb) + 2 * t;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[q][0] = ld_stream(pcol + (r0 + 8 * q) * n);
      v[q][1] = ld_stream(pcol + (r0 + 8 * q + 1) * n);
    }
  };
  if (nst > 0) load_stage(0);

  // the slice's alpha and mu for this tile: 16 chunks of 8 columns each
  for (int i = tid; i < nblk * 32; i += THREADS) {
    const int lb = i >> 5;
    const int k = i & 31;
    const __nv_bfloat16* src =
        (k < 16 ? alpha : mu) + (size_t)(blk0 + lb) * n + col0 + 8 * (k & 15);
    *reinterpret_cast<uint4*>(am + (lb * 32 + k) * 8) = __ldg(reinterpret_cast<const uint4*>(src));
  }
  if constexpr (GATHER) {
    // x into xs through perm: the 8 lanes p*bs/4 + 8s .. + 7 of (unit
    // lb*ls + s, plane p) are neighbours in perm, read with two 16-byte
    // loads once for all rows; then per row < B the 8 values x[row, perm[k]]
    // (0 for a pad lane, perm[k] >= m) make the words of t = 0..3
    const unsigned short* xh = reinterpret_cast<const unsigned short*>(x);
    const int items = nblk * ls * 4;
    for (int i = tid; i < items; i += THREADS) {
      const int p = i & 3;
      const int unit = i >> 2;
      const int lb = unit / ls;
      const int s = unit - lb * ls;
      const int4* pk =
          reinterpret_cast<const int4*>(perm + (size_t)(blk0 + lb) * bs + p * bs4 + 8 * s);
      const int4 q0 = __ldg(pk);
      const int4 q1 = __ldg(pk + 1);
      const int idx[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
      uint32_t* dst = xs + unit * 128 + p;
#pragma unroll 2
      for (int row = 0; row < B; ++row) {
        const unsigned short* xr = xh + (size_t)row * m;
        uint32_t w[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint32_t lo = (unsigned)idx[2 * k] < (unsigned)m ? __ldg(xr + idx[2 * k]) : 0u;
          const uint32_t hi =
              (unsigned)idx[2 * k + 1] < (unsigned)m ? __ldg(xr + idx[2 * k + 1]) : 0u;
          w[k] = lo | (hi << 16);
          if (A8) {
            const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[k]));
            const __nv_bfloat162 q = __floats2bfloat162_rn(rounded(f.x), rounded(f.y));
            w[k] = *reinterpret_cast<const uint32_t*>(&q);  // exact: integers <= 127
          }
        }
        dst[16 * row] = w[0];
        dst[16 * row + 4] = w[1];
        dst[16 * row + 8] = w[2];
        dst[16 * row + 12] = w[3];
      }
    }
  } else {
    // x into xs: one 16-byte load per (unit lb*ls + s, plane p, row < B)
    // gives the words of t = 0..3 (lanes p*bs/4 + 8s .. + 7). Pad rows are
    // not staged: their lanes read zeros in place of xs
    const int loads = nblk * ls * 4 * B;
#pragma unroll 4
    for (int i = tid; i < loads; i += THREADS) {
      const int rest = i / B;
      const int row = i - rest * B;
      const int p = rest & 3;
      const int unit = rest >> 2;
      const int lb = unit / ls;
      const int s = unit - lb * ls;
      uint4 w = *reinterpret_cast<const uint4*>(x + (size_t)row * K + (size_t)(blk0 + lb) * bs +
                                                p * bs4 + 8 * s);
      if (A8) {
        uint32_t* h = &w.x;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(h + k));
          const __nv_bfloat162 q = __floats2bfloat162_rn(rounded(f.x), rounded(f.y));
          h[k] = *reinterpret_cast<const uint32_t*>(&q);  // exact: integers <= 127
        }
      }
      uint32_t* dst_w = xs + (unit * 32 + 4 * row) * 4 + p;
      dst_w[0] = w.x;
      dst_w[4] = w.y;
      dst_w[8] = w.z;
      dst_w[12] = w.w;
    }
  }
  __syncthreads();

  // acc[j][e]: column 16g + j + 8 * (e >> 1) of the tile, row 2t + (e & 1)
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float d[8][4];
  float srow[4];  // the block's row sums: srow[0] row 2t, srow[1] row 2t + 1
  const uint32_t ones[4] = {0x3f803f80u, 0x3f803f80u, 0x3f803f80u, 0x3f803f80u};

  for (int st = 0; st < nst; ++st) {
    const int lb = warp + (st / spb) * WARPS;
    const int s0 = 4 * (st % spb);
    if (st > 0) load_stage(st);
    if (s0 == 0) {  // a new block: fresh fragments
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        srow[e] = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) d[j][e] = 0.f;
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 b = g < B
          ? *reinterpret_cast<const uint4*>(xs + ((lb * ls + s0 + q) * 32 + lane) * 4)
          : make_uint4(0, 0, 0, 0);
      mma_bf16(srow, ones, b.x, b.y);  // S: every A entry 1
      mma_bf16(srow, ones, b.z, b.w);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // columns j and j + 8 of the thread's 16: byte j % 4 of words j / 4
        // and 2 + j / 4; rows r and r + 1 into bytes 0 and 2
        const uint32_t sel = (j & 3) | ((4 + (j & 3)) << 8);
        const uint32_t wl = __byte_perm(word(v[q][0], j >> 2), word(v[q][1], j >> 2), sel);
        const uint32_t wh =
            __byte_perm(word(v[q][0], 2 + (j >> 2)), word(v[q][1], 2 + (j >> 2)), sel);
        if constexpr (A8 == 2) {  // every plane reads the raw byte
          const uint32_t rl = raw_bf16x2(wl), rh = raw_bf16x2(wh);
          const uint32_t raw[4] = {rl, rh, rl, rh};
          mma_bf16(d[j], raw, b.x, b.y);
          mma_bf16(d[j], raw, b.z, b.w);
        } else {
          const uint32_t a01[4] = {codes_bf16x2<0>(wl), codes_bf16x2<0>(wh),
                                   codes_bf16x2<1>(wl), codes_bf16x2<1>(wh)};
          mma_bf16(d[j], a01, b.x, b.y);
          const uint32_t a23[4] = {codes_bf16x2<2>(wl), codes_bf16x2<2>(wh),
                                   codes_bf16x2<3>(wl), codes_bf16x2<3>(wh)};
          mma_bf16(d[j], a23, b.z, b.w);
        }
      }
    }
    if (s0 + 4 == ls) {  // the block is complete: acc += alpha * d + mu * S
      const __nv_bfloat16* ab = am + (lb * 32 + 2 * g) * 8;  // alpha of columns 16g ..
      const uint4 al0 = *reinterpret_cast<const uint4*>(ab);
      const uint4 al1 = *reinterpret_cast<const uint4*>(ab + 8);
      const uint4 mu0 = *reinterpret_cast<const uint4*>(ab + 128);
      const uint4 mu1 = *reinterpret_cast<const uint4*>(ab + 136);
      const __nv_bfloat16* ah0 = reinterpret_cast<const __nv_bfloat16*>(&al0);
      const __nv_bfloat16* ah1 = reinterpret_cast<const __nv_bfloat16*>(&al1);
      const __nv_bfloat16* mh0 = reinterpret_cast<const __nv_bfloat16*>(&mu0);
      const __nv_bfloat16* mh1 = reinterpret_cast<const __nv_bfloat16*>(&mu1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float a_lo = __bfloat162float(ah0[j]), a_hi = __bfloat162float(ah1[j]);
        const float m_lo = __bfloat162float(mh0[j]), m_hi = __bfloat162float(mh1[j]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[j][e] = fmaf(e < 2 ? a_lo : a_hi, d[j][e], acc[j][e]);
          acc[j][e] = fmaf(e < 2 ? m_lo : m_hi, srow[e & 1], acc[j][e]);
        }
      }
    }
  }

  // the warps' accumulators, summed in the order warp 0, 1, 2, 3
  __syncthreads();  // every warp is done with xs
  float* red = reinterpret_cast<float*>(smem);  // [warp][value 4j + e][lane]
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) red[(warp * 32 + 4 * j + e) * 32 + lane] = acc[j][e];
  __syncthreads();
  float* o = splits > 1 ? partial + (size_t)sp * B * n : out;
#pragma unroll
  for (int q = 0; q < 8; ++q) {  // this thread sums values 8 * warp .. + 7 of lane
    const int i = 8 * warp + q;
    float s = red[i * 32 + lane];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) s += red[(w * 32 + i) * 32 + lane];
    const int row = 2 * t + (i & 1);
    const int col = col0 + 16 * g + (i >> 2) + 8 * ((i >> 1) & 1);
    if (row < B) o[(size_t)row * n + col] = s;
  }
  if (splits == 1) return;

  // the last CTA of this column tile sums the slices in order
  __threadfence();  // this CTA's partial is visible before it is counted
  __syncthreads();
  if (tid == 0) last = atomicAdd(&counters[blockIdx.x], 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = tid; i < B * (BN / 4); i += THREADS) {
    const int row = i / (BN / 4);
    const size_t at = (size_t)row * n + col0 + 4 * (i - row * (BN / 4));
    float4 s = __ldcg(reinterpret_cast<const float4*>(partial + at));
    for (int k = 1; k < splits; ++k) {
      const float4 p = __ldcg(reinterpret_cast<const float4*>(partial + (size_t)k * B * n + at));
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
    *reinterpret_cast<float4*>(out + at) = s;
  }
  if (tid == 0) counters[blockIdx.x] = 0;  // ready for the next launch on the stream
}

// The launch of both C entries. x (bf16, B rows of m values; m = K
// without GATHER) needs 16-byte alignment without GATHER, perm (K int32)
// with it: both are read as 16-byte vectors.
template <bool GATHER, bool IDX = false>
int launch(const void* x, const void* perm, const void* packed, const void* alpha,
           const void* mu, void* partial, void* out, void* counters, int B, int m, int K, int n,
           int bs, int splits, int a8, int device, void* stream, const void* sel = nullptr,
           int base = 0, int S = 0) {
  if (B < 1 || B > MAX_ROWS || bs < 128 || bs % 128 != 0 || K < bs || K % bs != 0 || n < BN ||
      n % BN != 0 || m < 1 || a8 < 0 || a8 > 2 || (a8 == 2 && bs > 1024))
    return (int)cudaErrorInvalidValue;
  if (IDX && (sel == nullptr || reinterpret_cast<uintptr_t>(sel) % 4 != 0 || S < 1))
    return (int)cudaErrorInvalidValue;
  const int nb = K / bs;
  if (splits < 1 || splits > nb) return (int)cudaErrorInvalidValue;
  const int bpc = (nb + splits - 1) / splits;
  if ((splits - 1) * bpc >= nb || bpc * bs > MAX_SLICE) return (int)cudaErrorInvalidValue;
  if (GATHER && perm == nullptr) return (int)cudaErrorInvalidValue;
  uintptr_t any = reinterpret_cast<uintptr_t>(GATHER ? perm : x) |
                  reinterpret_cast<uintptr_t>(packed) | reinterpret_cast<uintptr_t>(alpha) |
                  reinterpret_cast<uintptr_t>(mu) | reinterpret_cast<uintptr_t>(out);
  if (GATHER) any |= reinterpret_cast<uintptr_t>(x) & 1;  // bf16 x: 2-byte loads
  if (splits > 1) {
    if (partial == nullptr || counters == nullptr) return (int)cudaErrorInvalidValue;
    any |= reinterpret_cast<uintptr_t>(partial) | (reinterpret_cast<uintptr_t>(counters) & 3);
  }
  if (any % 16 != 0) return (int)cudaErrorMisalignedAddress;
  // This library links its own CUDA runtime: follow the caller's device.
  int cur = -1;
  if (cudaGetDevice(&cur) != cudaSuccess || cur != device) {
    const cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
  }
  const size_t smem =
      (size_t)(bpc * bs * 16 > RED_BYTES ? bpc * bs * 16 : RED_BYTES) + (size_t)bpc * 512;
  const dim3 grid(n / BN, splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  const int* pm = static_cast<const int*>(perm);
  const int8_t* pp = static_cast<const int8_t*>(packed);
  const __nv_bfloat16* ap = static_cast<const __nv_bfloat16*>(alpha);
  const __nv_bfloat16* mp = static_cast<const __nv_bfloat16*>(mu);
  float* part = static_cast<float*>(partial);
  float* op = static_cast<float*>(out);
  int* cp = static_cast<int*>(counters);
  const int* ip = static_cast<const int*>(sel);
  if (a8 == 2)
    ternary_matmul_dec_kernel<2, GATHER, IDX><<<grid, THREADS, smem, s>>>(
        xp, pm, pp, ap, mp, part, op, cp, B, m, K, n, bs, bpc, ip, base, S);
  else if (a8)
    ternary_matmul_dec_kernel<1, GATHER, IDX><<<grid, THREADS, smem, s>>>(
        xp, pm, pp, ap, mp, part, op, cp, B, m, K, n, bs, bpc, ip, base, S);
  else
    ternary_matmul_dec_kernel<0, GATHER, IDX><<<grid, THREADS, smem, s>>>(
        xp, pm, pp, ap, mp, part, op, cp, B, m, K, n, bs, bpc, ip, base, S);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points bound with ctypes (pt2tpu_torch/ops/kernels/ternary.py).
// a8: 0 bf16, 1 W2A8, 2 the floor probe (both on normalize_rows_a8's rows).
// x is (B, K) bf16 (W2A8: normalize_rows_a8's output), partial scratch of
// splits * B * n f32 (not read when splits is 1), out (B, n) f32, counters
// n / 128 int32 that are 0 (each launch leaves them 0; launches that share
// them must not run concurrently). The K slice of a CTA is
// bpc = ceil(nb / splits) blocks; splits must leave no slice empty and
// bpc * bs <= 2048. x, packed, alpha, mu, partial and out are 16-byte
// aligned. Returns the launch's CUDA error; 0 means it launched.
extern "C" int pt2_ternary_matmul_dec(const void* x, const void* packed, const void* alpha,
                                      const void* mu, void* partial, void* out, void* counters,
                                      int B, int K, int n, int bs, int splits, int a8, int device,
                                      void* stream) {
  return launch<false>(x, nullptr, packed, alpha, mu, partial, out, counters, B, K, K, n, bs,
                       splits, a8, device, stream);
}

// K3's decode rows: as pt2_ternary_matmul_dec, with x (B, m) bf16 in
// feature order (W2A8: its normalised rows) and perm (K,) int32 the visit
// lane -> feature map, pad lanes >= m. perm is 16-byte aligned, x 2-byte.
extern "C" int pt2_ternary_matmul_dec_igathered(const void* x, const void* perm,
                                                const void* packed, const void* alpha,
                                                const void* mu, void* partial, void* out,
                                                void* counters, int B, int m, int K, int n, int bs,
                                                int splits, int a8, int device, void* stream) {
  return launch<true>(x, perm, packed, alpha, mu, partial, out, counters, B, m, K, n, bs, splits,
                      a8, device, stream);
}

// The device-index entries (K1s / K3s at decode rows): as the two above, with
// packed (S, K/4, n), alpha and mu (S, nb, n) and, for K3, perm (S, K) whole
// contiguous stacks, and the slot base + *sel read by each CTA from device
// memory (sel: one int32 on the card, e.g. an element of the router's top-k;
// base: a host offset, layer * experts). A slot outside [0, S) traps.
extern "C" int pt2_ternary_matmul_dec_idx(const void* x, const void* packed, const void* alpha,
                                          const void* mu, void* partial, void* out,
                                          void* counters, const void* sel, int base, int S,
                                          int B, int K, int n, int bs, int splits, int a8,
                                          int device, void* stream) {
  return launch<false, true>(x, nullptr, packed, alpha, mu, partial, out, counters, B, K, K, n,
                             bs, splits, a8, device, stream, sel, base, S);
}

extern "C" int pt2_ternary_matmul_dec_igathered_idx(const void* x, const void* perm,
                                                    const void* packed, const void* alpha,
                                                    const void* mu, void* partial, void* out,
                                                    void* counters, const void* sel, int base,
                                                    int S, int B, int m, int K, int n, int bs,
                                                    int splits, int a8, int device,
                                                    void* stream) {
  return launch<true, true>(x, perm, packed, alpha, mu, partial, out, counters, B, m, K, n, bs,
                            splits, a8, device, stream, sel, base, S);
}
