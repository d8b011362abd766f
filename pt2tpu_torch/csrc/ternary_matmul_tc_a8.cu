// K1's many-row W2A8 path on the integer tensor cores, for Hopper (sm_90a).
//
// Replaces pt2tpu/ops/kernels/pallas_ternary.py:ternary_matmul_pallas (and
// its _stacked variant: the caller passes the view packed[li]) with a8=True
// at prefill row counts. Decode rows stay on the CUDA-core K1
// (csrc/ternary_matmul.cu) and bf16 prefill on csrc/ternary_matmul_tc.cu;
// the wrapper picks by shape (k1_path in pt2tpu_torch/ops/kernels/ternary.py),
// never after a failure.
//
// Contract (K1's in W2A8 mode): xn is the bf16 output of normalize_rows_a8
// (|xn| <= 127); xq = clip(rint(xn), -127, 127), rounded half to even as
// jnp.round rounds; with u = T + 1 in {0,1,2} unpacked from the plane-
// interleaved (K/4, n) int8 layout (byte [blk*bs/4 + r, j] holds lanes
// blk*bs + p*bs/4 + r in bits 2p..2p+1),
//
//   out[b, j] = sum_blk alpha[blk, j] * (xq_blk . u_blk[:, j])
//             + (mu[blk, j] - alpha[blk, j]) * sum(xq_blk)
//
// in f32, (B, n). The wrapper multiplies out by the rows' scales sx.
// Takes bs % 128 == 0 and n % 128 == 0 (what the JAX kernel asserts), any
// B >= 1.
//
// What bounds it: at 512 rows a llama-2-7b layer's four projections are
// 215 G integer operations against ~60 MB of packed weights, far above the
// card's operations-per-byte line, so the dots run on the int8 tensor cores
// (mma.sync m16n8k32 s8 x s8 -> s32). Design:
//   * A prepass kernel rounds xn to int8 once per call, into a (B, K) int8
//     scratch, and writes the exact int32 block sums S (nb, Bp) (Bp = B
//     rounded up to 128; 0 for the pad rows). It stores xq in the lane order
//     of the packed bytes: within a scale block, position 4r + p holds lane
//     p*bs/4 + r, the lane of plane p of packed row r. A dot product does not
//     depend on the order of k as long as both operands follow it, and in
//     this order the four k of a thread's 32-bit B register are the four
//     planes of one packed byte.
//   * A CTA owns 128 output columns x BM rows (BM = 32, 64 or 128 by B;
//     128 only above 256 rows) and walks K in stages of 128 lanes (32
//     packed rows: four k32 steps). Eight warps: 2 across rows x 4 across
//     32-column slabs. A 4-stage cp.async
//     ring (16-byte copies) brings in, per stage, the xq tile (BM x 128
//     bytes, 16-byte chunks XOR-swizzled by row so that ldmatrix sees no
//     bank conflicts), the packed tile (32 x 128 bytes, rows padded to 160
//     bytes), the block's alpha for the 128 columns and the block's S for
//     the BM rows. Each packed byte is read once per row tile.
//   * The codes go straight from shared memory into mma B registers. The
//     n-index of an n8 tile is mapped (as in ternary_matmul_tc.cu) so that a
//     thread's four n8 tiles are four neighbouring columns: one 32-bit load
//     of a packed row gives the thread its byte of all four tiles. Four
//     masks and a 4x4 byte transpose (prmt) spread the four bytes' 2-bit
//     fields into the four B registers {u0, u1, u2, u3}; no float
//     conversion. The xq tile is plain row-major int8, read with
//     ldmatrix.x4.b16 (a thread's pair of b16 is its four s8 of the A
//     fragment).
//   * Each scale block's int32 fragment starts at -S (the C operand of its
//     first mma, plus the bias of a float's bit pattern), so it ends at
//     xq . u - S = xq . T exactly (|xq . T| <= 127 * bs: no overflow). Then
//     acc += alpha * float(d) in f32 registers. The offset term
//     sum_blk mu * S (the contract's alpha * u + (mu - alpha) rewritten as
//     alpha * T + mu) is the small
//     product S @ mu, run on the bf16 tensor cores before the K loop while
//     the ring fills, with S split in three bf16 parts (exact: |S| < 2^24)
//     and bf16 mu, so every operand is exact. The kernel differs from the
//     plain version only in the order of its f32 sums.
//
// The floor probe (impl="floor8": the FLOOR instances, C entry
// pt2_ternary_matmul_tc_a8_floor) replaces pallas_ternary.py:_accumulate_step's
// "floor" mode at these rows: the B register of a column is its packed byte itself,
// repeated in all four lanes (one prmt), in place of the masks and the
// transpose, so the fragment ends at xq . b - S with b the raw signed byte.
// |xq . b - S| <= 127 * 129 * bs stays below 2^22 (the float bias's span) up
// to bs = 256, the most the floor takes. The same bytes, grid and launches;
// outputs are wrong by design (ternary_matmul_floor_plain is the contract).
// wgmma, TMA and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;        // 8 warps: 2 across rows x 4 across columns
constexpr int BN = 128;             // output columns per CTA (32 per warp)
constexpr int KC = 128;             // lanes (xq bytes) per stage
constexpr int PROWS = KC / 4;       // packed rows per stage
constexpr int PSTRIDE = BN + 32;    // bytes per packed row in shared memory (40 words)
constexpr int STAGES = 4;
constexpr int ROW_PAD = 128;        // the block-sum scratch holds B rounded up to this
// A scale block's int32 fragment starts at F_BIAS - S: its bits then read as
// the float 1.5 * 2^23 + xq . T exactly (|xq . T| <= 127 * 2048 < 2^22), so
// one f32 subtraction converts it, where cvt from s32 runs at a quarter of
// the f32 rate.
constexpr int F_BIAS = 0x4B400000;
constexpr float F_BIAS_VALUE = 12582912.f;  // 1.5 * 2^23

template <int MT>  // m16 tiles per warp
struct Tile {
  static constexpr int BM = 2 * 16 * MT;
  static constexpr int X_BYTES = BM * KC;
  static constexpr int P_BYTES = PROWS * PSTRIDE;
  static constexpr int A_BYTES = BN * 2;  // the block's alpha, bf16
  static constexpr int S_BYTES = BM * 4;  // the block's S for the tile's rows, int32
  static constexpr int STAGE = X_BYTES + P_BYTES + A_BYTES + S_BYTES;
  static constexpr int SMEM = STAGES * STAGE;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes 0 fills the destination with zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// w holds one packed byte of each of four columns (byte i: column i). Out:
// b[i] = the four 2-bit fields of byte i, one per byte, plane 0 lowest:
// the s8 B register {u0, u1, u2, u3} of column i.
__device__ __forceinline__ void spread_codes(uint32_t w, uint32_t (&b)[4]) {
  const uint32_t p0 = w & 0x03030303u;  // byte i: plane 0 of column i
  const uint32_t p1 = (w >> 2) & 0x03030303u;
  const uint32_t p2 = (w >> 4) & 0x03030303u;
  const uint32_t p3 = (w >> 6) & 0x03030303u;
  const uint32_t t0 = __byte_perm(p0, p1, 0x5140);  // {p0[0], p1[0], p0[1], p1[1]}
  const uint32_t t1 = __byte_perm(p2, p3, 0x5140);  // {p2[0], p3[0], p2[1], p3[1]}
  const uint32_t t2 = __byte_perm(p0, p1, 0x7362);  // {p0[2], p1[2], p0[3], p1[3]}
  const uint32_t t3 = __byte_perm(p2, p3, 0x7362);  // {p2[2], p3[2], p2[3], p3[3]}
  b[0] = __byte_perm(t0, t1, 0x5410);
  b[1] = __byte_perm(t0, t1, 0x7632);
  b[2] = __byte_perm(t2, t3, 0x5410);
  b[3] = __byte_perm(t2, t3, 0x7632);
}

// The floor probe's B registers: b[i] = byte i of w (column i's raw packed
// byte) in all four of its bytes.
__device__ __forceinline__ void spread_raw(uint32_t w, uint32_t (&b)[4]) {
  b[0] = __byte_perm(w, 0u, 0x0000u);
  b[1] = __byte_perm(w, 0u, 0x1111u);
  b[2] = __byte_perm(w, 0u, 0x2222u);
  b[3] = __byte_perm(w, 0u, 0x3333u);
}

// The prepass. One warp per (row, block) of Bp x nb: lane l handles packed
// rows r = l, l + 32, ... of the block, reads xn at lanes p*bs/4 + r
// (p = 0..3), rounds each half to even and clips it to [-127, 127], and
// writes the four int8 as one word at positions 4r .. 4r + 3 of the block.
// sums[blk * Bp + row] = the block's sum of xq, exact in int32; 0 for the
// pad rows B <= row < Bp.
__global__ void __launch_bounds__(THREADS)
quantize_lanes_kernel(const __nv_bfloat16* __restrict__ xn, int8_t* __restrict__ xq,
                      int* __restrict__ sums, int B, int Bp, int K, int bs, int nb) {
  const int w = (blockIdx.x * THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= Bp * nb) return;
  const int blk = w / Bp;
  const int row = w - blk * Bp;
  const int bs4 = bs / 4;
  int s = 0;
  if (row < B) {
    const __nv_bfloat16* xr = xn + (size_t)row * K + (size_t)blk * bs;
    uint32_t* qr = reinterpret_cast<uint32_t*>(xq + (size_t)row * K + (size_t)blk * bs);
    for (int r = lane; r < bs4; r += 32) {
      uint32_t word = 0;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float v = fminf(fmaxf(rintf(__bfloat162float(xr[p * bs4 + r])), -127.f), 127.f);
        const int q = (int)v;
        s += q;
        word |= (uint32_t)(q & 0xff) << (8 * p);
      }
      qr[r] = word;
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) sums[w] = s;
}

template <int MT, bool FLOOR>
__global__ void __launch_bounds__(THREADS, MT == 4 ? 1 : 2)
ternary_matmul_tc_a8_kernel(const int8_t* __restrict__ xq,           // (B, K), lane order
                            const int8_t* __restrict__ packed,       // (K/4, n)
                            const __nv_bfloat16* __restrict__ alpha,  // (nb, n)
                            const __nv_bfloat16* __restrict__ mu,     // (nb, n)
                            const int* __restrict__ sums,            // (nb, Bp)
                            float* __restrict__ out,                 // (B, n)
                            int B, int Bp, int K, int n, int bs) {
  typedef Tile<MT> T;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;  // row half of the CTA tile
  const int wn = warp & 3;   // 32-column slab
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = blockIdx.x * T::BM;
  const int col0 = blockIdx.y * BN;
  const int spb = bs / KC;  // stages per scale block
  const int nst = K / KC;
  const int wrow = wm * MT * 16;  // first row of this warp's m16 tiles in the CTA tile
  // A warp whose rows all lie past B skips its dots. The test is per warp
  // and per stage, never per mma: a branch around each warp-wide mma or
  // ldmatrix costs a convergence barrier.
  const bool active = row0 + wrow < B;

  // xq copies: this thread's chunk xc (16 bytes) of tile rows xr0, xr0 + 32,
  // ...; chunk xc of row r is stored at chunk xc ^ (r % 8)
  const int xr0 = tid >> 3;
  const int xc = tid & 7;
  const uint32_t xdst = xr0 * KC + ((xc ^ (xr0 & 7)) << 4);

  auto load_stage = [&](int st, int buf) {
    unsigned char* sb = smem + buf * T::STAGE;
    const int blk = st / spb;
    const uint32_t xs = smem_u32(sb);
    const int8_t* xb = xq + (size_t)st * KC + xc * 16;
#pragma unroll
    for (int j = 0; j < T::BM / 32; ++j) {
      const int row = row0 + xr0 + 32 * j;
      const bool ok = row < B;
      cp_async16(xs + xdst + j * 32 * KC, ok ? xb + (size_t)row * K : xq, ok ? 16 : 0);
    }
    // packed: 32 rows x 8 chunks of 16 columns, one chunk per thread; the
    // stage's packed rows are 32 * st .. (blk * bs/4 + 32 c with c = st % spb)
    const uint32_t ps = xs + T::X_BYTES;
    {
      const int r = tid >> 3;
      const int q = tid & 7;
      cp_async16(ps + r * PSTRIDE + q * 16, packed + (size_t)(PROWS * st + r) * n + col0 + q * 16,
                 16);
    }
    if (tid < BN / 8)  // alpha of the block: 16 chunks
      cp_async16(ps + T::P_BYTES + tid * 16, alpha + (size_t)blk * n + col0 + tid * 8, 16);
    else if (tid >= 32 && tid < 32 + T::BM / 4)  // S of the block for the tile's rows
      cp_async16(ps + T::P_BYTES + T::A_BYTES + (tid - 32) * 16,
                 sums + (size_t)blk * Bp + row0 + (tid - 32) * 4, 16);
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst) load_stage(s, s);
    cp_async_commit();
  }

  // acc = S @ mu over this tile while the ring fills: A = S's rows split
  // into three bf16 parts, B = mu at this thread's columns wn*32 + 4g + i
  float acc[MT][4][4];
  int d[MT][4][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mi][i][e] = 0.f;
        d[mi][i][e] = 0;
      }
  const int nb = K / bs;
  const __nv_bfloat16* mcol = mu + col0 + wn * 32 + 4 * g;
  for (int kb = 0; kb < nb; kb += 16) {
    uint32_t b0[4], b1[4];
    {
      uint2 m[4];  // mu rows kb + 2t, +1, +8, +9: 4 bf16 columns each
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = kb + 2 * t + (e & 1) + 8 * (e >> 1);
        m[e] = k < nb ? *reinterpret_cast<const uint2*>(mcol + (size_t)k * n) : make_uint2(0, 0);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t sel = (i & 1) ? 0x7632 : 0x5410;
        b0[i] = __byte_perm((i < 2 ? m[0].x : m[0].y), (i < 2 ? m[1].x : m[1].y), sel);
        b1[i] = __byte_perm((i < 2 ? m[2].x : m[2].y), (i < 2 ? m[3].x : m[3].y), sel);
      }
    }
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      // a0: row g, k 2t..2t+1; a1: row g + 8; a2: k + 8; a3: row g + 8, k + 8
      uint32_t a[3][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + wrow + mi * 16 + g + 8 * (e & 1);
        const int k = kb + 2 * t + 8 * (e >> 1);
        float r0 = k < nb ? (float)sums[(size_t)k * Bp + row] : 0.f;
        float r1 = k + 1 < nb ? (float)sums[(size_t)(k + 1) * Bp + row] : 0.f;
#pragma unroll
        for (int part = 0; part < 3; ++part) {  // each part takes the next 8 bits
          const __nv_bfloat162 h = __floats2bfloat162_rn(r0, r1);
          const float2 hf = __bfloat1622float2(h);
          a[part][e] = *reinterpret_cast<const uint32_t*>(&h);
          r0 -= hf.x;
          r1 -= hf.y;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int part = 0; part < 3; ++part) mma_bf16(acc[mi][i], a[part], b0[i], b1[i]);
    }
  }

  // ldmatrix rows: lane l gives row l % 16 of an m16 tile, k half l / 16
  const int a_kh = lane >> 4;
  const int a_sw = lane & 7;  // == tile row % 8

  for (int st = 0; st < nst; ++st) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage st has landed; everyone is done with st - 1
    {
      const int nx = st + STAGES - 1;
      if (nx < nst) load_stage(nx, nx % STAGES);
      cp_async_commit();
    }
    if (!active) continue;
    unsigned char* sb = smem + (st % STAGES) * T::STAGE;
    const uint32_t a_row = smem_u32(sb) + (wrow + (lane & 15)) * KC;
    const unsigned char* ps = sb + T::X_BYTES;
    const int c = st % spb;

    if (c == 0) {  // a new scale block: each fragment starts at -S of its row
      const int* sr = reinterpret_cast<const int*>(ps + T::P_BYTES + T::A_BYTES) + wrow + g;
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const int s_lo = F_BIAS - sr[mi * 16];
        const int s_hi = F_BIAS - sr[mi * 16 + 8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          d[mi][i][0] = d[mi][i][1] = s_lo;  // C rows g (e 0, 1) and g + 8 (e 2, 3)
          d[mi][i][2] = d[mi][i][3] = s_hi;
        }
      }
    }

#pragma unroll
    for (int s = 0; s < 4; ++s) {
      // k32 step s: packed rows 8s .. 8s + 7 of the stage, xq bytes 32s .. 32s + 31
      uint32_t a[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
        ldmatrix_x4(a[mi], a_row + mi * 16 * KC + (((2 * s + a_kh) ^ a_sw) << 4));
      // b0: mma k 4t .. 4t + 3 = packed row 8s + t, planes 0-3; b1: k + 16 =
      // row 8s + 4 + t; at this thread's 4 columns wn*32 + 4g .. +3
      const unsigned char* pr = ps + (8 * s + t) * PSTRIDE + wn * 32 + 4 * g;
      uint32_t lo[4], hi[4];
      if constexpr (FLOOR) {
        spread_raw(*reinterpret_cast<const uint32_t*>(pr), lo);
        spread_raw(*reinterpret_cast<const uint32_t*>(pr + 4 * PSTRIDE), hi);
      } else {
        spread_codes(*reinterpret_cast<const uint32_t*>(pr), lo);
        spread_codes(*reinterpret_cast<const uint32_t*>(pr + 4 * PSTRIDE), hi);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) mma_s8(d[mi][i], a[mi], lo[i], hi[i]);
    }

    if (c == spb - 1) {  // the scale block is complete: apply alpha
      // the C fragment of tile i holds columns 8t + i (e 0, 2) and 8t + 4 + i (e 1, 3)
      const uint4 av = *reinterpret_cast<const uint4*>(ps + T::P_BYTES + 2 * (wn * 32 + 8 * t));
      const __nv_bfloat16* ah = reinterpret_cast<const __nv_bfloat16*>(&av);
      float sa[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) sa[j] = __bfloat162float(ah[j]);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[mi][i][e] += sa[i + 4 * (e & 1)] * (__int_as_float(d[mi][i][e]) - F_BIAS_VALUE);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = row0 + wrow + mi * 16 + g + 8 * hr;
      if (row < B) {
        float* o = out + (size_t)row * n + col0 + wn * 32 + 8 * t;
        *reinterpret_cast<float4*>(o) = make_float4(acc[mi][0][2 * hr], acc[mi][1][2 * hr],
                                                    acc[mi][2][2 * hr], acc[mi][3][2 * hr]);
        *reinterpret_cast<float4*>(o + 4) =
            make_float4(acc[mi][0][2 * hr + 1], acc[mi][1][2 * hr + 1], acc[mi][2][2 * hr + 1],
                        acc[mi][3][2 * hr + 1]);
      }
    }
  }
}

template <int MT, bool FLOOR>
cudaError_t launch(const void* xq, const void* packed, const void* alpha, const void* mu,
                   const void* sums, void* out, int B, int Bp, int K, int n, int bs,
                   cudaStream_t stream) {
  typedef Tile<MT> T;
  const cudaError_t e = cudaFuncSetAttribute(ternary_matmul_tc_a8_kernel<MT, FLOOR>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             T::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((B + T::BM - 1) / T::BM, n / BN);  // row tiles fastest: they share packed bytes
  ternary_matmul_tc_a8_kernel<MT, FLOOR><<<grid, THREADS, T::SMEM, stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(packed),
      static_cast<const __nv_bfloat16*>(alpha), static_cast<const __nv_bfloat16*>(mu),
      static_cast<const int*>(sums), static_cast<float*>(out), B, Bp, K, n, bs);
  return cudaGetLastError();
}

// Both C entries' work: the prepass, then the product (the floor probe's
// instances with floor_probe 1, bs <= 256).
int run(const void* xn, const void* packed, const void* alpha, const void* mu, void* xq,
        void* sums, void* out, int B, int Bp, int K, int n, int bs, bool floor_probe,
        int device, void* stream) {
  if (B < 1 || bs < KC || bs % KC != 0 || K < bs || K % bs != 0 || n < BN || n % BN != 0 ||
      Bp < B || Bp % ROW_PAD != 0 || (floor_probe && bs > 256))
    return (int)cudaErrorInvalidValue;
  const uintptr_t any = reinterpret_cast<uintptr_t>(xn) | reinterpret_cast<uintptr_t>(packed) |
                        reinterpret_cast<uintptr_t>(alpha) | reinterpret_cast<uintptr_t>(mu) |
                        reinterpret_cast<uintptr_t>(xq) | reinterpret_cast<uintptr_t>(sums) |
                        reinterpret_cast<uintptr_t>(out);
  if (any % 16 != 0) return (int)cudaErrorMisalignedAddress;
  // This library links its own CUDA runtime: follow the caller's device.
  int cur = -1;
  if (cudaGetDevice(&cur) != cudaSuccess || cur != device) {
    const cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = K / bs;
  const long long warps = (long long)Bp * nb;
  quantize_lanes_kernel<<<(unsigned)((warps * 32 + THREADS - 1) / THREADS), THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(xn), static_cast<int8_t*>(xq), static_cast<int*>(sums),
      B, Bp, K, bs, nb);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // 128-row tiles only from 257 rows: below that they leave most SMs idle
  // at n = 4096 (on an H100, 64-row tiles were faster at 128 rows)
#define PT2_TC_A8_ROWS(MT_)                                                          \
  e = floor_probe ? launch<MT_, true>(xq, packed, alpha, mu, sums, out, B, Bp, K, n, bs, s) \
                  : launch<MT_, false>(xq, packed, alpha, mu, sums, out, B, Bp, K, n, bs, s);
  if (B <= 32) {
    PT2_TC_A8_ROWS(1)
  } else if (B <= 256) {
    PT2_TC_A8_ROWS(2)
  } else {
    PT2_TC_A8_ROWS(4)
  }
#undef PT2_TC_A8_ROWS
  return (int)e;
}

}  // namespace

// C entry points bound with ctypes (pt2tpu_torch/ops/kernels/ternary.py).
// xn is the (B, K) bf16 normalised input; xq is scratch of B * K int8 and
// sums scratch of nb * Bp int32 (Bp = B rounded up to 128). Every pointer
// is 16-byte aligned. Returns the first CUDA error of the two launches; 0
// means both launched.
extern "C" int pt2_ternary_matmul_tc_a8(const void* xn, const void* packed, const void* alpha,
                                        const void* mu, void* xq, void* sums, void* out, int B,
                                        int Bp, int K, int n, int bs, int device, void* stream) {
  return run(xn, packed, alpha, mu, xq, sums, out, B, Bp, K, n, bs, false, device, stream);
}

// The floor probe (impl="floor8"): as pt2_ternary_matmul_tc_a8, the raw
// packed bytes as codes; bs <= 256.
extern "C" int pt2_ternary_matmul_tc_a8_floor(const void* xn, const void* packed,
                                              const void* alpha, const void* mu, void* xq,
                                              void* sums, void* out, int B, int Bp, int K, int n,
                                              int bs, int device, void* stream) {
  return run(xn, packed, alpha, mu, xq, sums, out, B, Bp, K, n, bs, true, device, stream);
}
