// K1's many-row path on the tensor cores, for Hopper (sm_90a).
//
// Replaces pt2tpu/ops/kernels/pallas_ternary.py:ternary_matmul_pallas (and
// its _stacked variant: the caller passes the view packed[li]) at prefill
// row counts in bf16 mode. Decode rows and W2A8 stay on the CUDA-core K1
// (csrc/ternary_matmul.cu); the wrapper picks by shape (k1_path in
// pt2tpu_torch/ops/kernels/ternary.py), never after a failure.
//
// Contract (K1's): with u = T + 1 in {0,1,2} unpacked from the plane-
// interleaved (K/4, n) int8 layout (byte [blk*bs/4 + r, j] holds lanes
// blk*bs + p*bs/4 + r in bits 2p..2p+1),
//
//   out[b, j] = sum_blk alpha[blk, j] * (x_blk . u_blk[:, j])
//             + (mu[blk, j] - alpha[blk, j]) * sum(x_blk)
//
// x is bf16, the sums are f32, the output is (B, n) f32. Takes
// bs % 128 == 0 and n % 128 == 0 (what the JAX kernel asserts), any B >= 1.
//
// What bounds it: at 512 rows a llama-2-7b layer's four projections are
// 215 GFLOP against ~60 MB of packed weights, far above the card's
// operations-per-byte line, so the dots must run on the tensor cores.
// Design:
//   * A CTA owns 128 output columns x BM rows (BM = 32, 64 or 128 by B) and
//     walks K in stages of 128 lanes (32 packed rows; a scale block is
//     bs/128 stages). Eight warps: 2 across rows x 4 across 32-column slabs.
//   * A 4-stage cp.async ring (16-byte copies) brings in, per stage, the x
//     tile (BM x 128 bf16, 16-byte chunks XOR-swizzled by row so ldmatrix
//     sees no bank conflicts), the packed tile (32 x 128 bytes, rows padded
//     to 144 bytes) and the block's alpha for the 128 columns. Each packed
//     byte is read once per row tile.
//   * The codes go straight from shared memory into mma B fragments: the
//     n-index of an m16n8k16 tile is mapped so that a thread's four n8 tiles
//     are four neighbouring columns, so one 32-bit load of a packed row gives
//     that thread's bytes for all four tiles, and each byte feeds four k16
//     steps (its four planes). A plane's code becomes the bf16 pair
//     (128 + u * 4^q) by a mask and an or, and T = u - 1 exactly by one
//     bf16x2 fma (planes 0-2; plane 3 is shifted first).
//   * mma.sync m16n8k16 bf16 x bf16 -> f32. T in {-1,0,1} and bf16 x are
//     exact operands, so only the summation order differs from the plain
//     version. Each scale block's products go to a fresh fragment d; then
//     acc += alpha * d in f32 registers: alpha * T is never rounded to bf16.
//   * The offset term sum_blk mu[blk, j] * sum(x_blk) (the contract's
//     alpha * u + (mu - alpha) rewritten as alpha * T + mu) is a small
//     product S @ mu with S the (B, nb) row sums of x per block. A first
//     kernel writes S in f32 (one warp per (row, block)) to a scratch the
//     wrapper allocates; each CTA splits its rows of S into three bf16 parts
//     (S = s0 + s1 + s2 to 2^-24 relative, as f32 holds it) and runs
//     s0 @ mu + s1 @ mu + s2 @ mu on the tensor cores into acc before its K
//     loop, while the ring fills. mu is bf16, so every operand is exact.
// wgmma, TMA and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;        // 8 warps: 2 across rows x 4 across columns
constexpr int BN = 128;             // output columns per CTA (32 per warp)
constexpr int KC = 128;             // lanes per stage
constexpr int PROWS = KC / 4;       // packed rows per stage
constexpr int PSTRIDE = BN + 16;    // bytes per packed row in shared memory
constexpr int STAGES = 4;
constexpr int ROW_PAD = 128;        // the row-sum scratch holds B rounded up to this

template <int MT>  // m16 tiles per warp
struct Tile {
  static constexpr int BM = 2 * 16 * MT;
  static constexpr int X_BYTES = BM * KC * 2;
  static constexpr int P_BYTES = PROWS * PSTRIDE;
  static constexpr int A_BYTES = BN * 2;  // the block's alpha, bf16
  static constexpr int STAGE = X_BYTES + P_BYTES + A_BYTES;
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

// sums[blk * Bp + row] = sum of x[row, blk*bs : (blk+1)*bs] in f32; 0 for
// the pad rows B <= row < Bp. One warp per (row, block).
__global__ void __launch_bounds__(THREADS)
block_sums_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ sums, int B, int Bp,
                  int K, int bs, int nb) {
  const int w = (blockIdx.x * THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= Bp * nb) return;
  const int blk = w / Bp;
  const int row = w - blk * Bp;
  float s = 0.f;
  if (row < B) {
    const __nv_bfloat16* xr = x + (size_t)row * K + (size_t)blk * bs;
    for (int k = lane * 8; k < bs; k += 256) {
      const uint4 v = *reinterpret_cast<const uint4*>(xr + k);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        s += f.x + f.y;
      }
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) sums[w] = s;
}

// One k16 step of a stage: plane P of packed rows 16h .. 16h + 15, i.e.
// stage lanes 32P + 16h .. +15, for MT m16 tiles x 4 n8 tiles.
template <int P, int MT>
__device__ __forceinline__ void step(uint32_t a_row, int a_kh, int a_sw, int h,
                                     const uint32_t (&lo)[4], const uint32_t (&hi)[4],
                                     float (&d)[MT][4][4]) {
  const int s = 2 * P + h;
  uint32_t a[MT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
    ldmatrix_x4(a[mi], a_row + mi * 16 * (KC * 2) + (((2 * s + a_kh) ^ a_sw) << 4));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t b0 = codes_bf16x2<P>(lo[i]);
    const uint32_t b1 = codes_bf16x2<P>(hi[i]);
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) mma_bf16(d[mi][i], a[mi], b0, b1);
  }
}

template <int MT>
__global__ void __launch_bounds__(THREADS, MT == 4 ? 1 : 2)
ternary_matmul_tc_kernel(const __nv_bfloat16* __restrict__ x,      // (B, K)
                         const int8_t* __restrict__ packed,        // (K/4, n)
                         const __nv_bfloat16* __restrict__ alpha,  // (nb, n)
                         const __nv_bfloat16* __restrict__ mu,     // (nb, n)
                         const float* __restrict__ sums,           // (nb, Bp)
                         float* __restrict__ out,                  // (B, n)
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
  const int bs4 = bs / 4;
  const int spb = bs / KC;  // stages per scale block
  const int nst = K / KC;
  const int wrow = wm * MT * 16;  // first row of this warp's m16 tiles in the CTA tile
  // A warp whose rows all lie past B skips its dots. The test is per warp
  // and per stage, never per mma: a branch around each warp-wide mma or
  // ldmatrix costs a convergence barrier.
  const bool active = row0 + wrow < B;

  // x copies: this thread's chunk xq (8 lanes) of tile rows xr0, xr0 + 16, ...
  // Chunk q holds plane q/4, packed rows 32c + (q%4)*8 .. +8 of the block,
  // and is stored at chunk q ^ (row % 8).
  const int xr0 = tid >> 4;
  const int xq = tid & 15;
  const int xlane = (xq >> 2) * bs4 + (xq & 3) * 8;
  const uint32_t xdst = xr0 * (KC * 2) + ((xq ^ (xr0 & 7)) << 4);

  auto load_stage = [&](int st, int buf) {
    unsigned char* sb = smem + buf * T::STAGE;
    const int blk = st / spb;
    const int c = st - blk * spb;
    const uint32_t xs = smem_u32(sb);
    const __nv_bfloat16* xb = x + (size_t)blk * bs + 32 * c + xlane;
#pragma unroll
    for (int j = 0; j < T::BM / 16; ++j) {
      const int row = row0 + xr0 + 16 * j;
      const bool ok = row < B;
      cp_async16(xs + xdst + j * 16 * (KC * 2), ok ? xb + (size_t)row * K : x, ok ? 16 : 0);
    }
    // packed: 32 rows x 8 chunks of 16 columns, one chunk per thread
    const uint32_t ps = xs + T::X_BYTES;
    {
      const int r = tid >> 3;
      const int q = tid & 7;
      cp_async16(ps + r * PSTRIDE + q * 16,
                 packed + (size_t)(blk * bs4 + 32 * c + r) * n + col0 + q * 16, 16);
    }
    if (tid < BN / 8)  // alpha of the block: 16 chunks
      cp_async16(ps + T::P_BYTES + tid * 16, alpha + (size_t)blk * n + col0 + tid * 8, 16);
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst) load_stage(s, s);
    cp_async_commit();
  }

  // acc = S @ mu over this tile while the ring fills: A = S's rows split
  // into three bf16 parts, B = mu at this thread's columns wn*32 + 4g + i
  float acc[MT][4][4];
  float d[MT][4][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][i][e] = d[mi][i][e] = 0.f;
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
        float r0 = k < nb ? sums[(size_t)k * Bp + row] : 0.f;
        float r1 = k + 1 < nb ? sums[(size_t)(k + 1) * Bp + row] : 0.f;
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
    unsigned char* sb = smem + (st % STAGES) * T::STAGE;
    const uint32_t a_row = smem_u32(sb) + (wrow + (lane & 15)) * (KC * 2);
    const unsigned char* ps = sb + T::X_BYTES;
    if (!active) continue;

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // packed rows 16h + 2t, +1, +8, +9 at this thread's 4 columns wn*32 + 4g .. +3
      const unsigned char* pr = ps + (16 * h + 2 * t) * PSTRIDE + wn * 32 + 4 * g;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(pr);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(pr + PSTRIDE);
      const uint32_t w8 = *reinterpret_cast<const uint32_t*>(pr + 8 * PSTRIDE);
      const uint32_t w9 = *reinterpret_cast<const uint32_t*>(pr + 9 * PSTRIDE);
      uint32_t lo[4], hi[4];  // n8 tile i: column 4g + i's bytes of two rows in bytes 0 and 2
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t sel = i | (i << 4) | ((4 + i) << 8) | ((4 + i) << 12);
        lo[i] = __byte_perm(w0, w1, sel);
        hi[i] = __byte_perm(w8, w9, sel);
      }
      step<0>(a_row, a_kh, a_sw, h, lo, hi, d);
      step<1>(a_row, a_kh, a_sw, h, lo, hi, d);
      step<2>(a_row, a_kh, a_sw, h, lo, hi, d);
      step<3>(a_row, a_kh, a_sw, h, lo, hi, d);
    }

    if ((st + 1) % spb == 0) {  // the scale block is complete: apply alpha
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
          for (int e = 0; e < 4; ++e) {
            acc[mi][i][e] += sa[i + 4 * (e & 1)] * d[mi][i][e];
            d[mi][i][e] = 0.f;
          }
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

template <int MT>
cudaError_t launch(const void* x, const void* packed, const void* alpha, const void* mu,
                   const void* sums, void* out, int B, int Bp, int K, int n, int bs,
                   cudaStream_t stream) {
  typedef Tile<MT> T;
  const cudaError_t e = cudaFuncSetAttribute(
      ternary_matmul_tc_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((B + T::BM - 1) / T::BM, n / BN);  // row tiles fastest: they share packed bytes
  ternary_matmul_tc_kernel<MT><<<grid, THREADS, T::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(packed),
      static_cast<const __nv_bfloat16*>(alpha), static_cast<const __nv_bfloat16*>(mu),
      static_cast<const float*>(sums), static_cast<float*>(out), B, Bp, K, n, bs);
  return cudaGetLastError();
}

}  // namespace

// C entry point bound with ctypes (pt2tpu_torch/ops/kernels/ternary.py).
// sums is scratch of nb * Bp f32 (Bp = B rounded up to 128). Every pointer
// is 16-byte aligned. Returns the first CUDA error of the two launches; 0
// means both launched.
extern "C" int pt2_ternary_matmul_tc(const void* x, const void* packed, const void* alpha,
                                     const void* mu, void* sums, void* out, int B, int Bp, int K,
                                     int n, int bs, int device, void* stream) {
  if (B < 1 || bs < KC || bs % KC != 0 || K < bs || K % bs != 0 || n < BN || n % BN != 0 ||
      Bp < B || Bp % ROW_PAD != 0)
    return (int)cudaErrorInvalidValue;
  const uintptr_t any = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(packed) |
                        reinterpret_cast<uintptr_t>(alpha) | reinterpret_cast<uintptr_t>(mu) |
                        reinterpret_cast<uintptr_t>(sums) | reinterpret_cast<uintptr_t>(out);
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
  block_sums_kernel<<<(unsigned)((warps * 32 + THREADS - 1) / THREADS), THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<float*>(sums), B, Bp, K, bs, nb);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (B <= 32)
    e = launch<1>(x, packed, alpha, mu, sums, out, B, Bp, K, n, bs, s);
  else if (B <= 64)
    e = launch<2>(x, packed, alpha, mu, sums, out, B, Bp, K, n, bs, s);
  else
    e = launch<4>(x, packed, alpha, mu, sums, out, B, Bp, K, n, bs, s);
  return (int)e;
}
