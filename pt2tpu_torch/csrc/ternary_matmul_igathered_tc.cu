// K3's rows 9 to 64 on the tensor cores, for Hopper (sm_90a).
//
// Replaces pt2tpu/ops/kernels/pallas_ternary.py:ternary_matmul_pallas_igathered
// (and its _stacked variant: the caller passes the views packed[li] and
// perm[li]) at 9 to 64 rows, bf16 and W2A8: the SSR input gather fused into
// the packed ternary product,
//
//   out[b, j] = sum_blk alpha[blk, j] * (xg_blk . T_blk[:, j])
//             + mu[blk, j] * sum(xg_blk),      xg[b, k] = x[b, perm[k]]
//
// in f32, (B, n), with T in {-1,0,1} unpacked from the plane-interleaved
// (K/4, n) int8 layout (byte [blk*bs/4 + r, j] holds lane
// blk*bs + p*bs/4 + r in bits 2p..2p+1, as u = T + 1), xg[b, k] = 0 for a pad
// lane (perm[k] >= m). bs % 128 == 0, n % 128 == 0. bf16 mode: x is bf16.
// W2A8 mode: x is the bf16 output of normalize_rows_a8 (the wrapper
// normalises the rows before the gather: absmax does not depend on column
// order); the gather rounds it half to even and clips it to [-127, 127],
// which is exact in bf16. The wrapper multiplies by the row scales. Decode
// rows (1 to 8) run csrc/ternary_matmul_dec.cu, other shapes
// csrc/ternary_matmul.cu; the wrapper picks by shape (k3_path in
// pt2tpu_torch/ops/kernels/ternary.py), never after a failure.
//
// What bounds it: at 64 rows a llama-3-8b qkv reads 7.1 MB of codes and
// scales and does 3.2 GFLOP, 455 operations per byte, above the card's bf16
// line (295), so the dots must run on the tensor cores; at 16 rows (114
// per byte) it is bound by the bytes. Two launches from one C entry:
//
//   1. A one-pass gather writes xg (Bp, K) bf16 to a scratch, with
//      Bp = 16, 32 or 64 rows (B rounded up to the kernel's row tiles; pad
//      rows zero), and the f32 block sums S (nb, Bp) of xg. A CTA walks eight
//      blocks of one row, so that row of x (8 KB at llama-3-8b) stays in
//      the SM's L1 while its scattered 2-byte reads come in. The gather is
//      not done in the product's staging, as the decode rows do: there x is
//      64 KB at 8 rows and lives in L1, but at 64 rows it is 512 KB, and
//      with an SSR perm every CTA of every column tile would pull one 32-byte
//      sector from L2 for each 2-byte value (about 0.5 GB of sector traffic
//      for one llama-3-8b qkv). One pass reads x once; the product then
//      streams xg with 16-byte copies. In W2A8 mode the pass also rounds.
//      xg is written in the order the mma fragments want: within a block,
//      position 8h + 2p + i holds lane p*bs/4 + 2h + i (the lanes of plane
//      p of packed rows 2h, 2h + 1), so one 16-byte shared load gives a
//      lane its B registers for all four planes.
//   2. A split-K mma.sync product over xg. A CTA (8 warps) owns 128 output
//      columns and a slice of bpc scale blocks; the wrapper picks the number
//      of slices (igtc_splits) so that each projection fills the card in
//      about one wave of CTAs (2 per SM). A 4-stage cp.async ring brings in,
//      per 128 lanes, the xg tile (Bp x 128 bf16, 16-byte chunks XOR-swizzled
//      by row parity, so a quarter warp's 16-byte loads hit distinct banks),
//      the codes (32 packed rows x 128 columns, rows padded to 144 bytes)
//      and the block's alpha and mu. The operands are swapped, as in the
//      decode kernel: A = 16 output columns x 16 lanes of codes, B = 16 lanes
//      x an n8 tile of rows. Warp w owns columns 16w .. 16w + 15 of the tile
//      (A row g is column 16w + 2g, row g + 8 column 16w + 2g + 1, so a
//      2-byte shared load of a packed row gives a lane both of its columns),
//      and each A fragment of codes is converted once (a byte permute, then
//      the mask / or / fma.rn.bf16x2 of csrc/ternary_matmul_tc.cu: T exact
//      in bf16) and fed to all NT = Bp / 8 row tiles. Each scale block's
//      products go to a fresh f32 fragment d; then acc += alpha * d and
//      acc += mu * S in f32 registers. No warp shares an output with another.
//      Each slice writes its own (B, n) f32 partial, and the last CTA of a
//      column tile to finish (found by an integer counter) sums the slices
//      in slice order: no float atomics, the same bits on every run.
//
// The W2A8 products are integers below 127 * bs < 2^24 per block, exact in
// f32, as in the decode kernel.
//
// The floor probe (impl="floor8", a8 mode 2; replaces
// pallas_ternary.py:_accumulate_step's "floor" mode at these rows): the
// gather rounds as in W2A8, and the product's FLOOR instance takes the raw
// signed byte b of a packed row as the code of all four of its planes, as
// T = b - 1 (the decode kernel's raw_bf16x2), so the epilogue stays
// alpha * d + mu * S. The same bytes, grid and launches; outputs are wrong by
// design (ternary_matmul_igathered_floor_plain is the contract).
//
// Why the decode kernel's swapped layout and not the prefill kernel's
// (A = x rows): with A = codes, one converted fragment feeds every row tile,
// and a warp's accumulators grow by 8 per row tile (acc and d, 4 each), so
// 64 rows fit in 127 registers at 16 columns a warp. ptxas (nvcc for
// sm_90a, -O3): the product at NT = 2 / 4 / 8 row tiles 94 / 123 / 127
// registers, the gather 34, no spills in any instance. On an H100 SXM
// (700 W) the gather takes about 2 us of device time a launch at
// llama-3-8b's 4096 lanes and 16-64 rows, the product 10-25 us
// (chip_smoke.py phase 14c, torch.profiler; PERF.md). wgmma, TMA and warp
// specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;     // 8 warps, 16 output columns each
constexpr int BN = 128;          // output columns per CTA
constexpr int KC = 128;          // lanes per ring stage
constexpr int PROWS = KC / 4;    // packed rows per stage
constexpr int PSTRIDE = BN + 16; // bytes per packed row in shared memory
constexpr int STAGES = 4;
constexpr int MIN_ROWS = 9;
constexpr int MAX_ROWS = 64;

template <int NT>  // n8 row tiles
struct Stage {
  static constexpr int BP = 8 * NT;
  static constexpr int X_BYTES = BP * KC * 2;
  static constexpr int P_BYTES = PROWS * PSTRIDE;
  static constexpr int AM_BYTES = 2 * BN * 2;  // alpha, then mu, bf16
  static constexpr int BYTES = X_BYTES + P_BYTES + AM_BYTES;
  static constexpr int SMEM = STAGES * BYTES;
};

// The rows of xg and S for B rows: the kernel's row tiles, 2, 4 or 8 of 8.
int rows_pad(int B) { return B <= 16 ? 16 : B <= 32 ? 32 : 64; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// One warp per (row, block) of the (Bp, K) scratch, row-major over the
// warps so that a CTA's eight warps share a row of x. Lane h of the block's
// bs/8 chunks writes positions 8h .. 8h + 7 (word p = lanes p*bs/4 + 2h and
// + 1, from one 8-byte perm load); rows >= B are zeros. The block's sum goes
// to sums[blk * Bp + row]: each lane adds its values in order, then the
// warp's butterfly.
template <bool A8>
__global__ void __launch_bounds__(THREADS)
gather_rows_kernel(const __nv_bfloat16* __restrict__ x,  // (B, m)
                   const int* __restrict__ perm,         // (K,)
                   __nv_bfloat16* __restrict__ xg,       // (Bp, K)
                   float* __restrict__ sums,             // (nb, Bp)
                   int B, int Bp, int m, int K, int bs) {
  const int nb = K / bs;
  const int w = (blockIdx.x * THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= Bp * nb) return;
  const int row = w / nb;
  const int blk = w - row * nb;
  const int bs4 = bs / 4;
  const unsigned short* xr = reinterpret_cast<const unsigned short*>(x) + (size_t)row * m;
  const int* pb = perm + (size_t)blk * bs;
  uint4* dst = reinterpret_cast<uint4*>(xg + (size_t)row * K + (size_t)blk * bs);
  float s = 0.f;
  for (int h = lane; h < bs / 8; h += 32) {
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (row < B) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int2 q = __ldg(reinterpret_cast<const int2*>(pb + p * bs4 + 2 * h));
        const uint32_t lo = (unsigned)q.x < (unsigned)m ? __ldg(xr + q.x) : 0u;
        const uint32_t hi = (unsigned)q.y < (unsigned)m ? __ldg(xr + q.y) : 0u;
        v[p] = lo | (hi << 16);
        float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v[p]));
        if (A8) {
          f = make_float2(rounded(f.x), rounded(f.y));
          const __nv_bfloat162 r = __floats2bfloat162_rn(f.x, f.y);
          v[p] = *reinterpret_cast<const uint32_t*>(&r);  // exact: integers <= 127
        }
        s += f.x;
        s += f.y;
      }
    }
    dst[h] = make_uint4(v[0], v[1], v[2], v[3]);
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) sums[(size_t)blk * Bp + row] = s;
}

// Grid (n / 128, splits). CTA (c, sp) sums blocks sp*bpc ..
// min(nb, (sp+1)*bpc) - 1 for columns 128c .. 128c + 127 into
// partial[sp, :B] (out when there is one slice); the last CTA of column
// tile c to finish, found by counters[c], sums partial[0 .. splits-1] in
// that order into out and sets counters[c] back to 0.
template <int NT, bool FLOOR>
__global__ void __launch_bounds__(THREADS, 2)
igathered_tc_kernel(const __nv_bfloat16* __restrict__ xg,    // (Bp, K), fragment order
                    const float* __restrict__ sums,          // (nb, Bp)
                    const int8_t* __restrict__ packed,       // (K/4, n)
                    const __nv_bfloat16* __restrict__ alpha, // (nb, n)
                    const __nv_bfloat16* __restrict__ mu,    // (nb, n)
                    float* __restrict__ partial,             // (splits, B, n)
                    float* __restrict__ out,                 // (B, n)
                    int* __restrict__ counters,              // (n / 128,), zero
                    int B, int K, int n, int bs, int bpc) {
  typedef Stage<NT> S;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  const int tid = threadIdx.x;
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
  const int upb = bs / KC;  // ring stages per scale block
  const int nunits = nblk * upb;
  const int bs4 = bs / 4;
  const uint32_t sbase = smem_u32(smem);

  // Stage u of the slice into ring slot u % STAGES: xg rows (chunk c of row
  // r at chunk c ^ 4 (r & 1)), then the codes, then alpha and mu
  auto load_unit = [&](int u) {
    const int lb = u / upb;
    const int uu = u - lb * upb;
    const int blk = blk0 + lb;
    const uint32_t st = sbase + (u % STAGES) * S::BYTES;
    const __nv_bfloat16* xs = xg + (size_t)blk * bs + uu * KC;
#pragma unroll
    for (int i = tid; i < S::BP * 16; i += THREADS) {
      const int r = i >> 4;
      const int c = i & 15;
      cp_async16(st + r * (KC * 2) + ((c ^ ((r & 1) << 2)) << 4), xs + (size_t)r * K + c * 8);
    }
    const int8_t* ps = packed + ((size_t)blk * bs4 + uu * PROWS) * n + col0;
    {
      const int r = tid >> 3;
      const int c = tid & 7;
      cp_async16(st + S::X_BYTES + r * PSTRIDE + c * 16, ps + (size_t)r * n + c * 16);
    }
    if (tid < 32) {
      const __nv_bfloat16* src =
          (tid < 16 ? alpha : mu) + (size_t)blk * n + col0 + 8 * (tid & 15);
      cp_async16(st + S::X_BYTES + S::P_BYTES + tid * 16, src);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nunits) load_unit(s);
    cp_async_commit();
  }

  // acc[nt][e] / d[nt][e]: row nt*8 + 2t + (e & 1), column 16w + 2g + (e >> 1)
  float acc[NT][4];
  float d[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int u = 0; u < nunits; ++u) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage u has landed; every warp is done with stage u - 1
    if (u + STAGES - 1 < nunits) load_unit(u + STAGES - 1);
    cp_async_commit();
    const int lb = u / upb;
    const int uu = u - lb * upb;
    const unsigned char* st = smem + (u % STAGES) * S::BYTES;
    if (uu == 0) {  // a new block: fresh fragments
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[nt][e] = 0.f;
    }
    const unsigned char* pc = st + S::X_BYTES + 16 * warp + 2 * g;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      // packed rows 8q + 2t and + 1, this lane's two columns in bytes 0, 1
      const uint32_t h0 = *reinterpret_cast<const unsigned short*>(pc + (8 * q + 2 * t) * PSTRIDE);
      const uint32_t h1 =
          *reinterpret_cast<const unsigned short*>(pc + (8 * q + 2 * t + 1) * PSTRIDE);
      const uint32_t wl = __byte_perm(h0, h1, 0x0400);  // column 2g: rows into bytes 0, 2
      const uint32_t wh = __byte_perm(h0, h1, 0x0501);  // column 2g + 1
      uint32_t a01[4], a23[4];
      if constexpr (FLOOR) {  // every plane reads the raw byte
        const uint32_t rl = raw_bf16x2(wl), rh = raw_bf16x2(wh);
        a01[0] = a23[0] = a01[2] = a23[2] = rl;
        a01[1] = a23[1] = a01[3] = a23[3] = rh;
      } else {
        a01[0] = codes_bf16x2<0>(wl), a01[1] = codes_bf16x2<0>(wh);
        a01[2] = codes_bf16x2<1>(wl), a01[3] = codes_bf16x2<1>(wh);
        a23[0] = codes_bf16x2<2>(wl), a23[1] = codes_bf16x2<2>(wh);
        a23[2] = codes_bf16x2<3>(wl), a23[3] = codes_bf16x2<3>(wh);
      }
      const int chunk = (4 * q + t) ^ ((g & 1) << 2);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint4 b = *reinterpret_cast<const uint4*>(st + (nt * 8 + g) * (KC * 2) + chunk * 16);
        mma_bf16(d[nt], a01, b.x, b.y);
        mma_bf16(d[nt], a23, b.z, b.w);
      }
    }
    if (uu == upb - 1) {  // the block is complete: acc += alpha * d + mu * S
      const unsigned char* am = st + S::X_BYTES + S::P_BYTES + 2 * (16 * warp + 2 * g);
      const float2 af = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(am));
      const float2 mf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(am + 2 * BN));
      const float* sb = sums + (size_t)(blk0 + lb) * S::BP + 2 * t;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 sv = __ldg(reinterpret_cast<const float2*>(sb + nt * 8));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[nt][e] = fmaf(e < 2 ? af.x : af.y, d[nt][e], acc[nt][e]);
          acc[nt][e] = fmaf(e < 2 ? mf.x : mf.y, (e & 1) ? sv.y : sv.x, acc[nt][e]);
        }
      }
    }
  }
  cp_async_wait<0>();

  float* o = splits > 1 ? partial + (size_t)sp * B * n : out;
  const int col = col0 + 16 * warp + 2 * g;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int row = nt * 8 + 2 * t;
    if (row < B)
      *reinterpret_cast<float2*>(o + (size_t)row * n + col) = make_float2(acc[nt][0], acc[nt][2]);
    if (row + 1 < B)
      *reinterpret_cast<float2*>(o + (size_t)(row + 1) * n + col) =
          make_float2(acc[nt][1], acc[nt][3]);
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

// What both C entries take: 9 <= B <= 64, Bp = rows_pad(B), bs a multiple of
// 128 dividing K, m >= 1; perm and xg 16-byte aligned, sums 8-byte, x 2-byte.
int check_gather(const void* x, const void* perm, const void* xg, const void* sums, int B,
                 int Bp, int m, int K, int bs) {
  if (B < MIN_ROWS || B > MAX_ROWS || Bp != rows_pad(B) || bs < KC || bs % KC != 0 || K < bs ||
      K % bs != 0 || m < 1)
    return (int)cudaErrorInvalidValue;
  if (x == nullptr || perm == nullptr || xg == nullptr || sums == nullptr)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(perm) | reinterpret_cast<uintptr_t>(xg)) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(sums) % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 2 != 0)
    return (int)cudaErrorMisalignedAddress;
  return 0;
}

int set_device(int device) {
  // This library links its own CUDA runtime: follow the caller's device.
  int cur = -1;
  if (cudaGetDevice(&cur) != cudaSuccess || cur != device) return (int)cudaSetDevice(device);
  return 0;
}

int launch_gather(const void* x, const void* perm, void* xg, void* sums, int B, int Bp, int m,
                  int K, int bs, int a8, cudaStream_t s) {
  const int warps = Bp * (K / bs);
  const dim3 grid((warps * 32 + THREADS - 1) / THREADS);
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  const int* pm = static_cast<const int*>(perm);
  __nv_bfloat16* gp = static_cast<__nv_bfloat16*>(xg);
  float* sp = static_cast<float*>(sums);
  if (a8)
    gather_rows_kernel<true><<<grid, THREADS, 0, s>>>(xp, pm, gp, sp, B, Bp, m, K, bs);
  else
    gather_rows_kernel<false><<<grid, THREADS, 0, s>>>(xp, pm, gp, sp, B, Bp, m, K, bs);
  return (int)cudaGetLastError();
}

template <int NT, bool FLOOR = false>
int launch_product(const void* xg, const void* sums, const void* packed, const void* alpha,
                   const void* mu, void* partial, void* out, void* counters, int B, int K, int n,
                   int bs, int splits, int bpc, cudaStream_t s) {
  const cudaError_t e = cudaFuncSetAttribute(igathered_tc_kernel<NT, FLOOR>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             Stage<NT>::SMEM);
  if (e != cudaSuccess) return (int)e;
  igathered_tc_kernel<NT, FLOOR><<<dim3(n / BN, splits), THREADS, Stage<NT>::SMEM, s>>>(
      static_cast<const __nv_bfloat16*>(xg), static_cast<const float*>(sums),
      static_cast<const int8_t*>(packed), static_cast<const __nv_bfloat16*>(alpha),
      static_cast<const __nv_bfloat16*>(mu), static_cast<float*>(partial),
      static_cast<float*>(out), static_cast<int*>(counters), B, K, n, bs, bpc);
  return (int)cudaGetLastError();
}

// The product for Bp = 16, 32 or 64 rows: the unpack's instance, or the
// floor probe's (a8 mode 2).
int launch_rows(int a8, int Bp, const void* xg, const void* sums, const void* packed,
                const void* alpha, const void* mu, void* partial, void* out, void* counters,
                int B, int K, int n, int bs, int splits, int bpc, cudaStream_t s) {
#define PT2_IGTC_ROWS(NT_)                                                                      \
  return a8 == 2 ? launch_product<NT_, true>(xg, sums, packed, alpha, mu, partial, out,        \
                                             counters, B, K, n, bs, splits, bpc, s)            \
                 : launch_product<NT_, false>(xg, sums, packed, alpha, mu, partial, out,       \
                                              counters, B, K, n, bs, splits, bpc, s);
  if (Bp == 16) PT2_IGTC_ROWS(2)
  if (Bp == 32) PT2_IGTC_ROWS(4)
  PT2_IGTC_ROWS(8)
#undef PT2_IGTC_ROWS
}

}  // namespace

// C entry points bound with ctypes (pt2tpu_torch/ops/kernels/ternary.py).
//
// The gather alone (its time is part of the product's): x (B, m) bf16 in
// feature order (W2A8: its normalised rows, rounded here), perm (K,) int32
// the visit lane -> feature map with pad lanes >= m, xg a (Bp, K) bf16
// scratch and sums an (nb, Bp) f32 scratch, Bp = 16, 32 or 64 (B rounded up
// to a multiple of 16, then to a power of two). Returns the launch's CUDA
// error; 0 means it launched.
extern "C" int pt2_ternary_matmul_igathered_tc_gather(const void* x, const void* perm, void* xg,
                                                      void* sums, int B, int Bp, int m, int K,
                                                      int bs, int a8, int device, void* stream) {
  int rc = check_gather(x, perm, xg, sums, B, Bp, m, K, bs);
  if (rc == 0) rc = set_device(device);
  if (rc != 0) return rc;
  return launch_gather(x, perm, xg, sums, B, Bp, m, K, bs, a8, static_cast<cudaStream_t>(stream));
}

// The whole path, two launches on the stream: the gather into xg / sums as
// above, then the product into out (B, n) f32 over `splits` K slices of
// bpc = ceil(nb / splits) blocks (none empty), whose partials go to a
// (splits, B, n) f32 scratch (not read when splits is 1), with counters
// n / 128 int32 that are 0 (each launch leaves them 0; launches that share
// them must not run concurrently). packed, alpha, mu, partial and out are
// 16-byte aligned, n a multiple of 128. a8: 0 bf16, 1 W2A8, 2 the floor
// probe (bs <= 1024: its block dots stay exact in f32).
extern "C" int pt2_ternary_matmul_igathered_tc(const void* x, const void* perm, const void* packed,
                                               const void* alpha, const void* mu, void* xg,
                                               void* sums, void* partial, void* out,
                                               void* counters, int B, int m, int K, int n, int bs,
                                               int splits, int a8, int device, void* stream) {
  const int Bp = rows_pad(B);
  int rc = check_gather(x, perm, xg, sums, B, Bp, m, K, bs);
  if (rc != 0) return rc;
  if (a8 < 0 || a8 > 2 || (a8 == 2 && bs > 1024)) return (int)cudaErrorInvalidValue;
  const int nb = K / bs;
  if (n < BN || n % BN != 0 || splits < 1 || splits > nb) return (int)cudaErrorInvalidValue;
  const int bpc = (nb + splits - 1) / splits;
  if ((splits - 1) * bpc >= nb) return (int)cudaErrorInvalidValue;
  if (packed == nullptr || alpha == nullptr || mu == nullptr || out == nullptr)
    return (int)cudaErrorInvalidValue;
  uintptr_t any = reinterpret_cast<uintptr_t>(packed) | reinterpret_cast<uintptr_t>(alpha) |
                  reinterpret_cast<uintptr_t>(mu) | reinterpret_cast<uintptr_t>(out);
  if (splits > 1) {
    if (partial == nullptr || counters == nullptr) return (int)cudaErrorInvalidValue;
    any |= reinterpret_cast<uintptr_t>(partial) | (reinterpret_cast<uintptr_t>(counters) & 3);
  }
  if (any % 16 != 0) return (int)cudaErrorMisalignedAddress;
  rc = set_device(device);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  rc = launch_gather(x, perm, xg, sums, B, Bp, m, K, bs, a8, s);
  if (rc != 0) return rc;
  return launch_rows(a8, Bp, xg, sums, packed, alpha, mu, partial, out, counters, B, K, n, bs,
                     splits, bpc, s);
}
