// Whole ternary MLP in one launch for Hopper (sm_90a): kernel K2 of the port.
//
// Replaces pt2tpu/ops/kernels/pallas_ternary.py:ternary_mlp_pallas and
// ternary_mlp_pallas_stacked (the stacked variant collapses into this one:
// the caller passes the zero-copy views of layer li).
//
// Contract (gated MLP, decode rows, bf16 activations, scale blocks of 128):
// with xg = x[:, perm] (0 on pad lanes) when a gather is attached, else x
// zero-padded to Kg lanes, and half = gu_n / 2 the stored gate width,
//
//   gate = xg @ dequant(gu[:, :half]),   up = xg @ dequant(gu[:, half:])
//   mid  = bf16(act(gate) * up)           (f32, cast as down's input)
//   out  = mid @ dequant(dn[:half])       (down's pad rows beyond half unread)
//
// where act is the TPU kernel's _act_fn (pallas_ternary.py): silu, gelu in
// its tanh form (jax.nn.gelu's default; GeGLU, gemma's MLP) or relu, a
// template parameter of the kernel. gelu uses tanhf, not tanh.approx.f32:
// the activation runs 128 x TB times per block, so the exact form costs
// nothing measurable, and the approximate one would spend part of the
// kernel's tolerance against its plain version.
//
// in f32: W = alpha * u + (mu - alpha), u = T + 1 (K1's arithmetic; in the
// gate/up phase alpha multiplies each code, which is exact, before the sum).
//
// The ungated MLP (the TPU kernel's gated = False: gateup is up alone,
// gu_n = half >= I lanes, pad columns with zero scales) is the GATED = false
// instance: mid = bf16(act(up)). Its thread columns 32..63 repeat the up
// lanes of columns 0..31 (the gated kernel's layout, kept: this kernel
// serves the rows the decode and tensor-core paths do not take).
//
// The floor probe (impl="floor8"; pallas_ternary.py:_make_mlp_kernel with
// a8mode "floor": _accumulate_step's floor branch for gate, up and down) is
// the FLOOR instance, C entry pt2_ternary_mlp_floor, instantiated at TB = 8
// only (a probe, not a route: fewer rows leave tile rows empty) and built
// from csrc/ternary_mlp_floor.cu, which includes this file with
// PT2_MLP_FLOOR defined (its instances and this file's 48 then compile in
// parallel; together they were the longest build, 94 s): x is rounded
// half to even and clipped to +-127 as it is staged (no row normalisation,
// as the TPU kernel's MLP wrapper has none), every plane of a packed row
// reads its raw signed byte b in place of its 2-bit field (W = alpha * b +
// (mu - alpha), the same arithmetic), and mid is rounded and clipped the
// same way. Outputs are wrong by design (ternary_mlp_floor_plain is the
// contract); every product and block sum is an integer below 2^24, exact in
// f32.
//
// Design. The TPU kernel walks the nv = half / 128 blocks of the
// intermediate dimension as sequential grid steps and carries the output in
// VMEM. On Hopper blocks run in no order, so one thread block owns one
// 128-wide I-block kv (112 at llama-3-8b) and a tile of TB rows:
//   1. it computes gate and up for its 128 lanes over all of xg (the x chunk
//      is staged in shared memory through the gather, as in K3; 64 thread
//      columns of 4 lanes each, gate then up, and 8 thread rows that split
//      each scale block's packed rows and are summed in a fixed order);
//   2. mid = act(gate) * up stays in shared memory as bf16, with its sum
//      for down's mu term;
//   3. it multiplies mid by down's 128 matching rows (packed rows kv*32 ..)
//      over all n outputs and writes that partial product to a (nv, B, n)
//      f32 workspace.
// A second small kernel adds the nv partials in a fixed order. Neither mid
// nor the (B, 2I) gateup output touches device memory; the partials do
// (nv * B * n * 4 bytes each way: 7.3 MB at llama-3-8b and B = 4, which fits
// in the 50 MB L2).
//
// What bounds it: bytes, for the least time the card could take. Every
// packed weight byte (0.25 B/weight) and every bf16 scale is read once per
// row tile; at B <= 8 that is one pass. Each
// thread keeps four scale blocks' packed words in flight (16 loads; two at
// TB = 8, where the row accumulators take the registers) in the gate/up
// phase and 8 rows of a column quad in the down phase. The dots run on the
// CUDA cores, one FMA per code and row plus a shared-memory load of x per
// code, so from B = 4 the instruction rate binds before the memory does;
// tensor cores (mma / wgmma) and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BS = 128;            // scale block = one I-block
constexpr int BS4 = BS / 4;        // packed rows per scale block
constexpr int CX = 64;             // thread columns: 32 gate quads, 32 up quads
constexpr int TY = 8;              // thread rows splitting a block's packed rows
constexpr int THREADS = CX * TY;   // 512
// Down's packed rows loaded together in phase 3. Unrolling all 32 rows
// (x 4 planes x TB rows x 4 columns) made the compiler move the arrays to
// local memory at TB >= 4 (5.6 KB of stack at TB = 8, 4x slower).
constexpr int P3G = 8;
constexpr int RPT = BS4 / TY;      // packed rows per thread and scale block: 4
constexpr int CHUNK = 2048;        // x lanes staged in shared memory per pass
constexpr int NBC = CHUNK / BS;    // scale blocks per chunk

// 4 neighbouring bf16 (8-byte aligned) as floats, returned by value so that
// no local array has its address taken (that would move it to local memory).
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi));
}

// The activations, by the code the C entry takes (0 silu, 1 gelu, 2 relu).
template <int ACT>
__device__ __forceinline__ float act_fn(float g) {
  if (ACT == 0) return g / (1.f + expf(-g));
  if (ACT == 1) return 0.5f * g * (1.f + tanhf(0.7978845608f * (g + 0.044715f * g * g * g)));
  return fmaxf(g, 0.f);
}

// The floor's rounding: half to even (rintf, as jnp.round), clipped to +-127
__device__ __forceinline__ float rounded(float f) { return fminf(fmaxf(rintf(f), -127.f), 127.f); }

// Code p of byte j of w as a float: the 2-bit field u, or (FLOOR) the raw
// signed byte for every plane
template <bool FLOOR>
__device__ __forceinline__ float code(uint32_t w, int j, int p) {
  if (FLOOR) return (float)(int8_t)(w >> (8 * j));
  return (float)((w >> (8 * j + 2 * p)) & 3u);
}

template <int TB, bool GATHER, int ACT, bool GATED, bool FLOOR>
__global__ void __launch_bounds__(THREADS)
ternary_mlp_kernel(const __nv_bfloat16* __restrict__ x,         // (B, m)
                   const int* __restrict__ perm,                // (Kg,) if GATHER
                   const int8_t* __restrict__ gu_packed,        // (Kg/4, gu_n)
                   const __nv_bfloat16* __restrict__ gu_alpha,  // (Kg/BS, gu_n)
                   const __nv_bfloat16* __restrict__ gu_mu,
                   const int8_t* __restrict__ dn_packed,        // (Kd/4, n)
                   const __nv_bfloat16* __restrict__ dn_alpha,  // (Kd/BS, n)
                   const __nv_bfloat16* __restrict__ dn_mu,
                   float* __restrict__ partial,                 // (nv, B, n)
                   int B, int m, int Kg, int gu_n, int half, int n) {
  // scale blocks whose words are loaded together (512 threads: <= 128 regs)
  constexpr int INFLIGHT = TB >= 8 ? 2 : 4;
  __shared__ __align__(16) __nv_bfloat16 xs[TB][CHUNK];
  __shared__ float bsum[TB][NBC];
  __shared__ float gu[TB][2 * BS];  // gate lanes 0..127, up lanes 128..255
  __shared__ __nv_bfloat16 mid[TB][BS];
  __shared__ float msum[TB];

  const int tid = threadIdx.x;
  const int cx = tid % CX;
  const int ty = tid / CX;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int kv = blockIdx.x;
  const int row0 = blockIdx.y * TB;
  const int col = cx < CX / 2 ? kv * BS + cx * 4
                                : (GATED ? half : 0) + kv * BS + (cx - CX / 2) * 4;

  // ---- 1. gate and up for this I-block's 2 x 128 lanes
  float acc[TB][4];
#pragma unroll
  for (int b = 0; b < TB; ++b)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[b][j] = 0.f;

  for (int c0 = 0; c0 < Kg; c0 += CHUNK) {
    const int cols = min(CHUNK, Kg - c0);
    const int nblk = cols / BS;
    __syncthreads();  // the previous pass is done with xs and bsum
    for (int i = tid; i < TB * CHUNK; i += THREADS) {
      const int b = i / CHUNK;
      const int k = i - b * CHUNK;
      float v = 0.f;
      if (row0 + b < B && k < cols) {
        const __nv_bfloat16* xr = x + (size_t)(row0 + b) * m;
        const int kk = c0 + k;
        if (GATHER) {
          const int p = perm[kk];
          if ((unsigned)p < (unsigned)m) v = __bfloat162float(xr[p]);
        } else if (kk < m) {
          v = __bfloat162float(xr[kk]);
        }
      }
      xs[b][k] = __float2bfloat16(FLOOR ? rounded(v) : v);  // exact: a bf16 value or 0
    }
    __syncthreads();
    for (int s = warp; s < TB * nblk; s += THREADS / 32) {
      const int b = s / nblk;
      const int blk = s - b * nblk;
      float t = 0.f;
      for (int k = lane; k < BS; k += 32) t += __bfloat162float(xs[b][blk * BS + k]);
#pragma unroll
      for (int o = 16; o; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
      if (lane == 0) bsum[b][blk] = t;
    }
    __syncthreads();

    for (int blk0 = 0; blk0 < nblk; blk0 += INFLIGHT) {
      uint32_t w[INFLIGHT][RPT];
      float a[INFLIGHT][4], off[INFLIGHT][4];
#pragma unroll
      for (int g = 0; g < INFLIGHT; ++g) {
        if (blk0 + g < nblk) {
          const int gblk = c0 / BS + blk0 + g;
#pragma unroll
          for (int i = 0; i < RPT; ++i)
            w[g][i] = *reinterpret_cast<const uint32_t*>(
                gu_packed + (size_t)(gblk * BS4 + ty + TY * i) * gu_n + col);
          const size_t so = (size_t)gblk * gu_n + col;
          const float4 av = load4(gu_alpha + so), mv = load4(gu_mu + so);
          a[g][0] = av.x; a[g][1] = av.y; a[g][2] = av.z; a[g][3] = av.w;
          off[g][0] = mv.x - av.x; off[g][1] = mv.y - av.y;
          off[g][2] = mv.z - av.z; off[g][3] = mv.w - av.w;
        }
      }
#pragma unroll
      for (int g = 0; g < INFLIGHT; ++g) {
        // a guard, not a break: the loop must unroll so that w, a and off
        // stay in registers
        if (blk0 + g >= nblk) continue;
        const int blk = blk0 + g;
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int r = ty + TY * i;
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            // alpha * u is exact (u in {0, 1, 2}; the floor's bytes need 8
            // bits), so alpha folds into the codes and no per-block partial
            // sum is kept
            float au[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) au[j] = a[g][j] * code<FLOOR>(w[g][i], j, p);
#pragma unroll
            for (int b = 0; b < TB; ++b) {
              const float xv = __bfloat162float(xs[b][blk * BS + p * BS4 + r]);
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[b][j] = fmaf(xv, au[j], acc[b][j]);
            }
          }
        }
        if (ty == 0) {
#pragma unroll
          for (int b = 0; b < TB; ++b)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[b][j] += off[g][j] * bsum[b][blk];
        }
      }
    }
  }

  // The 8 thread rows' partial sums, added in a fixed order.
  for (int y = 0; y < TY; ++y) {
    if (ty == y) {
#pragma unroll
      for (int b = 0; b < TB; ++b)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          gu[b][cx * 4 + j] = (y == 0 ? 0.f : gu[b][cx * 4 + j]) + acc[b][j];
    }
    __syncthreads();
  }

  // ---- 2. mid = act(gate) * up (ungated: act(up)) in f32, kept as bf16
  // (down's operand type)
  for (int i = tid; i < TB * BS; i += THREADS) {
    const int b = i / BS;
    const int c = i - b * BS;
    const float a = act_fn<ACT>(gu[b][c]);
    const float v = GATED ? a * gu[b][BS + c] : a;
    mid[b][c] = __float2bfloat16(FLOOR ? rounded(v) : v);
  }
  __syncthreads();
  if (warp < TB) {
    float t = 0.f;
    for (int c = lane; c < BS; c += 32) t += __bfloat162float(mid[warp][c]);
#pragma unroll
    for (int o = 16; o; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) msum[warp] = t;
  }
  __syncthreads();

  // ---- 3. mid @ down's rows of this I-block, over all n outputs
  const int8_t* dp = dn_packed + (size_t)kv * BS4 * n;
  for (int j0 = tid * 4; j0 < n; j0 += THREADS * 4) {
    const float4 a = load4(dn_alpha + (size_t)kv * n + j0);
    const float4 mv = load4(dn_mu + (size_t)kv * n + j0);
    const float4 off = make_float4(mv.x - a.x, mv.y - a.y, mv.z - a.z, mv.w - a.w);
    float d[TB][4];
#pragma unroll
    for (int b = 0; b < TB; ++b)
#pragma unroll
      for (int j = 0; j < 4; ++j) d[b][j] = 0.f;
#pragma unroll 1
    for (int r0 = 0; r0 < BS4; r0 += P3G) {
      uint32_t w[P3G];
#pragma unroll
      for (int r = 0; r < P3G; ++r)
        w[r] = *reinterpret_cast<const uint32_t*>(dp + (size_t)(r0 + r) * n + j0);
#pragma unroll
      for (int r = 0; r < P3G; ++r) {
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          float u[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) u[j] = code<FLOOR>(w[r], j, p);
#pragma unroll
          for (int b = 0; b < TB; ++b) {
            const float mv = __bfloat162float(mid[b][p * BS4 + r0 + r]);
#pragma unroll
            for (int j = 0; j < 4; ++j) d[b][j] += mv * u[j];
          }
        }
      }
    }
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      if (row0 + b < B) {
        float4 o;
        o.x = a.x * d[b][0] + off.x * msum[b];
        o.y = a.y * d[b][1] + off.y * msum[b];
        o.z = a.z * d[b][2] + off.z * msum[b];
        o.w = a.w * d[b][3] + off.w * msum[b];
        *reinterpret_cast<float4*>(partial + ((size_t)kv * B + row0 + b) * n + j0) = o;
      }
    }
  }
}

// out[i] = sum over kv of partial[kv, i], in the order kv = 0, 1, ...
__global__ void __launch_bounds__(256)
sum_partials_kernel(const float* __restrict__ partial, float* __restrict__ out,
                    int nv, int total) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= total) return;
  float t = 0.f;
#pragma unroll 8
  for (int kv = 0; kv < nv; ++kv) t += partial[(size_t)kv * total + i];
  out[i] = t;
}

template <int TB, int ACT, bool GATED, bool FLOOR>
void launch(bool gather, const void* x, const void* perm, const void* gp,
            const void* ga, const void* gm, const void* dp, const void* da,
            const void* dm, void* partial, int B, int m, int Kg, int gu_n,
            int half, int n, cudaStream_t s) {
  dim3 grid(half / BS, (B + TB - 1) / TB);
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  const int* ip = static_cast<const int*>(perm);
  const int8_t* gpp = static_cast<const int8_t*>(gp);
  const __nv_bfloat16* gap = static_cast<const __nv_bfloat16*>(ga);
  const __nv_bfloat16* gmp = static_cast<const __nv_bfloat16*>(gm);
  const int8_t* dpp = static_cast<const int8_t*>(dp);
  const __nv_bfloat16* dap = static_cast<const __nv_bfloat16*>(da);
  const __nv_bfloat16* dmp = static_cast<const __nv_bfloat16*>(dm);
  float* pp = static_cast<float*>(partial);
  if (gather)
    ternary_mlp_kernel<TB, true, ACT, GATED, FLOOR><<<grid, THREADS, 0, s>>>(
        xp, ip, gpp, gap, gmp, dpp, dap, dmp, pp, B, m, Kg, gu_n, half, n);
  else
    ternary_mlp_kernel<TB, false, ACT, GATED, FLOOR><<<grid, THREADS, 0, s>>>(
        xp, ip, gpp, gap, gmp, dpp, dap, dmp, pp, B, m, Kg, gu_n, half, n);
}

template <int ACT, bool GATED, bool FLOOR>
void launch_rows(bool gather, const void* x, const void* perm, const void* gp,
                 const void* ga, const void* gm, const void* dp, const void* da,
                 const void* dm, void* partial, int B, int m, int Kg, int gu_n,
                 int half, int n, cudaStream_t s) {
#define PT2_MLP_TB(TB_)                                                                     \
  launch<TB_, ACT, GATED, FLOOR>(gather, x, perm, gp, ga, gm, dp, da, dm, partial, B, m, Kg, \
                                 gu_n, half, n, s)
  if constexpr (FLOOR)
    PT2_MLP_TB(8);
  else if (B == 1)
    PT2_MLP_TB(1);
  else if (B == 2)
    PT2_MLP_TB(2);
  else if (B <= 4)
    PT2_MLP_TB(4);
  else
    PT2_MLP_TB(8);
#undef PT2_MLP_TB
}

template <bool GATED, bool FLOOR>
void launch_act(int act, bool gather, const void* x, const void* perm, const void* gp,
                const void* ga, const void* gm, const void* dp, const void* da, const void* dm,
                void* partial, int B, int m, int Kg, int gu_n, int half, int n, cudaStream_t s) {
  if (act == 0)
    launch_rows<0, GATED, FLOOR>(gather, x, perm, gp, ga, gm, dp, da, dm, partial, B, m, Kg,
                                 gu_n, half, n, s);
  else if (act == 1)
    launch_rows<1, GATED, FLOOR>(gather, x, perm, gp, ga, gm, dp, da, dm, partial, B, m, Kg,
                                 gu_n, half, n, s);
  else
    launch_rows<2, GATED, FLOOR>(gather, x, perm, gp, ga, gm, dp, da, dm, partial, B, m, Kg,
                                 gu_n, half, n, s);
}

// Both C entries: the MLP kernel and the fixed-order sum of its partials.
template <bool FLOOR>
int run(const void* x, const void* perm, const void* gu_packed, const void* gu_alpha,
        const void* gu_mu, const void* dn_packed, const void* dn_alpha, const void* dn_mu,
        void* partial, void* out, int B, int m, int Kg, int gu_n, int half, int Kd, int n,
        int act, int device, void* stream) {
  const bool gather = perm != nullptr;
  if (B < 1 || B > 64 || m < 1 || Kg < BS || Kg % BS != 0 || half < BS ||
      half % BS != 0 || (gu_n != 2 * half && gu_n != half) || half > Kd || Kd % BS != 0 ||
      n < 4 || n % 4 != 0 || (!gather && m > Kg) || act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  int cur = -1;
  if (cudaGetDevice(&cur) != cudaSuccess || cur != device) {
    const cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gu_n == 2 * half)
    launch_act<true, FLOOR>(act, gather, x, perm, gu_packed, gu_alpha, gu_mu, dn_packed,
                            dn_alpha, dn_mu, partial, B, m, Kg, gu_n, half, n, s);
  else
    launch_act<false, FLOOR>(act, gather, x, perm, gu_packed, gu_alpha, gu_mu, dn_packed,
                             dn_alpha, dn_mu, partial, B, m, Kg, gu_n, half, n, s);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int total = B * n;
  sum_partials_kernel<<<(total + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), half / BS,
      total);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point bound with ctypes (pt2tpu_torch/ops/kernels/ternary.py).
// perm is null for the path without a gather. gu_n is 2 * half (gated: gate
// lanes [0, half), then up) or half (ungated: up alone). partial is an
// (nv, B, n) f32 workspace, nv = half / 128; out is (B, n) f32; act is 0
// (silu), 1 (gelu, tanh form) or 2 (relu). Launches the MLP kernel and
// the fixed-order sum of its partials on the caller's stream; returns
// cudaGetLastError() after the launches, 0 meaning launched.
#ifndef PT2_MLP_FLOOR
extern "C" int pt2_ternary_mlp(const void* x, const void* perm,
                               const void* gu_packed, const void* gu_alpha,
                               const void* gu_mu, const void* dn_packed,
                               const void* dn_alpha, const void* dn_mu,
                               void* partial, void* out, int B, int m, int Kg,
                               int gu_n, int half, int Kd, int n, int act,
                               int device, void* stream) {
  return run<false>(x, perm, gu_packed, gu_alpha, gu_mu, dn_packed, dn_alpha, dn_mu, partial,
                    out, B, m, Kg, gu_n, half, Kd, n, act, device, stream);
}

#else
// The floor probe's MLP (impl="floor8"): as pt2_ternary_mlp, with x and mid
// rounded and clipped to +-127 and every plane's code the raw signed byte of
// its packed row (the header).
extern "C" int pt2_ternary_mlp_floor(const void* x, const void* perm, const void* gu_packed,
                                     const void* gu_alpha, const void* gu_mu,
                                     const void* dn_packed, const void* dn_alpha,
                                     const void* dn_mu, void* partial, void* out, int B, int m,
                                     int Kg, int gu_n, int half, int Kd, int n, int act,
                                     int device, void* stream) {
  return run<true>(x, perm, gu_packed, gu_alpha, gu_mu, dn_packed, dn_alpha, dn_mu, partial, out,
                   B, m, Kg, gu_n, half, Kd, n, act, device, stream);
}
#endif
