// Fused 2-bit unpack + matmul for Hopper (sm_90a): kernels K1 and K3 of the
// port.
//
// K1 replaces pt2tpu/ops/kernels/pallas_ternary.py:ternary_matmul_pallas and
// ternary_matmul_pallas_stacked (the stacked variant collapses into this one:
// the caller passes the zero-copy view packed[li]). With a traced index (the
// mixture-of-experts decode's routed experts) the IDX instances take the
// whole stack and read the slot from device memory (pt2_ternary_matmul_idx,
// pt2_ternary_matmul_igathered_idx; K1s / K3s at W2A8 decode rows).
//
// K3 replaces ternary_matmul_pallas_igathered and its _stacked variant: the
// SSR input gather fused into K1, out = x[:, perm] @ dequant(packed). It is
// K1 with one change: the x chunk is staged in shared memory through the
// indexed load x[b, perm[k]] (0 where perm[k] >= m), so the gathered
// activations never go through device memory. In W2A8 mode the wrapper
// normalises the rows of x before the gather (absmax does not depend on the
// order of the columns). The TPU kernel builds a one-hot matrix from perm
// and multiplies on the MXU; on Hopper the gather is the load itself.
//
// Contract (K1's, not its TPU block structure): with u = T + 1 in {0,1,2}
// unpacked from the plane-interleaved (K/4, n) int8 layout
// (pt2tpu_torch/core/packing.py) and W = alpha*(u-1) + mu = alpha*u + (mu-alpha),
//
//   out[b, j] = sum_blk alpha[blk, j] * (x_blk . u_blk[:, j])
//             + (mu[blk, j] - alpha[blk, j]) * sum(x_blk)
//
// accumulated in f32; alpha and mu are applied in f32. bf16 mode: x arrives
// as bf16. W2A8 mode: x arrives normalised to |x| <= 127 (the wrapper's
// normalize_rows_a8); the kernel rounds half-to-even (rintf, as jnp.round),
// clips to [-127, 127], and the dot against u runs in int32. The wrapper
// multiplies the output by the per-row scale.
//
// The floor probe (impl="floor8", mode 2 of the C entries' a8): W2A8 with
// the 2-bit extraction (w >> 2p) & 3 replaced by the raw signed byte, so
// every plane of a packed row reads the byte itself (the FLOOR instances).
// It replaces pallas_ternary.py:_accumulate_step's "floor" mode: the same
// bytes, grid and launches, the same offset and alpha terms, no unpack; its
// outputs are wrong by design (ternary_matmul_floor_plain is its contract).
//
// What bounds it: at decode batch sizes the work is reading the weights,
// 0.25 B/weight of packed codes plus 4 B per (block, column) of bf16 alpha
// and mu, so the kernel is bound by device-memory bytes. This first design
// reads every packed byte exactly once per row tile and never writes a
// dequantised weight: each thread loads 4 neighbouring bytes of a packed row
// (one 32-bit load; 8 threads cover 32 contiguous bytes, a full sector), and
// unpacks the 16 codes in registers with shifts and masks. The x chunk and
// its per-block sums are staged in shared memory. The K loop runs inside the
// block: the 32 thread rows split the packed rows of each scale block and
// their partial sums are reduced in shared memory at the end, so no
// cross-block reduction exists. Its dots run on the CUDA cores, not the
// tensor cores; wgmma, TMA and a packed-byte ring are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 8;              // threads across columns, 4 columns each
constexpr int TY = 32;             // threads across the packed rows of a block
constexpr int THREADS = TX * TY;   // 256
constexpr int TN = TX * 4;         // output columns per thread block
constexpr int CHUNK = 2048;        // x columns staged in shared memory per pass
constexpr int MIN_BS = 16;         // smallest scale block the kernel takes

template <int A8> struct Acc { typedef int T; };
template <> struct Acc<0> { typedef float T; };

// A8: 0 bf16, 1 W2A8, 2 the floor probe (W2A8's rounding, raw bytes as codes)
template <int TB, int A8, bool GATHER, bool IDX>
__global__ void __launch_bounds__(THREADS)
ternary_matmul_kernel(const __nv_bfloat16* __restrict__ x,      // (B, m)
                      const int* __restrict__ perm,             // (K,) if GATHER
                      const int8_t* __restrict__ packed,        // (K/4, n)
                      const __nv_bfloat16* __restrict__ alpha,  // (nb, n)
                      const __nv_bfloat16* __restrict__ mu,     // (nb, n)
                      float* __restrict__ out,                  // (B, n)
                      int B, int m, int K, int n, int bs,
                      const int* __restrict__ sel, int base, int S) {  // if IDX
  // x rows hold m values: m == K without GATHER; with GATHER lane k of the
  // block's x chunk is x[b, perm[k]], or 0 for a pad lane (perm[k] >= m).
  // With IDX packed, alpha, mu (and perm) are stacks of S slots: the block
  // reads slot base + *sel from device memory once (thread 0; a slot outside
  // [0, S) traps) and offsets them by it.
  typedef typename Acc<A8>::T D;
  if constexpr (IDX) {
    __shared__ int slot_s;
    if (threadIdx.x == 0) {
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
  // The x chunk (TB x ch bf16) and, after the K loop, the reduction buffer
  // (TY x TB x TN f32) share one allocation: both are 4096 * TB bytes.
  __shared__ __align__(16) unsigned char smem[TB * CHUNK * 2];
  __shared__ float bsum[TB][CHUNK / MIN_BS];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int col0 = blockIdx.x * TN + tx * 4;
  const int row0 = blockIdx.y * TB;
  const int bs4 = bs / 4;
  const int bpc = CHUNK / bs;
  const int ch = bpc * bs;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);

  float acc[TB][4];
#pragma unroll
  for (int b = 0; b < TB; ++b)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[b][j] = 0.f;

  for (int c0 = 0; c0 < K; c0 += ch) {
    const int cols = min(ch, K - c0);
    const int nblk = cols / bs;
    __syncthreads();  // the previous pass is done with xs and bsum
    for (int i = tid; i < TB * ch; i += THREADS) {
      const int b = i / ch;
      const int k = i - b * ch;
      float v = 0.f;
      if (row0 + b < B && k < cols) {
        if (GATHER) {
          const int p = perm[c0 + k];
          if ((unsigned)p < (unsigned)m) v = __bfloat162float(x[(size_t)(row0 + b) * m + p]);
        } else {
          v = __bfloat162float(x[(size_t)(row0 + b) * K + c0 + k]);
        }
        if (A8) v = fminf(fmaxf(rintf(v), -127.f), 127.f);
      }
      xs[i] = __float2bfloat16(v);  // exact: v is bf16, or an integer <= 127
    }
    __syncthreads();
    // Per-(row, block) sums of the staged x, one warp per sum.
    for (int s = warp; s < TB * nblk; s += THREADS / 32) {
      const int b = s / nblk;
      const int blk = s - b * nblk;
      const __nv_bfloat16* xr = xs + b * ch + blk * bs;
      float t = 0.f;
      for (int k = lane; k < bs; k += 32) t += __bfloat162float(xr[k]);
#pragma unroll
      for (int o = 16; o; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
      if (lane == 0) bsum[b][blk] = t;
    }
    __syncthreads();

    for (int blk = 0; blk < nblk; ++blk) {
      const int gblk = c0 / bs + blk;
      D d[TB][4];
#pragma unroll
      for (int b = 0; b < TB; ++b)
#pragma unroll
        for (int j = 0; j < 4; ++j) d[b][j] = 0;
      for (int r = ty; r < bs4; r += TY) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(
            packed + (size_t)(gblk * bs4 + r) * n + col0);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          D u[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            u[j] = A8 == 2 ? (D)(int8_t)(w >> (8 * j)) : (D)((w >> (8 * j + 2 * p)) & 3u);
          const __nv_bfloat16* xk = xs + blk * bs + p * bs4 + r;
#pragma unroll
          for (int b = 0; b < TB; ++b) {
            const float xv = __bfloat162float(xk[b * ch]);
            const D xd = (D)xv;
#pragma unroll
            for (int j = 0; j < 4; ++j) d[b][j] += xd * u[j];
          }
        }
      }
      const size_t so = (size_t)gblk * n + col0;
      float a[4], off[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a[j] = __bfloat162float(alpha[so + j]);
        off[j] = __bfloat162float(mu[so + j]) - a[j];
      }
#pragma unroll
      for (int b = 0; b < TB; ++b)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[b][j] += a[j] * (float)d[b][j];
          if (ty == 0) acc[b][j] += off[j] * bsum[b][blk];
        }
    }
  }

  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // [TY][TB][TN]
#pragma unroll
  for (int b = 0; b < TB; ++b)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[(ty * TB + b) * TN + tx * 4 + j] = acc[b][j];
  __syncthreads();
  for (int o = tid; o < TB * TN; o += THREADS) {
    const int b = o / TN;
    const int c = o - b * TN;
    float t = 0.f;
#pragma unroll 8
    for (int y = 0; y < TY; ++y) t += red[(y * TB + b) * TN + c];
    if (row0 + b < B) out[(size_t)(row0 + b) * n + blockIdx.x * TN + c] = t;
  }
}

template <int TB, bool GATHER, bool IDX>
void launch(int a8, const void* x, const void* perm, const void* packed,
            const void* alpha, const void* mu, void* out, int B, int m, int K,
            int n, int bs, const int* sel, int base, int S, cudaStream_t stream) {
  dim3 grid(n / TN, (B + TB - 1) / TB);
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  const int* ip = static_cast<const int*>(perm);
  const int8_t* pp = static_cast<const int8_t*>(packed);
  const __nv_bfloat16* ap = static_cast<const __nv_bfloat16*>(alpha);
  const __nv_bfloat16* mp = static_cast<const __nv_bfloat16*>(mu);
  float* op = static_cast<float*>(out);
  if (a8 == 2)
    ternary_matmul_kernel<TB, 2, GATHER, IDX><<<grid, THREADS, 0, stream>>>(
        xp, ip, pp, ap, mp, op, B, m, K, n, bs, sel, base, S);
  else if (a8)
    ternary_matmul_kernel<TB, 1, GATHER, IDX><<<grid, THREADS, 0, stream>>>(
        xp, ip, pp, ap, mp, op, B, m, K, n, bs, sel, base, S);
  else
    ternary_matmul_kernel<TB, 0, GATHER, IDX><<<grid, THREADS, 0, stream>>>(
        xp, ip, pp, ap, mp, op, B, m, K, n, bs, sel, base, S);
}

template <bool GATHER, bool IDX = false>
int dispatch(const void* x, const void* perm, const void* packed,
             const void* alpha, const void* mu, void* out, int B, int m, int K,
             int n, int bs, int a8, int device, void* stream,
             const void* sel = nullptr, int base = 0, int S = 0) {
  if (B < 1 || m < 1 || bs < MIN_BS || bs > CHUNK || bs % 4 != 0 ||
      K % bs != 0 || n % TN != 0 || a8 < 0 || a8 > 2)
    return (int)cudaErrorInvalidValue;
  if (IDX && (sel == nullptr || reinterpret_cast<uintptr_t>(sel) % 4 != 0 || S < 1))
    return (int)cudaErrorInvalidValue;
  const int* ix = static_cast<const int*>(sel);
  // This library links its own CUDA runtime: follow the caller's device.
  int cur = -1;
  if (cudaGetDevice(&cur) != cudaSuccess || cur != device) {
    const cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int q = a8;
  if (B == 1)
    launch<1, GATHER, IDX>(q, x, perm, packed, alpha, mu, out, B, m, K, n, bs, ix, base,
                             S, s);
  else if (B == 2)
    launch<2, GATHER, IDX>(q, x, perm, packed, alpha, mu, out, B, m, K, n, bs, ix, base,
                             S, s);
  else if (B <= 4)
    launch<4, GATHER, IDX>(q, x, perm, packed, alpha, mu, out, B, m, K, n, bs, ix, base,
                             S, s);
  else
    launch<8, GATHER, IDX>(q, x, perm, packed, alpha, mu, out, B, m, K, n, bs, ix, base,
                             S, s);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point bound with ctypes (pt2tpu_torch/ops/kernels/ternary.py).
// a8: 0 bf16, 1 W2A8, 2 the floor probe (both on normalised rows).
// Returns cudaGetLastError() after the launch; 0 means launched.
extern "C" int pt2_ternary_matmul(const void* x, const void* packed,
                                  const void* alpha, const void* mu, void* out,
                                  int B, int K, int n, int bs, int a8,
                                  int device, void* stream) {
  return dispatch<false>(x, nullptr, packed, alpha, mu, out, B, K, K, n, bs,
                         a8, device, stream);
}

// K3: x is (B, m), perm is (K,) int32 (pt2tpu_torch/ops/kernels/ternary.py).
extern "C" int pt2_ternary_matmul_igathered(const void* x, const void* perm,
                                            const void* packed,
                                            const void* alpha, const void* mu,
                                            void* out, int B, int m, int K,
                                            int n, int bs, int a8, int device,
                                            void* stream) {
  return dispatch<true>(x, perm, packed, alpha, mu, out, B, m, K, n, bs, a8,
                        device, stream);
}

// The device-index entries (K1s / K3s): as the two above, with packed
// (S, K/4, n), alpha and mu (S, nb, n) and, for K3, perm (S, K) whole
// contiguous stacks, and the slot base + *sel read by each block from device
// memory (sel: one int32 on the card; base: a host offset). A slot outside
// [0, S) traps.
extern "C" int pt2_ternary_matmul_idx(const void* x, const void* packed,
                                      const void* alpha, const void* mu,
                                      void* out, const void* sel, int base,
                                      int S, int B, int K, int n, int bs,
                                      int a8, int device, void* stream) {
  return dispatch<false, true>(x, nullptr, packed, alpha, mu, out, B, K, K, n,
                               bs, a8, device, stream, sel, base, S);
}

extern "C" int pt2_ternary_matmul_igathered_idx(
    const void* x, const void* perm, const void* packed, const void* alpha,
    const void* mu, void* out, const void* sel, int base, int S, int B, int m,
    int K, int n, int bs, int a8, int device, void* stream) {
  return dispatch<true, true>(x, perm, packed, alpha, mu, out, B, m, K, n, bs,
                              a8, device, stream, sel, base, S);
}
