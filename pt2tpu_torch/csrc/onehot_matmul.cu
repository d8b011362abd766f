// Packed one-hot gather for Hopper (sm_90a): kernel K5 of the port.
//
// Replaces pt2tpu/ops/kernels/pallas_gather.py:onehot_matmul_pallas and
// onehot_matmul_pallas_stacked (the stacked variant at a host index
// collapses into this one: the caller passes the zero-copy view packed[li]).
// K5s, the stacked variant with a traced index (a routed expert's gather),
// is the IDX instance, C entry pt2_onehot_matmul_idx: G is the whole
// (S, D/4, K) stack and each block reads its slot, base + *sel, from device
// memory. Rows from 16 run csrc/onehot_matmul_rows.cu, which takes no
// device index.
//
// Contract: out[b, k] = sum_i x[b, i] * u[i, k], where u is the raw 2-bit
// field of G (the stored code + 1; {0, 1} and one-hot per column for a
// permutation, all-zero for a pad lane) and x (rows, m) is zero-padded to
// D >= m features. G is (D/4, K) int8 in the pack layout at block 128: byte
// [blk*32 + r, k] holds the fields of features blk*128 + p*32 + r in bits
// 2p..2p+1, p = 0..3. x and out are in x's element type (bf16 or f32); the
// sums are f32, so for a one-hot G and finite x the result is x[b, perm[k]]
// bit for bit (the value K4 copies), and for any other planes it is x @ G.
//
// What bounds it: bytes. It must read G once (0.25 B per (feature, lane):
// 4 MB at 4096 -> 4096), x once and write out once; the products are one
// per nonzero field. The TPU kernel streams G through the MXU as a dense
// (D, K) matrix because the TPU has no fast lane gather. Here the work is
// what the data holds. A block owns 32 lanes and 64 rows. Each thread owns 4
// neighbouring lanes and reads them as one 32-bit load per G row, 8 threads
// covering 32 contiguous bytes (a full sector); the 32 thread rows of the
// block split the G rows, issue their loads in batches of 16 and skip
// all-zero words (all but one in 128 for a one-hot G). The block first
// decodes its lanes' nonzero fields (feature i, value u) into shared memory,
// up to E per lane, sorted by i; then each thread computes
// out[b, k] = sum u * x[b, i] for its (row, lane) pairs, in increasing i,
// reading x through L1/L2 (a 4096-wide bf16 row is 8 KB) and writing 32
// neighbouring lanes per warp. A block whose planes hold more than E fields
// in a lane (not a permutation) walks its G rows again for each tile of 8
// rows instead, accumulating in registers and reducing the 32 thread rows'
// partial sums in a fixed order (shuffles within a warp, then shared memory
// across warps). Either way the result does not depend on scheduling.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 8;                 // threads across lanes, 4 lanes each
constexpr int TY = 32;                // threads across the G rows
constexpr int THREADS = TX * TY;      // 256
constexpr int WARPS = THREADS / 32;   // 8; a warp holds 4 thread rows
constexpr int TN = TX * 4;            // lanes per block
constexpr int U = 16;                 // G words a thread loads before using them
constexpr int BLOCK_ROWS = 64;        // x rows per block
constexpr int E = 4;                  // nonzero fields per lane kept in shared memory

__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

// With IDX, g is a stack of S slots of D4 x K bytes and thread 0 of the
// block reads slot base + *sel (a slot outside [0, S) traps), so a routed
// expert's index never goes to the host.
template <typename T, int TB, bool IDX>
__global__ void __launch_bounds__(THREADS)
onehot_matmul_kernel(const T* __restrict__ x,          // (rows, m)
                     const uint8_t* __restrict__ g,    // (D4, K), (S, D4, K) if IDX
                     T* __restrict__ out,              // (rows, K)
                     int rows, int m, int D4, int K,
                     const int* __restrict__ sel, int base, int S) {  // if IDX
  __shared__ float red[WARPS][TB][TN];
  __shared__ int ent_i[TN][E];
  __shared__ float ent_u[TN][E];
  __shared__ int ent_n[TN];
  const int tid = threadIdx.x;
  if constexpr (IDX) {
    __shared__ int slot_s;
    if (tid == 0) {
      const int s = base + *sel;
      if (s < 0 || s >= S) __trap();
      slot_s = s;
    }
    __syncthreads();
    g += (size_t)slot_s * D4 * K;
  }
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int k0 = blockIdx.x * TN + tx * 4;
  const int r_begin = blockIdx.y * BLOCK_ROWS;
  const int r_end = min(rows, r_begin + BLOCK_ROWS);

  // ---- the lanes' nonzero fields, once for all rows of the block
  if (tid < TN) ent_n[tid] = 0;
  __syncthreads();
  for (int R0 = ty; R0 < D4; R0 += TY * U) {
    uint32_t w[U];
#pragma unroll
    for (int s = 0; s < U; ++s) {
      const int R = R0 + s * TY;
      w[s] = R < D4 ? *reinterpret_cast<const uint32_t*>(g + (size_t)R * K + k0) : 0u;
    }
#pragma unroll
    for (int s = 0; s < U; ++s) {
      uint32_t ws = w[s];
      const int R = R0 + s * TY;
      const int ibase = (R >> 5) * 128 + (R & 31);
      while (ws) {
        const int f = (__ffs(ws) - 1) >> 1;  // field index 4j + p
        const uint32_t u = (ws >> (2 * f)) & 3u;
        ws &= ~(3u << (2 * f));
        const int i = ibase + (f & 3) * 32;
        if (i >= m) continue;  // x is zero-padded to D
        const int c = tx * 4 + (f >> 2);
        const int slot = atomicAdd(&ent_n[c], 1);
        if (slot < E) {
          ent_i[c][slot] = i;
          ent_u[c][slot] = (float)u;
        }
      }
    }
  }
  const bool overflow = __syncthreads_or(tid < TN && ent_n[tid] > E);
  if (!overflow) {
    if (tid < TN) {  // the arrival order is the scheduler's: sort by feature
      const int n = ent_n[tid];
      for (int a = 1; a < n; ++a)
        for (int b = a; b > 0 && ent_i[tid][b - 1] > ent_i[tid][b]; --b) {
          const int ti = ent_i[tid][b];
          ent_i[tid][b] = ent_i[tid][b - 1];
          ent_i[tid][b - 1] = ti;
          const float tu = ent_u[tid][b];
          ent_u[tid][b] = ent_u[tid][b - 1];
          ent_u[tid][b - 1] = tu;
        }
    }
    __syncthreads();
    const int c = tid % TN;
    const int n = ent_n[c];
    for (int b = r_begin + tid / TN; b < r_end; b += THREADS / TN) {
      const T* xb = x + (size_t)b * m;
      float t = 0.f;
      for (int e = 0; e < n; ++e) t += ent_u[c][e] * to_f(xb[ent_i[c][e]]);
      store(out + (size_t)b * K + blockIdx.x * TN + c, t);
    }
    return;
  }

  // ---- planes with more than E fields in a lane: walk G per row tile
  for (int row0 = r_begin; row0 < r_end; row0 += TB) {
    const int nb = min(TB, r_end - row0);
    float acc[TB][4];
#pragma unroll
    for (int b = 0; b < TB; ++b)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[b][j] = 0.f;

    for (int R0 = ty; R0 < D4; R0 += TY * U) {
      uint32_t w[U];
#pragma unroll
      for (int s = 0; s < U; ++s) {
        const int R = R0 + s * TY;
        w[s] = R < D4 ? *reinterpret_cast<const uint32_t*>(g + (size_t)R * K + k0) : 0u;
      }
#pragma unroll
      for (int s = 0; s < U; ++s) {
        uint32_t ws = w[s];
        const int R = R0 + s * TY;
        const int ibase = (R >> 5) * 128 + (R & 31);
        while (ws) {  // the nonzero 2-bit fields, lowest bit first: lane j, plane p
          const int f = (__ffs(ws) - 1) >> 1;  // field index 4j + p
          const float u = (float)((ws >> (2 * f)) & 3u);
          ws &= ~(3u << (2 * f));
          const int j = f >> 2;
          const int i = ibase + (f & 3) * 32;
          if (i >= m) continue;  // x is zero-padded to D
          const T* xi = x + (size_t)row0 * m + i;
#pragma unroll
          for (int b = 0; b < TB; ++b) {
            if (b < nb) {
              const float v = u * to_f(xi[(size_t)b * m]);
#pragma unroll
              for (int jj = 0; jj < 4; ++jj)
                if (jj == j) acc[b][jj] += v;
            }
          }
        }
      }
    }

    // The 4 thread rows of a warp (lanes tx + 8q), then the 8 warps in order.
#pragma unroll
    for (int b = 0; b < TB; ++b)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float t = acc[b][j];
        t += __shfl_xor_sync(0xffffffffu, t, 8);
        t += __shfl_xor_sync(0xffffffffu, t, 16);
        if (lane < TX) red[warp][b][tx * 4 + j] = t;
      }
    __syncthreads();
    for (int o = tid; o < TB * TN; o += THREADS) {
      const int b = o / TN;
      const int c = o - b * TN;
      if (b < nb) {
        float t = 0.f;
#pragma unroll
        for (int q = 0; q < WARPS; ++q) t += red[q][b][c];
        store(out + (size_t)(row0 + b) * K + blockIdx.x * TN + c, t);
      }
    }
    __syncthreads();  // red is reused by the next row tile
  }
}

template <typename T, int TB, bool IDX>
void launch(const void* x, const void* g, void* out, int rows, int m, int D4, int K,
            cudaStream_t s, const int* sel, int base, int S) {
  dim3 grid(K / TN, (rows + BLOCK_ROWS - 1) / BLOCK_ROWS);
  onehot_matmul_kernel<T, TB, IDX><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(g), static_cast<T*>(out),
      rows, m, D4, K, sel, base, S);
}

template <typename T, bool IDX>
void dispatch(const void* x, const void* g, void* out, int rows, int m, int D4, int K,
              cudaStream_t s, const int* sel, int base, int S) {
  if (rows == 1)
    launch<T, 1, IDX>(x, g, out, rows, m, D4, K, s, sel, base, S);
  else if (rows == 2)
    launch<T, 2, IDX>(x, g, out, rows, m, D4, K, s, sel, base, S);
  else if (rows <= 4)
    launch<T, 4, IDX>(x, g, out, rows, m, D4, K, s, sel, base, S);
  else
    launch<T, 8, IDX>(x, g, out, rows, m, D4, K, s, sel, base, S);
}

template <bool IDX>
int run(const void* x, const void* g, void* out, int rows, int m, int D4, int K, int elem_bytes,
        int device, void* stream, const void* sel, int base, int S) {
  if (rows < 1 || m < 1 || D4 < 32 || D4 % 32 != 0 || m > 4 * D4 || K < TN ||
      K % 128 != 0 || (elem_bytes != 2 && elem_bytes != 4))
    return (int)cudaErrorInvalidValue;
  if (IDX && (sel == nullptr || reinterpret_cast<uintptr_t>(sel) % 4 != 0 || S < 1))
    return (int)cudaErrorInvalidValue;
  // This library links its own CUDA runtime: follow the caller's device.
  int cur = -1;
  if (cudaGetDevice(&cur) != cudaSuccess || cur != device) {
    const cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ip = static_cast<const int*>(sel);
  if (elem_bytes == 2)
    dispatch<__nv_bfloat16, IDX>(x, g, out, rows, m, D4, K, s, ip, base, S);
  else
    dispatch<float, IDX>(x, g, out, rows, m, D4, K, s, ip, base, S);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points bound with ctypes (pt2tpu_torch/ops/kernels/gather.py).
// x is (rows, m), g is (D4, K) int8, out is (rows, K); elem_bytes is 2 (bf16)
// or 4 (f32). Returns cudaGetLastError() after the launch; 0 means launched.
extern "C" int pt2_onehot_matmul(const void* x, const void* g, void* out, int rows,
                                 int m, int D4, int K, int elem_bytes, int device,
                                 void* stream) {
  return run<false>(x, g, out, rows, m, D4, K, elem_bytes, device, stream, nullptr, 0, 0);
}

// K5s: as pt2_onehot_matmul with g the whole contiguous (S, D4, K) stack and
// the slot base + *sel read by each block from device memory (sel: one
// int32 on the card, 4-byte aligned; base: a host offset). A slot outside
// [0, S) traps.
extern "C" int pt2_onehot_matmul_idx(const void* x, const void* g, void* out, int rows, int m,
                                     int D4, int K, int elem_bytes, const void* sel, int base,
                                     int S, int device, void* stream) {
  return run<true>(x, g, out, rows, m, D4, K, elem_bytes, device, stream, sel, base, S);
}
