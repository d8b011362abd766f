// SSR input gather for Hopper (sm_90a): kernel K4 of the port.
//
// Replaces pt2tpu/ops/kernels/pallas_gather.py:onehot_iota_pallas and
// onehot_iota_pallas_stacked (the stacked variant at a host index collapses
// into this one: the caller passes the zero-copy view perm[li]). K4s, the
// stacked variant with a traced index (a routed expert's gather), is the IDX
// instance, C entry pt2_onehot_gather_idx: perm is the whole (S, K) stack
// and each block reads its slot, base + *sel, from device memory.
//
// Contract: out[b, k] = x[b, perm[k]] where 0 <= perm[k] < m, else 0 (pad
// lanes point at index m). x is (rows, m), out is (rows, K), both in x's
// element type (bf16 or f32); the kernel copies bit patterns, so the result
// is bit-exact.
//
// What bounds it: bytes. It reads x once (rows * m elements), perm once and
// writes out once, with no arithmetic. The TPU kernel builds a one-hot
// matrix from perm in VMEM and multiplies on the MXU because the TPU has no
// fast lane gather; on Hopper a gather is an indexed load. Each thread owns
// one output lane k: it reads perm[k] once into a register and then copies
// x[b, perm[k]] for the block's rows, so the writes of a warp are 32
// neighbouring lanes (coalesced) and the scattered reads stay inside one
// row of x, which L1/L2 hold (a 4096-wide bf16 row is 8 KB).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // output lanes per block
constexpr int ROWS = 16;      // rows per block

// With IDX, perm is a stack of S slots of K lanes and thread 0 of the block
// reads slot base + *sel (a slot outside [0, S) traps), so a routed
// expert's index never goes to the host.
template <typename T, bool IDX>
__global__ void __launch_bounds__(THREADS)
onehot_gather_kernel(const T* __restrict__ x,        // (rows, m)
                     const int* __restrict__ perm,   // (K,), (S, K) if IDX
                     T* __restrict__ out,            // (rows, K)
                     int rows, int m, int K,
                     const int* __restrict__ sel, int base, int S) {  // if IDX
  if constexpr (IDX) {
    __shared__ int slot_s;
    if (threadIdx.x == 0) {
      const int s = base + *sel;
      if (s < 0 || s >= S) __trap();
      slot_s = s;
    }
    __syncthreads();
    perm += (size_t)slot_s * K;
  }
  const int k = blockIdx.x * THREADS + threadIdx.x;
  if (k >= K) return;
  const int p = perm[k];
  const bool valid = (unsigned)p < (unsigned)m;
  const int r0 = blockIdx.y * ROWS;
  const int r1 = min(rows, r0 + ROWS);
#pragma unroll 4
  for (int b = r0; b < r1; ++b)
    out[(size_t)b * K + k] = valid ? x[(size_t)b * m + p] : T(0);
}

template <bool IDX>
int run(const void* x, const void* perm, void* out, int rows, int m, int K, int elem_bytes,
        int device, void* stream, const void* sel, int base, int S) {
  if (rows < 1 || m < 1 || K < 1 || (elem_bytes != 2 && elem_bytes != 4))
    return (int)cudaErrorInvalidValue;
  if (IDX && (sel == nullptr || reinterpret_cast<uintptr_t>(sel) % 4 != 0 || S < 1))
    return (int)cudaErrorInvalidValue;
  int cur = -1;
  if (cudaGetDevice(&cur) != cudaSuccess || cur != device) {
    const cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((K + THREADS - 1) / THREADS, (rows + ROWS - 1) / ROWS);
  const int* pp = static_cast<const int*>(perm);
  const int* ip = static_cast<const int*>(sel);
  if (elem_bytes == 2)
    onehot_gather_kernel<uint16_t, IDX><<<grid, THREADS, 0, s>>>(
        static_cast<const uint16_t*>(x), pp, static_cast<uint16_t*>(out), rows, m, K, ip, base,
        S);
  else
    onehot_gather_kernel<uint32_t, IDX><<<grid, THREADS, 0, s>>>(
        static_cast<const uint32_t*>(x), pp, static_cast<uint32_t*>(out), rows, m, K, ip, base,
        S);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points bound with ctypes (pt2tpu_torch/ops/kernels/gather.py).
// elem_bytes is 2 (bf16) or 4 (f32). Returns cudaGetLastError() after the
// launch; 0 means launched.
extern "C" int pt2_onehot_gather(const void* x, const void* perm, void* out,
                                 int rows, int m, int K, int elem_bytes,
                                 int device, void* stream) {
  return run<false>(x, perm, out, rows, m, K, elem_bytes, device, stream, nullptr, 0, 0);
}

// K4s: as pt2_onehot_gather with perm the whole contiguous (S, K) stack and
// the slot base + *sel read by each block from device memory (sel: one
// int32 on the card, 4-byte aligned; base: a host offset). A slot outside
// [0, S) traps.
extern "C" int pt2_onehot_gather_idx(const void* x, const void* perm, void* out, int rows, int m,
                                     int K, int elem_bytes, const void* sel, int base, int S,
                                     int device, void* stream) {
  return run<true>(x, perm, out, rows, m, K, elem_bytes, device, stream, sel, base, S);
}
