// SSR input gather for Hopper (sm_90a): kernel K4 of the port.
//
// Replaces pt2tpu/ops/kernels/pallas_gather.py:onehot_iota_pallas and
// onehot_iota_pallas_stacked (the stacked variant collapses into this one:
// the caller passes the zero-copy view perm[li]).
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
onehot_gather_kernel(const T* __restrict__ x,        // (rows, m)
                     const int* __restrict__ perm,   // (K,)
                     T* __restrict__ out,            // (rows, K)
                     int rows, int m, int K) {
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

}  // namespace

// C entry point bound with ctypes (pt2tpu_torch/ops/kernels/gather.py).
// elem_bytes is 2 (bf16) or 4 (f32). Returns cudaGetLastError() after the
// launch; 0 means launched.
extern "C" int pt2_onehot_gather(const void* x, const void* perm, void* out,
                                 int rows, int m, int K, int elem_bytes,
                                 int device, void* stream) {
  if (rows < 1 || m < 1 || K < 1 || (elem_bytes != 2 && elem_bytes != 4))
    return (int)cudaErrorInvalidValue;
  int cur = -1;
  if (cudaGetDevice(&cur) != cudaSuccess || cur != device) {
    const cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((K + THREADS - 1) / THREADS, (rows + ROWS - 1) / ROWS);
  const int* pp = static_cast<const int*>(perm);
  if (elem_bytes == 2)
    onehot_gather_kernel<uint16_t><<<grid, THREADS, 0, s>>>(
        static_cast<const uint16_t*>(x), pp, static_cast<uint16_t*>(out), rows, m, K);
  else
    onehot_gather_kernel<uint32_t><<<grid, THREADS, 0, s>>>(
        static_cast<const uint32_t*>(x), pp, static_cast<uint32_t*>(out), rows, m, K);
  return (int)cudaGetLastError();
}
