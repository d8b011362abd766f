// K6's rows 9 to 64 on the tensor cores, for Hopper (sm_90a).
//
// Replaces pt2tpu/ops/kernels/pallas_ternary.py:ternary_matmul_pallas_gathered
// (and its _stacked variant: the caller passes the views gpacked[li],
// packed[li], alpha[li], mu[li]) at 9 to 64 rows, bf16 and W2A8: the SSR
// gather through the packed one-hot planes, then the packed ternary product,
//
//   out[b, j] = sum_blk alpha[blk, j] * (xg_blk . T_blk[:, j])
//             + mu[blk, j] * sum(xg_blk),      xg = bf16(x @ G)
//
// in f32, (B, n), scale blocks of 128, n % 128 == 0. bf16 mode: x is bf16.
// W2A8 mode: x is the bf16 output of normalize_rows_a8 (absmax does not
// depend on column order), the gather rounds xg half to even and clips it
// to [-127, 127], exact in bf16; the wrapper multiplies by the row scales.
// Decode rows run csrc/ternary_matmul_gathered_dec.cu, every other shape
// csrc/ternary_matmul_gathered.cu (the CUDA-core K6, unchanged); the
// wrapper picks by shape (k6_path in pt2tpu_torch/ops/kernels/ternary.py),
// never after a failure.
//
// What bounds it: as for K3's rows 9 to 64, the bytes at 16 rows and the
// operations at 64 (3.2 GFLOP against 7.1 MB at llama-3-8b qkv), so the dots
// run on the tensor cores. The CUDA-core K6 does one FMA per code and row
// and keeps a (K/128, B, n) f32 partial per call (12.6 MB at qkv and 16
// rows). Here K6 is two launches from one C entry, on the caller's stream:
//
//   1. The plane gather (csrc/planes_gather.cuh) in fragment order: xg
//      (Bp, K) bf16, Bp = 16, 32 or 64 (pad rows zero), within a block
//      position 8h + 2p + i holding lane 32p + 2h + i, and the block sums S
//      (K/128, Bp) f32, into scratch that the wrapper keeps per stream:
//      exactly what K3's gather writes (igathered_tc_gather_plain).
//   2. K3's split-K mma.sync product (csrc/ternary_matmul_igathered_tc.cu,
//      which this file includes), launch_product<NT> as it is: igtc_splits
//      K slices, their partials summed in slice order by the last CTA of
//      each column tile (the stream's counters).
// No float atomics: the same bits on every run. The floor probe
// (impl="floor8", a8 mode 2): the gather rounds as in W2A8, then K3's
// product in its FLOOR instance (launch_rows).
//
// ptxas and times on an H100: PERF.md §6 (chip_smoke.py phases 17a-17c).

#include "ternary_matmul_igathered_tc.cu"  // K3's product, its helpers and launch
#include "planes_gather.cuh"               // the plane gather

// C entry point bound with ctypes (pt2tpu_torch/ops/kernels/ternary.py).
// x (B, m) bf16 in feature order (W2A8: its normalised rows, rounded by the
// gather), 9 <= B <= 64, g (D4, K) int8 planes (D4 a multiple of 32,
// m <= 4 * D4), packed (K/4, n) int8 with (K/128, n) bf16 alpha and mu;
// scratch xg (Bp, K) bf16 and sums (K/128, Bp) f32 with Bp = 16, 32 or 64
// (B rounded up to 16, then to a power of two), partial (splits, B, n) f32
// (not read when splits is 1); out (B, n) f32; counters n / 128 int32 that
// are 0 (each launch leaves them 0; launches that share them must not run
// concurrently). K slices of ceil(nb / splits) blocks, none empty. g, xg,
// packed, alpha, mu, partial and out 16-byte aligned, sums 8-byte, x
// 2-byte. Two launches (the gather, the product); returns the first
// failure's CUDA error, 0 meaning both launched.
extern "C" int pt2_ternary_matmul_gathered_tc(const void* x, const void* g, const void* packed,
                                              const void* alpha, const void* mu, void* xg,
                                              void* sums, void* partial, void* out,
                                              void* counters, int B, int m, int D4, int K, int n,
                                              int splits, int a8, int device, void* stream) {
  if (B < MIN_ROWS || B > MAX_ROWS || a8 < 0 || a8 > 2) return (int)cudaErrorInvalidValue;
  const int Bp = rows_pad(B);
  int rc = planes_gather::check(x, g, xg, sums, B, Bp, m, D4, K, true);
  if (rc != 0) return rc;
  if (reinterpret_cast<uintptr_t>(sums) % 8 != 0) return (int)cudaErrorMisalignedAddress;
  const int nb = K / KC;
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
  rc = planes_gather::launch_gather(x, g, xg, sums, B, Bp, m, D4, K, true, a8 != 0, s);
  if (rc != 0) return rc;
  return launch_rows(a8, Bp, xg, sums, packed, alpha, mu, partial, out, counters, B, K, n, KC,
                     splits, bpc, s);
}
