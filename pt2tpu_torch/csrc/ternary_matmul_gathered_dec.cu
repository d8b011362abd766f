// K6's decode rows (1 to 8) on the tensor cores, for Hopper (sm_90a).
//
// Replaces pt2tpu/ops/kernels/pallas_ternary.py:ternary_matmul_pallas_gathered
// (and its _stacked variant at a host index: the caller passes the views
// gpacked[li], packed[li], alpha[li], mu[li]) at decode row counts: the SSR
// gather through the packed one-hot planes, then the packed ternary product,
//
//   out[b, j] = sum_blk alpha[blk, j] * (xg_blk . T_blk[:, j])
//             + mu[blk, j] * sum(xg_blk),      xg = bf16(x @ G)
//
// in f32, (B, n), 1 <= B <= 8, scale blocks of 128, n % 128 == 0, with T in
// {-1,0,1} unpacked from the plane-interleaved (K/4, n) int8 layout. bf16
// mode: x is bf16. W2A8 mode (routed here only with K1_DEC_A8): x is the
// bf16 output of normalize_rows_a8, the gather rounds xg half to even and
// clips it to [-127, 127], and the wrapper multiplies by the row scales.
// Rows 9 to 64 run csrc/ternary_matmul_gathered_tc.cu, every other shape
// csrc/ternary_matmul_gathered.cu (the CUDA-core K6, unchanged); the
// wrapper picks by shape (k6_path in pt2tpu_torch/ops/kernels/ternary.py),
// never after a failure. The floor probe (impl="floor8", a8 mode 2): the
// gather rounds as in W2A8, then the decode kernel's FLOOR instance.
//
// What bounds it: bytes, as K1's decode rows: the codes (0.25 B per
// weight), the scales and the planes (0.25 B per (feature, lane)). The
// CUDA-core K6 decodes G for its rows into shared memory and then does one
// FMA per code and row on the CUDA cores, so from 4 rows its instruction
// rate binds. Here K6 is two launches from one C entry, on the caller's
// stream:
//
//   1. The plane gather (csrc/planes_gather.cuh) in lane order: xg (B, K)
//      bf16 into a scratch that the wrapper keeps per stream.
//   2. K1's split-K tensor-core decode GEMV (csrc/ternary_matmul_dec.cu,
//      which this file includes), ternary_matmul_dec_kernel<0, false, false>
//      as it is, over xg: dec_splits K slices, their partials summed in
//      slice order by the last CTA of each column tile (the stream's
//      counters). W2A8's xg holds integers already, so the bf16 instance
//      computes what the W2A8 one would.
// No float atomics: the same bits on every run. On a permutation the
// gathered values are x[b, perm[k]] bit for bit, so the output is K3's
// decode rows' on the same perm, bit for bit.
//
// K6s (the _stacked variant with a traced index: a routed expert's
// projection) is C entry pt2_ternary_matmul_gathered_dec_idx: the same two
// launches, each an IDX instance (the plane gather's and K1's decode
// kernel's, csrc/ternary_matmul_dec.cu), over the whole stacks; both read
// the slot base + *sel from the same int32 in device memory.
//
// ptxas and times on an H100: PERF.md §6 (chip_smoke.py phases 17a-17c).

#include "ternary_matmul_dec.cu"  // K1's decode kernel, its helpers and its launch
#include "planes_gather.cuh"      // the plane gather

// C entry point bound with ctypes (pt2tpu_torch/ops/kernels/ternary.py).
// x (B, m) bf16 in feature order (W2A8: its normalised rows), g (D4, K) int8
// planes (D4 a multiple of 32, m <= 4 * D4), packed (K/4, n) int8 with
// (K/128, n) bf16 alpha and mu; xg a (B, K) bf16 scratch, partial a
// (splits, B, n) f32 scratch (not read when splits is 1), out (B, n) f32,
// counters n / 128 int32 that are 0 (each launch leaves them 0; launches
// that share them must not run concurrently). K slices of
// ceil(nb / splits) blocks, none empty, at most 16 blocks each. g, xg,
// packed, alpha, mu, partial and out 16-byte aligned, x 2-byte. Two
// launches (the gather, the GEMV); returns the first failure's CUDA error,
// 0 meaning both launched.
extern "C" int pt2_ternary_matmul_gathered_dec(const void* x, const void* g, const void* packed,
                                               const void* alpha, const void* mu, void* xg,
                                               void* partial, void* out, void* counters, int B,
                                               int m, int D4, int K, int n, int splits, int a8,
                                               int device, void* stream) {
  if (B > MAX_ROWS) return (int)cudaErrorInvalidValue;
  int rc = planes_gather::check(x, g, xg, nullptr, B, B, m, D4, K, false);
  if (rc == 0) rc = planes_gather::use_device(device);
  if (rc != 0) return rc;
  rc = planes_gather::launch_gather(x, g, xg, nullptr, B, B, m, D4, K, false, a8 != 0,
                                    static_cast<cudaStream_t>(stream));
  if (rc != 0) return rc;
  return launch<false>(xg, nullptr, packed, alpha, mu, partial, out, counters, B, K, K, n, 128,
                       splits, a8 == 2 ? 2 : 0, device, stream);
}

// K6s at decode rows: as pt2_ternary_matmul_gathered_dec with g (S, D4, K),
// packed (S, K/4, n), alpha and mu (S, K/128, n) whole contiguous stacks
// (each slot 16-byte aligned) and the slot base + *sel read by each CTA of
// both launches from device memory (sel: one int32 on the card, 4-byte
// aligned; base: a host offset). A slot outside [0, S) traps.
extern "C" int pt2_ternary_matmul_gathered_dec_idx(const void* x, const void* g,
                                                   const void* packed, const void* alpha,
                                                   const void* mu, void* xg, void* partial,
                                                   void* out, void* counters, const void* sel,
                                                   int base, int S, int B, int m, int D4, int K,
                                                   int n, int splits, int a8, int device,
                                                   void* stream) {
  if (B > MAX_ROWS) return (int)cudaErrorInvalidValue;
  if (sel == nullptr || reinterpret_cast<uintptr_t>(sel) % 4 != 0 || S < 1)
    return (int)cudaErrorInvalidValue;
  int rc = planes_gather::check(x, g, xg, nullptr, B, B, m, D4, K, false);
  if (rc == 0) rc = planes_gather::use_device(device);
  if (rc != 0) return rc;
  rc = planes_gather::launch_gather_idx(x, g, xg, B, m, D4, K, a8 != 0, sel, base, S,
                                        static_cast<cudaStream_t>(stream));
  if (rc != 0) return rc;
  return launch<false, true>(xg, nullptr, packed, alpha, mu, partial, out, counters, B, K, K, n,
                             128, splits, a8 == 2 ? 2 : 0, device, stream, sel, base, S);
}
