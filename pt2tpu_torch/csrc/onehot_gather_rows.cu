// K4's rows path for Hopper (sm_90a): the SSR input gather at rows >=
// K4_ROWS_MIN_ROWS (ops/kernels/gather.py:k4_path; fewer rows, rows of x
// wider than 64 KB and K % 8 != 0 stay on csrc/onehot_gather.cu). Together
// they replace pt2tpu/ops/kernels/pallas_gather.py:onehot_iota_pallas and
// onehot_iota_pallas_stacked (the stacked variant at a host index is the
// caller's zero-copy view perm[li]; with a traced index, K4s, it is the IDX
// instance, C entry pt2_onehot_gather_rows_idx: perm the whole (S, K) stack,
// each CTA reading its slot base + *sel from device memory).
//
// Contract (K4's): out[b, k] = x[b, perm[k]] where 0 <= perm[k] < m, else
// +0 (pad lanes point at index m). x is (rows, m), out (rows, K), both in
// x's element type (bf16 or f32); the kernel copies bit patterns, with no
// arithmetic: bit-exact, -0.0 and NaN payloads included.
//
// What bounds it: bytes. The function reads x once, perm once and writes
// out once: 2 * rows * m + 4 * K + 2 * rows * K bytes in bf16, 8.4 MB at
// llama-3-8b's 4096 -> 4096 and 512 rows, 2.51 us at 3.35 TB/s. K4's first
// kernel gives each thread one output lane and has it read x[b, perm[k]]
// with a 2-byte load per row: a warp's load touches about 32 lines of 128
// bytes, and each of its 16 lane blocks pulls most of every row of x from
// L2 again. Here the rows are read whole instead:
//
//  * A CTA of 256 threads owns a stage of R rows and 2048-lane chunks of the
//    output, 8 neighbouring lanes a thread. It copies its R rows of x whole
//    into shared memory, one cp.async.bulk per row, each completing on its
//    own mbarrier, where rows start and end on 16 bytes (else coalesced
//    element loads: m = 300 in bf16 is a 600-byte row).
//  * Each thread loads its 8 perm entries with two 16-byte loads and keeps
//    them in registers for the stage's rows. As each row lands it reads its
//    8 elements from shared memory (random 2-byte reads cost a few bank
//    conflicts, not a line fetch each) and writes them as one 16-byte store
//    (two in f32).
//  * grid.y walks the stages, one CTA each; grid.x CTAs split a stage's
//    2048-lane chunks (1: one CTA loops over every chunk and reads each row
//    of x from L2 once). Several CTAs resident on an SM overlap one's copies
//    with another's gathers. The default plan (default_plan below) was
//    chosen by an A/B of plans on an H100 (scripts/torch_k4_rows_ab.py,
//    PERF.md §6); a draft whose persistent CTAs walked the stages with a
//    ring of two, the next stage's copies in flight during a gather, was
//    slower at every row count timed and was dropped.
//
// No scratch, no atomics, no per-stream state: a CUDA graph captures it, and
// every run writes the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {  // internal linkage: no other library's kernels of the same names interpose
namespace gather_rows {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 8;                 // lanes a thread owns: one 16-byte bf16 store
constexpr int CHUNK = THREADS * PER_THREAD;   // lanes a CTA gathers at once
constexpr int TILE_BYTES = 65536;             // one stage's rows, at most
constexpr int MIN_CTAS = 256;                 // the default plan's R halves while the grid is smaller

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void store8(uint16_t* p, const uint32_t (&v)[PER_THREAD]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(v[0] | v[1] << 16, v[2] | v[3] << 16, v[4] | v[5] << 16, v[6] | v[7] << 16);
}

__device__ __forceinline__ void store8(uint32_t* p, const uint32_t (&v)[PER_THREAD]) {
  reinterpret_cast<uint4*>(p)[0] = make_uint4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<uint4*>(p)[1] = make_uint4(v[4], v[5], v[6], v[7]);
}

// Grid (chunk CTAs, stages); dynamic shared memory: the stage, R rows of m
// elements. T is uint16_t (bf16) or uint32_t (f32): bits only. With IDX,
// perm is a stack of S slots of K lanes (each slot 16-byte aligned: K % 8
// == 0) and thread 0 of the CTA reads slot base + *sel (a slot outside
// [0, S) traps), so a routed expert's index never goes to the host.
template <typename T, int R, bool IDX>
__global__ void __launch_bounds__(THREADS)
gather_rows_kernel(const T* __restrict__ x,       // (rows, m)
                   const int* __restrict__ perm,  // (K,), (S, K) if IDX
                   T* __restrict__ out,           // (rows, K)
                   int rows, int m, int K,
                   const int* __restrict__ sel, int base, int S) {  // if IDX
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar[R];  // one per staged row
  T* xs = reinterpret_cast<T*>(smem);
  const int tid = threadIdx.x;
  if constexpr (IDX) {
    __shared__ int slot_s;
    if (tid == 0) {
      const int s = base + *sel;
      if (s < 0 || s >= S) __trap();
      slot_s = s;
    }
    __syncthreads();
    perm += (size_t)slot_s * K;
  }
  const int row0 = blockIdx.y * R;
  const int nr = min(R, rows - row0);
  const T* src = x + (size_t)row0 * m;
  const uint32_t row_bytes = (uint32_t)m * (uint32_t)sizeof(T);
  const bool bulk = reinterpret_cast<uintptr_t>(x) % 16 == 0 && row_bytes % 16 == 0;

  // ---- stage the rows: one bulk copy per row, each completing on its own
  // barrier, so that row 0's gather starts while the others land
  if (bulk) {
    if (tid == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&bar[r])));
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();  // the barriers are initialised before anyone waits on them
    if (tid == 0) {
      for (int r = 0; r < nr; ++r) {
        const uint32_t b = smem_addr(&bar[r]);
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
                     "r"(row_bytes)
                     : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
            "[%3];\n" ::"r"(smem_addr(xs + (size_t)r * m)),
            "l"(src + (size_t)r * m), "r"(row_bytes), "r"(b)
            : "memory");
      }
    }
  } else {
    for (int e = tid; e < nr * m; e += THREADS) xs[e] = src[e];
    __syncthreads();
  }

  const int nchunks = (K + CHUNK - 1) / CHUNK;
  for (int c = blockIdx.x; c < nchunks; c += gridDim.x) {
    const int k0 = c * CHUNK + tid * PER_THREAD;
    if (k0 >= K) break;  // K % 8 == 0: a thread's 8 lanes are all in or all out
    // this thread's perm entries, in registers for the stage's rows; a pad
    // lane reads element 0 and masks it to +0
    const int4 p0 = __ldg(reinterpret_cast<const int4*>(perm + k0));
    const int4 p1 = __ldg(reinterpret_cast<const int4*>(perm + k0 + 4));
    const int pv[PER_THREAD] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
    int idx[PER_THREAD];
    uint32_t keep[PER_THREAD];
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      const bool in = (unsigned)pv[j] < (unsigned)m;
      idx[j] = in ? pv[j] : 0;
      keep[j] = in ? 0xffffffffu : 0u;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= nr) break;
      if (bulk) {  // phase 0 of row r's barrier: its bytes have landed
        uint32_t done = 0;
        while (!done)
          asm volatile(
              "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
              " selp.u32 %0, 1, 0, p;\n}\n"
              : "=r"(done)
              : "r"(smem_addr(&bar[r]))
              : "memory");
      }
      const T* xr = xs + (size_t)r * m;
      uint32_t v[PER_THREAD];
#pragma unroll
      for (int j = 0; j < PER_THREAD; ++j) v[j] = (uint32_t)xr[idx[j]] & keep[j];
      store8(out + (size_t)(row0 + r) * K + k0, v);
    }
  }
}

struct Plan {
  int R, gx;  // rows per stage, chunk CTAs; one CTA row per stage
};

inline int use_device(int device) {
  int cur = -1;
  if (cudaGetDevice(&cur) != cudaSuccess || cur != device) return (int)cudaSetDevice(device);
  return 0;
}

// The plan pt2_onehot_gather_rows launches: the chunks split over up to
// two CTAs, R the largest of 4, 2, 1 whose stage fits TILE_BYTES and that
// still gives MIN_CTAS CTAs (R 4 at 512 rows, 2 at 256, 1 below). In the
// A/B at 4096 lanes (two chunks) and 16-512 rows the split plans beat every
// plan that reads x once (one CTA looping over both chunks: 0.1-0.5 us
// slower a call): more resident CTAs hide the copies' latency better than
// fewer, longer ones, and L2 carries the second read of x. Wider rows (more
// chunks) were not timed, so a row is read by at most two CTAs.
inline Plan default_plan(int rows, int m, int elem_bytes, int K) {
  const long row_bytes = (long)m * elem_bytes;
  const int gx = (K + CHUNK - 1) / CHUNK < 2 ? 1 : 2;
  int R = 4;
  while (R > 1 && (R * row_bytes > TILE_BYTES || (long)gx * ((rows + R - 1) / R) < MIN_CTAS))
    R /= 2;
  return Plan{R, gx};
}

// The slot of an IDX launch: the pointer to its int32 index, the host
// offset and the stack's slot count (unused otherwise).
struct Slot {
  const int* sel;
  int base, S;
};

template <typename T, int R, bool IDX>
int launch(const void* x, const void* perm, void* out, int rows, int m, int K, int gx,
           int device, cudaStream_t s, const Slot& slot) {
  // a 64 KB stage is above the default 48 KB: raised once per device
  static bool raised[64] = {};
  if (device < 0 || device >= 64 || !raised[device]) {
    const cudaError_t e = cudaFuncSetAttribute(
        gather_rows_kernel<T, R, IDX>, cudaFuncAttributeMaxDynamicSharedMemorySize, TILE_BYTES);
    if (e != cudaSuccess) return (int)e;
    if (device >= 0 && device < 64) raised[device] = true;
  }
  const size_t smem = ((size_t)R * m * sizeof(T) + 15) / 16 * 16;
  gather_rows_kernel<T, R, IDX><<<dim3(gx, (rows + R - 1) / R), THREADS, smem, s>>>(
      static_cast<const T*>(x), static_cast<const int*>(perm), static_cast<T*>(out), rows, m, K,
      slot.sel, slot.base, slot.S);
  return (int)cudaGetLastError();
}

template <typename T, bool IDX>
int dispatch(const void* x, const void* perm, void* out, int rows, int m, int K, const Plan& p,
             int device, cudaStream_t s, const Slot& slot) {
  switch (p.R) {
    case 4:
      return launch<T, 4, IDX>(x, perm, out, rows, m, K, p.gx, device, s, slot);
    case 2:
      return launch<T, 2, IDX>(x, perm, out, rows, m, K, p.gx, device, s, slot);
    default:
      return launch<T, 1, IDX>(x, perm, out, rows, m, K, p.gx, device, s, slot);
  }
}

// What a launch takes: rows, m >= 1, K a positive multiple of 8, one stage
// of R rows within TILE_BYTES, at most 65535 stages; x aligned to its
// element, perm and out to 16 bytes; a plan of R in {1, 2, 4} and 1 to
// ceil(K / 2048) chunk CTAs.
inline int check(const void* x, const void* perm, const void* out, int rows, int m, int K,
                 int elem_bytes, const Plan& p) {
  if (x == nullptr || perm == nullptr || out == nullptr || rows < 1 || m < 1 || K < 8 ||
      K % 8 != 0 || (elem_bytes != 2 && elem_bytes != 4))
    return (int)cudaErrorInvalidValue;
  if ((p.R != 1 && p.R != 2 && p.R != 4) || (long)p.R * m * elem_bytes > TILE_BYTES ||
      p.gx < 1 || p.gx > (K + CHUNK - 1) / CHUNK || (rows + p.R - 1) / p.R > 65535)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % elem_bytes ||
      (reinterpret_cast<uintptr_t>(perm) | reinterpret_cast<uintptr_t>(out)) % 16)
    return (int)cudaErrorMisalignedAddress;
  return 0;
}

template <bool IDX = false>
inline int run(const void* x, const void* perm, void* out, int rows, int m, int K,
               int elem_bytes, const Plan& p, int device, void* stream,
               const Slot& slot = Slot{nullptr, 0, 0}) {
  int rc = check(x, perm, out, rows, m, K, elem_bytes, p);
  if (rc == 0 && IDX &&
      (slot.sel == nullptr || reinterpret_cast<uintptr_t>(slot.sel) % 4 != 0 || slot.S < 1))
    rc = (int)cudaErrorInvalidValue;
  if (rc == 0) rc = use_device(device);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return elem_bytes == 2 ? dispatch<uint16_t, IDX>(x, perm, out, rows, m, K, p, device, s, slot)
                         : dispatch<uint32_t, IDX>(x, perm, out, rows, m, K, p, device, s, slot);
}

}  // namespace gather_rows
}  // namespace

// C entry points bound with ctypes (pt2tpu_torch/ops/kernels/gather.py).
//
// pt2_onehot_gather_rows: K4's rows path, one launch on `stream` with the
// default plan. x (rows, m), perm (K,) int32, out (rows, K); elem_bytes 2
// (bf16) or 4 (f32), m * elem_bytes <= 65536, K % 8 == 0. Returns the
// launch's CUDA error; 0 means it launched.
extern "C" int pt2_onehot_gather_rows(const void* x, const void* perm, void* out, int rows, int m,
                                      int K, int elem_bytes, int device, void* stream) {
  if (rows < 1 || m < 1 || (elem_bytes != 2 && elem_bytes != 4) ||
      (long)m * elem_bytes > gather_rows::TILE_BYTES)
    return (int)cudaErrorInvalidValue;
  return gather_rows::run(x, perm, out, rows, m, K, elem_bytes,
                          gather_rows::default_plan(rows, m, elem_bytes, K), device, stream);
}

// pt2_onehot_gather_rows_plan: the same launch with a plan the caller names
// (rows per stage R, chunk CTAs gx), for checks and the A/B that chose the
// default plan.
extern "C" int pt2_onehot_gather_rows_plan(const void* x, const void* perm, void* out, int rows,
                                           int m, int K, int elem_bytes, int R, int gx,
                                           int device, void* stream) {
  return gather_rows::run(x, perm, out, rows, m, K, elem_bytes, gather_rows::Plan{R, gx}, device,
                          stream);
}

// pt2_onehot_gather_rows_idx: K4s on the rows path, the launch of
// pt2_onehot_gather_rows with perm the whole contiguous (S, K) stack and the
// slot base + *sel read by each CTA from device memory (sel: one int32 on
// the card, 4-byte aligned; base: a host offset). A slot outside [0, S)
// traps.
extern "C" int pt2_onehot_gather_rows_idx(const void* x, const void* perm, void* out, int rows,
                                          int m, int K, int elem_bytes, const void* sel,
                                          int base, int S, int device, void* stream) {
  if (rows < 1 || m < 1 || (elem_bytes != 2 && elem_bytes != 4) ||
      (long)m * elem_bytes > gather_rows::TILE_BYTES)
    return (int)cudaErrorInvalidValue;
  return gather_rows::run<true>(x, perm, out, rows, m, K, elem_bytes,
                                gather_rows::default_plan(rows, m, elem_bytes, K), device, stream,
                                gather_rows::Slot{static_cast<const int*>(sel), base, S});
}
