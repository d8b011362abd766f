// K5's rows path for Hopper (sm_90a): x @ G through the packed one-hot
// planes at rows >= K5_ROWS_MIN_ROWS (16; ops/kernels/gather.py:k5_path;
// fewer rows stay on csrc/onehot_matmul.cu). Together they replace
// pt2tpu/ops/kernels/pallas_gather.py:onehot_matmul_pallas and
// onehot_matmul_pallas_stacked (the stacked variant is the caller's zero-copy
// view packed[li]).
//
// Contract (K5's): out[b, k] = sum over the nonzero fields (i, u) of lane k,
// i < m, of u * x[b, i], where u is G's raw 2-bit field (the stored code + 1:
// {0, 1} and one field per lane for a permutation, none for a pad lane) and
// G is (D/4, K) int8 in the pack layout at block 128 (byte [blk*32 + r, k]
// holds the fields of features blk*128 + p*32 + r in bits 2p..2p+1). x and
// out are in x's element type, bf16 or f32; the sum is f32, the fields in
// increasing i, each product rounded before it is added (no fused
// multiply-add) and the first product the sum's start. So a lane with one
// field of 1 copies x[b, i] bit for bit (-0.0 included: the value K4
// copies), a lane with no field gives +0.0, and any planes give x @ G.
//
// What bounds it: bytes. The function must read G once (0.25 B per
// (feature, lane): 4 MB at llama-3-8b's 4096 -> 4096), x once and write out
// once; at 512 rows in bf16 that is 12 MB, 3.76 us at 3.35 TB/s. The
// products are one per nonzero field. K5's first kernel (onehot_matmul.cu)
// gives each block 32 lanes and 64 rows, so at 512 rows eight blocks decode
// the same planes, and reads x with one 2-byte load per (row, lane): a
// 32-byte sector for 2 useful bytes, about 64 MB through L2 for 4 MB of x.
// The planes are the same for every row, so here they are decoded once per
// call, and x is read from device memory in whole rows. Two launches on the
// caller's stream:
//
//  1. The lane map (lane_map_kernel). One CTA of 512 threads per strip of
//     32 lanes (128 CTAs at K = 4096, about one per SM) reads its strip's
//     planes once with 16-byte loads that skip L1 and collects each lane's
//     fields, sorted by feature, with the plane gather's decode
//     (planes_gather::strip_fields, shared with K6). It writes them to a
//     scratch in device memory that stays in L2 (80 KB at K = 4096): a
//     count per lane, int32 [K], then E = 4 entry planes, int32 [E][K], entry
//     e of lane k = (i << 2) | u for e < count <= E, and -1 elsewhere (all E
//     of a lane with more than E fields).
//  2. The rows (rows_kernel). A CTA of 256 threads owns a tile of R rows and
//     a chunk of 2048 lanes, 8 neighbouring lanes a thread. It stages its R
//     rows of x whole into shared memory: a bulk copy per row
//     (cp.async.bulk, each completing on its own mbarrier) where rows start
//     and end on 16 bytes, else coalesced element loads (m = 300 in bf16 is
//     a 600-byte row). It is launch 1's programmatic dependant: its CTAs
//     may start while the lane map is built, issue their copies, and only
//     then wait for launch 1 to end. Then it reads its lanes' counts and
//     the entry planes that any of its lanes needs (one for a permutation)
//     from L2, and row by row, as each row lands, gathers from shared
//     memory and writes the row's 8 lanes as one 16-byte store (two in
//     f32). R is the largest of 4, 2 and 1 whose tile fits in 64 KB of
//     shared memory (up to m = 8192 in f32) and that still gives MIN_CTAS
//     CTAs; several CTAs on an SM overlap one's copy with another's
//     gather. So x crosses device memory once and L2 once per lane chunk
//     (2 at K = 4096), not a sector per (row, lane).
//
// On an H100 (PERF.md §6) the path takes 6.3-12.0 us a call at 16-512 rows,
// 3-5x its bound: the lane map's 4-5 us (the plane gather's decode, with its
// launch) is the floor at few rows. In A/Bs of edited copies
// (scripts/torch_k5_rows_ab.py) the programmatic launch saved 0.6-1.3 us a
// call, 256 threads and 2048 lanes a CTA beat 128 and 512 by up to 2.4 us,
// and a barrier per row against one per tile changed nothing measurable.
//
// A lane with more than E fields (planes that are not a permutation) walks
// its column of G for each of its rows, reading x from the staged tile, in
// the same feature order. No flag goes back to the host: any planes give
// the right sums. No atomics outside launch 1's shared memory, and the
// entries are sorted there: the same bits on every run.

#include "planes_gather.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {  // internal linkage: no other library's kernels of the same names interpose
namespace onehot_rows {

using planes_gather::E;
using planes_gather::LANES;

constexpr int MAP_THREADS = planes_gather::THREADS;  // 512: the plane gather's decode
constexpr int THREADS = 256;                         // launch 2
constexpr int PER_THREAD = 8;                        // lanes a thread owns: one 16-byte bf16 store
constexpr int CHUNK = THREADS * PER_THREAD;          // lanes a CTA owns
constexpr int MAX_R = 4;                             // rows a CTA owns, at most
constexpr int TILE_BYTES = 65536;                    // shared memory for the staged rows, at most
constexpr int MIN_CTAS = 256;                        // R halves (to 1) while the grid is smaller

// ---- launch 1: each strip's fields into the lane map
__global__ void __launch_bounds__(MAP_THREADS)
lane_map_kernel(const uint8_t* __restrict__ g,  // (D4, K)
                int* __restrict__ map,          // [K] counts, then [E][K] entries
                int m, int D4, int K) {
  __shared__ int ent_i[E][LANES];
  __shared__ float ent_u[E][LANES];
  __shared__ int ent_n[LANES];
  // launch 2 may start now: it stages x, then waits for this grid to end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int k0 = blockIdx.x * LANES;
  planes_gather::strip_fields(g, k0, m, D4, K, ent_i, ent_u, ent_n);
  const int t = threadIdx.x;
  if (t < LANES) {
    map[k0 + t] = ent_n[t];
  } else if (t < LANES * (E + 1)) {
    const int e = t / LANES - 1;
    const int c = t % LANES;
    const int n = ent_n[c];
    map[(size_t)(e + 1) * K + k0 + c] = (n <= E && e < n) ? (ent_i[e][c] << 2 | (int)ent_u[e][c]) : -1;
  }
}

// ---- launch 2: the rows, gathered from shared memory
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

// Lane k's sum for one staged row xr by walking its column of G (a lane with
// more than E fields): features in increasing order, as the entries are.
template <typename T>
__device__ __noinline__ float walk_column(const uint8_t* __restrict__ g, const T* xr, int k, int m,
                                          int D4, int K) {
  float t = 0.f;
  bool started = false;
  for (int grp = 0; grp < D4 / 32; ++grp) {
    uint32_t by[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) by[r] = __ldg(g + (size_t)(grp * 32 + r) * K + k);
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const uint32_t u = (by[r] >> (2 * p)) & 3u;
        const int i = grp * 128 + 32 * p + r;
        if (u == 0 || i >= m) continue;
        const float v = __fmul_rn((float)u, to_f(xr[i]));
        t = started ? __fadd_rn(t, v) : v;
        started = true;
      }
  }
  return t;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[PER_THREAD]) {
  uint4 w;
  uint32_t* h = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
  for (int j = 0; j < PER_THREAD / 2; ++j) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    h[j] = *reinterpret_cast<const uint32_t*>(&b);
  }
  *reinterpret_cast<uint4*>(p) = w;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[PER_THREAD]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Grid (ceil(K / CHUNK), ceil(rows / R)); dynamic shared memory R * m
// elements (16-byte rounded).
template <typename T, int R>
__global__ void __launch_bounds__(THREADS)
rows_kernel(const T* __restrict__ x,          // (rows, m)
            const uint8_t* __restrict__ g,    // (D4, K): walked by lanes with more than E fields
            const int* __restrict__ map,      // launch 1's lane map
            T* __restrict__ out,              // (rows, K)
            int rows, int m, int D4, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar[R];  // one per staged row
  T* xs = reinterpret_cast<T*>(smem);
  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * R;
  const int nr = min(R, rows - row0);
  const T* src = x + (size_t)row0 * m;
  const uint32_t row_bytes = (uint32_t)m * (uint32_t)sizeof(T);
  const bool bulk = reinterpret_cast<uintptr_t>(src) % 16 == 0 && row_bytes % 16 == 0;

  // ---- stage the tile's rows: one bulk copy per row, each completing on
  // its own barrier, so that row 0's sums start while the others land
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
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                         smem_addr(&bar[r])),
                     "r"(row_bytes)
                     : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
            "[%3];\n" ::"r"(smem_addr(xs + r * m)),
            "l"(src + (size_t)r * m), "r"(row_bytes), "r"(smem_addr(&bar[r]))
            : "memory");
      }
    }
  } else {
    for (int i = tid; i < nr * m; i += THREADS) xs[i] = src[i];
  }

  // ---- meanwhile this thread's lanes: their counts and the entries they
  // need, once launch 1 has ended (launched as its programmatic dependant,
  // this grid may start before; without that, the wait returns at once)
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int k0 = blockIdx.x * CHUNK + tid * PER_THREAD;
  const bool active = k0 < K;  // K is a multiple of 128: a thread's 8 lanes are all in or all out
  int cnt[PER_THREAD];
  int ent[E][PER_THREAD];
  int need = 0;  // entry planes any of the lanes needs
  if (active) {
    const int4 c0 = __ldg(reinterpret_cast<const int4*>(map + k0));
    const int4 c1 = __ldg(reinterpret_cast<const int4*>(map + k0 + 4));
    cnt[0] = c0.x, cnt[1] = c0.y, cnt[2] = c0.z, cnt[3] = c0.w;
    cnt[4] = c1.x, cnt[5] = c1.y, cnt[6] = c1.z, cnt[7] = c1.w;
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) need = max(need, cnt[j] <= E ? cnt[j] : 0);
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (e < need) {
      const int* row = map + (size_t)(e + 1) * K + k0;
      const int4 a = __ldg(reinterpret_cast<const int4*>(row));
      const int4 b = __ldg(reinterpret_cast<const int4*>(row + 4));
      ent[e][0] = a.x, ent[e][1] = a.y, ent[e][2] = a.z, ent[e][3] = a.w;
      ent[e][4] = b.x, ent[e][5] = b.y, ent[e][6] = b.z, ent[e][7] = b.w;
    }
  }
  if (!bulk) __syncthreads();
  if (!active) return;  // no barrier follows; the CTA's other threads wait for the copies

  // ---- the sums, row by row as the rows land, lane by lane
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
    const T* xr = xs + r * m;
    float acc[PER_THREAD];
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      const int n = cnt[j];
      acc[j] = 0.f;
      if (n <= E) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if (e < n) {
            const float v = __fmul_rn((float)(ent[e][j] & 3), to_f(xr[ent[e][j] >> 2]));
            acc[j] = e == 0 ? v : __fadd_rn(acc[j], v);
          }
        }
      } else {
        acc[j] = walk_column(g, xr, k0 + j, m, D4, K);
      }
    }
    store8(out + (size_t)(row0 + r) * K + k0, acc);
  }
}

// R for a call: the largest of 4, 2, 1 whose tile fits TILE_BYTES and that
// still gives MIN_CTAS CTAs (1 when even one row does not: refused).
inline int rows_per_cta(int rows, int m, int elem_bytes, int K) {
  const long row_bytes = (long)m * elem_bytes;
  const long chunks = (K + CHUNK - 1) / CHUNK;
  int R = MAX_R;
  while (R > 1 && (R * row_bytes > TILE_BYTES || chunks * ((rows + R - 1) / R) < MIN_CTAS)) R /= 2;
  return R;
}

template <typename T, int R>
int launch_rows(const void* x, const void* g, const int* map, void* out, int rows, int m, int D4,
                int K, int device, cudaStream_t s) {
  // the 64 KB tile is above the default 48 KB: raised once per device
  static bool raised[64] = {};
  if (device < 0 || device >= 64 || !raised[device]) {
    const cudaError_t e = cudaFuncSetAttribute(
        rows_kernel<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, TILE_BYTES);
    if (e != cudaSuccess) return (int)e;
    if (device >= 0 && device < 64) raised[device] = true;
  }
  // a programmatic dependant of launch 1: its CTAs may start while the lane
  // map is built, staging x before they wait for it
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((K + CHUNK - 1) / CHUNK, (rows + R - 1) / R);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = ((size_t)R * m * sizeof(T) + 15) / 16 * 16;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, rows_kernel<T, R>, static_cast<const T*>(x),
                                           static_cast<const uint8_t*>(g), map,
                                           static_cast<T*>(out), rows, m, D4, K);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <typename T>
int dispatch_rows(const void* x, const void* g, const int* map, void* out, int rows, int m, int D4,
                  int K, int device, cudaStream_t s) {
  switch (rows_per_cta(rows, m, (int)sizeof(T), K)) {
    case 4:
      return launch_rows<T, 4>(x, g, map, out, rows, m, D4, K, device, s);
    case 2:
      return launch_rows<T, 2>(x, g, map, out, rows, m, D4, K, device, s);
    default:
      return launch_rows<T, 1>(x, g, map, out, rows, m, D4, K, device, s);
  }
}

// What both launches take: m >= 1, D4 a multiple of 32 with m <= 4 * D4, K
// a multiple of 128; g and map 16-byte aligned. The rows launch also takes
// one row of x within TILE_BYTES, x aligned to its element and out to 16
// bytes (checked by its C entry).
inline int check(const void* g, const void* map, int m, int D4, int K) {
  if (m < 1 || D4 < 32 || D4 % 32 != 0 || m > 4 * D4 || K < 128 || K % 128 != 0)
    return (int)cudaErrorInvalidValue;
  if (g == nullptr || map == nullptr) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(map)) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  return 0;
}

inline int launch_map(const void* g, void* map, int m, int D4, int K, cudaStream_t s) {
  lane_map_kernel<<<K / LANES, MAP_THREADS, 0, s>>>(static_cast<const uint8_t*>(g),
                                                    static_cast<int*>(map), m, D4, K);
  return (int)cudaGetLastError();
}

}  // namespace onehot_rows
}  // namespace

// C entry points bound with ctypes (pt2tpu_torch/ops/kernels/gather.py).
//
// pt2_onehot_matmul_rows: K5's rows path, both launches on `stream`. x is
// (rows, m), g (D4, K) int8 planes, map an int32 scratch of (1 + E) * K
// (the caller's, reused by every call on its stream), out (rows, K);
// elem_bytes 2 (bf16) or 4 (f32), m * elem_bytes <= 65536. Returns the
// first launch's CUDA error; 0 means both launched.
extern "C" int pt2_onehot_matmul_rows(const void* x, const void* g, void* map, void* out,
                                      int rows, int m, int D4, int K, int elem_bytes, int device,
                                      void* stream) {
  int rc = onehot_rows::check(g, map, m, D4, K);
  if (rc == 0 && (rows < 1 || x == nullptr || out == nullptr ||
                  (elem_bytes != 2 && elem_bytes != 4) || (long)m * elem_bytes > onehot_rows::TILE_BYTES))
    rc = (int)cudaErrorInvalidValue;
  if (rc == 0 && (reinterpret_cast<uintptr_t>(x) % elem_bytes || reinterpret_cast<uintptr_t>(out) % 16))
    rc = (int)cudaErrorMisalignedAddress;
  if (rc == 0) rc = planes_gather::use_device(device);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  rc = onehot_rows::launch_map(g, map, m, D4, K, s);
  if (rc != 0) return rc;
  const int* mp = static_cast<const int*>(map);
  return elem_bytes == 2
             ? onehot_rows::dispatch_rows<__nv_bfloat16>(x, g, mp, out, rows, m, D4, K, device, s)
             : onehot_rows::dispatch_rows<float>(x, g, mp, out, rows, m, D4, K, device, s);
}

// pt2_onehot_lane_map: launch 1 alone, for checks and timing (its time is
// part of the path's): the lane map of planes g over m features into map.
extern "C" int pt2_onehot_lane_map(const void* g, void* map, int m, int D4, int K, int device,
                                   void* stream) {
  int rc = onehot_rows::check(g, map, m, D4, K);
  if (rc == 0) rc = planes_gather::use_device(device);
  if (rc != 0) return rc;
  return onehot_rows::launch_map(g, map, m, D4, K, static_cast<cudaStream_t>(stream));
}
