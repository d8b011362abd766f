// The plane gather for Hopper (sm_90a): x @ G through the packed one-hot
// planes, written where K1's decode kernel or K3's tensor-core product reads
// its x. It is the first of the two launches of each of K6's redesigned
// paths (csrc/ternary_matmul_gathered_dec.cu for rows 1 to 8,
// csrc/ternary_matmul_gathered_tc.cu for rows 9 to 64), which together
// replace pt2tpu/ops/kernels/pallas_ternary.py:ternary_matmul_pallas_gathered
// (and its _stacked variant) at those rows; the gather is that kernel's
// prologue (_gather_prologue, into its VMEM scratch xg_ref).
//
// Contract: for x (B, m) bf16 in feature order (W2A8: the output of
// normalize_rows_a8) and G (D/4, K) int8 in the pack layout at block 128
// (byte [blk*32 + r, k] holds the 2-bit fields of features blk*128 + p*32 + r
// in bits 2p..2p+1, as u = code + 1: {0, 1} and one field per lane for a
// permutation, none for a pad lane),
//
//   xg[b, k] = sum over the nonzero fields (i, u) of lane k, i < m, of u * x[b, i]
//
// in f32, the fields in increasing i (the first product is the sum's start,
// so a lane with one field of 1 gives x[b, i] bit for bit), then rounded to
// bf16 as the TPU kernel's scratch is (pallas_ternary.py:517-522); W2A8
// first rounds it half to even and clips it to [-127, 127], which bf16
// holds exactly. A lane with no field gives 0. Two output forms:
//   * lane order (FRAG false): xg (B, K) bf16, the x that K1's decode kernel
//     reads (csrc/ternary_matmul_dec.cu without GATHER);
//   * fragment order (FRAG true): xg (Bp, K) bf16, Bp = 16, 32 or 64, rows
//     >= B zero, within each scale block of 128 lanes position 8h + 2p + i
//     holding lane 32p + 2h + i, and S (K/128, Bp) f32, each block's sum of
//     the stored values: what K3's product reads
//     (csrc/ternary_matmul_igathered_tc.cu, igathered_tc_kernel).
//
// What bounds it: its bound is bytes. It must read G once (0.25 B per
// (feature, lane): 4 MB at llama-3-8b's 4096 -> 4096), x once and write xg
// once; the products are one per nonzero field. On an H100 it runs at 4-6x
// that bound (5.1-9.3 us a launch at 1-64 rows, PERF.md §6): what holds it
// is the decode of each strip's loaded words and the launch, not the 4 MB
// (a variant that reads no x is 0.3 us faster at 1-8 rows). A CTA owns a
// strip of 32 lanes (a quarter of a scale block), so 4096 lanes give 128
// CTAs, about one per SM: a CTA of 128 lanes would leave 32 CTAs to pull
// 4 MB. Each thread owns 16
// neighbouring lanes and reads them as one 16-byte load per G row (two
// threads cover the strip's 32 bytes, a full sector); the 256 thread rows
// of the CTA split the G rows, issue all of their loads (4 at D/4 = 1024)
// before any use and skip all-zero words (all but one in 128 for a
// permutation). 512 threads with 4 loads each beat 256 with 8 and 1024
// with 2 at every row count (scripts/torch_k6_gather_ab.py; PERF.md §6):
// the decoding of the loaded words and the rows' x loads are spread over
// more warps. The fields found are kept per lane in shared memory, up to
// E, and sorted by feature; a lane with more than E fields (planes that are
// not a permutation) walks its column of G again for each of its rows
// instead. No flag goes back to the host: any planes give the right sums.
// Then warp w computes rows w, w + 16, ..., one lane per thread, reading x
// through L1 / L2 (a 4096-wide bf16 row is 8 KB).
//
// Fragment order needs each block's four quarters together: the four CTAs
// of a block form a cluster. Each keeps its 32 lanes of every row and the
// row's quarter sum (a warp butterfly over its 32 stored values) in shared
// memory; after a cluster barrier, CTA r of the cluster writes rows
// r*Bp/4 .. (r+1)*Bp/4 - 1 of the block, each 16-byte chunk h (positions
// 8h .. 8h + 7) from the four quarters' lanes 2h, 2h + 1 read through
// distributed shared memory, and S = ((s0 + s1) + s2) + s3 in quarter
// order. No atomics: the same bits on every run. Lane order runs in the
// same clusters and writes its strip's lanes directly.
//
// K6s (the _stacked variant with a traced index: a routed expert's
// projection) gathers through the IDX instance: g is the whole (S, D/4, K)
// stack and thread 0 of each CTA reads the slot, base + *sel, from device
// memory (outside [0, S) it traps); the GEMV that follows reads the same
// int32 for its weights (csrc/ternary_matmul_gathered_dec.cu).
//
// Everything here lives in namespace planes_gather, so that it does not
// clash with the constants and helpers of the sources that include it.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace planes_gather {

namespace cg = cooperative_groups;

constexpr int LANES = 32;             // lanes per CTA: a quarter of a scale block
constexpr int QUARTERS = 4;           // CTAs per cluster: one scale block of 128 lanes
constexpr int THREADS = 512;          // 16 warps; 256 thread rows x 2 threads across the strip
constexpr int WARPS = THREADS / 32;
constexpr int ROW_STEP = THREADS / 2; // G rows the CTA covers per batch of loads
constexpr int U = 4;                  // 16-byte G loads a thread issues before using them
constexpr int E = 4;                  // fields per lane kept in shared memory
constexpr int MAX_ROWS = 64;

// W2A8's rounding of a gathered value: half to even, clipped to +-127
__device__ __forceinline__ float round_a8(float f) {
  return fminf(fmaxf(rintf(f), -127.f), 127.f);
}

__device__ __forceinline__ uint4 ld_planes(const uint8_t* p) {
  uint4 r;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

// Lane k's sum for row xr (x's row b, m values) by walking its column of G:
// the lanes with more than E fields. Features in increasing order: per
// group of 32 G rows, plane p, then row r (feature grp*128 + 32p + r).
__device__ float walk_column(const uint8_t* __restrict__ g, const unsigned short* __restrict__ xr,
                             int k, int m, int D4, int K) {
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
        const float v = (float)u * __uint_as_float((uint32_t)__ldg(xr + i) << 16);
        t = started ? t + v : v;
        started = true;
      }
  }
  return t;
}

// The fields (feature i < m, value u) of each lane of the strip of LANES
// lanes from k0, read from G once: up to E per lane in ent_i / ent_u, sorted
// by feature, and the lane's count of fields in ent_n (more than E: the lane
// must walk its column instead). All THREADS threads of the CTA call it; it
// ends with a barrier, after which the three arrays hold the result. K6's
// plane gather and K5's lane map (csrc/onehot_matmul_rows.cu) both start so.
__device__ __forceinline__ void strip_fields(const uint8_t* __restrict__ g, int k0, int m, int D4,
                                             int K, int (&ent_i)[E][LANES],
                                             float (&ent_u)[E][LANES], int (&ent_n)[LANES]) {
  const int tid = threadIdx.x;
  if (tid < LANES) ent_n[tid] = 0;
  __syncthreads();
  const int side = tid & 1;  // lanes 16 * side .. + 15 of the strip
  for (int R0 = tid >> 1; R0 < D4; R0 += ROW_STEP * U) {
    uint4 w[U];
#pragma unroll
    for (int s = 0; s < U; ++s) {
      const int R = R0 + s * ROW_STEP;
      w[s] = R < D4 ? ld_planes(g + (size_t)R * K + k0 + 16 * side) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int s = 0; s < U; ++s) {
      const int R = R0 + s * ROW_STEP;
      const int ibase = (R >> 5) * 128 + (R & 31);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t ws = j == 0 ? w[s].x : j == 1 ? w[s].y : j == 2 ? w[s].z : w[s].w;
        while (ws) {  // the nonzero 2-bit fields: byte f >> 2 (a lane), plane f & 3
          const int f = (__ffs(ws) - 1) >> 1;
          const int u = (ws >> (2 * f)) & 3;
          ws &= ~(3u << (2 * f));
          const int i = ibase + 32 * (f & 3);
          if (i >= m) continue;  // x is zero beyond its m features
          const int c = 16 * side + 4 * j + (f >> 2);
          const int slot = atomicAdd(&ent_n[c], 1);
          if (slot < E) {
            ent_i[slot][c] = i;
            ent_u[slot][c] = (float)u;
          }
        }
      }
    }
  }
  __syncthreads();
  if (tid < LANES) {  // the arrival order is the scheduler's: sort by feature
    const int n = min(ent_n[tid], E);
    for (int a = 1; a < n; ++a)
      for (int b = a; b > 0 && ent_i[b - 1][tid] > ent_i[b][tid]; --b) {
        const int ti = ent_i[b][tid];
        ent_i[b][tid] = ent_i[b - 1][tid];
        ent_i[b - 1][tid] = ti;
        const float tu = ent_u[b][tid];
        ent_u[b][tid] = ent_u[b - 1][tid];
        ent_u[b - 1][tid] = tu;
      }
  }
  __syncthreads();
}

// Grid (K / 32): CTA c owns lanes 32c .. 32c + 31, the quarter c % 4 of
// scale block c / 4, whose four CTAs form a cluster. With IDX, g is a stack
// of S slots of D4 x K bytes and the CTA gathers through slot base + *sel.
template <bool FRAG, bool A8, bool IDX = false>
__global__ void __cluster_dims__(QUARTERS, 1, 1) __launch_bounds__(THREADS)
planes_gather_kernel(const __nv_bfloat16* __restrict__ x,  // (B, m)
                     const uint8_t* __restrict__ g,        // (D4, K), (S, D4, K) if IDX
                     __nv_bfloat16* __restrict__ xg,       // (B, K) lanes / (Bp, K) fragments
                     float* __restrict__ sums,             // (K / 128, Bp) if FRAG
                     int B, int Bp, int m, int D4, int K,
                     const int* __restrict__ sel, int base, int S) {  // if IDX
  __shared__ int ent_i[E][LANES];
  __shared__ float ent_u[E][LANES];
  __shared__ int ent_n[LANES];
  __shared__ __align__(16) unsigned short vals[FRAG ? MAX_ROWS : 1][LANES];  // bf16 bits
  __shared__ float qsum[FRAG ? MAX_ROWS : 1];
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
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int k0 = blockIdx.x * LANES;
  const unsigned short* xh = reinterpret_cast<const unsigned short*>(x);

  // ---- each lane's fields (feature i, value u), once for all rows
  strip_fields(g, k0, m, D4, K, ent_i, ent_u, ent_n);

  // ---- the values: warp w computes rows w, w + WARPS, ..., lane `lane`
  const int n = ent_n[lane];
  const int k = k0 + lane;
  const int rows = FRAG ? Bp : B;
  for (int b = warp; b < rows; b += WARPS) {
    float t = 0.f;
    if (b < B) {
      const unsigned short* xr = xh + (size_t)b * m;
      if (n <= E) {
        for (int e = 0; e < n; ++e) {
          const float v = ent_u[e][lane] * __uint_as_float((uint32_t)__ldg(xr + ent_i[e][lane]) << 16);
          t = e == 0 ? v : t + v;
        }
      } else {
        t = walk_column(g, xr, k, m, D4, K);
      }
      if (A8) t = round_a8(t);
    }
    const __nv_bfloat16 v = __float2bfloat16_rn(t);
    if (!FRAG) {
      xg[(size_t)b * K + k] = v;
    } else {
      vals[b][lane] = __bfloat16_as_ushort(v);
      float s = __bfloat162float(v);
#pragma unroll
      for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) qsum[b] = s;
    }
  }
  if constexpr (FRAG) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every quarter's values and sums are in its shared memory
    const int rank = (int)cluster.block_rank();
    const int blk = blockIdx.x / QUARTERS;
    const unsigned short* qv[QUARTERS];
    const float* qs[QUARTERS];
#pragma unroll
    for (int q = 0; q < QUARTERS; ++q) {
      qv[q] = cluster.map_shared_rank(&vals[0][0], q);
      qs[q] = cluster.map_shared_rank(&qsum[0], q);
    }
    const int per = Bp / QUARTERS;
    for (int idx = tid; idx < per * 16; idx += THREADS) {
      const int b = rank * per + (idx >> 4);
      const int h = idx & 15;
      uint4 chunk;
      chunk.x = *reinterpret_cast<const uint32_t*>(qv[0] + b * LANES + 2 * h);
      chunk.y = *reinterpret_cast<const uint32_t*>(qv[1] + b * LANES + 2 * h);
      chunk.z = *reinterpret_cast<const uint32_t*>(qv[2] + b * LANES + 2 * h);
      chunk.w = *reinterpret_cast<const uint32_t*>(qv[3] + b * LANES + 2 * h);
      *reinterpret_cast<uint4*>(xg + (size_t)b * K + (size_t)blk * 128 + 8 * h) = chunk;
      if (h == 0) sums[(size_t)blk * Bp + b] = ((qs[0][b] + qs[1][b]) + qs[2][b]) + qs[3][b];
    }
    cluster.sync();  // no CTA leaves while another reads its shared memory
  }
}

// What the launch takes: 1 <= B <= 64 (lane order B <= Bp = B; fragment
// order Bp 16, 32 or 64 and B <= Bp), m >= 1, D4 a multiple of 32 with
// m <= 4 * D4, K a multiple of 128; g and xg 16-byte aligned, sums 4-byte,
// x 2-byte.
inline int check(const void* x, const void* g, const void* xg, const void* sums, int B, int Bp,
                 int m, int D4, int K, bool frag) {
  if (B < 1 || B > MAX_ROWS || m < 1 || D4 < 32 || D4 % 32 != 0 || m > 4 * D4 || K < 128 ||
      K % 128 != 0)
    return (int)cudaErrorInvalidValue;
  if (frag ? (Bp != 16 && Bp != 32 && Bp != 64) || B > Bp : Bp != B)
    return (int)cudaErrorInvalidValue;
  if (x == nullptr || g == nullptr || xg == nullptr || (frag && sums == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(xg)) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 2 != 0 || (frag && reinterpret_cast<uintptr_t>(sums) % 4))
    return (int)cudaErrorMisalignedAddress;
  return 0;
}

// One launch on stream s (checked by the caller); returns its CUDA error.
inline int launch_gather(const void* x, const void* g, void* xg, void* sums, int B, int Bp, int m,
                         int D4, int K, bool frag, bool a8, cudaStream_t s) {
  const dim3 grid(K / LANES);
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  const uint8_t* gp = static_cast<const uint8_t*>(g);
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(xg);
  float* sp = static_cast<float*>(sums);
  if (frag) {
    if (a8)
      planes_gather_kernel<true, true><<<grid, THREADS, 0, s>>>(xp, gp, op, sp, B, Bp, m, D4, K,
                                                                nullptr, 0, 0);
    else
      planes_gather_kernel<true, false><<<grid, THREADS, 0, s>>>(xp, gp, op, sp, B, Bp, m, D4, K,
                                                                 nullptr, 0, 0);
  } else {
    if (a8)
      planes_gather_kernel<false, true><<<grid, THREADS, 0, s>>>(xp, gp, op, sp, B, Bp, m, D4, K,
                                                                 nullptr, 0, 0);
    else
      planes_gather_kernel<false, false><<<grid, THREADS, 0, s>>>(xp, gp, op, sp, B, Bp, m, D4,
                                                                  K, nullptr, 0, 0);
  }
  return (int)cudaGetLastError();
}

// The IDX launch in lane order (K6s's decode rows): g the whole stack,
// the slot base + *sel (sel 4-byte aligned, S >= 1: the caller checks).
inline int launch_gather_idx(const void* x, const void* g, void* xg, int B, int m, int D4, int K,
                             bool a8, const void* sel, int base, int S, cudaStream_t s) {
  const dim3 grid(K / LANES);
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  const uint8_t* gp = static_cast<const uint8_t*>(g);
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(xg);
  const int* ip = static_cast<const int*>(sel);
  if (a8)
    planes_gather_kernel<false, true, true><<<grid, THREADS, 0, s>>>(xp, gp, op, nullptr, B, B, m,
                                                                     D4, K, ip, base, S);
  else
    planes_gather_kernel<false, false, true><<<grid, THREADS, 0, s>>>(xp, gp, op, nullptr, B, B,
                                                                      m, D4, K, ip, base, S);
  return (int)cudaGetLastError();
}

// This library links its own CUDA runtime: follow the caller's device.
inline int use_device(int device) {
  int cur = -1;
  if (cudaGetDevice(&cur) != cudaSuccess || cur != device) return (int)cudaSetDevice(device);
  return 0;
}

}  // namespace planes_gather

// C entry point bound with ctypes (pt2tpu_torch/ops/kernels/ternary.py): the
// plane gather alone, for checks and timing (its time is part of each
// path's). x (B, m) bf16 (W2A8: the normalised rows, rounded here), g (D4,
// K) int8 planes; frag 0: xg (B, K) bf16 in lane order, Bp = B, sums not
// read; frag 1: xg (Bp, K) bf16 in fragment order and sums (K / 128, Bp)
// f32. Returns the launch's CUDA error; 0 means it launched.
extern "C" int pt2_planes_gather(const void* x, const void* g, void* xg, void* sums, int B,
                                 int Bp, int m, int D4, int K, int frag, int a8, int device,
                                 void* stream) {
  int rc = planes_gather::check(x, g, xg, sums, B, Bp, m, D4, K, frag != 0);
  if (rc == 0) rc = planes_gather::use_device(device);
  if (rc != 0) return rc;
  return planes_gather::launch_gather(x, g, xg, sums, B, Bp, m, D4, K, frag != 0, a8 != 0,
                                      static_cast<cudaStream_t>(stream));
}
