// Packed one-hot gather fused into the ternary matmul, for Hopper (sm_90a):
// kernel K6 of the port.
//
// Replaces pt2tpu/ops/kernels/pallas_ternary.py:ternary_matmul_pallas_gathered
// and ternary_matmul_pallas_gathered_stacked (the stacked variant at a host
// index collapses into this one: the caller passes the zero-copy views
// gpacked[li], packed[li], alpha[li], mu[li]). K6s, the stacked variant with
// a traced index, takes this kernel where its decode rows are not on the
// tensor cores (W2A8 while K1_DEC_A8 is off): the IDX instances, C entry
// pt2_ternary_matmul_gathered_idx, read the slot base + *sel of the whole
// stacks from device memory.
//
// Contract: out = (x @ G) @ W, W = alpha*(u-1) + mu, for x (B, m) bf16 in
// feature order (1 <= B <= 64), G (D/4, K) int8 packed one-hot planes (K5's
// layout: byte [blk*32 + r, k] holds the fields of features blk*128 + p*32
// + r), packed (K/4, n) int8 ternary planes with bf16 alpha / mu per scale
// block of 128 lanes, out (B, n) f32. The gathered xg = x @ G is an f32 sum
// of the raw fields (exact for a one-hot G). bf16 mode multiplies xg as it
// is; W2A8 mode (x normalised by the wrapper, as K1's) rounds xg half to
// even and clips it to [-127, 127] first. Per scale block the kernel adds
//
//   alpha[blk, j] * (xg_blk . u_blk[:, j]) + (mu - alpha)[blk, j] * sum(xg_blk)
//
// in f32 (W2A8: the dot of integers <= 127 * 2 over 128 lanes is exact in
// f32). The floor probe (impl="floor8", a8 mode 2; replaces
// pallas_ternary.py:_accumulate_step's "floor" mode here) rounds xg as W2A8
// does and takes the raw signed byte of a packed row as u for all four of
// its planes (its dots, integers below 127 * 128 * 128, are exact in f32):
// the same bytes and launches, no unpack, outputs wrong by design
// (ternary_matmul_gathered_floor_plain is the contract).
//
// What bounds it: at decode batch sizes, bytes: the weights (0.25 B per
// weight plus 4 B of scales per (block, column)), G (0.25 B per (feature,
// lane)) and x. The TPU kernel gathers one (row tile, K chunk) into VMEM
// once and then sweeps every output tile of that chunk with an f32
// accumulator per tile, because its grid runs in order on one core. On
// Hopper blocks run in parallel and in no order, so this design is split-K:
// a block owns one scale block of 128 lanes (a "chunk") and a group of
// output-column tiles. It decodes its chunk of G for all B rows into shared
// memory once (phase A: each thread owns 4 lanes, one 32-bit load per G row,
// the 8 warps split the G rows, all-zero words skipped, partial sums reduced
// across warps in a fixed order), then streams its chunk's 32 packed rows
// for each of its column tiles of 1024 (phase B: each thread owns 4 columns
// and loads their packed words 8 rows at a time; x is read from shared
// memory as a broadcast), and writes its f32 contribution to a (chunks, B, n)
// workspace. A second kernel sums the chunks in chunk order, so the result
// is deterministic without atomics. A chunk's G is decoded once per column
// group; the groups are only as many as it takes to give the card about two
// blocks per SM. Its dots run on the CUDA cores; tensor cores and TMA are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CH = 128;            // lanes per chunk: one scale block
constexpr int CH4 = CH / 4;        // packed rows of W per chunk
constexpr int TILE_N = THREADS * 4;  // output columns per pass
constexpr int U = 16;              // G words a thread loads before using them
constexpr int RG = 8;              // packed W rows a thread loads before using them
constexpr int MAX_B = 64;

template <int TB>
size_t smem_bytes(int B) {
  const int Bp = (B + TB - 1) / TB * TB;
  return sizeof(float) * ((size_t)Bp * CH + (size_t)WARPS * TB * CH + Bp);
}

// With IDX, g, packed, alpha and mu are stacks of S slots and thread 0 of
// the block reads slot base + *sel (a slot outside [0, S) traps), so a
// routed expert's index never goes to the host.
// A8: 0 bf16, 1 W2A8, 2 the floor probe (W2A8's rounding, raw bytes as codes).
template <int TB, int A8, bool IDX>
__global__ void __launch_bounds__(THREADS)
gathered_kernel(const __nv_bfloat16* __restrict__ x,      // (B, m)
                const uint8_t* __restrict__ g,            // (D4, K)
                const int8_t* __restrict__ packed,        // (K/4, n)
                const __nv_bfloat16* __restrict__ alpha,  // (K/128, n)
                const __nv_bfloat16* __restrict__ mu,     // (K/128, n)
                float* __restrict__ partial,              // (K/128, B, n)
                int B, int m, int D4, int K, int n, int tiles_per_group,
                const int* __restrict__ sel, int base, int S) {  // if IDX
  extern __shared__ float smem[];
  if constexpr (IDX) {
    __shared__ int slot_s;
    if (threadIdx.x == 0) {
      const int s = base + *sel;
      if (s < 0 || s >= S) __trap();
      slot_s = s;
    }
    __syncthreads();
    const size_t slot = (size_t)slot_s;
    g += slot * D4 * K;
    packed += slot * (size_t)(K / 4) * n;
    alpha += slot * (size_t)(K / CH) * n;
    mu += slot * (size_t)(K / CH) * n;
  }
  const int Bp = (B + TB - 1) / TB * TB;
  float* xg = smem;                     // [Bp][CH]
  float* red = xg + Bp * CH;            // [WARPS][TB][CH]
  float* bsum = red + WARPS * TB * CH;  // [Bp]
  const int chunk = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // ---- phase A: xg[b][l] = sum_i x[b, i] * u_G[i, chunk*128 + l]
  const int kg = chunk * CH + lane * 4;
  for (int row0 = 0; row0 < Bp; row0 += TB) {
    const int nb = min(TB, B - row0);
    float acc[TB][4];
#pragma unroll
    for (int b = 0; b < TB; ++b)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[b][j] = 0.f;
    for (int R0 = warp; R0 < D4; R0 += WARPS * U) {
      uint32_t w[U];
#pragma unroll
      for (int s = 0; s < U; ++s) {
        const int R = R0 + s * WARPS;
        w[s] = R < D4 ? *reinterpret_cast<const uint32_t*>(g + (size_t)R * K + kg) : 0u;
      }
#pragma unroll
      for (int s = 0; s < U; ++s) {
        uint32_t ws = w[s];
        const int R = R0 + s * WARPS;
        const int ibase = (R >> 5) * 128 + (R & 31);
        while (ws) {  // the nonzero 2-bit fields: lane j, plane p
          const int f = (__ffs(ws) - 1) >> 1;  // field index 4j + p
          const float u = (float)((ws >> (2 * f)) & 3u);
          ws &= ~(3u << (2 * f));
          const int j = f >> 2;
          const int i = ibase + (f & 3) * 32;
          if (i >= m) continue;  // x is zero-padded to D
          const __nv_bfloat16* xi = x + (size_t)row0 * m + i;
#pragma unroll
          for (int b = 0; b < TB; ++b) {
            if (b < nb) {
              const float v = u * __bfloat162float(xi[(size_t)b * m]);
#pragma unroll
              for (int jj = 0; jj < 4; ++jj)
                if (jj == j) acc[b][jj] += v;
            }
          }
        }
      }
    }
#pragma unroll
    for (int b = 0; b < TB; ++b)
#pragma unroll
      for (int j = 0; j < 4; ++j) red[(warp * TB + b) * CH + lane * 4 + j] = acc[b][j];
    __syncthreads();
    for (int o = tid; o < TB * CH; o += THREADS) {
      const int b = o / CH;
      const int c = o - b * CH;
      float t = 0.f;
#pragma unroll
      for (int q = 0; q < WARPS; ++q) t += red[(q * TB + b) * CH + c];
      if (A8) t = fminf(fmaxf(rintf(t), -127.f), 127.f);
      xg[(row0 + b) * CH + c] = t;  // rows past B hold 0
    }
    __syncthreads();  // red is reused by the next row tile
  }
  // Per-row sums of the staged (W2A8: rounded) x, one warp per row.
  for (int b = warp; b < Bp; b += WARPS) {
    float t = 0.f;
#pragma unroll
    for (int c = lane; c < CH; c += 32) t += xg[b * CH + c];
#pragma unroll
    for (int o = 16; o; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) bsum[b] = t;
  }
  __syncthreads();

  // ---- phase B: this chunk's contribution to the group's column tiles
  const int tiles = (n + TILE_N - 1) / TILE_N;
  const int t_end = min(tiles, (blockIdx.y + 1) * tiles_per_group);
  for (int tile = blockIdx.y * tiles_per_group; tile < t_end; ++tile) {
    const int c0 = tile * TILE_N + tid * 4;
    if (c0 >= n) continue;
    const int8_t* wp = packed + (size_t)chunk * CH4 * n + c0;
    float a[4], off[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const size_t so = (size_t)chunk * n + c0 + j;
      a[j] = __bfloat162float(alpha[so]);
      off[j] = __bfloat162float(mu[so]) - a[j];
    }
    for (int row0 = 0; row0 < B; row0 += TB) {
      float d[TB][4];
#pragma unroll
      for (int b = 0; b < TB; ++b)
#pragma unroll
        for (int j = 0; j < 4; ++j) d[b][j] = 0.f;
      // The chunk's 32 packed rows, 8 at a time (the first row tile reads
      // them from device memory, later ones from L1).
#pragma unroll 1
      for (int r0 = 0; r0 < CH4; r0 += RG) {
        uint32_t w[RG];
#pragma unroll
        for (int r = 0; r < RG; ++r)
          w[r] = *reinterpret_cast<const uint32_t*>(wp + (size_t)(r0 + r) * n);
#pragma unroll
        for (int r = 0; r < RG; ++r) {
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            float u[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              u[j] = A8 == 2 ? (float)(int8_t)(w[r] >> (8 * j))
                             : (float)((w[r] >> (8 * j + 2 * p)) & 3u);
            const float* xr = xg + row0 * CH + p * CH4 + r0 + r;
#pragma unroll
            for (int b = 0; b < TB; ++b) {
              const float xv = xr[b * CH];
#pragma unroll
              for (int j = 0; j < 4; ++j) d[b][j] += xv * u[j];
            }
          }
        }
      }
#pragma unroll
      for (int b = 0; b < TB; ++b) {
        if (row0 + b < B) {
          const float s = bsum[row0 + b];
          float4 o;
          o.x = a[0] * d[b][0] + off[0] * s;
          o.y = a[1] * d[b][1] + off[1] * s;
          o.z = a[2] * d[b][2] + off[2] * s;
          o.w = a[3] * d[b][3] + off[3] * s;
          *reinterpret_cast<float4*>(partial + ((size_t)chunk * B + row0 + b) * n + c0) = o;
        }
      }
    }
  }
}

// out[i] = sum over chunks, in chunk order, of partial[chunk][i] (4 floats a thread).
__global__ void __launch_bounds__(THREADS)
chunk_sum_kernel(const float4* __restrict__ partial, float4* __restrict__ out, int chunks,
                 int count4) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= count4) return;
  float4 s = partial[i];
  for (int c = 1; c < chunks; ++c) {
    const float4 v = partial[(size_t)c * count4 + i];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  out[i] = s;
}

// The slot of an IDX launch: the pointer to its int32 index, the host
// offset and the stacks' slot count (unused otherwise).
struct Slot {
  const int* sel;
  int base, S;
};

template <int TB, int A8, bool IDX>
cudaError_t launch(const void* x, const void* g, const void* packed, const void* alpha,
                   const void* mu, void* partial, int B, int m, int D4, int K, int n,
                   dim3 grid, int tiles_per_group, cudaStream_t s, const Slot& slot) {
  static bool attr_set = false;  // above 48 KB needs the opt-in, once per instantiation
  const size_t bytes = smem_bytes<TB>(B);
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(gathered_kernel<TB, A8, IDX>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem_bytes<TB>(MAX_B));
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  gathered_kernel<TB, A8, IDX><<<grid, THREADS, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(g),
      static_cast<const int8_t*>(packed), static_cast<const __nv_bfloat16*>(alpha),
      static_cast<const __nv_bfloat16*>(mu), static_cast<float*>(partial), B, m, D4, K, n,
      tiles_per_group, slot.sel, slot.base, slot.S);
  return cudaGetLastError();
}

template <int TB, bool IDX>
cudaError_t launch_mode(int a8, const void* x, const void* g, const void* packed,
                        const void* alpha, const void* mu, void* partial, int B, int m, int D4,
                        int K, int n, dim3 grid, int tpg, cudaStream_t s, const Slot& sl) {
  if (a8 == 2)
    return launch<TB, 2, IDX>(x, g, packed, alpha, mu, partial, B, m, D4, K, n, grid, tpg, s, sl);
  return a8 ? launch<TB, 1, IDX>(x, g, packed, alpha, mu, partial, B, m, D4, K, n, grid, tpg,
                                 s, sl)
            : launch<TB, 0, IDX>(x, g, packed, alpha, mu, partial, B, m, D4, K, n, grid, tpg,
                                 s, sl);
}

// The two launches of both C entries (arguments as they state).
template <bool IDX>
int run(const void* x, const void* g, const void* packed, const void* alpha, const void* mu,
        void* partial, void* out, int B, int m, int D4, int K, int n, int a8, int device,
        void* stream, const Slot& sl) {
  if (B < 1 || B > MAX_B || m < 1 || D4 < 32 || D4 % 32 != 0 || m > 4 * D4 || K < CH ||
      K % CH != 0 || n < 128 || n % 128 != 0 || a8 < 0 || a8 > 2)
    return (int)cudaErrorInvalidValue;
  if (IDX && (sl.sel == nullptr || reinterpret_cast<uintptr_t>(sl.sel) % 4 != 0 || sl.S < 1))
    return (int)cudaErrorInvalidValue;
  // This library links its own CUDA runtime: follow the caller's device.
  int cur = -1;
  if (cudaGetDevice(&cur) != cudaSuccess || cur != device) {
    const cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
  }
  int sms = 0;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const int chunks = K / CH;
  const int tiles = (n + TILE_N - 1) / TILE_N;
  // Column groups: as few as give about two blocks per SM (each group
  // decodes the chunk's G again), at most one per tile.
  const int want = max(1, min(tiles, (2 * sms + chunks - 1) / chunks));
  const int tpg = (tiles + want - 1) / want;
  dim3 grid(chunks, (tiles + tpg - 1) / tpg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int q = a8;
  if (B == 1)
    e = launch_mode<1, IDX>(q, x, g, packed, alpha, mu, partial, B, m, D4, K, n, grid, tpg, s,
                            sl);
  else if (B == 2)
    e = launch_mode<2, IDX>(q, x, g, packed, alpha, mu, partial, B, m, D4, K, n, grid, tpg, s,
                            sl);
  else if (B <= 4)
    e = launch_mode<4, IDX>(q, x, g, packed, alpha, mu, partial, B, m, D4, K, n, grid, tpg, s,
                            sl);
  else
    e = launch_mode<8, IDX>(q, x, g, packed, alpha, mu, partial, B, m, D4, K, n, grid, tpg, s,
                            sl);
  if (e != cudaSuccess) return (int)e;
  const int count4 = B * n / 4;
  chunk_sum_kernel<<<(count4 + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      static_cast<const float4*>(partial), static_cast<float4*>(out), chunks, count4);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points bound with ctypes (pt2tpu_torch/ops/kernels/ternary.py).
// x (B, m) bf16, g (D4, K) int8, packed (K/4, n) int8, alpha / mu (K/128, n)
// bf16, partial (K/128, B, n) f32 scratch, out (B, n) f32; a8 0 bf16, 1
// W2A8, 2 the floor probe (both on normalised rows). Launches the
// chunk kernel and the chunk sum; returns the first CUDA error, 0 if both
// launched.
extern "C" int pt2_ternary_matmul_gathered(const void* x, const void* g, const void* packed,
                                           const void* alpha, const void* mu, void* partial,
                                           void* out, int B, int m, int D4, int K, int n,
                                           int a8, int device, void* stream) {
  return run<false>(x, g, packed, alpha, mu, partial, out, B, m, D4, K, n, a8, device, stream,
                    Slot{nullptr, 0, 0});
}

// K6s on the CUDA cores: as pt2_ternary_matmul_gathered with g (S, D4, K),
// packed (S, K/4, n), alpha and mu (S, K/128, n) whole contiguous stacks and
// the slot base + *sel read by each block from device memory (sel: one
// int32 on the card, 4-byte aligned; base: a host offset). A slot outside
// [0, S) traps.
extern "C" int pt2_ternary_matmul_gathered_idx(const void* x, const void* g, const void* packed,
                                               const void* alpha, const void* mu, void* partial,
                                               void* out, const void* sel, int base, int S,
                                               int B, int m, int D4, int K, int n, int a8,
                                               int device, void* stream) {
  return run<true>(x, g, packed, alpha, mu, partial, out, B, m, D4, K, n, a8, device, stream,
                   Slot{static_cast<const int*>(sel), base, S});
}
