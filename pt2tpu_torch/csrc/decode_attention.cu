// Single-query decode attention over the KV cache for Hopper (sm_90a):
// kernel K7 of the port.
//
// Replaces pt2tpu/ops/kernels/pallas_attention.py:decode_attention_pallas
// (its bf16 kernel and its int8 kernels: the "hb" layout's math, which the
// "bh" layout shares). The contract is in pt2tpu_torch/ops/kernels/
// attention.py: q (B, 1, H, hd) against k/v (B, M, Hkv, hd) in bf16, or in
// int8 with f32 (B, M, Hkv) scales; query head h reads kv head h / rep.
//
// What bounds it: bytes. Each decode step reads the whole layer cache
// (2 * B * M * Hkv * hd elements) once and does 4 flops per element and
// query head of the group, far below the card's flops per byte. So the
// design reads every K/V row once, for all `rep` query heads of its group,
// and keeps everything else on chip.
//
// Design. The TPU grid (B, M/bm) runs in order on one core and carries the
// online-softmax state across M tiles, with the query laid out block-
// diagonally only to feed the MXU. Here a block owns one (row b, kv head,
// chunk of M): at B = 8, Hkv = 8 there are only 64 (b, kv head) pairs for
// 132 SMs, so M is split into chunks until there are about two blocks per
// SM. 128 threads = 8 position rows x 16 lanes; a lane holds 8 consecutive
// head dims, so 16 lanes cover a 128-wide K/V row with one 16-byte load each
// (int8: 8 bytes) and a row of the cache is read as one contiguous piece.
//   0. the group's queries into shared memory in f32; int8: each head is
//      quantised there too (the host does no query prep).
//   1. scores: per position, 16 lanes form the partial dots of their 8 dims
//      with each query head (bf16: f32 FMA; int8: two __dp4a, exact in
//      int32), then reduce over the 16 lanes with shuffles; lane 0 scales
//      the score (bf16: * scale; int8: * k_scale * q_scale * scale, where a
//      zero factor marks an invalid slot) and stores it in shared memory,
//      -inf for an invalid slot.
//   2. per query head: the chunk's max m (at least NEG = -0.7 f32max, the
//      TPU kernel's floor), p = exp(s - m), l = sum p in f32, and p (int8:
//      p * v_scale) rounded to bf16 in place, as the TPU kernel rounds the
//      operand of its P.V dot.
//   3. P.V: each thread accumulates its 8 dims for its positions in f32;
//      the 8 position rows are summed in a fixed order through shared
//      memory and the chunk writes (acc, m, l) to an f32 partial.
// A second small kernel combines the chunks of each (b, h) in chunk order:
// out = sum_c e^(m_c - M) acc_c / max(sum_c e^(m_c - M) l_c, 1e-30), in
// bf16. No atomics, so the result does not change from run to run.
//
// Not done here (later work): tensor-core dots, TMA, and skipping chunks
// past a row's last valid slot (the TPU kernel streams all of M too).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int ROWS = 8;       // position rows of a block
constexpr int LANES = 16;     // lanes per position: 16 x 8 dims = 128
constexpr int UNROLL = 4;     // positions per thread in flight
constexpr int CHUNK_MAX = 512;
constexpr int MAX_HEADS = 8;  // query heads of one kv head per block
constexpr float NEG = -0.7f * FLT_MAX;

// 8 consecutive elements as raw bits: bf16 16 bytes, int8 8 bytes.
template <bool QUANT> struct Raw;
template <> struct Raw<false> { uint4 u; };
template <> struct Raw<true> { uint2 u; };

template <bool QUANT>
__device__ __forceinline__ Raw<QUANT> load_raw(const void* p) {
  Raw<QUANT> r;
  if constexpr (QUANT) r.u = *reinterpret_cast<const uint2*>(p);
  else r.u = *reinterpret_cast<const uint4*>(p);
  return r;
}

__device__ __forceinline__ void to_float(const Raw<false>& r, float f[8]) {
  const uint32_t w[4] = {r.u.x, r.u.y, r.u.z, r.u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 -> f32 is a 16-bit shift
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void to_float(const Raw<true>& r, float f[8]) {
  const uint32_t w[2] = {r.u.x, r.u.y};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[4 * i + j] = static_cast<float>(static_cast<int8_t>((w[i] >> (8 * j)) & 0xffu));
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// One block: row b = blockIdx.z, kv head and head group from blockIdx.y,
// chunk blockIdx.x of `chunk` positions. RB = query heads per block rounded
// up to a power of two; heads past the group's count are computed on zeros
// and never written.
template <int HD, bool QUANT, int RB>
__global__ void __launch_bounds__(THREADS)
decode_attention_chunk(const __nv_bfloat16* __restrict__ q,  // (B, H, HD)
                       const void* __restrict__ k,        // (B, M, Hkv, HD)
                       const void* __restrict__ v,
                       const uint8_t* __restrict__ valid, // (B, M)
                       const float* __restrict__ k_scale, // int8: (B, M, Hkv)
                       const float* __restrict__ v_scale,
                       float* __restrict__ part_acc,      // (B, H, nchunk, HD)
                       float* __restrict__ part_ml,       // (B, H, nchunk, 2)
                       float scale, int M, int H, int Hkv, int chunk, int nchunk, int groups) {
  constexpr int PIECES = HD / 128;
  constexpr int EB = QUANT ? 1 : 2;  // element bytes of the cache
  __shared__ __align__(16) float sq[RB][HD];       // q in f32
  __shared__ __align__(16) int8_t sq8[QUANT ? RB : 1][HD];  // int8: q quantised
  __shared__ float sqs[RB];                        // int8: q_scale * scale
  __shared__ float ss[RB][CHUNK_MAX];              // scores, then rounded p
  __shared__ __align__(16) float red[ROWS][HD];    // the 8 rows' acc, summed
  __shared__ float sm[RB], sl[RB];

  const int c = blockIdx.x;
  const int hkv = blockIdx.y / groups, g = blockIdx.y % groups;
  const int b = blockIdx.z;
  const int rep = H / Hkv;
  const int h0 = hkv * rep + g * MAX_HEADS;
  const int nh = min(RB, rep - g * MAX_HEADS);
  const int c0 = c * chunk, clen = min(chunk, M - c0);
  const int tid = threadIdx.x, lane = tid % LANES, row = tid / LANES;

  // ---- the group's queries into shared memory
  for (int i = tid; i < RB * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    sq[r][d] = r < nh ? __bfloat162float(q[((size_t)b * H + h0 + r) * HD + d]) : 0.f;
  }
  __syncthreads();
  const int warp = tid / 32, wl = tid % 32;
  if constexpr (QUANT) {
    // int8 query, one warp per head: q_scale = max|q| / 127 floored at
    // 1e-20, codes rint(q / q_scale) (half to even, as torch.round) clipped
    // to +-127. Every block of the group computes the same codes.
    for (int r = warp; r < RB; r += THREADS / 32) {
      float a = 0.f;
      for (int d = wl; d < HD; d += 32) a = fmaxf(a, fabsf(sq[r][d]));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, off));
      const float qs = fmaxf(a / 127.f, 1e-20f);
      for (int d = wl; d < HD; d += 32)
        sq8[r][d] = static_cast<int8_t>(fminf(fmaxf(rintf(sq[r][d] / qs), -127.f), 127.f));
      if (wl == 0) sqs[r] = r < nh ? qs * scale : 0.f;
    }
    __syncthreads();
  }
  float qsf[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) qsf[r] = QUANT ? sqs[r] : 0.f;

  const size_t rs = (size_t)Hkv * HD;  // elements between positions
  const size_t base = ((size_t)b * M + c0) * rs + (size_t)hkv * HD + lane * 8;
  const char* kb = static_cast<const char*>(k) + base * EB;
  const char* vb = static_cast<const char*>(v) + base * EB;

  // ---- 1. scores of the chunk's positions for every head of the group
  for (int p0 = 0; p0 < clen; p0 += ROWS * UNROLL) {
    Raw<QUANT> raw[UNROLL][PIECES];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int p = p0 + u * ROWS + row;
#pragma unroll
      for (int pc = 0; pc < PIECES; ++pc)
        if (p < clen) raw[u][pc] = load_raw<QUANT>(kb + ((size_t)p * rs + pc * 128) * EB);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int p = p0 + u * ROWS + row;
      float s[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) s[r] = 0.f;
      if (p < clen) {
#pragma unroll
        for (int pc = 0; pc < PIECES; ++pc) {
          const int d0 = pc * 128 + lane * 8;
          if constexpr (QUANT) {
            const int kw0 = static_cast<int>(raw[u][pc].u.x), kw1 = static_cast<int>(raw[u][pc].u.y);
#pragma unroll
            for (int r = 0; r < RB; ++r) {
              const int2 qw = *reinterpret_cast<const int2*>(&sq8[r][d0]);
              int acc = __dp4a(kw0, qw.x, 0);
              acc = __dp4a(kw1, qw.y, acc);
              s[r] += static_cast<float>(acc);  // partial sums < 2^24: exact
            }
          } else {
            float kf[8];
            to_float(raw[u][pc], kf);
#pragma unroll
            for (int r = 0; r < RB; ++r) {
              const float4 qa = *reinterpret_cast<const float4*>(&sq[r][d0]);
              const float4 qb = *reinterpret_cast<const float4*>(&sq[r][d0 + 4]);
              float a = s[r];
              a = fmaf(kf[0], qa.x, a); a = fmaf(kf[1], qa.y, a);
              a = fmaf(kf[2], qa.z, a); a = fmaf(kf[3], qa.w, a);
              a = fmaf(kf[4], qb.x, a); a = fmaf(kf[5], qb.y, a);
              a = fmaf(kf[6], qb.z, a); a = fmaf(kf[7], qb.w, a);
              s[r] = a;
            }
          }
        }
      }
      // every lane takes part in the shuffles; the 16 lanes of a position
      // are one half of a warp, so offsets 8..1 stay inside it
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int off = LANES / 2; off > 0; off >>= 1)
          s[r] += __shfl_xor_sync(0xffffffffu, s[r], off);
      if (p < clen && lane == 0) {
        const size_t pos = (size_t)b * M + c0 + p;
        const bool ok = valid[pos] != 0;
        if constexpr (QUANT) {
          const float ksp = k_scale[pos * Hkv + hkv];
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            const float ks = ok ? ksp * qsf[r] : 0.f;
            ss[r][p] = ks > 0.f ? s[r] * ks : -INFINITY;
          }
        } else {
#pragma unroll
          for (int r = 0; r < RB; ++r) ss[r][p] = ok ? s[r] * scale : -INFINITY;
        }
      }
    }
  }
  __syncthreads();

  // ---- 2. the chunk's softmax statistics, p rounded to bf16 in place
  for (int r = warp; r < RB; r += THREADS / 32) {
    float m = NEG;
    for (int p = wl; p < clen; p += 32) m = fmaxf(m, ss[r][p]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
    for (int p = wl; p < clen; p += 32) {
      const float e = expf(ss[r][p] - m);  // -inf (invalid) -> 0
      l += e;
      float pv = e;
      if constexpr (QUANT) pv = e * v_scale[((size_t)b * M + c0 + p) * Hkv + hkv];
      ss[r][p] = bf16_round(pv);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    if (wl == 0) {
      sm[r] = m;
      sl[r] = l;
    }
  }
  __syncthreads();

  // ---- 3. P.V over the chunk, f32 accumulators for 8 dims x RB heads
  float acc[RB][PIECES][8];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int pc = 0; pc < PIECES; ++pc)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[r][pc][j] = 0.f;
  for (int p0 = 0; p0 < clen; p0 += ROWS * UNROLL) {
    Raw<QUANT> raw[UNROLL][PIECES];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int p = p0 + u * ROWS + row;
#pragma unroll
      for (int pc = 0; pc < PIECES; ++pc)
        if (p < clen) raw[u][pc] = load_raw<QUANT>(vb + ((size_t)p * rs + pc * 128) * EB);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int p = p0 + u * ROWS + row;
      if (p >= clen) continue;
#pragma unroll
      for (int pc = 0; pc < PIECES; ++pc) {
        float vf[8];
        to_float(raw[u][pc], vf);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float pr = ss[r][p];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[r][pc][j] = fmaf(pr, vf[j], acc[r][pc][j]);
        }
      }
    }
  }

  // ---- the chunk's partial: rows summed in order 0..7
  const size_t out0 = ((size_t)b * H + h0) * nchunk + c;
#pragma unroll
  for (int r = 0; r < RB; ++r) {
#pragma unroll
    for (int pc = 0; pc < PIECES; ++pc)
#pragma unroll
      for (int j = 0; j < 8; ++j) red[row][pc * 128 + lane * 8 + j] = acc[r][pc][j];
    __syncthreads();
    if (r < nh) {
      for (int d = tid; d < HD; d += THREADS) {
        float t = 0.f;
#pragma unroll
        for (int i = 0; i < ROWS; ++i) t += red[i][d];
        part_acc[(out0 + (size_t)r * nchunk) * HD + d] = t;
      }
    }
    __syncthreads();
  }
  if (tid < nh) {
    part_ml[(out0 + (size_t)tid * nchunk) * 2] = sm[tid];
    part_ml[(out0 + (size_t)tid * nchunk) * 2 + 1] = sl[tid];
  }
}

// One block per (b, h): combine the chunks in chunk order.
template <int HD>
__global__ void __launch_bounds__(THREADS)
decode_attention_combine(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                         __nv_bfloat16* __restrict__ out, int nchunk) {
  const size_t bh = blockIdx.x;
  const float* ml = part_ml + bh * nchunk * 2;
  float mx = NEG;
  for (int c = 0; c < nchunk; ++c) mx = fmaxf(mx, ml[2 * c]);
  float l = 0.f;
  for (int c = 0; c < nchunk; ++c) l += expf(ml[2 * c] - mx) * ml[2 * c + 1];
  const float den = fmaxf(l, 1e-30f);
  for (int d = threadIdx.x; d < HD; d += THREADS) {
    float a = 0.f;
    for (int c = 0; c < nchunk; ++c) a += expf(ml[2 * c] - mx) * part_acc[(bh * nchunk + c) * HD + d];
    out[bh * HD + d] = __float2bfloat16_rn(a / den);
  }
}

template <int HD, bool QUANT>
cudaError_t launch(int rb, dim3 grid, cudaStream_t s, const __nv_bfloat16* q, const void* k,
                   const void* v, const uint8_t* valid, const float* ks, const float* vs,
                   float* pa, float* pml, float scale, int M, int H, int Hkv, int chunk,
                   int nchunk, int groups) {
#define PT2_K7_CASE(RB_)                                                                   \
  case RB_:                                                                                \
    decode_attention_chunk<HD, QUANT, RB_><<<grid, THREADS, 0, s>>>(                       \
        q, k, v, valid, ks, vs, pa, pml, scale, M, H, Hkv, chunk, nchunk, groups);         \
    break;
  switch (rb) {
    PT2_K7_CASE(1)
    PT2_K7_CASE(2)
    PT2_K7_CASE(4)
    PT2_K7_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef PT2_K7_CASE
  return cudaGetLastError();
}

}  // namespace

// C entry point bound with ctypes (pt2tpu_torch/ops/kernels/attention.py).
// q is bf16 (B, H, hd) (quantised to int8 in the kernel when quant); k/v
// bf16 or (quant) int8 with k_scale/v_scale (B, M, Hkv) f32; valid (B, M)
// bytes; part_acc (B, H, nchunk, hd) and part_ml (B, H, nchunk, 2) f32
// scratch with nchunk = ceil(M / chunk); out (B, H, hd) bf16. hd is 128 or
// 256; chunk a multiple of 8 up to 512. Returns the first launch error, or 0.
extern "C" int pt2_decode_attention(const void* q, const void* k, const void* v,
                                    const void* valid, const void* k_scale,
                                    const void* v_scale, void* part_acc, void* part_ml,
                                    void* out, float scale, int B, int M, int H, int Hkv,
                                    int hd, int chunk, int quant, int device, void* stream) {
  if (B < 1 || M < 1 || Hkv < 1 || H < Hkv || H % Hkv || (hd != 128 && hd != 256) ||
      chunk < ROWS || chunk > CHUNK_MAX || chunk % ROWS ||
      (quant && (!k_scale || !v_scale)))
    return (int)cudaErrorInvalidValue;
  int cur = -1;
  if (cudaGetDevice(&cur) != cudaSuccess || cur != device) {
    const cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rep = H / Hkv;
  const int groups = (rep + MAX_HEADS - 1) / MAX_HEADS;
  const int heads = rep < MAX_HEADS ? rep : MAX_HEADS;
  const int rb = heads <= 1 ? 1 : heads <= 2 ? 2 : heads <= 4 ? 4 : 8;
  const int nchunk = (M + chunk - 1) / chunk;
  if (Hkv * groups > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(nchunk, Hkv * groups, B);
  const uint8_t* vd = static_cast<const uint8_t*>(valid);
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(q);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  float* pa = static_cast<float*>(part_acc);
  float* pml = static_cast<float*>(part_ml);
  cudaError_t e;
  if (hd == 128)
    e = quant ? launch<128, true>(rb, grid, s, qb, k, v, vd, ks, vs, pa, pml, scale, M, H, Hkv,
                                  chunk, nchunk, groups)
              : launch<128, false>(rb, grid, s, qb, k, v, vd, ks, vs, pa, pml, scale, M, H,
                                   Hkv, chunk, nchunk, groups);
  else
    e = quant ? launch<256, true>(rb, grid, s, qb, k, v, vd, ks, vs, pa, pml, scale, M, H, Hkv,
                                  chunk, nchunk, groups)
              : launch<256, false>(rb, grid, s, qb, k, v, vd, ks, vs, pa, pml, scale, M, H,
                                   Hkv, chunk, nchunk, groups);
  if (e != cudaSuccess) return (int)e;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  if (hd == 128)
    decode_attention_combine<128><<<B * H, THREADS, 0, s>>>(pa, pml, o, nchunk);
  else
    decode_attention_combine<256><<<B * H, THREADS, 0, s>>>(pa, pml, o, nchunk);
  return (int)cudaGetLastError();
}
