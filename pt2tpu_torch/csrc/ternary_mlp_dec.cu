// K2's decode rows (1 to 8) on the tensor cores, for Hopper (sm_90a).
//
// Replaces pt2tpu/ops/kernels/pallas_ternary.py:ternary_mlp_pallas (and its
// _stacked variant: the caller passes the views of layer li) at decode row
// counts: the whole gated MLP, bf16, scale blocks of 128,
//
//   gate = xg @ dequant(gu[:, :half]),   up = xg @ dequant(gu[:, half:])
//   mid  = bf16(act(gate) * up)
//   out  = mid @ dequant(dn[:half])      (B, n) f32, 1 <= B <= 8
//
// with xg = x[:, perm] (0 for a pad lane, perm[k] >= m) for the "ssr"
// layout and x zero-padded to Kg lanes for the "down" layout (the wrapper
// passes the identity perm: lanes k >= m read as 0), and act silu, gelu
// (tanh form, tanhf) or relu, a template parameter as in
// csrc/ternary_mlp.cu. The ungated MLP (the TPU kernel's gated = False:
// gateup is up alone, I or more lanes wide) is the GATED = false instance,
// C entry pt2_ternary_mlp_dec_ungated: mid = bf16(act(up)) over all of up's
// lanes (pad columns carry zero scales, so act(0) = 0 there), then down. Rows 9 to 64 run csrc/ternary_mlp_tc.cu; the wrapper
// picks by rows (k2_path in pt2tpu_torch/ops/kernels/ternary.py), never
// after a failure.
//
// The floor probe (impl="floor8"; pallas_ternary.py:_make_mlp_kernel with
// a8mode "floor", whose _accumulate_step takes its floor branch for gate,
// up and down alike) is the FLOOR instance, C entries
// pt2_ternary_mlp_dec_floor and pt2_ternary_mlp_dec_floor_ungated: x is
// rounded half to even and clipped to +-127 as it is staged (no row
// normalisation: the TPU kernel's MLP wrapper has none), every plane of a
// packed row reads its raw signed byte b as the code T = b - 1 (the decode
// kernel's raw_bf16x2, so the epilogue stays alpha * d + mu * S), mid is
// rounded and clipped the same way before it is stored (an integer, exact in
// bf16), and down is the decode kernel's own FLOOR instance (a8 mode 2) over
// it. The same bytes, grid, splits and launches; outputs are wrong by design
// (ternary_mlp_floor_plain is the contract). The block dots are integers
// below 127 * 129 * 128 < 2^24, exact in f32.
//
// What bounds it: at <= 8 rows the MLP reads 0.25 B per weight of codes
// plus 4 B per (block, column) of alpha and mu, and does 2 * 8 operations
// per weight: device-memory bytes. The CUDA-core K2 (csrc/ternary_mlp.cu)
// does one FMA per code and row on the CUDA cores, so from 4 rows its
// instruction rate binds. Here the MLP is K1's split-K tensor-core decode
// GEMV (csrc/ternary_matmul_dec.cu, which this file includes) twice, with
// the gated epilogue between. One C entry, two launches on the caller's
// stream:
//
//   1. Gate/up (mlp_dec_gateup_kernel below): the decode kernel's body with
//      x staged through perm (its GATHER instances' staging), over all
//      2 * half gateup columns, split-K by dec_splits: 16-byte code loads
//      straight into registers, mma.sync m16n8k16 with A = codes and B =
//      the <= 8 rows, S from the ones-mma, the warps summed in order. What
//      changes is the end. Every slice writes its (B, 2 * half) f32
//      partial, even when there is one slice (1.8 MB at llama-3-8b and 8
//      rows: it stays in L2). Gate tile t (columns 128t ..) and up tile
//      t + half / 128 share one integer counter; the last of the pair's
//      2 * splits CTAs to finish sums the gate slices and the up slices in
//      slice order and writes mid = bf16(act(gate) * up) for those 128
//      lanes into a (B, half) bf16 row-major scratch: the x layout of K1's
//      decode kernel. Ungated, each up tile has a counter of its own, and
//      the last of its splits CTAs writes mid = bf16(act(up)).
//   2. Down: K1's decode kernel, ternary_matmul_dec_kernel<false, false>,
//      as it is, over mid with K = half (down's pad blocks beyond half are
//      never read), split-K by dec_splits, slices summed in slice order by
//      the last CTA of each column tile.
// No float atomics: the same bits on every run.
//
// ptxas and times on an H100: PERF.md §6 (chip_smoke.py phases 16a-16c).

#include "ternary_matmul_dec.cu"  // K1's decode kernel, its helpers and its launch

namespace {

constexpr int MBS = 128;       // K2's scale block, gateup's and down's
constexpr int MLS = MBS / 32;  // load sets of 8 packed rows per block
constexpr int MBS4 = MBS / 4;

// The activations, by the code the C entry takes (0 silu, 1 gelu, 2 relu),
// as csrc/ternary_mlp.cu computes them.
template <int ACT>
__device__ __forceinline__ float mlp_act(float g) {
  if (ACT == 0) return g / (1.f + expf(-g));
  if (ACT == 1) return 0.5f * g * (1.f + tanhf(0.7978845608f * (g + 0.044715f * g * g * g)));
  return fmaxf(g, 0.f);
}

// Grid (n / 128, splits), n = 2 * half gated, half ungated. CTA (c, sp) is
// ternary_matmul_dec_kernel's CTA (c, sp) with GATHER over gateup (bs =
// 128): it sums blocks sp*bpc .. min(nb, (sp+1)*bpc) - 1 of column tile c
// into partial[sp, :B]. Gated, tile c pairs with tile c +- half / 128 (gate
// with up); the last of the pair's 2 * splits CTAs to finish (counters[c mod
// half / 128]) writes mid for the pair's 128 lanes. Ungated, the last of
// tile c's splits CTAs (counters[c]) writes mid for the tile's 128 lanes.
// Either sets its counter back to 0.
template <int ACT, bool GATED, bool FLOOR>
__global__ void __launch_bounds__(THREADS, 4)
mlp_dec_gateup_kernel(const __nv_bfloat16* __restrict__ x,      // (B, m), feature order
                      const int* __restrict__ perm,             // (Kg,)
                      const int8_t* __restrict__ packed,        // (Kg / 4, n)
                      const __nv_bfloat16* __restrict__ alpha,  // (Kg / 128, n)
                      const __nv_bfloat16* __restrict__ mu,     // (Kg / 128, n)
                      float* __restrict__ partial,              // (splits, B, n)
                      __nv_bfloat16* __restrict__ mid,          // (B, half)
                      int* __restrict__ counters,               // (half / 128,), zero
                      int B, int m, int Kg, int half, int bpc) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n = GATED ? 2 * half : half;
  const int col0 = blockIdx.x * BN;
  const int sp = blockIdx.y;
  const int splits = gridDim.y;
  const int blk0 = sp * bpc;
  const int nblk = min(bpc, Kg / MBS - blk0);
  // xs and am as in ternary_matmul_dec_kernel: per (local block lb, load
  // set s, lane (g, t)) four words, word P = (x[g, lane(P, r)],
  // x[g, lane(P, r + 1)]), r = 8s + 2t; per local block the tile's 128
  // alpha, then its 128 mu. The warps' sums alias xs at the end.
  uint32_t* xs = reinterpret_cast<uint32_t*>(smem);
  __nv_bfloat16* am = reinterpret_cast<__nv_bfloat16*>(
      smem + (bpc * MBS * 16 > RED_BYTES ? bpc * MBS * 16 : RED_BYTES));

  // This warp's blocks lb = warp, warp + WARPS, ...: one stage (four load
  // sets) each. The first block's packed rows are loaded before x is staged.
  const int nst = warp < nblk ? (nblk - 1 - warp) / WARPS + 1 : 0;
  const int8_t* pcol = packed + col0 + 16 * g;
  uint4 v[4][2];
  auto load_stage = [&](int st) {
    const size_t r0 = (size_t)(blk0 + warp + st * WARPS) * MBS4 + 2 * t;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[q][0] = ld_stream(pcol + (r0 + 8 * q) * n);
      v[q][1] = ld_stream(pcol + (r0 + 8 * q + 1) * n);
    }
  };
  if (nst > 0) load_stage(0);

  for (int i = tid; i < nblk * 32; i += THREADS) {
    const int lb = i >> 5;
    const int k = i & 31;
    const __nv_bfloat16* src =
        (k < 16 ? alpha : mu) + (size_t)(blk0 + lb) * n + col0 + 8 * (k & 15);
    *reinterpret_cast<uint4*>(am + (lb * 32 + k) * 8) = __ldg(reinterpret_cast<const uint4*>(src));
  }
  // x into xs through perm, as the GATHER instances stage it: the 8 lanes
  // p*32 + 8s .. + 7 of (unit lb*4 + s, plane p) are neighbours in perm
  {
    const unsigned short* xh = reinterpret_cast<const unsigned short*>(x);
    const int items = nblk * MLS * 4;
    for (int i = tid; i < items; i += THREADS) {
      const int p = i & 3;
      const int unit = i >> 2;
      const int lb = unit / MLS;
      const int s = unit - lb * MLS;
      const int4* pk =
          reinterpret_cast<const int4*>(perm + (size_t)(blk0 + lb) * MBS + p * MBS4 + 8 * s);
      const int4 q0 = __ldg(pk);
      const int4 q1 = __ldg(pk + 1);
      const int idx[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
      uint32_t* dst = xs + unit * 128 + p;
#pragma unroll 2
      for (int row = 0; row < B; ++row) {
        const unsigned short* xr = xh + (size_t)row * m;
        uint32_t w[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint32_t lo = (unsigned)idx[2 * k] < (unsigned)m ? __ldg(xr + idx[2 * k]) : 0u;
          const uint32_t hi =
              (unsigned)idx[2 * k + 1] < (unsigned)m ? __ldg(xr + idx[2 * k + 1]) : 0u;
          w[k] = lo | (hi << 16);
          if constexpr (FLOOR) {
            const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[k]));
            const __nv_bfloat162 q = __floats2bfloat162_rn(rounded(f.x), rounded(f.y));
            w[k] = *reinterpret_cast<const uint32_t*>(&q);  // exact: integers <= 127
          }
        }
        dst[16 * row] = w[0];
        dst[16 * row + 4] = w[1];
        dst[16 * row + 8] = w[2];
        dst[16 * row + 12] = w[3];
      }
    }
  }
  __syncthreads();

  // acc[j][e]: column 16g + j + 8 * (e >> 1) of the tile, row 2t + (e & 1)
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const uint32_t ones[4] = {0x3f803f80u, 0x3f803f80u, 0x3f803f80u, 0x3f803f80u};

  for (int st = 0; st < nst; ++st) {
    const int lb = warp + st * WARPS;
    if (st > 0) load_stage(st);
    float d[8][4];
    float srow[4];  // the block's row sums: srow[0] row 2t, srow[1] row 2t + 1
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      srow[e] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) d[j][e] = 0.f;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 b = g < B ? *reinterpret_cast<const uint4*>(xs + ((lb * MLS + q) * 32 + lane) * 4)
                            : make_uint4(0, 0, 0, 0);
      mma_bf16(srow, ones, b.x, b.y);  // S: every A entry 1
      mma_bf16(srow, ones, b.z, b.w);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t sel = (j & 3) | ((4 + (j & 3)) << 8);
        const uint32_t wl = __byte_perm(word(v[q][0], j >> 2), word(v[q][1], j >> 2), sel);
        const uint32_t wh =
            __byte_perm(word(v[q][0], 2 + (j >> 2)), word(v[q][1], 2 + (j >> 2)), sel);
        if constexpr (FLOOR) {  // every plane reads the raw byte
          const uint32_t rl = raw_bf16x2(wl), rh = raw_bf16x2(wh);
          const uint32_t raw[4] = {rl, rh, rl, rh};
          mma_bf16(d[j], raw, b.x, b.y);
          mma_bf16(d[j], raw, b.z, b.w);
        } else {
          const uint32_t a01[4] = {codes_bf16x2<0>(wl), codes_bf16x2<0>(wh), codes_bf16x2<1>(wl),
                                   codes_bf16x2<1>(wh)};
          mma_bf16(d[j], a01, b.x, b.y);
          const uint32_t a23[4] = {codes_bf16x2<2>(wl), codes_bf16x2<2>(wh), codes_bf16x2<3>(wl),
                                   codes_bf16x2<3>(wh)};
          mma_bf16(d[j], a23, b.z, b.w);
        }
      }
    }
    // the block is complete: acc += alpha * d + mu * S
    const __nv_bfloat16* ab = am + (lb * 32 + 2 * g) * 8;  // alpha of columns 16g ..
    const uint4 al0 = *reinterpret_cast<const uint4*>(ab);
    const uint4 al1 = *reinterpret_cast<const uint4*>(ab + 8);
    const uint4 mu0 = *reinterpret_cast<const uint4*>(ab + 128);
    const uint4 mu1 = *reinterpret_cast<const uint4*>(ab + 136);
    const __nv_bfloat16* ah0 = reinterpret_cast<const __nv_bfloat16*>(&al0);
    const __nv_bfloat16* ah1 = reinterpret_cast<const __nv_bfloat16*>(&al1);
    const __nv_bfloat16* mh0 = reinterpret_cast<const __nv_bfloat16*>(&mu0);
    const __nv_bfloat16* mh1 = reinterpret_cast<const __nv_bfloat16*>(&mu1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float a_lo = __bfloat162float(ah0[j]), a_hi = __bfloat162float(ah1[j]);
      const float m_lo = __bfloat162float(mh0[j]), m_hi = __bfloat162float(mh1[j]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[j][e] = fmaf(e < 2 ? a_lo : a_hi, d[j][e], acc[j][e]);
        acc[j][e] = fmaf(e < 2 ? m_lo : m_hi, srow[e & 1], acc[j][e]);
      }
    }
  }

  // the warps' accumulators, summed in the order warp 0, 1, 2, 3, into
  // this slice's partial
  __syncthreads();  // every warp is done with xs
  float* red = reinterpret_cast<float*>(smem);  // [warp][value 4j + e][lane]
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) red[(warp * 32 + 4 * j + e) * 32 + lane] = acc[j][e];
  __syncthreads();
  float* o = partial + (size_t)sp * B * n;
#pragma unroll
  for (int q = 0; q < 8; ++q) {  // this thread sums values 8 * warp .. + 7 of lane
    const int i = 8 * warp + q;
    float s = red[i * 32 + lane];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) s += red[(w * 32 + i) * 32 + lane];
    const int row = 2 * t + (i & 1);
    const int col = col0 + 16 * g + (i >> 2) + 8 * ((i >> 1) & 1);
    if (row < B) o[(size_t)row * n + col] = s;
  }

  // the last CTA of the gate/up pair (ungated: of the up tile) sums each
  // half's slices in order and writes mid for its 128 lanes
  const int tiles = half / BN;
  const int pair = GATED && blockIdx.x >= tiles ? blockIdx.x - tiles : blockIdx.x;
  __threadfence();  // this CTA's partial is visible before it is counted
  __syncthreads();
  if (tid == 0) last = atomicAdd(&counters[pair], 1) == (GATED ? 2 : 1) * splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = tid; i < B * (BN / 4); i += THREADS) {
    const int row = i / (BN / 4);
    const int lane0 = pair * BN + 4 * (i - row * (BN / 4));
    const size_t at = (size_t)row * n + lane0;
    float4 gs = __ldcg(reinterpret_cast<const float4*>(partial + at));
    for (int k = 1; k < splits; ++k) {
      const float4 pg = __ldcg(reinterpret_cast<const float4*>(partial + (size_t)k * B * n + at));
      gs.x += pg.x;
      gs.y += pg.y;
      gs.z += pg.z;
      gs.w += pg.w;
    }
    float4 v = make_float4(mlp_act<ACT>(gs.x), mlp_act<ACT>(gs.y), mlp_act<ACT>(gs.z),
                           mlp_act<ACT>(gs.w));
    if constexpr (GATED) {
      float4 us = __ldcg(reinterpret_cast<const float4*>(partial + at + half));
      for (int k = 1; k < splits; ++k) {
        const float4 pu =
            __ldcg(reinterpret_cast<const float4*>(partial + (size_t)k * B * n + at + half));
        us.x += pu.x;
        us.y += pu.y;
        us.z += pu.z;
        us.w += pu.w;
      }
      v = make_float4(v.x * us.x, v.y * us.y, v.z * us.z, v.w * us.w);
    }
    if constexpr (FLOOR)  // the floor's mid: rounded and clipped, exact in bf16
      v = make_float4(rounded(v.x), rounded(v.y), rounded(v.z), rounded(v.w));
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 w;
    w.x = *reinterpret_cast<const uint32_t*>(&lo);
    w.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(mid + (size_t)row * half + lane0) = w;
  }
  if (tid == 0) counters[pair] = 0;  // ready for the next launch on the stream
}

// The blocks per slice for `splits` slices of nb blocks, or 0 where that
// leaves a slice empty, is outside 1 .. nb, or stages more than MAX_SLICE
// lanes.
int dec_slice_blocks(int nb, int splits) {
  if (splits < 1 || splits > nb) return 0;
  const int bpc = (nb + splits - 1) / splits;
  return (splits - 1) * bpc < nb && bpc * MBS <= MAX_SLICE ? bpc : 0;
}

// The two launches of the C entries (arguments as they state).
template <bool GATED, bool FLOOR = false>
int run(const void* x, const void* perm, const void* gu_packed, const void* gu_alpha,
        const void* gu_mu, const void* dn_packed, const void* dn_alpha, const void* dn_mu,
        void* gu_partial, void* dn_partial, void* mid, void* out, void* counters, int B, int m,
        int Kg, int half, int n, int gu_splits, int dn_splits, int act, int device,
        void* stream) {
  if (B < 1 || B > MAX_ROWS || m < 1 || Kg < MBS || Kg % MBS != 0 || half < MBS ||
      half % MBS != 0 || n < BN || n % BN != 0 || act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  const int gu_bpc = dec_slice_blocks(Kg / MBS, gu_splits);
  if (gu_bpc == 0 || dec_slice_blocks(half / MBS, dn_splits) == 0)
    return (int)cudaErrorInvalidValue;
  const void* aligned[] = {perm, gu_packed, gu_alpha, gu_mu, dn_packed, dn_alpha, dn_mu,
                           gu_partial, mid, out, dn_splits > 1 ? dn_partial : out};
  uintptr_t any = 0;
  for (const void* p : aligned) {
    if (p == nullptr) return (int)cudaErrorInvalidValue;
    any |= reinterpret_cast<uintptr_t>(p);
  }
  if (x == nullptr || counters == nullptr) return (int)cudaErrorInvalidValue;
  if (any % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 2 != 0 ||
      reinterpret_cast<uintptr_t>(counters) % 4 != 0)
    return (int)cudaErrorMisalignedAddress;
  // This library links its own CUDA runtime: follow the caller's device.
  int cur = -1;
  if (cudaGetDevice(&cur) != cudaSuccess || cur != device) {
    const cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
  }
  const size_t smem = (size_t)(gu_bpc * MBS * 16 > RED_BYTES ? gu_bpc * MBS * 16 : RED_BYTES) +
                      (size_t)gu_bpc * 512;
  const dim3 grid((GATED ? 2 : 1) * half / BN, gu_splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  const int* pm = static_cast<const int*>(perm);
  const int8_t* gp = static_cast<const int8_t*>(gu_packed);
  const __nv_bfloat16* ga = static_cast<const __nv_bfloat16*>(gu_alpha);
  const __nv_bfloat16* gm = static_cast<const __nv_bfloat16*>(gu_mu);
  float* part = static_cast<float*>(gu_partial);
  __nv_bfloat16* md = static_cast<__nv_bfloat16*>(mid);
  int* cp = static_cast<int*>(counters);
  if (act == 0)
    mlp_dec_gateup_kernel<0, GATED, FLOOR><<<grid, THREADS, smem, s>>>(
        xp, pm, gp, ga, gm, part, md, cp, B, m, Kg, half, gu_bpc);
  else if (act == 1)
    mlp_dec_gateup_kernel<1, GATED, FLOOR><<<grid, THREADS, smem, s>>>(
        xp, pm, gp, ga, gm, part, md, cp, B, m, Kg, half, gu_bpc);
  else
    mlp_dec_gateup_kernel<2, GATED, FLOOR><<<grid, THREADS, smem, s>>>(
        xp, pm, gp, ga, gm, part, md, cp, B, m, Kg, half, gu_bpc);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch<false>(mid, nullptr, dn_packed, dn_alpha, dn_mu, dn_partial, out, counters, B,
                       half, half, n, MBS, dn_splits, FLOOR ? 2 : 0, device, stream);
}

}  // namespace

// C entry points bound with ctypes (pt2tpu_torch/ops/kernels/ternary.py).
//
// x (B, m) bf16, 1 <= B <= 8, in feature order; perm (Kg,) int32 the visit
// lane -> feature map with pad lanes >= m (the identity arange(Kg) for the
// layout without a gather, m <= Kg); gateup (Kg / 4, 2 * half) int8 codes
// with (Kg / 128, 2 * half) bf16 alpha and mu, gate lanes [0, half) then up
// lanes; down (>= half / 4, n) int8 codes with (>= half / 128, n) bf16 alpha
// and mu, of which the first half / 128 blocks are read. Scratch:
// gu_partial (gu_splits, B, 2 * half) f32, dn_partial (dn_splits, B, n) f32
// (not read with one slice), mid (B, half) bf16; out (B, n) f32; counters
// max(half, n) / 128 int32, all 0 (each launch leaves them 0; launches that
// share them must not run concurrently). Kg, half and n multiples of 128;
// each product's K slices are ceil(nb / splits) blocks, none empty, at most
// 16 blocks (2048 lanes) each; act 0 silu, 1 gelu (tanh form), 2 relu.
// perm, codes, scales, scratch and out 16-byte aligned, x 2-byte, counters
// 4-byte. Two launches on the stream (gate/up, down); returns the first
// failure's CUDA error, 0 meaning both launched.
extern "C" int pt2_ternary_mlp_dec(const void* x, const void* perm, const void* gu_packed,
                                   const void* gu_alpha, const void* gu_mu, const void* dn_packed,
                                   const void* dn_alpha, const void* dn_mu, void* gu_partial,
                                   void* dn_partial, void* mid, void* out, void* counters, int B,
                                   int m, int Kg, int half, int n, int gu_splits, int dn_splits,
                                   int act, int device, void* stream) {
  return run<true>(x, perm, gu_packed, gu_alpha, gu_mu, dn_packed, dn_alpha, dn_mu, gu_partial,
                   dn_partial, mid, out, counters, B, m, Kg, half, n, gu_splits, dn_splits, act,
                   device, stream);
}

// The ungated MLP: as pt2_ternary_mlp_dec with gateup the up projection
// alone, (Kg / 4, half) int8 codes with (Kg / 128, half) bf16 alpha and mu
// (half >= I: pad columns carry zero scales), gu_partial (gu_splits, B,
// half) f32, and mid = bf16(act(up)).
extern "C" int pt2_ternary_mlp_dec_ungated(const void* x, const void* perm, const void* gu_packed,
                                           const void* gu_alpha, const void* gu_mu,
                                           const void* dn_packed, const void* dn_alpha,
                                           const void* dn_mu, void* gu_partial, void* dn_partial,
                                           void* mid, void* out, void* counters, int B, int m,
                                           int Kg, int half, int n, int gu_splits, int dn_splits,
                                           int act, int device, void* stream) {
  return run<false>(x, perm, gu_packed, gu_alpha, gu_mu, dn_packed, dn_alpha, dn_mu, gu_partial,
                    dn_partial, mid, out, counters, B, m, Kg, half, n, gu_splits, dn_splits, act,
                    device, stream);
}

// The floor probe's MLP (impl="floor8"): as pt2_ternary_mlp_dec and
// pt2_ternary_mlp_dec_ungated, with x and mid rounded and clipped to +-127
// and every plane's code the raw signed byte of its packed row (the header).
extern "C" int pt2_ternary_mlp_dec_floor(const void* x, const void* perm, const void* gu_packed,
                                         const void* gu_alpha, const void* gu_mu,
                                         const void* dn_packed, const void* dn_alpha,
                                         const void* dn_mu, void* gu_partial, void* dn_partial,
                                         void* mid, void* out, void* counters, int B, int m,
                                         int Kg, int half, int n, int gu_splits, int dn_splits,
                                         int act, int device, void* stream) {
  return run<true, true>(x, perm, gu_packed, gu_alpha, gu_mu, dn_packed, dn_alpha, dn_mu,
                         gu_partial, dn_partial, mid, out, counters, B, m, Kg, half, n, gu_splits,
                         dn_splits, act, device, stream);
}

extern "C" int pt2_ternary_mlp_dec_floor_ungated(const void* x, const void* perm,
                                                 const void* gu_packed, const void* gu_alpha,
                                                 const void* gu_mu, const void* dn_packed,
                                                 const void* dn_alpha, const void* dn_mu,
                                                 void* gu_partial, void* dn_partial, void* mid,
                                                 void* out, void* counters, int B, int m, int Kg,
                                                 int half, int n, int gu_splits, int dn_splits,
                                                 int act, int device, void* stream) {
  return run<false, true>(x, perm, gu_packed, gu_alpha, gu_mu, dn_packed, dn_alpha, dn_mu,
                          gu_partial, dn_partial, mid, out, counters, B, m, Kg, half, n,
                          gu_splits, dn_splits, act, device, stream);
}
