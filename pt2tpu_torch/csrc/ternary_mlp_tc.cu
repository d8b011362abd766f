// K2's rows 9 to 64 on the tensor cores, for Hopper (sm_90a).
//
// Replaces pt2tpu/ops/kernels/pallas_ternary.py:ternary_mlp_pallas (and its
// _stacked variant: the caller passes the views of layer li) at 9 to 64
// rows: the whole gated MLP, bf16, scale blocks of 128,
//
//   gate = xg @ dequant(gu[:, :half]),   up = xg @ dequant(gu[:, half:])
//   mid  = bf16(act(gate) * up)
//   out  = mid @ dequant(dn[:half])      (B, n) f32
//
// with xg = x[:, perm] (0 for a pad lane, perm[k] >= m) for the "ssr"
// layout and x zero-padded to Kg lanes for the "down" layout, and act silu,
// gelu (tanh form, tanhf) or relu, a template parameter as in
// csrc/ternary_mlp.cu, which keeps the decode rows 1 to 8. The wrapper picks
// by shape (k2_path in pt2tpu_torch/ops/kernels/ternary.py), never after a
// failure. The ungated MLP (the TPU kernel's gated = False: gateup is up
// alone, I or more lanes wide; mid = bf16(act(up))) is the GATED = false
// instance of the gate/up product, C entry pt2_ternary_mlp_tc_ungated: one
// up product whose epilogue applies the activation (below).
//
// The floor probe (impl="floor8"; pallas_ternary.py:_make_mlp_kernel with
// a8mode "floor": _accumulate_step's floor branch for gate, up and down) is
// the FLOOR instance, C entries pt2_ternary_mlp_tc_floor and
// pt2_ternary_mlp_tc_floor_ungated: K3's gather rounds x half to even and
// clips it to +-127 (its W2A8 mode; no row normalisation, as the TPU
// kernel's MLP wrapper has none), the gate/up product reads the raw signed
// byte b of a packed row as the code of all four of its planes (T = b - 1,
// raw_bf16x2, so the epilogue stays alpha * d + mu * S), the epilogue rounds
// and clips mid the same way (an integer, exact in bf16; its block sums are
// exact), and down is K3's FLOOR product over it. The same bytes, grid and
// launches; outputs are wrong by design (ternary_mlp_floor_plain is the
// contract).
//
// What bounds it: at 64 rows a llama-3-8b MLP reads 49.6 MB of codes and
// scales and does 22.5 GFLOP, 454 operations per byte, above the card's
// bf16 line (295): the dots must run on the tensor cores. At 16 rows (114
// per byte) the bytes bound it. The CUDA-core kernel (csrc/ternary_mlp.cu)
// re-reads every code once per 8-row tile and does one FMA per code and row.
// Here the MLP is the K3 tensor-core path twice (this file includes
// csrc/ternary_matmul_igathered_tc.cu and launches its gather and its
// product as they are), with a gated epilogue between. One C entry, three
// launches on the caller's stream:
//
//   1. K3's one-pass gather writes xg (Bp, Kg) bf16 in mma fragment order
//      and its block sums S (Kg / 128, Bp) f32, Bp = 16, 32 or 64 (pad rows
//      zero). The "down" layout goes through the same gather with the
//      identity perm (the wrapper's arange(Kg)): lanes k >= m read as 0,
//      which is the zero pad.
//   2. The gate/up product (mlp_gateup_kernel below): K3's split-K
//      mma.sync m16n8k16 product with A = codes (converted once per CTA and
//      fed to all NT = Bp / 8 row tiles) and B = xg, but a CTA owns 64 gate
//      lanes j and the 64 up lanes half + j that pair with them: warp w's A
//      rows g and g + 8 are gate lane 8w + g and its up lane. So every
//      thread holds gate and up of the same (row, lane) in one accumulator
//      fragment and writes mid = bf16(act(gate) * up) itself, with no
//      exchange between CTAs. mid goes to a (Bp, half) bf16 scratch in the
//      down product's fragment order (1.8 MB at llama-3-8b and 64 rows: it
//      stays in L2), and the CTA's 64 lanes of mid, as stored, are summed
//      per row (over g by shuffles, then over the warps in order). Down's
//      scale block of 128 lanes is two CTAs: the second of the pair to
//      finish (an integer counter) adds the two halves, first half first,
//      into Smid (half / 128, Bp) f32. Where K is cut into slices (not at
//      llama-3-8b or gemma-2b, whose 224 and 256 CTAs fill one wave), each
//      slice writes its (Bp, 2 * half) f32 partial and the last CTA of a
//      column tile sums the slices in slice order, then runs the epilogue.
//      Ungated, a CTA owns the 128 up lanes of one down block instead:
//      warp w's A rows g and g + 8 are lanes 8w + g and 64 + 8w + g of the
//      block (the same fragments, the second lane where the gated CTA has
//      its up lane), its epilogue writes mid = bf16(act(up)) for both, sums
//      each 64 lanes as stored as the gated CTAs do, and adds the two
//      halves into Smid itself, first half first: no pair counter.
//   3. K3's product over mid: K = half (down's pad blocks beyond half are
//      never read), n = dim, split-K by igtc_splits, slices summed in slice
//      order by the last CTA of each column tile, acc += alpha * d +
//      mu * Smid.
// No float atomics: the same bits on every run.
//
// ptxas (nvcc for sm_90a, -O3): the gate/up product at NT = 2 / 4 / 8 row
// tiles 80 / 95 / 128 registers, with 8 bytes of spill (28 bytes of spill
// loads) at NT = 8 only; K3's product and gather as in its source (127 and
// 34 registers at most, no spills). On an H100 SXM (700 W) a llama-3-8b
// MLP takes 71 / 86 / 129 us at 16 / 32 / 64 rows, gate/up about 60 % of
// it (chip_smoke.py phase 15c; PERF.md). wgmma, TMA and one fused launch
// are later work.

#include "ternary_matmul_igathered_tc.cu"  // K3's gather, product and helpers

namespace {

constexpr int MBS = 128;     // K2's scale block, gateup's and down's
constexpr int MCOLS = 64;    // gate lanes (and as many up lanes) per CTA
constexpr int WARPS = THREADS / 32;

// The activations, by the code the C entry takes (0 silu, 1 gelu, 2 relu),
// as csrc/ternary_mlp.cu computes them.
template <int ACT>
__device__ __forceinline__ float mlp_act(float g) {
  if (ACT == 0) return g / (1.f + expf(-g));
  if (ACT == 1) return 0.5f * g * (1.f + tanhf(0.7978845608f * (g + 0.044715f * g * g * g)));
  return fmaxf(g, 0.f);
}

// Grid (half / 64, splits). CTA (c, sp) sums gateup's blocks sp*bpc ..
// min(nb, (sp+1)*bpc) - 1 for gate lanes 64c .. 64c + 63 and up lanes
// half + 64c ..; with one slice it goes straight to the epilogue, else it
// writes partial[sp] and the last CTA of column tile c (counters[c]) sums
// the slices in order and runs it. The epilogue writes mid for its 64
// lanes and all Bp rows, their per-row sum to msums[c], and the second CTA
// of down block c / 2 to finish (counters[gridDim.x + c / 2]) writes
// msums[half / 64 + c / 2] = msums[c & ~1] + msums[c | 1]. Each counter is
// left 0.
//
// Ungated (GATED false): grid (half / 128, splits), gateup is up alone
// (half lanes, n2 = half); CTA (c, sp) sums lanes 128c .. 128c + 127 (its
// gate lanes' place holds lanes 128c .., its up lanes' 128c + 64 ..),
// writes mid = bf16(act(up)) for them, msums[2c] and msums[2c + 1] the sums
// of its two 64-lane halves and msums[half / 64 + c] their sum, with no
// pair counter.
template <int NT, int ACT, bool GATED, bool FLOOR>
__global__ void __launch_bounds__(THREADS, 2)
mlp_gateup_kernel(const __nv_bfloat16* __restrict__ xg,     // (Bp, Kg), fragment order
                  const float* __restrict__ sums,           // (Kg / 128, Bp)
                  const int8_t* __restrict__ packed,        // (Kg / 4, n2)
                  const __nv_bfloat16* __restrict__ alpha,  // (Kg / 128, n2)
                  const __nv_bfloat16* __restrict__ mu,     // (Kg / 128, n2)
                  float* __restrict__ partial,              // (splits, Bp, n2)
                  __nv_bfloat16* __restrict__ mid,          // (Bp, half), fragment order
                  float* __restrict__ msums,                // (half / 64 + half / 128, Bp)
                  int* __restrict__ counters,               // (half / 64 + half / 128,), zero
                  int Kg, int half, int bpc) {
  typedef Stage<NT> S;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[GATED ? 1 : 2][WARPS][S::BP];
  __shared__ int last;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int c = blockIdx.x;
  const int lane0 = c * (GATED ? MCOLS : 2 * MCOLS);  // the CTA's first gate lane
  const int off2 = GATED ? half : MCOLS;  // its up lanes' offset from its gate lanes
  const int n2 = GATED ? 2 * half : half;
  const int sp = blockIdx.y;
  const int splits = gridDim.y;
  const int blk0 = sp * bpc;
  const int nblk = min(bpc, Kg / MBS - blk0);
  const uint32_t sbase = smem_u32(smem);

  // Block blk0 + u into ring slot u % STAGES: the xg tile (chunk c of row r
  // at chunk c ^ 4 (r & 1)), the codes (per packed row 64 gate bytes, then
  // 64 up bytes; ungated the CTA's first 64 lanes, then its last 64), alpha
  // and mu (64 gate values, then 64 up values, each)
  auto load_unit = [&](int u) {
    const int blk = blk0 + u;
    const uint32_t st = sbase + (u % STAGES) * S::BYTES;
    const __nv_bfloat16* xs = xg + (size_t)blk * MBS;
#pragma unroll
    for (int i = tid; i < S::BP * 16; i += THREADS) {
      const int r = i >> 4;
      const int cc = i & 15;
      cp_async16(st + r * (KC * 2) + ((cc ^ ((r & 1) << 2)) << 4), xs + (size_t)r * Kg + cc * 8);
    }
    {
      const int r = tid >> 3;
      const int cc = tid & 7;
      const int col = (cc < 4 ? lane0 : off2 + lane0) + 16 * (cc & 3);
      cp_async16(st + S::X_BYTES + r * PSTRIDE + cc * 16,
                 packed + ((size_t)blk * PROWS + r) * n2 + col);
    }
    if (tid < 32) {
      const int k = tid & 15;
      const int col = (k < 8 ? lane0 : off2 + lane0) + 8 * (k & 7);
      cp_async16(st + S::X_BYTES + S::P_BYTES + tid * 16,
                 (tid < 16 ? alpha : mu) + (size_t)blk * n2 + col);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nblk) load_unit(s);
    cp_async_commit();
  }

  // acc[nt][e] / d[nt][e]: row nt*8 + 2t + (e & 1); e < 2 gate lane
  // lane0 + 8w + g, e >= 2 its up lane
  float acc[NT][4];
  float d[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int u = 0; u < nblk; ++u) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // block u has landed; every warp is done with block u - 1
    if (u + STAGES - 1 < nblk) load_unit(u + STAGES - 1);
    cp_async_commit();
    const unsigned char* st = smem + (u % STAGES) * S::BYTES;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[nt][e] = 0.f;
    const unsigned char* pc = st + S::X_BYTES + 8 * warp + g;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      // packed rows 8q + 2t and + 1 into bytes 0 and 2: the gate lane's, then the up lane's
      const unsigned char* r0 = pc + (8 * q + 2 * t) * PSTRIDE;
      const uint32_t wl = (uint32_t)r0[0] | ((uint32_t)r0[PSTRIDE] << 16);
      const uint32_t wh = (uint32_t)r0[MCOLS] | ((uint32_t)r0[PSTRIDE + MCOLS] << 16);
      uint32_t a01[4], a23[4];
      if constexpr (FLOOR) {  // every plane reads the raw byte
        const uint32_t rl = raw_bf16x2(wl), rh = raw_bf16x2(wh);
        a01[0] = a23[0] = a01[2] = a23[2] = rl;
        a01[1] = a23[1] = a01[3] = a23[3] = rh;
      } else {
        a01[0] = codes_bf16x2<0>(wl), a01[1] = codes_bf16x2<0>(wh);
        a01[2] = codes_bf16x2<1>(wl), a01[3] = codes_bf16x2<1>(wh);
        a23[0] = codes_bf16x2<2>(wl), a23[1] = codes_bf16x2<2>(wh);
        a23[2] = codes_bf16x2<3>(wl), a23[3] = codes_bf16x2<3>(wh);
      }
      const int chunk = (4 * q + t) ^ ((g & 1) << 2);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint4 b = *reinterpret_cast<const uint4*>(st + (nt * 8 + g) * (KC * 2) + chunk * 16);
        mma_bf16(d[nt], a01, b.x, b.y);
        mma_bf16(d[nt], a23, b.z, b.w);
      }
    }
    // acc += alpha * d + mu * S
    const __nv_bfloat16* am =
        reinterpret_cast<const __nv_bfloat16*>(st + S::X_BYTES + S::P_BYTES) + 8 * warp + g;
    const float ag = __bfloat162float(am[0]);
    const float au = __bfloat162float(am[MCOLS]);
    const float mg = __bfloat162float(am[2 * MCOLS]);
    const float mu_ = __bfloat162float(am[3 * MCOLS]);
    const float* sb = sums + (size_t)(blk0 + u) * S::BP + 2 * t;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 sv = __ldg(reinterpret_cast<const float2*>(sb + nt * 8));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[nt][e] = fmaf(e < 2 ? ag : au, d[nt][e], acc[nt][e]);
        acc[nt][e] = fmaf(e < 2 ? mg : mu_, (e & 1) ? sv.y : sv.x, acc[nt][e]);
      }
    }
  }
  cp_async_wait<0>();

  const int gl = lane0 + 8 * warp + g;  // this lane's gate lane; its up lane is off2 + gl
  if (splits > 1) {
    float* o = partial + (size_t)sp * S::BP * n2;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const size_t at = (size_t)(nt * 8 + 2 * t + i) * n2 + gl;
        o[at] = acc[nt][i];
        o[at + off2] = acc[nt][2 + i];
      }
    __threadfence();  // this CTA's partial is visible before it is counted
    __syncthreads();
    if (tid == 0) last = atomicAdd(&counters[c], 1) == splits - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    // the slices in slice order, into this thread's own fragment positions
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const size_t at = (size_t)(nt * 8 + 2 * t + i) * n2 + gl;
        float sg = __ldcg(partial + at);
        float su = __ldcg(partial + at + off2);
        for (int k = 1; k < splits; ++k) {
          sg += __ldcg(partial + (size_t)k * S::BP * n2 + at);
          su += __ldcg(partial + (size_t)k * S::BP * n2 + at + off2);
        }
        acc[nt][i] = sg;
        acc[nt][2 + i] = su;
      }
    if (tid == 0) counters[c] = 0;  // ready for the next launch on the stream
  }

  if constexpr (!GATED) {
    // mid = bf16(act(up)) for lanes gl and gl + 64 at down's fragment
    // positions (within a block, position 8h + 2p + i holds lane
    // p*32 + 2h + i); each 64-lane half summed as stored, over g, then the
    // warps in order; the block's sum is the first half's plus the second's
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int l = gl + h * MCOLS - lane0;
      __nv_bfloat16* mp = mid + lane0 + 8 * ((l & 31) >> 1) + 2 * (l >> 5) + (l & 1);
      float rs[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float a = mlp_act<ACT>(acc[nt][2 * h + i]);
          const __nv_bfloat16 v = __float2bfloat16(FLOOR ? rounded(a) : a);
          mp[(size_t)(nt * 8 + 2 * t + i) * half] = v;
          rs[nt][i] = __bfloat162float(v);
        }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) rs[nt][i] += __shfl_xor_sync(0xffffffffu, rs[nt][i], o);
          if (g == 0) red[h][warp][nt * 8 + 2 * t + i] = rs[nt][i];
        }
    }
    __syncthreads();
    if (tid < S::BP) {
      float s0 = red[0][0][tid], s1 = red[1][0][tid];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) {
        s0 += red[0][w][tid];
        s1 += red[1][w][tid];
      }
      msums[(size_t)(2 * c) * S::BP + tid] = s0;
      msums[(size_t)(2 * c + 1) * S::BP + tid] = s1;
      msums[(size_t)(2 * gridDim.x + c) * S::BP + tid] = s0 + s1;
    }
    return;
  }

  // mid = bf16(act(gate) * up) at down's fragment position of lane gl
  // (within a block, position 8h + 2p + i holds lane p*32 + 2h + i)
  const int l = gl & (MBS - 1);
  __nv_bfloat16* mp = mid + (gl - l) + 8 * ((l & 31) >> 1) + 2 * (l >> 5) + (l & 1);
  float rs[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float a = mlp_act<ACT>(acc[nt][i]) * acc[nt][2 + i];
      const __nv_bfloat16 v = __float2bfloat16(FLOOR ? rounded(a) : a);
      mp[(size_t)(nt * 8 + 2 * t + i) * half] = v;
      rs[nt][i] = __bfloat162float(v);
    }
  // per row, the sum of the CTA's 64 lanes as stored: over g, then the warps in order
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) rs[nt][i] += __shfl_xor_sync(0xffffffffu, rs[nt][i], o);
      if (g == 0) red[0][warp][nt * 8 + 2 * t + i] = rs[nt][i];
    }
  __syncthreads();
  if (tid < S::BP) {
    float s = red[0][0][tid];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) s += red[0][w][tid];
    msums[(size_t)c * S::BP + tid] = s;
  }

  // the second CTA of down block c / 2 to finish adds the block's two halves
  __threadfence();  // mid and this CTA's half sums are visible before they are counted
  __syncthreads();
  const int bc = gridDim.x + (c >> 1);
  if (tid == 0) last = atomicAdd(&counters[bc], 1) == 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (tid < S::BP)
    msums[(size_t)bc * S::BP + tid] = __ldcg(msums + (size_t)(c & ~1) * S::BP + tid) +
                                      __ldcg(msums + (size_t)(c | 1) * S::BP + tid);
  if (tid == 0) counters[bc] = 0;
}

template <int NT, int ACT, bool GATED, bool FLOOR>
int launch_gateup(const void* xg, const void* sums, const void* packed, const void* alpha,
                  const void* mu, void* partial, void* mid, void* msums, void* counters, int Kg,
                  int half, int splits, int bpc, cudaStream_t s) {
  const cudaError_t e =
      cudaFuncSetAttribute(mlp_gateup_kernel<NT, ACT, GATED, FLOOR>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, Stage<NT>::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(GATED ? half / MCOLS : half / MBS, splits);
  mlp_gateup_kernel<NT, ACT, GATED, FLOOR><<<grid, THREADS, Stage<NT>::SMEM, s>>>(
      static_cast<const __nv_bfloat16*>(xg), static_cast<const float*>(sums),
      static_cast<const int8_t*>(packed), static_cast<const __nv_bfloat16*>(alpha),
      static_cast<const __nv_bfloat16*>(mu), static_cast<float*>(partial),
      static_cast<__nv_bfloat16*>(mid), static_cast<float*>(msums), static_cast<int*>(counters),
      Kg, half, bpc);
  return (int)cudaGetLastError();
}

template <int NT, bool GATED, bool FLOOR>
int launch_gateup_act(int act, const void* xg, const void* sums, const void* packed,
                      const void* alpha, const void* mu, void* partial, void* mid, void* msums,
                      void* counters, int Kg, int half, int splits, int bpc, cudaStream_t s) {
#define PT2_MLP_TC_ACT(A_)                                                                      \
  if (act == A_)                                                                                  \
    return launch_gateup<NT, A_, GATED, FLOOR>(xg, sums, packed, alpha, mu, partial, mid, msums, \
                                               counters, Kg, half, splits, bpc, s);
  PT2_MLP_TC_ACT(0)
  PT2_MLP_TC_ACT(1)
  PT2_MLP_TC_ACT(2)
#undef PT2_MLP_TC_ACT
  return (int)cudaErrorInvalidValue;
}

// The blocks per slice for `splits` slices of nb blocks, or 0 where that
// leaves a slice empty (or splits is outside 1 .. nb).
int slice_blocks(int nb, int splits) {
  if (splits < 1 || splits > nb) return 0;
  const int bpc = (nb + splits - 1) / splits;
  return (splits - 1) * bpc < nb ? bpc : 0;
}

// The three launches of the C entries (arguments as they state).
template <bool GATED, bool FLOOR = false>
int run(const void* x, const void* perm, const void* gu_packed, const void* gu_alpha,
        const void* gu_mu, const void* dn_packed, const void* dn_alpha, const void* dn_mu,
        void* xg, void* sums, void* gu_partial, void* mid, void* mid_sums, void* dn_partial,
        void* out, void* counters, int B, int m, int Kg, int half, int n, int gu_splits,
        int dn_splits, int act, int device, void* stream) {
  const int Bp = rows_pad(B);
  int rc = check_gather(x, perm, xg, sums, B, Bp, m, Kg, MBS);
  if (rc != 0) return rc;
  if (half < MBS || half % MBS != 0 || n < BN || n % BN != 0 || act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  const int gu_bpc = slice_blocks(Kg / MBS, gu_splits);
  const int dn_bpc = slice_blocks(half / MBS, dn_splits);
  if (gu_bpc == 0 || dn_bpc == 0) return (int)cudaErrorInvalidValue;
  const void* aligned[] = {gu_packed, gu_alpha, gu_mu, dn_packed, dn_alpha, dn_mu,
                           mid,       mid_sums, out,
                           gu_splits > 1 ? gu_partial : out, dn_splits > 1 ? dn_partial : out};
  uintptr_t any = 0;
  for (const void* p : aligned) {
    if (p == nullptr) return (int)cudaErrorInvalidValue;
    any |= reinterpret_cast<uintptr_t>(p);
  }
  if (counters == nullptr) return (int)cudaErrorInvalidValue;
  if (any % 16 != 0 || reinterpret_cast<uintptr_t>(counters) % 4 != 0)
    return (int)cudaErrorMisalignedAddress;
  rc = set_device(device);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  rc = launch_gather(x, perm, xg, sums, B, Bp, m, Kg, MBS, FLOOR ? 1 : 0, s);
  if (rc != 0) return rc;
  float* ms = static_cast<float*>(mid_sums);
  const float* block_sums = ms + (size_t)(half / MCOLS) * Bp;
#define PT2_MLP_TC_ROWS(NT_)                                                                   \
  rc = launch_gateup_act<NT_, GATED, FLOOR>(act, xg, sums, gu_packed, gu_alpha, gu_mu,           \
                                            gu_partial, mid, ms, counters, Kg, half, gu_splits,  \
                                            gu_bpc, s);                                          \
  if (rc != 0) return rc;                                                                       \
  return launch_product<NT_, FLOOR>(mid, block_sums, dn_packed, dn_alpha, dn_mu, dn_partial,    \
                                    out, counters, B, half, n, MBS, dn_splits, dn_bpc, s);
  if (Bp == 16) {
    PT2_MLP_TC_ROWS(2)
  }
  if (Bp == 32) {
    PT2_MLP_TC_ROWS(4)
  }
  PT2_MLP_TC_ROWS(8)
#undef PT2_MLP_TC_ROWS
}

}  // namespace

// C entry points bound with ctypes (pt2tpu_torch/ops/kernels/ternary.py).
//
// x (B, m) bf16, 9 <= B <= 64, in feature order; perm (Kg,) int32 the visit
// lane -> feature map with pad lanes >= m (the identity arange(Kg) for the
// layout without a gather, m <= Kg); gateup (Kg / 4, 2 * half) int8 codes
// with (Kg / 128, 2 * half) bf16 alpha and mu, gate lanes [0, half) then up
// lanes; down (>= half / 4, n) int8 codes with (>= half / 128, n) bf16 alpha
// and mu, of which the first half / 128 blocks are read. Scratch, Bp = 16,
// 32 or 64 (B rounded up to a multiple of 16, then to a power of two):
// xg (Bp, Kg) bf16, sums (Kg / 128, Bp) f32, gu_partial (gu_splits, Bp,
// 2 * half) f32 (not read with one slice), mid (Bp, half) bf16, mid_sums
// (half / 64 + half / 128, Bp) f32, dn_partial (dn_splits, B, n) f32 (not
// read with one slice); out (B, n) f32; counters half / 64 + half / 128 and
// n / 128 int32 (the larger), all 0 (each launch leaves them 0; launches
// that share them must not run concurrently). half and n multiples of 128;
// act 0 silu, 1 gelu (tanh form), 2 relu. perm 16-byte aligned, every
// other operand and scratch 16-byte aligned but x (2-byte) and counters
// (4-byte). Three launches on the stream (gather, gate/up, down); returns
// the first launch's CUDA error, 0 meaning all three launched.
extern "C" int pt2_ternary_mlp_tc(const void* x, const void* perm, const void* gu_packed,
                                  const void* gu_alpha, const void* gu_mu, const void* dn_packed,
                                  const void* dn_alpha, const void* dn_mu, void* xg, void* sums,
                                  void* gu_partial, void* mid, void* mid_sums, void* dn_partial,
                                  void* out, void* counters, int B, int m, int Kg, int half,
                                  int n, int gu_splits, int dn_splits, int act, int device,
                                  void* stream) {
  return run<true>(x, perm, gu_packed, gu_alpha, gu_mu, dn_packed, dn_alpha, dn_mu, xg, sums,
                   gu_partial, mid, mid_sums, dn_partial, out, counters, B, m, Kg, half, n,
                   gu_splits, dn_splits, act, device, stream);
}

// The ungated MLP: as pt2_ternary_mlp_tc with gateup the up projection
// alone, (Kg / 4, half) int8 codes with (Kg / 128, half) bf16 alpha and mu
// (half >= I: pad columns carry zero scales), gu_partial (gu_splits, Bp,
// half) f32, and mid = bf16(act(up)); mid_sums and counters sized as there.
extern "C" int pt2_ternary_mlp_tc_ungated(const void* x, const void* perm, const void* gu_packed,
                                          const void* gu_alpha, const void* gu_mu,
                                          const void* dn_packed, const void* dn_alpha,
                                          const void* dn_mu, void* xg, void* sums,
                                          void* gu_partial, void* mid, void* mid_sums,
                                          void* dn_partial, void* out, void* counters, int B,
                                          int m, int Kg, int half, int n, int gu_splits,
                                          int dn_splits, int act, int device, void* stream) {
  return run<false>(x, perm, gu_packed, gu_alpha, gu_mu, dn_packed, dn_alpha, dn_mu, xg, sums,
                    gu_partial, mid, mid_sums, dn_partial, out, counters, B, m, Kg, half, n,
                    gu_splits, dn_splits, act, device, stream);
}

// The floor probe's MLP (impl="floor8"): as pt2_ternary_mlp_tc and
// pt2_ternary_mlp_tc_ungated, with x and mid rounded and clipped to +-127
// and every plane's code the raw signed byte of its packed row (the header).
extern "C" int pt2_ternary_mlp_tc_floor(const void* x, const void* perm, const void* gu_packed,
                                        const void* gu_alpha, const void* gu_mu,
                                        const void* dn_packed, const void* dn_alpha,
                                        const void* dn_mu, void* xg, void* sums,
                                        void* gu_partial, void* mid, void* mid_sums,
                                        void* dn_partial, void* out, void* counters, int B, int m,
                                        int Kg, int half, int n, int gu_splits, int dn_splits,
                                        int act, int device, void* stream) {
  return run<true, true>(x, perm, gu_packed, gu_alpha, gu_mu, dn_packed, dn_alpha, dn_mu, xg,
                         sums, gu_partial, mid, mid_sums, dn_partial, out, counters, B, m, Kg,
                         half, n, gu_splits, dn_splits, act, device, stream);
}

extern "C" int pt2_ternary_mlp_tc_floor_ungated(const void* x, const void* perm,
                                                const void* gu_packed, const void* gu_alpha,
                                                const void* gu_mu, const void* dn_packed,
                                                const void* dn_alpha, const void* dn_mu, void* xg,
                                                void* sums, void* gu_partial, void* mid,
                                                void* mid_sums, void* dn_partial, void* out,
                                                void* counters, int B, int m, int Kg, int half,
                                                int n, int gu_splits, int dn_splits, int act,
                                                int device, void* stream) {
  return run<false, true>(x, perm, gu_packed, gu_alpha, gu_mu, dn_packed, dn_alpha, dn_mu, xg,
                          sums, gu_partial, mid, mid_sums, dn_partial, out, counters, B, m, Kg,
                          half, n, gu_splits, dn_splits, act, device, stream);
}
