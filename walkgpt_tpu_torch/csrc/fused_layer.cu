// K12: the fused decode-layer tail, one cooperative launch per layer:
// attention over the quantized flat cache, the W8A8 o-projection, the
// residual, RMSNorm and the int4 MLP. Replaces
// walkgpt_tpu/ops/fused_layer.py:fused_layer_tail (_kernel), the greedy
// decode step's layer tail of the int4x format (MHA, n_kv * D == hidden).
// The TPU kernel runs a sequential phased grid (attention per (row, length
// block), then o-proj column tiles, then MLP intermediate tiles accumulating
// into a resident output). On the card these phases depend on each other
// across the whole grid (the o-proj needs every head of a row, the norm the
// whole x2 row), so the kernel is one cooperative launch whose blocks share
// the work of each phase and meet at a grid barrier between phases:
//   1. attention per (row, kv head): the walk of decode_walk.cuh (K4's
//      engine) on the pre-quantized query of banded_q8, PV8 off; the rows
//      out / max(bf16(l), 1e-30) are kept in fp32 (unlike K4, no cast to
//      the query's type) in the scratch attf [B, hd];
//   2. o-proj column tiles: each block recomputes its rows' absmax from
//      attf, sr = max(absmax, 1e-8) * (1/127) and the codes clip(rint(a /
//      sr), -127, 127) with a true division (not nn.linear's quantizer),
//      then the exact int32 product with o, part = (float(acc) * sr) * os,
//      x2 = bf16(float(x) + part), bf16 even for an fp32 x, into x2 [B, hd];
//   3. MLP intermediate tiles: each block recomputes its rows' RMS from x2,
//      hn = bf16((x2 * (1 / sqrt(mean(x2^2) + eps))) * pn) with IEEE sqrt
//      and division (not rsqrtf), then K6's tile code (mlp4_tile.cuh) writes
//      each tile's scaled down partial to parts [n_tiles, B, hd];
//   4. y = x2 + parts[0] + parts[1] + ... in tile order (the TPU grid's
//      accumulation order), fp32 out [B, hd].
// Length blocks at or past nvb = ceil(valid_len / bl) are skipped.
// FMA contraction: where the TPU kernel rounds between a product and a sum
// (the o-proj epilogue and residual, the norm), the code uses __fmul_rn /
// __fadd_rn / __fdiv_rn / __fsqrt_rn, which are never contracted; the walk
// and the MLP tile are K4's and K6's code as they stand.
// Bound: bytes. 7B, 2 rows, 480 of 512 slots valid: o 16.8 MB, the packed
// gate/up/down 67.6 MB, the K/V int4 rows and scales below valid_len 3.9 MB:
// about 88 MB, 26 us at 3.35 TB/s. The design reads each weight once per
// launch; the phases' scratches are small and stay in L2.
// Grid: as many blocks as can be co-resident (occupancy x SMs), at most
// the largest phase's work count; each phase is grid-strided.
#include <cooperative_groups.h>

#include <algorithm>

#include "decode_walk.cuh"
#include "mlp4_tile.cuh"

namespace {

using namespace wgt;
namespace cg = cooperative_groups;

constexpr int NT = DW_NT;              // threads per block (= MLP4_NT)
constexpr int MB = MLP4_MB;            // rows per pass of phases 2 and 3
constexpr int OT = 32;                 // o-proj output columns per tile, 4 per thread
constexpr int ORG = NT / (OT / 4);     // thread groups splitting the o-proj's rows
static_assert(NT == MLP4_NT, "the MLP tile and the walk take the same block");

struct TailArgs {
  DecodeArgs att;                      // phase 1 (q8, qsc, cache, mask; out = attf)
  const void* x;                       // [B, hd] in T: the layer's input
  const int8_t* ow;                    // [hd, hd] o-proj codes
  const float* os;                     // [hd] o-proj scales
  const void* pn;                      // [hd] post-norm scale in P
  const int8_t *gp, *up, *dp;          // packed MLP weights (up null: gelu MLP)
  const float *gs, *us, *ds;
  float* attf;                         // scratch [B, hd]
  float* x2;                           // scratch [B, hd], bf16-rounded values
  float* parts;                        // scratch [I / TI, B, hd]
  float* y;                            // out [B, hd]
  int B, hd, I, TI, gelu;
  float eps;
};

// tree reductions over the block (tmp: NT floats of shared memory)
__device__ float block_max(float v, float* tmp) {
  tmp[threadIdx.x] = v;
  __syncthreads();
  for (int w = NT / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) tmp[threadIdx.x] = fmaxf(tmp[threadIdx.x], tmp[threadIdx.x + w]);
    __syncthreads();
  }
  const float r = tmp[0];
  __syncthreads();
  return r;
}

__device__ float block_sum(float v, float* tmp) {
  tmp[threadIdx.x] = v;
  __syncthreads();
  for (int w = NT / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) tmp[threadIdx.x] = __fadd_rn(tmp[threadIdx.x], tmp[threadIdx.x + w]);
    __syncthreads();
  }
  const float r = tmp[0];
  __syncthreads();
  return r;
}

// shared memory of phase 2 in floats: codes [MB][hd] bytes (rounded up),
// sums [ORG][MB][OT] ints, sr [MB], tmp [NT]
size_t oproj_floats(int hd) {
  return (size_t(MB) * hd + 15) / 16 * 4 + size_t(ORG) * MB * OT + MB + NT;
}

// phase 3: hn [MB][hd], tmp [NT], the tile's work
size_t mlp_floats(int hd, int TI) { return size_t(MB) * hd + NT + mlp4_work_floats(TI); }

template <typename T>
__device__ void oproj_phase(const TailArgs& a, float* smem) {
  const int hd = a.hd, n_ot = (hd + OT - 1) / OT;
  if (int(blockIdx.x) >= n_ot) return;
  int8_t* codes = reinterpret_cast<int8_t*>(smem);
  int* sums = reinterpret_cast<int*>(smem + (size_t(MB) * hd + 15) / 16 * 4);
  float* sr_s = reinterpret_cast<float*>(sums + ORG * MB * OT);
  float* tmp = sr_s + MB;
  const T* x = static_cast<const T*>(a.x);
  const int cgi = threadIdx.x % (OT / 4), rg = threadIdx.x / (OT / 4);
  for (int m0 = 0; m0 < a.B; m0 += MB) {
    const int mb = min(MB, a.B - m0);
    for (int m = 0; m < mb; ++m) {
      const float* row = a.attf + size_t(m0 + m) * hd;
      float mx = 0.f;
      for (int i = threadIdx.x; i < hd; i += NT) mx = fmaxf(mx, fabsf(row[i]));
      const float sr = __fmul_rn(fmaxf(block_max(mx, tmp), 1e-8f), 1.0f / 127.0f);
      for (int i = threadIdx.x; i < hd; i += NT)
        codes[m * hd + i] = int8_t(fminf(fmaxf(rintf(__fdiv_rn(row[i], sr)), -127.f), 127.f));
      if (threadIdx.x == 0) sr_s[m] = sr;
    }
    __syncthreads();
    for (int ot = blockIdx.x; ot < n_ot; ot += gridDim.x) {
      const int col = ot * OT + cgi * 4;
      int acc[MB][4];
#pragma unroll
      for (int m = 0; m < MB; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[m][c] = 0;
      if (col < hd) {
        for (int r = rg; r < hd; r += ORG) {
          const char4 w = *reinterpret_cast<const char4*>(a.ow + size_t(r) * hd + col);
          const int b[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int m = 0; m < MB; ++m) {
            if (m < mb) {
              const int q = codes[m * hd + r];
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[m][c] += q * b[c];
            }
          }
        }
      }
#pragma unroll
      for (int m = 0; m < MB; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c) sums[(rg * MB + m) * OT + cgi * 4 + c] = acc[m][c];
      __syncthreads();
      for (int i = threadIdx.x; i < mb * OT; i += NT) {
        const int m = i / OT, c = i - m * OT, n = ot * OT + c;
        if (n >= hd) continue;
        int s = 0;
        for (int q = 0; q < ORG; ++q) s += sums[(q * MB + m) * OT + c];
        const float part = __fmul_rn(__fmul_rn(float(s), sr_s[m]), a.os[n]);
        const size_t at = size_t(m0 + m) * hd + n;
        a.x2[at] = round_to<__nv_bfloat16>(__fadd_rn(to_f(x[at]), part));
      }
      __syncthreads();
    }
  }
}

template <typename P>
__device__ void mlp_phase(const TailArgs& a, float* smem) {
  const int hd = a.hd, n_tiles = a.I / a.TI;
  if (int(blockIdx.x) >= n_tiles) return;
  float* hn = smem;                     // [MB][hd]
  float* tmp = hn + MB * hd;            // [NT]
  float* work = tmp + NT;
  const P* pn = static_cast<const P*>(a.pn);
  for (int m0 = 0; m0 < a.B; m0 += MB) {
    const int mb = min(MB, a.B - m0);
    for (int m = 0; m < mb; ++m) {
      const float* row = a.x2 + size_t(m0 + m) * hd;
      float ss = 0.f;
      for (int i = threadIdx.x; i < hd; i += NT) ss = __fadd_rn(ss, __fmul_rn(row[i], row[i]));
      const float var = __fdiv_rn(block_sum(ss, tmp), float(hd));
      const float r = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, a.eps)));
      for (int i = threadIdx.x; i < hd; i += NT)
        hn[m * hd + i] = round_to<__nv_bfloat16>(__fmul_rn(__fmul_rn(row[i], r), to_f(pn[i])));
    }
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x)
      mlp4_tile(hn, mb, m0, t, a.gp, a.gs, a.up, a.us, a.dp, a.ds, a.parts, a.B, hd, a.I, a.TI,
                a.gelu, work);
    __syncthreads();                    // hn is rewritten for the next rows
  }
}

template <typename T, typename P>
__global__ void __launch_bounds__(NT) fused_tail(TailArgs a) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int items = a.B * a.att.n_kv;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int b = it / a.att.n_kv;
    walk_block<float, int8_t, Q_INT8, false>(a.att, b, it - b * a.att.n_kv, 0, smem);
  }
  grid.sync();
  oproj_phase<T>(a, smem);
  grid.sync();
  mlp_phase<P>(a, smem);
  grid.sync();
  const int n_tiles = a.I / a.TI, bh = a.B * a.hd;
  for (int i = blockIdx.x * NT + threadIdx.x; i < bh; i += gridDim.x * NT) {
    float y = a.x2[i];
    for (int t = 0; t < n_tiles; ++t) y = __fadd_rn(y, a.parts[size_t(t) * bh + i]);
    a.y[i] = y;
  }
}

template <typename T, typename P>
int launch_tail(TailArgs a, cudaStream_t st) {
  const size_t floats = std::max(std::max(oproj_floats(a.hd), mlp_floats(a.hd, a.TI)),
                                 decode_smem(1, a.att.D, a.att.bl, sizeof(int8_t)) / 4 + 1);
  const size_t smem = floats * sizeof(float);
  if (smem > DW_SMEM_MAX) return int(cudaErrorInvalidValue);
  auto kernel = fused_tail<T, P>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return int(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return int(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return int(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, smem);
  if (err != cudaSuccess) return int(err);
  if (per_sm < 1) return int(cudaErrorInvalidConfiguration);
  const int work = std::max(std::max(a.B * a.att.n_kv, (a.hd + OT - 1) / OT),
                            std::max(a.I / a.TI, 1));
  const int blocks = std::min(per_sm * sms, work);
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(blocks), dim3(NT), args,
                                    smem, st);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

}  // namespace

// One layer's tail. q8: [B, hd] int8 and qs: [B, H] fp32 (banded_q8 of q,
// head h at [b, h]); k, v: the layer's [B, L, width] int8 cache; ks, vs:
// [B, H, L] bf16; mask: [B, L] bytes; x: [B, hd] in x_dtype; ow: [hd, hd]
// int8; os: [hd] fp32; pn: [hd] in pn_dtype; gp, up: [hd/2, I] int8 (up,
// us null for the gelu MLP); gs, us: [I] fp32; dp: [I/2, hd] int8; ds:
// [hd] fp32; scratches attf, x2: [B, hd] fp32, parts: [I/TI, B, hd] fp32;
// y: [B, hd] fp32. dtypes: 0 = float32, 1 = bfloat16. Returns the launch's
// CUDA error.
extern "C" int wg_fused_layer_tail(const void* q8, const void* qs, const void* k, const void* ks,
                                   const void* v, const void* vs, const void* mask,
                                   const void* x, const void* ow, const void* os, const void* pn,
                                   const void* gp, const void* gs, const void* up,
                                   const void* us, const void* dp, const void* ds, void* attf,
                                   void* x2, void* parts, void* y, int B, int n_kv, int D, int L,
                                   int bl, int nvb, int pack4, int I, int TI, int gelu,
                                   float scale, float eps, int x_dtype, int pn_dtype,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int hd = n_kv * D;
  if (B <= 0 || n_kv <= 0 || D <= 0 || bl <= 0 || L % bl || nvb < 0 || nvb * bl > L
      || hd % 4 || TI < 4 || TI % 4 || TI > 4 * NT || NT % (TI / 4) || I % TI)
    return int(cudaErrorInvalidValue);
  TailArgs a{};
  a.att.q8 = static_cast<const int8_t*>(q8);
  a.att.qsc = static_cast<const float*>(qs);
  a.att.k = k;
  a.att.v = v;
  a.att.ks = static_cast<const __nv_bfloat16*>(ks);
  a.att.vs = static_cast<const __nv_bfloat16*>(vs);
  a.att.mask = static_cast<const uint8_t*>(mask);
  a.att.out = attf;
  a.att.H = n_kv;
  a.att.n_kv = n_kv;
  a.att.D = D;
  a.att.L = L;
  a.att.bl = bl;
  a.att.nvb = nvb;
  a.att.Tc = 1;
  a.att.pack4 = pack4;
  a.att.qg = 1;
  a.att.scale = scale;
  a.x = x;
  a.ow = static_cast<const int8_t*>(ow);
  a.os = static_cast<const float*>(os);
  a.pn = pn;
  a.gp = static_cast<const int8_t*>(gp);
  a.up = static_cast<const int8_t*>(up);
  a.dp = static_cast<const int8_t*>(dp);
  a.gs = static_cast<const float*>(gs);
  a.us = static_cast<const float*>(us);
  a.ds = static_cast<const float*>(ds);
  a.attf = static_cast<float*>(attf);
  a.x2 = static_cast<float*>(x2);
  a.parts = static_cast<float*>(parts);
  a.y = static_cast<float*>(y);
  a.B = B;
  a.hd = hd;
  a.I = I;
  a.TI = TI;
  a.gelu = gelu;
  a.eps = eps;
  if (x_dtype == 0 && pn_dtype == 0) return launch_tail<float, float>(a, st);
  if (x_dtype == 0 && pn_dtype == 1) return launch_tail<float, __nv_bfloat16>(a, st);
  if (x_dtype == 1 && pn_dtype == 0) return launch_tail<__nv_bfloat16, float>(a, st);
  if (x_dtype == 1 && pn_dtype == 1) return launch_tail<__nv_bfloat16, __nv_bfloat16>(a, st);
  return int(cudaErrorInvalidValue);
}
