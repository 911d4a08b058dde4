// Shared forward-attention engine for the three attention kernels
// (flash_attention.cu, sam_window_attention.cu, sam_flash_attention.cu).
//
// One block of 256 threads computes a 64-row query tile against all the key
// tiles it needs, 64 keys at a time, with an fp32 online softmax. The three
// kernels differ only in a "problem" object that says where q, k and v live,
// how q is scaled and rounded, what bias and mask a logit gets, whether the
// probabilities are rounded before the value product, and where the output
// goes. The logits tile never leaves the block.
//
// Arithmetic: inputs are converted to fp32 (exact for bf16), every product
// and sum runs on the CUDA cores in fp32. This is the simple first version:
// it is bound by shared-memory traffic and fp32 FMA rate, not by the tensor
// cores (see the note in ops/flash_attention.py and PERF.md).
//
// Thread layout: thread t owns query rows 4*(t/16) .. +3 of the tile and
// key columns (t%16) + 16*j (j < 4) of each key tile; for the output it owns
// the same 4 rows and head-dim columns (t%16) + 16*jj (jj < NJ), NJ = ceil(D/16).
// A row's 16 owners are one half-warp, so row max / row sum are 4 shuffles.
//
// The end of the file holds what the quantized kernels (K4-K7) share: the
// packed-int4 nibbles, the MLP activation and the in-order sum of tiles.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace wgt {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int KS = BK + 1;      // padded row stride of K^T and P in shared memory
constexpr int NTHREADS = 256;
constexpr float NEG_BIG = -1e30f;   // the JAX kernels' finite "masked" logit

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as JAX's astype
}

// x rounded to T and back (identity for float).
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Shared memory: Q^T [DP][BQ], K^T / P [max(DP,BQ)][KS] (P reuses the K^T
// region once the logits are computed), V [BK][DP].
template <int NJ>
constexpr size_t smem_bytes() {
  constexpr int DP = 16 * NJ;
  constexpr int KP = DP > BQ ? DP : BQ;
  return sizeof(float) * (size_t(DP) * BQ + size_t(KP) * KS + size_t(BK) * DP);
}

// Problem interface (all device methods):
//   int D, nq, nk, nkt, q0;      head dim, rows in this tile, keys, key tiles
//                                 to visit, absolute index of the tile's row 0
//   float q(int r, int d)        scaled query, tile row r < nq
//   float k(int key, int d), v(int key, int d)
//   float logit(float s, int row, int key)   bias / mask, row and key absolute
//   float p_round(float p)       rounding of p before the value product
//   void out(int r, int d, float x), lse(int r, float x)
template <int NJ, class Prob>
__device__ __forceinline__ void attention_tile(const Prob& pr, float* smem) {
  constexpr int DP = 16 * NJ;
  float* QsT = smem;
  float* KsT = QsT + DP * BQ;
  float* Ps = KsT;
  float* Vs = KsT + (DP > BQ ? DP : BQ) * KS;

  const int tid = threadIdx.x;
  const int tr = tid >> 4;
  const int tc = tid & 15;
  const int D = pr.D;

  for (int i = tid; i < BQ * D; i += NTHREADS) {
    const int r = i / D, d = i - r * D;
    QsT[d * BQ + r] = r < pr.nq ? pr.q(r, d) : 0.f;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_BIG;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
  }

  for (int kt = 0; kt < pr.nkt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the previous tile's P and V are no longer read
    for (int i = tid; i < BK * D; i += NTHREADS) {
      const int c = i / D, d = i - c * D, key = k0 + c;
      const bool ok = key < pr.nk;
      KsT[d * KS + c] = ok ? pr.k(key, d) : 0.f;
      Vs[c * DP + d] = ok ? pr.v(key, d) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&QsT[d * BQ + 4 * tr]);
      const float* kr = &KsT[d * KS + tc];
      const float b[4] = {kr[0], kr[16], kr[32], kr[48]};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[0][j] = fmaf(a.x, b[j], s[0][j]);
        s[1][j] = fmaf(a.y, b[j], s[1][j]);
        s[2][j] = fmaf(a.z, b[j], s[2][j]);
        s[3][j] = fmaf(a.w, b[j], s[3][j]);
      }
    }
    __syncthreads();   // K^T is dead: its region now takes P

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = pr.q0 + 4 * tr + i;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tc + 16 * j;
        // keys past the end take no part at all (p = 0); masked keys get the
        // finite NEG_BIG exactly as the JAX kernels do
        s[i][j] = key < pr.nk ? pr.logit(s[i][j], row, key) : -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mn);
        rs += p;
        Ps[(4 * tr + i) * KS + tc + 16 * j] = pr.p_round(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = mn;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();

    const int kmax = min(BK, pr.nk - k0);
    for (int c = 0; c < kmax; ++c) {
      const float p0 = Ps[(4 * tr + 0) * KS + c];
      const float p1 = Ps[(4 * tr + 1) * KS + c];
      const float p2 = Ps[(4 * tr + 2) * KS + c];
      const float p3 = Ps[(4 * tr + 3) * KS + c];
      const float* vr = &Vs[c * DP + tc];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float vv = vr[16 * jj];
        acc[0][jj] = fmaf(p0, vv, acc[0][jj]);
        acc[1][jj] = fmaf(p1, vv, acc[1][jj]);
        acc[2][jj] = fmaf(p2, vv, acc[2][jj]);
        acc[3][jj] = fmaf(p3, vv, acc[3][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * tr + i;
    if (r >= pr.nq) continue;
    const float lm = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int d = tc + 16 * jj;
      if (d < D) pr.out(r, d, acc[i][jj] / lm);
    }
    if (tc == 0) pr.lse(r, m[i] + logf(lm));
  }
}

template <class Prob, int NJ>
__global__ void __launch_bounds__(NTHREADS) attention_kernel(typename Prob::Args a) {
  extern __shared__ __align__(16) float smem[];
  const Prob pr(a, blockIdx.x, blockIdx.y);
  attention_tile<NJ>(pr, smem);
}

template <class Prob, int NJ>
cudaError_t launch_nj(const typename Prob::Args& a, dim3 grid, cudaStream_t st) {
  const size_t smem = smem_bytes<NJ>();
  cudaError_t e = cudaFuncSetAttribute(attention_kernel<Prob, NJ>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(smem));
  if (e != cudaSuccess) return e;
  attention_kernel<Prob, NJ><<<grid, NTHREADS, smem, st>>>(a);
  return cudaGetLastError();
}

// Instantiates the engine for head dims up to 128 (NJ = ceil(D/16) <= 8).
template <class Prob>
cudaError_t launch(const typename Prob::Args& a, int D, dim3 grid, cudaStream_t st) {
  switch ((D + 15) / 16) {
    case 1: return launch_nj<Prob, 1>(a, grid, st);
    case 2: return launch_nj<Prob, 2>(a, grid, st);
    case 3: return launch_nj<Prob, 3>(a, grid, st);
    case 4: return launch_nj<Prob, 4>(a, grid, st);
    case 5: return launch_nj<Prob, 5>(a, grid, st);
    case 6: return launch_nj<Prob, 6>(a, grid, st);
    case 7: return launch_nj<Prob, 7>(a, grid, st);
    case 8: return launch_nj<Prob, 8>(a, grid, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// shared by the quantized kernels
// ---------------------------------------------------------------------------

// Packed int4 byte b: the low nibble sign-extended, the high one by an
// arithmetic shift.
__device__ __forceinline__ int lo4(int b) { return int(unsigned(b) << 28) >> 28; }
__device__ __forceinline__ int hi4(int b) { return b >> 4; }

// silu(g), or exact (erf) gelu(g).
__device__ __forceinline__ float act_fn(float g, int gelu) {
  return gelu ? 0.5f * g * (1.f + erff(g * 0.70710678118654752f)) : g / (1.f + expf(-g));
}

// out[i] = the sum of scratch[t, i] over t < n_tiles, in tile order.
template <typename T>
__global__ void sum_tiles(const float* __restrict__ scratch, T* __restrict__ out, int n_tiles,
                          int MH) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MH) return;
  float y = scratch[i];
  for (int t = 1; t < n_tiles; ++t) y += scratch[size_t(t) * MH + i];
  out[i] = from_f<T>(y);
}

}  // namespace wgt
