// Shared backward-attention engine for the three attention backward kernels
// (flash_attention_bwd.cu, sam_window_attention_bwd.cu,
// sam_flash_attention_bwd.cu), the Hopper counterpart of the two-kernel
// Pallas backwards of walkgpt_tpu/ops/flash_attention.py.
//
// The TPU kernels keep a whole key/value sequence (and, for the window
// kernel, a whole [196, 196] fp32 dlogits tile) in VMEM. An H100 block has
// at most 227 KB of shared memory, so here every pass streams 64-row tiles
// and recomputes the probabilities from the forward's saved logsumexp:
//
//   dq pass   one block per (64-query tile, batch*head): for each key tile
//             s = q.k (+ bias), p = exp(s - lse), dp = g.v,
//             ds = p * (dp - delta), dq += ds.k; with a rel-pos bias also
//             drel_h[q, r] += sum of ds over the tile's keys in grid row r
//             and drel_w[q, c] likewise over grid column c.
//   dk/dv     one block per (64-key tile, batch*head): for each query tile
//   pass      the same s, p, dp, ds, then dv += p^T.g and dk += ds^T.q.
//
// Each output element is summed by exactly one thread in tile order: no
// atomics, so the result is the same on every run. The logits are formed
// with the forward engine's fma order over the head dim, so p matches the
// saved lse bit for bit. All products run in fp32 on the CUDA cores (the
// simple first version: bound by shared-memory traffic and the fp32 FMA
// rate, far from the bf16 tensor-core bound).
//
// Thread layout (256 threads): thread t owns rows 4*(t/16) .. +3 of the
// block's own tile and columns (t%16) + 16*j (j < 4) of the streamed tile;
// for the accumulators, the same 4 rows and head-dim columns (t%16) + 16*jj.
//
// Problem interface (device methods; rows and keys absolute):
//   int N, NK, D;                  query rows, keys, head dim
//   float scale;                   applied to dq and dk at the end
//   float qs(row, d)               the query as the logits see it (scaled,
//                                  and rounded where the forward rounds)
//   float qr(row, d)               the fp32 query that dk is summed over
//   float k(key, d), v(key, d), g(row, d), lse(row), delta(row)
//   float logit(s, row, key)       s plus the bias
//   bool valid(row, key)           false: p is exactly 0 (masked)
//   int dq_key_tiles(q0)           key tiles a query tile visits
//   int dkv_first_qtile(k0)        first query tile a key tile visits
//   void dq(row, d, x), dk(key, d, x), dv(key, d, x)
//   static constexpr bool REL;     with REL: int gh, gw, and
//   void drh(row, r, x), drw(row, c, x)
#pragma once

#include "attention_tile.cuh"

namespace wgt {

// Shared memory of the dq pass: Q^T and G^T [DP][BQ], K^T and V^T [DP][KS],
// dS [BQ][KS], lse and delta [BQ], and with a rel-pos bias drel_h [BQ][gh]
// and drel_w [BQ][gw].
template <int NJ>
constexpr size_t dq_smem_bytes() {
  constexpr int DP = 16 * NJ;
  return sizeof(float) * (2 * size_t(DP) * BQ + 2 * size_t(DP) * KS + size_t(BQ) * KS + 2 * BQ);
}

// Shared memory of the dk/dv pass: K^T and V^T [DP][BK], the scaled query,
// the fp32 query and G, each transposed [DP][KS], P / dS [BK][KS], lse and
// delta [BQ].
template <int NJ>
constexpr size_t dkv_smem_bytes() {
  constexpr int DP = 16 * NJ;
  return sizeof(float) * (2 * size_t(DP) * BK + 3 * size_t(DP) * KS + size_t(BK) * KS + 2 * BQ);
}

template <int NJ, class Prob>
__device__ __forceinline__ void dq_pass(const Prob& pr, int q0, float* smem) {
  constexpr int DP = 16 * NJ;
  float* QsT = smem;
  float* GsT = QsT + DP * BQ;
  float* KsT = GsT + DP * BQ;
  float* VsT = KsT + DP * KS;
  float* Ds = VsT + DP * KS;
  float* lse_s = Ds + BQ * KS;
  float* delta_s = lse_s + BQ;
  float* drh_s = delta_s + BQ;    // REL only: [BQ][gh], then [BQ][gw]
  float* drw_s = nullptr;

  const int tid = threadIdx.x;
  const int tr = tid >> 4;
  const int tc = tid & 15;
  const int D = pr.D;
  const int nq = min(BQ, pr.N - q0);

  for (int i = tid; i < BQ * D; i += NTHREADS) {
    const int r = i / D, d = i - r * D;
    const bool ok = r < nq;
    QsT[d * BQ + r] = ok ? pr.qs(q0 + r, d) : 0.f;
    GsT[d * BQ + r] = ok ? pr.g(q0 + r, d) : 0.f;
  }
  for (int r = tid; r < BQ; r += NTHREADS) {
    lse_s[r] = r < nq ? pr.lse(q0 + r) : 0.f;
    delta_s[r] = r < nq ? pr.delta(q0 + r) : 0.f;
  }
  if constexpr (Prob::REL) {
    drw_s = drh_s + BQ * pr.gh;
    for (int i = tid; i < BQ * (pr.gh + pr.gw); i += NTHREADS) drh_s[i] = 0.f;
  }

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;

  const int nkt = pr.dq_key_tiles(q0);
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    const int kmax = min(BK, pr.NK - k0);
    __syncthreads();   // the previous tile's K^T and dS are no longer read
    for (int i = tid; i < BK * D; i += NTHREADS) {
      const int c = i / D, d = i - c * D;
      const bool ok = c < kmax;
      KsT[d * KS + c] = ok ? pr.k(k0 + c, d) : 0.f;
      VsT[d * KS + c] = ok ? pr.v(k0 + c, d) : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&QsT[d * BQ + 4 * tr]);
      const float4 gq = *reinterpret_cast<const float4*>(&GsT[d * BQ + 4 * tr]);
      const float* kr = &KsT[d * KS + tc];
      const float* vr = &VsT[d * KS + tc];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float kb = kr[16 * j], vb = vr[16 * j];
        s[0][j] = fmaf(a.x, kb, s[0][j]);
        s[1][j] = fmaf(a.y, kb, s[1][j]);
        s[2][j] = fmaf(a.z, kb, s[2][j]);
        s[3][j] = fmaf(a.w, kb, s[3][j]);
        dp[0][j] = fmaf(gq.x, vb, dp[0][j]);
        dp[1][j] = fmaf(gq.y, vb, dp[1][j]);
        dp[2][j] = fmaf(gq.z, vb, dp[2][j]);
        dp[3][j] = fmaf(gq.w, vb, dp[3][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * tr + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tc + 16 * j, key = k0 + c;
        const bool ok = r < nq && c < kmax && pr.valid(q0 + r, key);
        const float p = ok ? expf(pr.logit(s[i][j], q0 + r, key) - lse_s[r]) : 0.f;
        Ds[r * KS + c] = p * (dp[i][j] - delta_s[r]);
      }
    }
    __syncthreads();

    for (int c = 0; c < kmax; ++c) {
      const float d0 = Ds[(4 * tr + 0) * KS + c];
      const float d1 = Ds[(4 * tr + 1) * KS + c];
      const float d2 = Ds[(4 * tr + 2) * KS + c];
      const float d3 = Ds[(4 * tr + 3) * KS + c];
      const float* kc = &KsT[tc * KS + c];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float kv = kc[16 * jj * KS];
        acc[0][jj] = fmaf(d0, kv, acc[0][jj]);
        acc[1][jj] = fmaf(d1, kv, acc[1][jj]);
        acc[2][jj] = fmaf(d2, kv, acc[2][jj]);
        acc[3][jj] = fmaf(d3, kv, acc[3][jj]);
      }
    }
    if constexpr (Prob::REL) {
      // one thread per (row, grid row) and per (row, grid column) touched by
      // this tile, summing its keys in order
      const int gw = pr.gw;
      const int r0 = k0 / gw, nr = (k0 + kmax - 1) / gw - r0 + 1;
      for (int idx = tid; idx < BQ * nr; idx += NTHREADS) {
        const int i = idx % BQ, rr = r0 + idx / BQ;
        const int c_lo = max(rr * gw - k0, 0), c_hi = min((rr + 1) * gw - k0, kmax);
        float sum = 0.f;
        for (int c = c_lo; c < c_hi; ++c) sum += Ds[i * KS + c];
        drh_s[i * pr.gh + rr] += sum;
      }
      for (int idx = tid; idx < BQ * gw; idx += NTHREADS) {
        const int i = idx % BQ, cw = idx / BQ;
        float sum = 0.f;
        for (int c = (cw - k0 % gw + gw) % gw; c < kmax; c += gw) sum += Ds[i * KS + c];
        drw_s[i * gw + cw] += sum;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * tr + i;
    if (r >= nq) continue;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int d = tc + 16 * jj;
      if (d < D) pr.dq(q0 + r, d, acc[i][jj] * pr.scale);
    }
  }
  if constexpr (Prob::REL) {
    __syncthreads();
    for (int idx = tid; idx < nq * pr.gh; idx += NTHREADS)
      pr.drh(q0 + idx / pr.gh, idx % pr.gh, drh_s[idx]);
    for (int idx = tid; idx < nq * pr.gw; idx += NTHREADS)
      pr.drw(q0 + idx / pr.gw, idx % pr.gw, drw_s[idx]);
  }
}

template <int NJ, class Prob>
__device__ __forceinline__ void dkv_pass(const Prob& pr, int k0, float* smem) {
  constexpr int DP = 16 * NJ;
  float* KsT = smem;              // [DP][BK], float4 along keys
  float* VsT = KsT + DP * BK;
  float* QsT = VsT + DP * BK;     // [DP][KS]
  float* QrT = QsT + DP * KS;
  float* GsT = QrT + DP * KS;
  float* Ps = GsT + DP * KS;      // [BK][KS]: p, then dS
  float* lse_s = Ps + BK * KS;
  float* delta_s = lse_s + BQ;

  const int tid = threadIdx.x;
  const int tr = tid >> 4;
  const int tc = tid & 15;
  const int D = pr.D;
  const int nk = min(BK, pr.NK - k0);

  for (int i = tid; i < BK * D; i += NTHREADS) {
    const int c = i / D, d = i - c * D;
    const bool ok = c < nk;
    KsT[d * BK + c] = ok ? pr.k(k0 + c, d) : 0.f;
    VsT[d * BK + c] = ok ? pr.v(k0 + c, d) : 0.f;
  }

  float dk[4][NJ], dv[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) dk[i][jj] = dv[i][jj] = 0.f;

  const int nqt = (pr.N + BQ - 1) / BQ;
  for (int qt = pr.dkv_first_qtile(k0); qt < nqt; ++qt) {
    const int q0 = qt * BQ;
    const int nq = min(BQ, pr.N - q0);
    __syncthreads();   // the previous tile's Q, G and dS are no longer read
    for (int i = tid; i < BQ * D; i += NTHREADS) {
      const int r = i / D, d = i - r * D;
      const bool ok = r < nq;
      QsT[d * KS + r] = ok ? pr.qs(q0 + r, d) : 0.f;
      QrT[d * KS + r] = ok ? pr.qr(q0 + r, d) : 0.f;
      GsT[d * KS + r] = ok ? pr.g(q0 + r, d) : 0.f;
    }
    for (int r = tid; r < BQ; r += NTHREADS) {
      lse_s[r] = r < nq ? pr.lse(q0 + r) : 0.f;
      delta_s[r] = r < nq ? pr.delta(q0 + r) : 0.f;
    }
    __syncthreads();

    // s^T and dp^T: rows are this block's keys, columns the query tile
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&KsT[d * BK + 4 * tr]);
      const float4 av = *reinterpret_cast<const float4*>(&VsT[d * BK + 4 * tr]);
      const float* qr = &QsT[d * KS + tc];
      const float* gr = &GsT[d * KS + tc];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float qb = qr[16 * j], gb = gr[16 * j];
        s[0][j] = fmaf(qb, a.x, s[0][j]);
        s[1][j] = fmaf(qb, a.y, s[1][j]);
        s[2][j] = fmaf(qb, a.z, s[2][j]);
        s[3][j] = fmaf(qb, a.w, s[3][j]);
        dp[0][j] = fmaf(gb, av.x, dp[0][j]);
        dp[1][j] = fmaf(gb, av.y, dp[1][j]);
        dp[2][j] = fmaf(gb, av.z, dp[2][j]);
        dp[3][j] = fmaf(gb, av.w, dp[3][j]);
      }
    }
    float ds[4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int kc = 4 * tr + c, key = k0 + kc;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tc + 16 * j;
        const bool ok = r < nq && kc < nk && pr.valid(q0 + r, key);
        const float p = ok ? expf(pr.logit(s[c][j], q0 + r, key) - lse_s[r]) : 0.f;
        Ps[kc * KS + r] = p;
        ds[c][j] = p * (dp[c][j] - delta_s[r]);
      }
    }
    __syncthreads();
    for (int r = 0; r < nq; ++r) {
      const float p0 = Ps[(4 * tr + 0) * KS + r];
      const float p1 = Ps[(4 * tr + 1) * KS + r];
      const float p2 = Ps[(4 * tr + 2) * KS + r];
      const float p3 = Ps[(4 * tr + 3) * KS + r];
      const float* gc = &GsT[tc * KS + r];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float gv = gc[16 * jj * KS];
        dv[0][jj] = fmaf(p0, gv, dv[0][jj]);
        dv[1][jj] = fmaf(p1, gv, dv[1][jj]);
        dv[2][jj] = fmaf(p2, gv, dv[2][jj]);
        dv[3][jj] = fmaf(p3, gv, dv[3][jj]);
      }
    }
    __syncthreads();   // P is read: its region now takes dS
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(4 * tr + c) * KS + tc + 16 * j] = ds[c][j];
    __syncthreads();
    for (int r = 0; r < nq; ++r) {
      const float d0 = Ps[(4 * tr + 0) * KS + r];
      const float d1 = Ps[(4 * tr + 1) * KS + r];
      const float d2 = Ps[(4 * tr + 2) * KS + r];
      const float d3 = Ps[(4 * tr + 3) * KS + r];
      const float* qc = &QrT[tc * KS + r];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float qv = qc[16 * jj * KS];
        dk[0][jj] = fmaf(d0, qv, dk[0][jj]);
        dk[1][jj] = fmaf(d1, qv, dk[1][jj]);
        dk[2][jj] = fmaf(d2, qv, dk[2][jj]);
        dk[3][jj] = fmaf(d3, qv, dk[3][jj]);
      }
    }
  }

#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int kc = 4 * tr + c;
    if (kc >= nk) continue;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int d = tc + 16 * jj;
      if (d < D) {
        pr.dk(k0 + kc, d, dk[c][jj] * pr.scale);
        pr.dv(k0 + kc, d, dv[c][jj]);
      }
    }
  }
}

template <class Prob, int NJ>
__global__ void __launch_bounds__(NTHREADS) dq_kernel(typename Prob::Args a) {
  extern __shared__ __align__(16) float smem[];
  const Prob pr(a, blockIdx.y);
  dq_pass<NJ>(pr, blockIdx.x * BQ, smem);
}

template <class Prob, int NJ>
__global__ void __launch_bounds__(NTHREADS) dkv_kernel(typename Prob::Args a) {
  extern __shared__ __align__(16) float smem[];
  const Prob pr(a, blockIdx.y);
  dkv_pass<NJ>(pr, blockIdx.x * BK, smem);
}

template <class Prob, int NJ>
cudaError_t launch_bwd_nj(const typename Prob::Args& a, int n_bh, int N, int NK, int rel_cols,
                          cudaStream_t st) {
  const size_t dq_smem = dq_smem_bytes<NJ>() + sizeof(float) * BQ * rel_cols;
  const size_t dkv_smem = dkv_smem_bytes<NJ>();
  cudaError_t e = cudaFuncSetAttribute(dq_kernel<Prob, NJ>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(dq_smem));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(dkv_kernel<Prob, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int(dkv_smem));
  if (e != cudaSuccess) return e;
  dq_kernel<Prob, NJ><<<dim3((N + BQ - 1) / BQ, n_bh), NTHREADS, dq_smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dkv_kernel<Prob, NJ><<<dim3((NK + BK - 1) / BK, n_bh), NTHREADS, dkv_smem, st>>>(a);
  return cudaGetLastError();
}

// Both passes for head dims up to 128 (NJ = ceil(D/16) <= 8). rel_cols:
// gh + gw of a rel-pos bias (its drel accumulators live in shared memory).
template <class Prob>
cudaError_t launch_bwd(const typename Prob::Args& a, int D, int n_bh, int N, int NK,
                       int rel_cols, cudaStream_t st) {
  switch ((D + 15) / 16) {
    case 1: return launch_bwd_nj<Prob, 1>(a, n_bh, N, NK, rel_cols, st);
    case 2: return launch_bwd_nj<Prob, 2>(a, n_bh, N, NK, rel_cols, st);
    case 3: return launch_bwd_nj<Prob, 3>(a, n_bh, N, NK, rel_cols, st);
    case 4: return launch_bwd_nj<Prob, 4>(a, n_bh, N, NK, rel_cols, st);
    case 5: return launch_bwd_nj<Prob, 5>(a, n_bh, N, NK, rel_cols, st);
    case 6: return launch_bwd_nj<Prob, 6>(a, n_bh, N, NK, rel_cols, st);
    case 7: return launch_bwd_nj<Prob, 7>(a, n_bh, N, NK, rel_cols, st);
    case 8: return launch_bwd_nj<Prob, 8>(a, n_bh, N, NK, rel_cols, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace wgt
