// Tensor-core backward-attention engine (bf16), the Hopper redesign of
// attention_bwd.cuh for bf16 inputs. Built on it: K3b
// (sam_flash_attention_bwd.cu). Its fp32 route stays on attention_bwd.cuh.
//
// Two passes, as the CUDA-core engine and the TPU kernels have them, each
// recomputing p from the forward's saved logsumexp:
//   dq pass   a block of 4 warps per 64-query tile (16 rows a warp) walks
//             the key tiles of 64: s = qs.k^T and dp = g.v^T, p = exp(s +
//             bias - lse), ds = p * (dp - delta), dq += ds.k; with a rel-pos
//             bias also drel_h and drel_w (below).
//   dk/dv     a block of 4 warps per 64-key tile (16 keys a warp) walks the
//   pass      query tiles of 64: s^T = k.qs^T and dp^T = v.g^T, the same p
//             and ds, dv += p^T.g and dk += ds^T.q.
// Both passes run in one launch. Two blocks of 4 warps fit an SM (about
// 240 registers a thread); blocks of 8 warps over 128 rows (one an SM)
// measured no faster.
// Products: s and dp have bf16 operands on the TPU too, and are single bf16
// mma.sync.m16n8k16 products with fp32 sums. p and ds are fp32, and the TPU
// kernels form dq, dk and dv in fp32: here each of those three products
// takes its fp32 operand split in two, hi = bf16(x) and lo = bf16(x - hi),
// as two bf16 products into one fp32 accumulator; hi + lo keeps about 16
// significant bits of x where bf16 alone keeps 8 (the other operand, k, q
// or g, is a bf16 input and exact). Streamed tiles are double-buffered in
// shared memory by cp.async, one barrier per tile; the block's own tile is
// staged once. The dk/dv pass scales q as its fragments are loaded.
//
// Determinism: no atomics. Every output element is summed by one thread
// (or one quad, in a fixed shuffle order) in tile order, so two runs give
// the same bits.
//
// Rel-pos gradients (dq pass, Prob::REL): drel_h[q, r] and drel_w[q, c] are
// the sums of ds over the keys of grid row r and grid column c, in fp32.
//   * gw == 64 (ViT-H): key tile kt is grid row kt, so drel_h[q, kt] is the
//     row sum of the tile's ds fragment (the thread's 16 values in order,
//     then a quad shuffle) and is written at once; drel_w is an elementwise
//     running sum of the ds fragments in registers.
//   * otherwise each warp writes its 16 x 64 ds block to shared memory and
//     its lanes sum it by (row, grid row) and (row, grid column) into fp32
//     accumulators [64][gh + gw] in shared memory, one lane per element.
//
// Problem interface (device; rows and keys absolute unless said):
//   struct Args; Prob(const Args&, int bh)
//   static size_t dq_extra_bytes(const Args&)    host and device: staging
//   static size_t dkv_extra_bytes(const Args&)   bytes of the dq pass, and
//                 of one query tile of the dk/dv pass (which holds two)
//   void stage(int q0, char* extra)              dq pass: stage the tile's
//                 tables (all threads, cp.async or plain stores; the engine
//                 commits, waits and synchronises after)
//   void stage_q(int q0, int k0, char* buf) const   dk/dv pass: likewise
//                 for the query tile at q0 and the block's keys k0 .. k0 +
//                 63, into one of two buffers
//   size_t tab_bytes() const                     the size of such a buffer
//   const bf16 *q, *k, *v, *g; int64_t sq, sk, sv, sg; bool vec
//   static constexpr bool FAST   (as in attention_mma.cuh; for REL also
//                 gw == 64, so drel_w stays in registers)
//   const float *lse, *delta;  int N, NK, D;  float scale;  bf16 qscale
//   void bias_qk(float (&s)[NT][4], int k0, int row, int nq) const
//                 dq pass: the bias of local rows row, row + 8 (< nq) and
//                 keys k0 + 8 n + 2 t + j (< NK)
//   void bias_kq(float (&s)[NT][4], int q0, int k0, int key,
//                const char* buf) const
//                 dk/dv pass: rows are keys key, key + 8 (< NK) of the block
//                 at k0, columns queries q0 + 8 n + 2 t + j (< N), buf the
//                 tile's tables
//   void dq(row, d, x), dk(key, d, x), dv(key, d, x) const
//   static constexpr bool REL; with REL: int gh, gw and
//   void drh(row, r, x), drw(row, c, x) const
#pragma once

#include "attention_mma.cuh"

namespace wgt {
namespace tc {

// a block's own tile: 64 rows, once; the streamed tiles: 64 rows, twice
template <int KD> __host__ __device__ constexpr size_t dq_tile_bytes() {  // Q, G, (K, V) x 2
  return sizeof(bf16) * size_t(2 * BQ + 4 * BK) * row_stride<KD>();
}
template <int KD> __host__ __device__ constexpr size_t dkv_tile_bytes() {  // K, V, (Q, G) x 2
  return sizeof(bf16) * size_t(2 * BK + 4 * BQ) * row_stride<KD>() + sizeof(float) * 4 * BQ;
}

constexpr int DSS = BK + 4;   // fp32 row stride of a warp's staged ds block

// the general rel-gradient path's shared memory: the warps' ds blocks and
// the [64][gh + gw] fp32 accumulators (none when gw == BK)
__host__ __device__ inline size_t rel_grad_bytes(int gh, int gw) {
  return gw == BK ? 0 : sizeof(float) * BQ * (DSS + gh + gw);
}

template <int KD, class Prob>
__device__ __forceinline__ void dq_pass_mma(const Prob& pr, int q0, char* smem, float* scratch) {
  constexpr int SS = row_stride<KD>();
  constexpr int DP = 16 * KD;
  constexpr bool F = Prob::FAST;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = Qs + BQ * SS;
  bf16* Ks = Gs + BQ * SS;         // [2][BK][SS]
  bf16* Vs = Ks + 2 * BK * SS;       // [2][BK][SS]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row = 16 * warp + g;     // this thread's rows: row, row + 8
  const int nq = min(BQ, pr.N - q0);
  const int nkt = (pr.NK + BK - 1) / BK;

  load_rows<SS, DP, F>(Qs, pr.q + q0 * pr.sq, pr.sq, nq, pr.D, pr.vec);
  load_rows<SS, DP, F>(Gs, pr.g + q0 * pr.sg, pr.sg, nq, pr.D, pr.vec);
  load_rows<SS, DP, F>(Ks, pr.k, pr.sk, min(BK, pr.NK), pr.D, pr.vec);
  load_rows<SS, DP, F>(Vs, pr.v, pr.sv, min(BK, pr.NK), pr.D, pr.vec);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  scale_rows<SS, DP>(Qs, Qs, pr.qscale);

  float lse[2], delta[2];   // lse in log2 units
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool ok = row + 8 * h < nq;
    lse[h] = ok ? pr.lse[q0 + row + 8 * h] * LOG2E : 0.f;
    delta[h] = ok ? pr.delta[q0 + row + 8 * h] : 0.f;
  }
  float dq[2 * KD][4];
#pragma unroll
  for (int i = 0; i < 2 * KD; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;
  float drw[NT][4];   // REL with gw == BK: drel_w of the fragment's columns
#pragma unroll
  for (int n = 0; n < NT; ++n) drw[n][0] = drw[n][1] = drw[n][2] = drw[n][3] = 0.f;
  bool rel_regs = false;
  float* dsw = nullptr;
  float* drh_s = nullptr;
  float* drw_s = nullptr;
  if constexpr (Prob::REL) {
    rel_regs = F || pr.gw == BK;
    dsw = scratch + warp * 16 * DSS;
    drh_s = scratch + BQ * DSS;
    drw_s = drh_s + BQ * pr.gh;
  }

  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    const bf16* Kb = Ks + (kt & 1) * BK * SS;
    const bf16* Vb = Vs + (kt & 1) * BK * SS;
    if (kt > 0) cp_wait<0>();
    __syncthreads();   // tile kt has landed (at kt = 0: the scaled Q); every
                       // warp is done with tile kt - 1
    if (kt + 1 < nkt) {   // into the buffer of tile kt - 1, while kt is multiplied
      const int k1 = k0 + BK, nk1 = min(BK, pr.NK - k1), b = (kt + 1) & 1;
      load_rows<SS, DP, F>(Ks + b * BK * SS, pr.k + k1 * pr.sk, pr.sk, nk1, pr.D,
                                       pr.vec);
      load_rows<SS, DP, F>(Vs + b * BK * SS, pr.v + k1 * pr.sv, pr.sv, nk1, pr.D,
                                       pr.vec);
      cp_commit();
    }

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma_abt<KD, SS>(s, Qs + 16 * warp * SS, Kb);
    mma_abt<KD, SS>(dp, Gs + 16 * warp * SS, Vb);
    pr.bias_qk(s, k0, row, nq);
    const bool full = F || (k0 + BK <= pr.NK && nq == BQ);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const bool ok = full || (k0 + 8 * n + 2 * t + (e & 1) < pr.NK && row + 8 * h < nq);
        const float p = ok ? exp2_fast(fmaf(s[n][e], LOG2E, -lse[h])) : 0.f;
        s[n][e] = p * (dp[n][e] - delta[h]);   // s now holds ds
      }
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      uint32_t hi[4], lo[4];
      a_frag_split(s, j, hi, lo);
      mma_ab2<KD, SS>(dq, hi, lo, Kb, j);
    }

    if constexpr (Prob::REL) {
      if (rel_regs) {
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            rs[e >> 1] += s[n][e];
            drw[n][e] += s[n][e];
          }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
          rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
          if (t == 0 && (F || row + 8 * h < nq)) pr.drh(q0 + row + 8 * h, kt, rs[h]);
        }
      } else {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) dsw[(g + 8 * (e >> 1)) * DSS + 8 * n + 2 * t + (e & 1)] = s[n][e];
        __syncwarp();
        const int gh = pr.gh, gw = pr.gw;
        const int kmax = min(BK, pr.NK - k0);
        const int r0 = k0 / gw, nr = (k0 + kmax - 1) / gw - r0 + 1;
        for (int idx = lane; idx < 16 * nr; idx += 32) {
          const int i = idx / nr, rr = r0 + idx - (idx / nr) * nr;
          const int c_hi = min((rr + 1) * gw - k0, kmax);
          float sum = 0.f;
          for (int c = max(rr * gw - k0, 0); c < c_hi; ++c) sum += dsw[i * DSS + c];
          drh_s[(16 * warp + i) * gh + rr] += sum;
        }
        const int w = min(gw, kmax);
        for (int idx = lane; idx < 16 * w; idx += 32) {
          const int i = idx / w, j = idx - i * w;
          float sum = 0.f;
          for (int c = j; c < kmax; c += gw) sum += dsw[i * DSS + c];
          drw_s[(16 * warp + i) * gw + (k0 + j) % gw] += sum;
        }
        __syncwarp();
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= nq) continue;
#pragma unroll
    for (int i = 0; i < 2 * KD; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * i + 2 * t + e;
        if (d < pr.D) pr.dq(q0 + r, d, dq[i][2 * h + e] * pr.scale);
      }
  }
  if constexpr (Prob::REL) {
    if (rel_regs) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + 8 * h;
        if (r >= nq) continue;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            pr.drw(q0 + r, 8 * n + 2 * t + e, drw[n][2 * h + e]);
      }
    } else {
      // a warp's accumulator rows are its own: no block barrier needed
      const int gh = pr.gh, gw = pr.gw;
      for (int idx = lane; idx < 16 * gh; idx += 32) {
        const int r = 16 * warp + idx / gh;
        if (r < nq) pr.drh(q0 + r, idx % gh, drh_s[r * gh + idx % gh]);
      }
      for (int idx = lane; idx < 16 * gw; idx += 32) {
        const int r = 16 * warp + idx / gw;
        if (r < nq) pr.drw(q0 + r, idx % gw, drw_s[r * gw + idx % gw]);
      }
    }
  }
}

template <int KD, class Prob>
__device__ __forceinline__ void dkv_pass_mma(const Prob& pr, int k0, char* smem) {
  constexpr int SS = row_stride<KD>();
  constexpr int DP = 16 * KD;
  constexpr bool F = Prob::FAST;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BQ * SS;
  bf16* Qr = Vs + BQ * SS;         // [2][BQ][SS] the raw query
  bf16* Gs = Qr + 2 * BQ * SS;       // [2][BQ][SS]
  float* lse_s = reinterpret_cast<float*>(Gs + 2 * BQ * SS);   // [2][BQ]
  float* delta_s = lse_s + 2 * BQ;                              // [2][BQ]
  char* tabs = reinterpret_cast<char*>(delta_s + 2 * BQ);       // [2] the Prob's tables
  const size_t tab_bytes = pr.tab_bytes();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row = 16 * warp + g;     // this thread's keys: k0 + row, + 8
  const int nk = min(BQ, pr.NK - k0);
  const int nqt = (pr.N + BQ - 1) / BQ;

  auto stage = [&](int qt) {   // then the caller commits
    const int q0 = qt * BQ, nq = min(BQ, pr.N - q0), b = qt & 1;
    load_rows<SS, DP, F>(Qr + b * BQ * SS, pr.q + q0 * pr.sq, pr.sq, nq, pr.D,
                                     pr.vec);
    load_rows<SS, DP, F>(Gs + b * BQ * SS, pr.g + q0 * pr.sg, pr.sg, nq, pr.D,
                                     pr.vec);
    for (int i = threadIdx.x; i < 2 * BQ; i += NTHREADS) {
      const int r = i & (BQ - 1);
      const bool ok = r < nq;
      if (i < BQ)
        cp_async4(lse_s + b * BQ + r, pr.lse + (ok ? q0 + r : 0), ok ? 4 : 0);
      else
        cp_async4(delta_s + b * BQ + r, pr.delta + (ok ? q0 + r : 0), ok ? 4 : 0);
    }
    pr.stage_q(q0, k0, tabs + b * tab_bytes);
  };
  load_rows<SS, DP, F>(Ks, pr.k + k0 * pr.sk, pr.sk, nk, pr.D, pr.vec);
  load_rows<SS, DP, F>(Vs, pr.v + k0 * pr.sv, pr.sv, nk, pr.D, pr.vec);
  stage(0);
  cp_commit();

  float dk[2 * KD][4], dv[2 * KD][4];
#pragma unroll
  for (int i = 0; i < 2 * KD; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

  for (int qt = 0; qt < nqt; ++qt) {
    const int q0 = qt * BQ, b = qt & 1;
    cp_wait<0>();
    __syncthreads();   // tile qt has landed; every warp is done with tile qt - 1
    if (qt + 1 < nqt) {   // into the buffers of tile qt - 1, while qt is multiplied
      stage(qt + 1);
      cp_commit();
    }
    const bf16* Qb = Qr + b * BQ * SS;
    const bf16* Gb = Gs + b * BQ * SS;

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma_abt_scaled<KD, SS>(s, Ks + 16 * warp * SS, Qb, pr.qscale);   // q * scale in bf16
    mma_abt<KD, SS>(dp, Vs + 16 * warp * SS, Gb);
    pr.bias_kq(s, q0, k0, k0 + row, tabs + b * tab_bytes);
    const float* lb = lse_s + b * BQ;
    const float* db = delta_s + b * BQ;
    const bool full = F || (q0 + BQ <= pr.N && nk == BQ);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + 2 * t + (e & 1);
        const bool ok = full || (q0 + c < pr.N && row + 8 * (e >> 1) < nk);
        const float p = ok ? exp2_fast(fmaf(s[n][e], LOG2E, -lb[c] * LOG2E)) : 0.f;
        s[n][e] = p;                          // p^T
        dp[n][e] = p * (dp[n][e] - db[c]);    // ds^T
      }
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
      uint32_t hi[4], lo[4];
      a_frag_split(s, j, hi, lo);
      mma_ab2<KD, SS>(dv, hi, lo, Gb, j);
      a_frag_split(dp, j, hi, lo);
      mma_ab2<KD, SS>(dk, hi, lo, Qb, j);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= nk) continue;
#pragma unroll
    for (int i = 0; i < 2 * KD; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * i + 2 * t + e;
        if (d < pr.D) {
          pr.dk(k0 + r, d, dk[i][2 * h + e] * pr.scale);
          pr.dv(k0 + r, d, dv[i][2 * h + e]);
        }
      }
  }
}

// Both passes in one launch: blocks x < n_dkv are the dk/dv pass (a key
// tile each; the longer blocks start first), the others the dq pass (a
// query tile each), so the two passes share the card and neither leaves a
// tail of idle SMs.
template <class Prob, int KD>
__global__ void __launch_bounds__(NTHREADS) bwd_mma_kernel(typename Prob::Args a, int n_dkv) {
  extern __shared__ __align__(16) char smem[];
  Prob pr(a, blockIdx.y);
  if (blockIdx.x >= n_dkv) {
    const int q0 = (blockIdx.x - n_dkv) * BQ;
    char* extra = smem + dq_tile_bytes<KD>();
    pr.stage(q0, extra);
    zero_smem(smem, dq_tile_bytes<KD>());
    float* scratch = reinterpret_cast<float*>(extra + Prob::dq_extra_bytes(a));
    if constexpr (Prob::REL) zero_smem(scratch, rel_grad_bytes(a.gh, a.gw));
    __syncthreads();
    dq_pass_mma<KD>(pr, q0, smem, scratch);
  } else {
    zero_smem(smem, dkv_tile_bytes<KD>());
    __syncthreads();
    dkv_pass_mma<KD>(pr, blockIdx.x * BQ, smem);
  }
}

template <class Prob, int KD>
cudaError_t launch_bwd_kd(const typename Prob::Args& a, int n_bh, int N, int NK,
                          cudaStream_t st) {
  size_t dq_smem = dq_tile_bytes<KD>() + Prob::dq_extra_bytes(a);
  if constexpr (Prob::REL) dq_smem += rel_grad_bytes(a.gh, a.gw);
  const size_t dkv_smem = dkv_tile_bytes<KD>() + 2 * Prob::dkv_extra_bytes(a);
  const size_t smem = dq_smem > dkv_smem ? dq_smem : dkv_smem;
  cudaError_t e = cudaFuncSetAttribute(bwd_mma_kernel<Prob, KD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  const int n_dq = (N + BQ - 1) / BQ, n_dkv = (NK + BQ - 1) / BQ;
  bwd_mma_kernel<Prob, KD><<<dim3(n_dq + n_dkv, n_bh), NTHREADS, smem, st>>>(a, n_dkv);
  return cudaGetLastError();
}

// Both passes for head dims up to 128 (KD = ceil(D/16) <= 8).
template <class Prob>
cudaError_t launch_bwd(const typename Prob::Args& a, int D, int n_bh, int N, int NK,
                       cudaStream_t st) {
  switch ((D + 15) / 16) {
    case 1: return launch_bwd_kd<Prob, 1>(a, n_bh, N, NK, st);
    case 2: return launch_bwd_kd<Prob, 2>(a, n_bh, N, NK, st);
    case 3: return launch_bwd_kd<Prob, 3>(a, n_bh, N, NK, st);
    case 4: return launch_bwd_kd<Prob, 4>(a, n_bh, N, NK, st);
    case 5: return launch_bwd_kd<Prob, 5>(a, n_bh, N, NK, st);
    case 6: return launch_bwd_kd<Prob, 6>(a, n_bh, N, NK, st);
    case 7: return launch_bwd_kd<Prob, 7>(a, n_bh, N, NK, st);
    case 8: return launch_bwd_kd<Prob, 8>(a, n_bh, N, NK, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc
}  // namespace wgt
