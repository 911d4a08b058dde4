// Tensor-core backward-attention engine (bf16), the Hopper redesign of
// attention_bwd.cuh for bf16 inputs. Built on it: K3b
// (sam_flash_attention_bwd.cu), K2b (sam_window_attention_bwd.cu) and K10b
// (sam_window_attention_split_bwd.cu) on the 4-warp layout, and K1b
// (flash_attention_bwd.cu) on the pair layout at the end of this file.
// Their fp32 routes stay on attention_bwd.cuh.
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
// K3b runs both passes in one launch: two blocks of 4 warps fit an SM
// (about 240 registers a thread); blocks of 8 warps over 128 rows (one an
// SM) measured no faster, and two launches slower. K2b and K10b (4 tiles
// each way) run the dq pass, then the dk/dv pass, in launches of their own,
// each compiled for three blocks an SM: at ViT-H's windows one launch of
// both is slower (tools/attention_variants.py times the two).
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
// Ragged tiles (problems without FAST): a warp whose 16 rows of the
// block's own tile all lie past its end forms no products. A ragged last
// streamed tile runs whole (its rows past the end are zeros): skipping its
// groups of 16 rows past the end measured slower at ViT-H's windows, with
// runtime bounds in every tile and with the last tile's step compiled
// apart alike (the products are not what bounds these kernels).
//
// Outputs: each warp rounds its 16 rows of dq (or dk and dv) to bf16 into
// its own rows of the block's staged tile, which no other warp reads, and
// copies them out row by row, 16 bytes a lane where vec holds.
//
// Rel-pos gradients (dq pass, Prob::REL): drel_h[q, r] and drel_w[q, c] are
// the sums of ds over the keys of grid row r and grid column c, in fp32.
//   * gw == 64 (ViT-H): key tile kt is grid row kt, so drel_h[q, kt] is the
//     row sum of the tile's ds fragment (the thread's 16 values in order,
//     then a quad shuffle) and is written at once; drel_w is an elementwise
//     running sum of the ds fragments in registers.
//   * Prob::ONE_HOT with gh, gw <= 16 (the windows' grids): drel_h and
//     drel_w are products of ds with one-hot matrices on the tensor cores,
//     B[k][c] = 1 where the tile's key k lies in grid row (column) c, read
//     from the problem's key table; ds split hi + lo as for dq, fp32 sums in
//     registers (16 rows x 16 grid rows, and x 16 grid columns, a warp);
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
//   const bf16 *q, *k, *v, *g; int64_t sq, sk, sv, sg
//   bool vec      rows of q, k, v, g and the outputs start 16-byte aligned
//                 and D % 8 == 0: 16-byte copies; otherwise 2-byte ones
//   static constexpr bool FAST   (as in attention_mma.cuh; for REL also
//                 gw == 64, so drel_w stays in registers)
//   static constexpr bool TWO_LAUNCHES   the dq pass, then the dk/dv pass,
//                 each in a launch of its own (else both in one launch)
//   const float *lse, *delta;  int64_t sl   (lse and delta of row r at r * sl)
//   int N, NK, D;  float scale;  bf16 qscale
//   void bias_qk(float (&s)[NT][4], int k0, int row, int nq) const
//                 dq pass: the bias of local rows row, row + 8 (< nq) and
//                 keys k0 + 8 n + 2 t + j (< NK)
//   void bias_kq(float (&s)[NT][4], int q0, int k0, int key,
//                const char* buf) const
//                 dk/dv pass: rows are keys key, key + 8 (< NK) of the block
//                 at k0, columns queries q0 + 8 n + 2 t + j (< N), buf the
//                 tile's tables
//   bf16* dq_row(row), dk_row(key), dv_row(key) const   an output row
//                 (D values, contiguous)
//   static constexpr bool REL; with REL: int gh, gw (Args too),
//   void drh(row, r, x), drw(row, c, x) const, static constexpr bool
//   ONE_HOT and, where it holds, const uint16_t* kidx() const: the key
//   table of the dq pass's stage(), key k -> (k / gw) | (k % gw) << 8 for
//   every k < 64 * key tiles (0 past NK)
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
constexpr int ONE_HOT_MAX = 16;   // grid rows and columns of the one-hot rel path

// A warp's 16 x DP fp32 accumulator (mma layout) times sc, rounded to bf16
// into the warp's own 16 staged rows st (row stride SS), then out to
// row(r) for r < nr: 16-byte copies where vec holds, else 2-byte ones.
template <int KD, int SS, class RowPtr>
__device__ __forceinline__ void store_rows(const float (&acc)[2 * KD][4], float sc, bf16* st,
                                           int nr, int D, bool vec, RowPtr row) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  __syncwarp();
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 2 * KD; ++i)
      *reinterpret_cast<__nv_bfloat162*>(st + (g + 8 * h) * SS + 8 * i + 2 * t) =
          __floats2bfloat162_rn(acc[i][2 * h] * sc, acc[i][2 * h + 1] * sc);
  __syncwarp();
  if (vec) {
    const int cpr = D >> 3;
    for (int idx = lane; idx < 16 * cpr; idx += 32) {
      const int r = idx / cpr, c = idx - r * cpr;
      if (r < nr)
        *reinterpret_cast<uint4*>(row(r) + 8 * c) =
            *reinterpret_cast<const uint4*>(st + r * SS + 8 * c);
    }
  } else {
    for (int idx = lane; idx < 16 * D; idx += 32) {
      const int r = idx / D, d = idx - r * D;
      if (r < nr) row(r)[d] = st[r * SS + d];
    }
  }
}

// the bf16 pair (1 where the byte at `shift` of x is c, else 0; likewise y),
// x and y the key-table entries of two consecutive keys
__device__ __forceinline__ uint32_t one_hot_pair(uint32_t x, uint32_t y, int shift, int c) {
  return (((x >> shift) & 0xffu) == uint32_t(c) ? 0x3f80u : 0u) |
         (((y >> shift) & 0xffu) == uint32_t(c) ? 0x3f800000u : 0u);
}

// drh[nb] += (hi + lo) . B_h and drw[nb] += (hi + lo) . B_w for the k-step
// whose key-table entries start at kt (16 keys): B_h[k][c] = 1 where key k
// lies in grid row 8 nb + c, B_w likewise for the grid column
__device__ __forceinline__ void one_hot_mma(float (&drh)[2][4], float (&drw)[2][4],
                                            const uint32_t hi[4], const uint32_t lo[4],
                                            const uint16_t* kt) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint32_t k01 = *reinterpret_cast<const uint32_t*>(kt + 2 * t);      // keys 2t, 2t + 1
  const uint32_t k89 = *reinterpret_cast<const uint32_t*>(kt + 2 * t + 8);  // 2t + 8, 2t + 9
#pragma unroll
  for (int nb = 0; nb < 2; ++nb) {
    const int c = 8 * nb + g;
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      const uint32_t b0 = one_hot_pair(k01 & 0xffffu, k01 >> 16, 8 * w, c);
      const uint32_t b1 = one_hot_pair(k89 & 0xffffu, k89 >> 16, 8 * w, c);
      float (&acc)[4] = w ? drw[nb] : drh[nb];
      mma(acc, hi, b0, b1);
      mma(acc, lo, b0, b1);
    }
  }
}

// the general rel-gradient path's shared memory: the warps' ds blocks and
// the [64][gh + gw] fp32 accumulators (none on the other two paths)
__host__ __device__ inline size_t rel_grad_bytes(int gh, int gw, bool one_hot) {
  return gw == BK || (one_hot && gh <= ONE_HOT_MAX && gw <= ONE_HOT_MAX)
             ? 0
             : sizeof(float) * BQ * (DSS + gh + gw);
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
  const bool idle = !F && 16 * warp >= nq;   // no row of the warp is valid

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
    lse[h] = ok ? pr.lse[(q0 + row + 8 * h) * pr.sl] * LOG2E : 0.f;
    delta[h] = ok ? pr.delta[(q0 + row + 8 * h) * pr.sl] : 0.f;
  }
  float dq[2 * KD][4];
#pragma unroll
  for (int i = 0; i < 2 * KD; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;
  float drw[NT][4];   // REL with gw == BK: drel_w of the fragment's columns
#pragma unroll
  for (int n = 0; n < NT; ++n) drw[n][0] = drw[n][1] = drw[n][2] = drw[n][3] = 0.f;
  bool rel_regs = false, one_hot = false;
  float* dsw = nullptr;
  float* drh_s = nullptr;
  float* drw_s = nullptr;
  float drh1[2][4], drw1[2][4];   // ONE_HOT: drel_h, drel_w of the warp's rows
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) drh1[n][e] = drw1[n][e] = 0.f;
  if constexpr (Prob::REL) {
    rel_regs = F || pr.gw == BK;
    if constexpr (Prob::ONE_HOT)
      one_hot = !rel_regs && pr.gh <= ONE_HOT_MAX && pr.gw <= ONE_HOT_MAX;
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
    if (idle) continue;

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
      if constexpr (Prob::ONE_HOT) {
        if (one_hot) one_hot_mma(drh1, drw1, hi, lo, pr.kidx() + k0 + 16 * j);
      }
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
      } else if (!one_hot) {
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

  store_rows<KD, SS>(dq, pr.scale, Qs + 16 * warp * SS, min(16, nq - 16 * warp), pr.D,
                     pr.vec, [&](int r) { return pr.dq_row(q0 + 16 * warp + r); });
  if constexpr (Prob::REL) {
    if (one_hot) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + 8 * h;
        if (r >= nq) continue;
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * nb + 2 * t + e;
            if (c < pr.gh) pr.drh(q0 + r, c, drh1[nb][2 * h + e]);
            if (c < pr.gw) pr.drw(q0 + r, c, drw1[nb][2 * h + e]);
          }
      }
    } else if (rel_regs) {
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
  const bool idle = !F && 16 * warp >= nk;   // no key of the warp is valid

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
        cp_async4(lse_s + b * BQ + r, pr.lse + (ok ? (q0 + r) * pr.sl : 0), ok ? 4 : 0);
      else
        cp_async4(delta_s + b * BQ + r, pr.delta + (ok ? (q0 + r) * pr.sl : 0), ok ? 4 : 0);
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
    if (idle) continue;
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

  const int nr = min(16, nk - 16 * warp), r0 = k0 + 16 * warp;
  store_rows<KD, SS>(dk, pr.scale, Ks + 16 * warp * SS, nr, pr.D, pr.vec,
                     [&](int r) { return pr.dk_row(r0 + r); });
  store_rows<KD, SS>(dv, 1.f, Vs + 16 * warp * SS, nr, pr.D, pr.vec,
                     [&](int r) { return pr.dv_row(r0 + r); });
}

// The passes a launch runs: both in one launch (blocks x < n_dkv are the
// dk/dv pass, a key tile each, the longer blocks first; the others the dq
// pass, a query tile each), so that they share the card and neither leaves
// a tail of idle SMs; or one pass a launch, so that each is compiled, and
// given registers, on its own (Prob::TWO_LAUNCHES).
enum Passes { BOTH, DQ, DKV };

// blocks an SM each kind of launch is compiled for: a launch of one pass
// for three (at most 168 registers a thread: both passes spill a little at
// D = 80, and still run faster at ViT-H's windows than at two blocks an
// SM), a launch of both for two (about 240 registers)
template <int P> constexpr int min_blocks() { return P == BOTH ? 1 : 3; }

template <class Prob, int KD, int P>
__global__ void __launch_bounds__(NTHREADS, min_blocks<P>())
    bwd_mma_kernel(typename Prob::Args a, int n_dkv) {
  extern __shared__ __align__(16) char smem[];
  Prob pr(a, blockIdx.y);
  // only the columns D .. DP - 1 rely on zeros (load_rows writes every row)
  const bool pad = pr.D != 16 * KD;
  if (P == DQ || (P == BOTH && blockIdx.x >= n_dkv)) {
    const int q0 = (blockIdx.x - (P == BOTH ? n_dkv : 0)) * BQ;
    char* extra = smem + dq_tile_bytes<KD>();
    pr.stage(q0, extra);
    if (pad) zero_smem(smem, dq_tile_bytes<KD>());
    float* scratch = reinterpret_cast<float*>(extra + Prob::dq_extra_bytes(a));
    if constexpr (Prob::REL) zero_smem(scratch, rel_grad_bytes(a.gh, a.gw, Prob::ONE_HOT));
    __syncthreads();
    dq_pass_mma<KD>(pr, q0, smem, scratch);
  } else {
    if (pad) zero_smem(smem, dkv_tile_bytes<KD>());
    __syncthreads();
    dkv_pass_mma<KD>(pr, blockIdx.x * BQ, smem);
  }
}

template <class Prob, int KD, int P>
cudaError_t launch_pass(const typename Prob::Args& a, dim3 grid, size_t smem, int n_dkv,
                        cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(bwd_mma_kernel<Prob, KD, P>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  bwd_mma_kernel<Prob, KD, P><<<grid, NTHREADS, smem, st>>>(a, n_dkv);
  return cudaGetLastError();
}

template <class Prob, int KD>
cudaError_t launch_bwd_kd(const typename Prob::Args& a, int n_bh, int N, int NK,
                          cudaStream_t st) {
  size_t dq_smem = dq_tile_bytes<KD>() + Prob::dq_extra_bytes(a);
  if constexpr (Prob::REL) dq_smem += rel_grad_bytes(a.gh, a.gw, Prob::ONE_HOT);
  const size_t dkv_smem = dkv_tile_bytes<KD>() + 2 * Prob::dkv_extra_bytes(a);
  const int n_dq = (N + BQ - 1) / BQ, n_dkv = (NK + BQ - 1) / BQ;
  if constexpr (Prob::TWO_LAUNCHES) {
    cudaError_t e = launch_pass<Prob, KD, DQ>(a, dim3(n_dq, n_bh), dq_smem, 0, st);
    if (e != cudaSuccess) return e;
    return launch_pass<Prob, KD, DKV>(a, dim3(n_dkv, n_bh), dkv_smem, 0, st);
  }
  return launch_pass<Prob, KD, BOTH>(a, dim3(n_dq + n_dkv, n_bh),
                                     dq_smem > dkv_smem ? dq_smem : dkv_smem, n_dkv, st);
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

// ---------------------------------------------------------------------------
// The windowed blocks' rel-pos bias in the backward (K2b, K10b): the dq pass
// stages its query tile's rel rows and the key table with the forward's
// WinRel and adds the bias as the forward does, s + (rel_h + rel_w), so p
// matches the forward's lse. The dk/dv pass stages each query tile's rows
// alone (WinRel<R>::stage_rows, [64][ws] for rel_h, then for rel_w) and adds
// the bias of the thread's two keys, whose grid row and column it divides
// out per tile.
// ---------------------------------------------------------------------------

// s[n][2 h + j] += rel_h[c, kh] + rel_w[c, kw] for the keys key + 8 h (kh, kw
// = its grid row and column; keys >= nk read column 0, masked afterwards)
// and the tile's queries c = 8 n + 2 t + j, from the rows staged in buf
template <typename R>
__device__ __forceinline__ void win_bias_kq(float (&s)[NT][4], const char* buf, int ws, int key,
                                            int nk) {
  const int t = threadIdx.x & 3;
  const R* th = reinterpret_cast<const R*>(buf);
  const R* tw = th + BQ * ws;
  int kh[2], kw[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kk = key + 8 * h;
    kh[h] = kk < nk ? kk / ws : 0;
    kw[h] = kk < nk ? kk - kh[h] * ws : 0;
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = 8 * n + 2 * t + j;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        s[n][2 * h + j] += WinRel<R>::to_float(th[c * ws + kh[h]]) +
                           WinRel<R>::to_float(tw[c * ws + kw[h]]);
    }
}

// ---------------------------------------------------------------------------
// The pair layout (K1b): 8 warps a block, for head dims up to 128. In the
// 4-warp layout above a warp holds dk and dv of its 16 keys (2 x 16 x DP
// fp32: 128 registers a thread at D = 128) beside s, dp and the split
// fragments, which overflows 255 registers. Here warps w and w + 4 own the
// same 16 rows of the block's tile and split each step's products between
// them, so that a warp holds one 16 x DP accumulator at most:
//   dq pass   warp w: s = scale (q.k^T), p; warp w + 4: dp = g.v^T, then
//             ds = p (dp - delta); each warp then sums half of dq's head
//             dims, d-tiles [0, KH) and [KH, KD), KH = ceil(KD / 2).
//   dk/dv     warp w: s^T = scale (k.q^T), p^T, dv += p^T.g; warp w + 4:
//   pass      dp^T = v.g^T, ds^T = p^T (dp^T - delta), dk += ds^T.q.
// Each warp runs the same number of mma.sync per step. p (and in the dq
// pass ds) crosses from one warp of the pair to the other through a 4 KB
// shared-memory slot: every lane writes and reads only its own fragment
// positions, and a barrier of the pair's 64 threads (named barrier 1 + the
// pair) orders the two. The logits are the fp32 accumulator of q.k times
// scale (Prob::SCALE_ACC): q is staged unscaled. Masks: the problem's
// mask_qk / mask_kq set the logits of masked pairs to -inf, so p is exactly
// 0 there; pairs past the tile's end get p = 0 from the engine.
// Blocks are ordered heaviest first (see bwd_pair_kernel).
// Problem interface (as above, without the rel-pos parts), plus:
//   static constexpr bool SCALE_ACC = true
//   int dq_key_tiles(int q0) const        key tiles the dq pass of the query
//                                         tile at q0 walks (from 0)
//   int dkv_first_qtile(int k0) const     first query tile of the dk/dv pass
//   void mask_qk(float (&s)[NT][4], int q0, int k0, int row) const
//                 rows q0 + row, + 8; keys k0 + 8 n + 2 t + (e & 1)
//   void mask_kq(float (&s)[NT][4], int q0, int k0, int key) const
//                 rows keys k0 + key, + 8; columns queries q0 + 8 n + 2 t + (e & 1)
// ---------------------------------------------------------------------------

constexpr int PAIR_WARPS = 8;
constexpr int PAIR_THREADS = 32 * PAIR_WARPS;
constexpr int XCH_FLOATS = 32 * 4 * NT;                      // one pair's slot
constexpr size_t XCH_BYTES = sizeof(float) * XCH_FLOATS * 4;   // four pairs

__device__ __forceinline__ void pair_sync(int pair) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(pair + 1) : "memory");
}

// a warp's 16 x 64 fp32 fragment into, and out of, its pair's slot
__device__ __forceinline__ void xch_put(float* x, const float (&f)[NT][4]) {
  float4* p = reinterpret_cast<float4*>(x) + (threadIdx.x & 31);
#pragma unroll
  for (int n = 0; n < NT; ++n) p[32 * n] = make_float4(f[n][0], f[n][1], f[n][2], f[n][3]);
}
__device__ __forceinline__ void xch_get(const float* x, float (&f)[NT][4]) {
  const float4* p = reinterpret_cast<const float4*>(x) + (threadIdx.x & 31);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const float4 v = p[32 * n];
    f[n][0] = v.x;
    f[n][1] = v.y;
    f[n][2] = v.z;
    f[n][3] = v.w;
  }
}

// out[0 .. 2 ND) (16 x 16 ND) += (hi + lo) . B columns 16 D0 .. 16 (D0 + ND)
// - 1 of rows 16 j .. + 15 of b (mma_ab2 over a range of head-dim tiles)
template <int D0, int ND, int SS, int NO>
__device__ __forceinline__ void mma_ab2_part(float (&out)[NO][4], const uint32_t hi[4],
                                             const uint32_t lo[4], const bf16* b, int j) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int dp = 0; dp < ND; ++dp) {
    uint32_t bf[4];
    ldsm_x4_t(bf, b + (16 * j + (lane & 7) + ((lane >> 3) & 1) * 8) * SS + 16 * (D0 + dp) +
                      (lane >> 4) * 8);
    mma(out[2 * dp], hi, bf[0], bf[1]);
    mma(out[2 * dp + 1], hi, bf[2], bf[3]);
    mma(out[2 * dp], lo, bf[0], bf[1]);
    mma(out[2 * dp + 1], lo, bf[2], bf[3]);
  }
}

template <int KD, class Prob>
__device__ __forceinline__ void dq_pass_pair(const Prob& pr, int q0, char* smem) {
  constexpr int SS = row_stride<KD>();
  constexpr int DP = 16 * KD;
  constexpr int KH = (KD + 1) / 2;
  constexpr int T = PAIR_THREADS;
  static_assert(Prob::SCALE_ACC, "the pair layout scales the logits' accumulator");
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = Qs + BQ * SS;
  bf16* Ks = Gs + BQ * SS;         // [2][BK][SS]
  bf16* Vs = Ks + 2 * BK * SS;       // [2][BK][SS]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pair = warp & 3, role = warp >> 2;
  float* xch = reinterpret_cast<float*>(smem + dq_tile_bytes<KD>()) + pair * XCH_FLOATS;
  const int g = lane >> 2, t = lane & 3;
  const int row = 16 * pair + g;     // this thread's rows: row, row + 8
  const int nq = min(BQ, pr.N - q0);
  const int nkt = pr.dq_key_tiles(q0);

  load_rows<SS, DP, false, T>(Qs, pr.q + q0 * pr.sq, pr.sq, nq, pr.D, pr.vec);
  load_rows<SS, DP, false, T>(Gs, pr.g + q0 * pr.sg, pr.sg, nq, pr.D, pr.vec);
  load_rows<SS, DP, false, T>(Ks, pr.k, pr.sk, min(BK, pr.NK), pr.D, pr.vec);
  load_rows<SS, DP, false, T>(Vs, pr.v, pr.sv, min(BK, pr.NK), pr.D, pr.vec);
  cp_commit();

  float lse[2], delta[2];   // lse in log2 units
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool ok = row + 8 * h < nq;
    lse[h] = ok ? pr.lse[q0 + row + 8 * h] * LOG2E : 0.f;
    delta[h] = ok ? pr.delta[q0 + row + 8 * h] : 0.f;
  }
  float dq[2 * KH][4];   // role 0: d-tiles [0, KH); role 1: [KH, KD)
#pragma unroll
  for (int i = 0; i < 2 * KH; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    const bf16* Kb = Ks + (kt & 1) * BK * SS;
    const bf16* Vb = Vs + (kt & 1) * BK * SS;
    cp_wait<0>();
    __syncthreads();   // tile kt has landed; every warp is done with tile kt - 1
    if (kt + 1 < nkt) {   // into the buffer of tile kt - 1, while kt is multiplied
      const int k1 = k0 + BK, nk1 = min(BK, pr.NK - k1), b = (kt + 1) & 1;
      load_rows<SS, DP, false, T>(Ks + b * BK * SS, pr.k + k1 * pr.sk, pr.sk, nk1, pr.D,
                                  pr.vec);
      load_rows<SS, DP, false, T>(Vs + b * BK * SS, pr.v + k1 * pr.sv, pr.sv, nk1, pr.D,
                                  pr.vec);
      cp_commit();
    }

    float f[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) f[n][0] = f[n][1] = f[n][2] = f[n][3] = 0.f;
    if (role == 0) {   // s, then p
      mma_abt<KD, SS>(f, Qs + 16 * pair * SS, Kb);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) f[n][e] *= pr.scale;
      pr.mask_qk(f, q0, k0, row);
      const bool full = k0 + BK <= pr.NK && nq == BQ;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const bool ok = full || (k0 + 8 * n + 2 * t + (e & 1) < pr.NK && row + 8 * h < nq);
          f[n][e] = ok ? exp2_fast(fmaf(f[n][e], LOG2E, -lse[h])) : 0.f;
        }
      xch_put(xch, f);
    } else {           // dp
      mma_abt<KD, SS>(f, Gs + 16 * pair * SS, Vb);
    }
    pair_sync(pair);
    if (role == 1) {   // ds = p (dp - delta), back to the pair's slot
      float p[NT][4];
      xch_get(xch, p);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) f[n][e] = p[n][e] * (f[n][e] - delta[e >> 1]);
      xch_put(xch, f);
    }
    pair_sync(pair);
    if (role == 0) xch_get(xch, f);
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      uint32_t hi[4], lo[4];
      a_frag_split(f, j, hi, lo);
      if (role == 0)
        mma_ab2_part<0, KH, SS>(dq, hi, lo, Kb, j);
      else
        mma_ab2_part<KH, KD - KH, SS>(dq, hi, lo, Kb, j);
    }
  }

  const int d0 = role ? 16 * KH : 0, nd = role ? KD - KH : KH;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= nq) continue;
#pragma unroll
    for (int i = 0; i < 2 * KH; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = d0 + 8 * i + 2 * t + e;
        if (i < 2 * nd && d < pr.D) pr.dq(q0 + r, d, dq[i][2 * h + e] * pr.scale);
      }
  }
}

template <int KD, class Prob>
__device__ __forceinline__ void dkv_pass_pair(const Prob& pr, int k0, char* smem) {
  constexpr int SS = row_stride<KD>();
  constexpr int DP = 16 * KD;
  constexpr int T = PAIR_THREADS;
  static_assert(Prob::SCALE_ACC, "the pair layout scales the logits' accumulator");
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BQ * SS;
  bf16* Qr = Vs + BQ * SS;         // [2][BQ][SS]
  bf16* Gs = Qr + 2 * BQ * SS;       // [2][BQ][SS]
  float* lse_s = reinterpret_cast<float*>(Gs + 2 * BQ * SS);   // [2][BQ]
  float* delta_s = lse_s + 2 * BQ;                              // [2][BQ]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pair = warp & 3, role = warp >> 2;
  float* xch = reinterpret_cast<float*>(smem + dkv_tile_bytes<KD>()) + pair * XCH_FLOATS;
  const int g = lane >> 2, t = lane & 3;
  const int row = 16 * pair + g;     // this thread's keys: k0 + row, + 8
  const int nk = min(BK, pr.NK - k0);
  const int nqt = (pr.N + BQ - 1) / BQ;

  auto stage = [&](int qt) {   // then the caller commits
    const int q0 = qt * BQ, nq = min(BQ, pr.N - q0), b = qt & 1;
    load_rows<SS, DP, false, T>(Qr + b * BQ * SS, pr.q + q0 * pr.sq, pr.sq, nq, pr.D, pr.vec);
    load_rows<SS, DP, false, T>(Gs + b * BQ * SS, pr.g + q0 * pr.sg, pr.sg, nq, pr.D, pr.vec);
    for (int i = threadIdx.x; i < 2 * BQ; i += T) {
      const int r = i & (BQ - 1);
      const bool ok = r < nq;
      if (i < BQ)
        cp_async4(lse_s + b * BQ + r, pr.lse + (ok ? q0 + r : 0), ok ? 4 : 0);
      else
        cp_async4(delta_s + b * BQ + r, pr.delta + (ok ? q0 + r : 0), ok ? 4 : 0);
    }
  };
  const int first = pr.dkv_first_qtile(k0);
  load_rows<SS, DP, false, T>(Ks, pr.k + k0 * pr.sk, pr.sk, nk, pr.D, pr.vec);
  load_rows<SS, DP, false, T>(Vs, pr.v + k0 * pr.sv, pr.sv, nk, pr.D, pr.vec);
  stage(first);
  cp_commit();

  float acc[2 * KD][4];   // role 0: dv; role 1: dk
#pragma unroll
  for (int i = 0; i < 2 * KD; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int qt = first; qt < nqt; ++qt) {
    const int q0 = qt * BQ, b = qt & 1;
    cp_wait<0>();
    __syncthreads();   // tile qt has landed; every warp is done with tile qt - 1
    if (qt + 1 < nqt) {   // into the buffers of tile qt - 1, while qt is multiplied
      stage(qt + 1);
      cp_commit();
    }
    const bf16* Qb = Qr + b * BQ * SS;
    const bf16* Gb = Gs + b * BQ * SS;
    const float* db = delta_s + b * BQ;

    float f[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) f[n][0] = f[n][1] = f[n][2] = f[n][3] = 0.f;
    if (role == 0) {   // s^T, then p^T
      const float* lb = lse_s + b * BQ;
      mma_abt<KD, SS>(f, Ks + 16 * pair * SS, Qb);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) f[n][e] *= pr.scale;
      pr.mask_kq(f, q0, k0, row);
      const bool full = q0 + BQ <= pr.N && nk == BK;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * n + 2 * t + (e & 1);
          const bool ok = full || (q0 + c < pr.N && row + 8 * (e >> 1) < nk);
          f[n][e] = ok ? exp2_fast(fmaf(f[n][e], LOG2E, -lb[c] * LOG2E)) : 0.f;
        }
      xch_put(xch, f);
    } else {           // dp^T
      mma_abt<KD, SS>(f, Vs + 16 * pair * SS, Gb);
    }
    pair_sync(pair);
    if (role == 1) {   // ds^T = p^T (dp^T - delta)
      float p[NT][4];
      xch_get(xch, p);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) f[n][e] = p[n][e] * (f[n][e] - db[8 * n + 2 * t + (e & 1)]);
    }
    const bf16* Bb = role ? Qb : Gb;   // dk += ds^T.q; dv += p^T.g
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
      uint32_t hi[4], lo[4];
      a_frag_split(f, j, hi, lo);
      mma_ab2<KD, SS>(acc, hi, lo, Bb, j);
    }
  }

  const float sc = role ? pr.scale : 1.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= nk) continue;
#pragma unroll
    for (int i = 0; i < 2 * KD; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * i + 2 * t + e;
        if (d >= pr.D) continue;
        if (role)
          pr.dk(k0 + r, d, acc[i][2 * h + e] * sc);
        else
          pr.dv(k0 + r, d, acc[i][2 * h + e]);
      }
  }
}

// Both passes of the pair layout in one launch over a 1-D grid of 2 * nt *
// n_bh blocks (nt tiles of 64 on each side, N == NK), heaviest first: rank
// r holds, for every (batch, head), the dk/dv pass of key tile r and the dq
// pass of query tile nt - 1 - r, which under a causal mask both walk nt - r
// tiles (without one, every block walks nt).
template <class Prob, int KD>
__global__ void __launch_bounds__(PAIR_THREADS) bwd_pair_kernel(typename Prob::Args a, int nt,
                                                                  int n_bh) {
  extern __shared__ __align__(16) char smem[];
  const int r = blockIdx.x / (2 * n_bh), rem = blockIdx.x - r * 2 * n_bh;
  const Prob pr(a, rem >> 1);
  // only the columns D .. DP - 1 rely on zeros (load_rows writes every row)
  const bool pad = pr.D != 16 * KD;
  if (rem & 1) {
    if (pad) zero_smem<PAIR_THREADS>(smem, dq_tile_bytes<KD>());
    __syncthreads();
    dq_pass_pair<KD>(pr, (nt - 1 - r) * BQ, smem);
  } else {
    if (pad) zero_smem<PAIR_THREADS>(smem, dkv_tile_bytes<KD>());
    __syncthreads();
    dkv_pass_pair<KD>(pr, r * BK, smem);
  }
}

template <class Prob, int KD>
cudaError_t launch_pair_kd(const typename Prob::Args& a, int n_bh, int N, cudaStream_t st) {
  const size_t dq_smem = dq_tile_bytes<KD>() + XCH_BYTES;
  const size_t dkv_smem = dkv_tile_bytes<KD>() + XCH_BYTES;
  const size_t smem = dq_smem > dkv_smem ? dq_smem : dkv_smem;
  cudaError_t e = cudaFuncSetAttribute(bwd_pair_kernel<Prob, KD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  const int nt = (N + BQ - 1) / BQ;
  bwd_pair_kernel<Prob, KD><<<2 * nt * n_bh, PAIR_THREADS, smem, st>>>(a, nt, n_bh);
  return cudaGetLastError();
}

// Both passes of the pair layout for head dims up to 128 (KD <= 8), N == NK.
template <class Prob>
cudaError_t launch_pair(const typename Prob::Args& a, int D, int n_bh, int N, cudaStream_t st) {
  switch ((D + 15) / 16) {
    case 1: return launch_pair_kd<Prob, 1>(a, n_bh, N, st);
    case 2: return launch_pair_kd<Prob, 2>(a, n_bh, N, st);
    case 3: return launch_pair_kd<Prob, 3>(a, n_bh, N, st);
    case 4: return launch_pair_kd<Prob, 4>(a, n_bh, N, st);
    case 5: return launch_pair_kd<Prob, 5>(a, n_bh, N, st);
    case 6: return launch_pair_kd<Prob, 6>(a, n_bh, N, st);
    case 7: return launch_pair_kd<Prob, 7>(a, n_bh, N, st);
    case 8: return launch_pair_kd<Prob, 8>(a, n_bh, N, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc
}  // namespace wgt
