// The decode-attention engine shared by K4 and K8 (decode_attention_q.cu)
// and K11 (decode_attention.cu).
//
// A block of 256 threads takes one (row, kv head) and up to `qg` of its
// query rows: the n_rep query heads of that kv head for each of the Tc
// tokens (Tc = 1 for a decode step, the chunk length for K8; query row g is
// token g / n_rep, head kv * n_rep + g % n_rep). It walks the row's cache in
// blocks of `bl` keys, in order, with an online softmax; each block's cache
// values are staged in shared memory DW_KT keys at a time and consumed there
// by every query row of the block, so a chunk reads the cache once, not once
// per token. The rounding points are those of the TPU kernels the engine
// replaces, per `bl`-key block:
//   * scores: Q_INT8: q quantized per (token, head), qs = max(|q|max, 1e-20)
//     * (1/127), q8 = round(q / qs), an exact integer q8 . k, then
//     s * (ks * (qs * scale)); Q_BF16: bf16(q) . k in fp32, then
//     s * (ks * scale); Q_F32 (K11): (q * scale) . k in fp32, no scales;
//   * invalid keys get the finite -1e30 and p = 0;
//   * m_new = max(m, max s), alpha = exp(m - m_new), l = l * alpha + sum p
//     with the unrounded alpha;
//   * quantized cache: acc = acc * bf16(alpha) + p_v . v with p_v =
//     bf16(p * vs) (or, PV8, p * vs quantized per query row and block:
//     psc = max(max, 1e-20) * (1/127), an exact integer product, times
//     psc), out = acc / max(bf16(l), 1e-30);
//   * flat fp cache (K11): acc = acc * alpha + p_v . v with p_v = p rounded
//     to the cache's type, out = acc / max(l, 1e-30).
// A block that holds no valid key for a query row leaves that row's state as
// it was (alpha = 1, p = 0), so K8's token t computes what K4 computes at
// the same position over the same cache, bit for bit.
// Work split: scores a warp per key (lanes over D, shuffle sums), softmax
// statistics a warp per query row, the value product a thread per (query
// row, dim) with keys in order.
#pragma once

#include <type_traits>

#include "attention_tile.cuh"

namespace wgt {

constexpr int DW_NT = 256;
constexpr int DW_NW = DW_NT / 32;
constexpr int DW_KT = 64;              // keys per staged tile
constexpr int DW_QMAX = 32;            // query rows per block at most
constexpr size_t DW_SMEM_MAX = 232448; // shared memory a block may use on sm_90

enum QMode { Q_INT8 = 0, Q_BF16 = 1, Q_F32 = 2 };

struct DecodeArgs {
  const void* q;                 // [B, Tc, H*D] in T
  const void* k;                 // the layer's cache values [B, L, width]
  const void* v;
  const __nv_bfloat16* ks;       // [B, n_kv, L] per (token, kv head), or null
  const __nv_bfloat16* vs;
  const uint8_t* mask;           // [B, L] key mask, or null for a causal chunk
  const int* cache_len;          // [B] pre-chunk lengths (causal chunk), or null
  void* out;                     // [B, Tc, H*D] in T
  int H, n_kv, D, L, bl;
  int nvb;                       // blocks to visit (key-mask mode)
  int Tc, pack4;
  int qg;                        // query rows per block (set by decode_launch)
  float scale;
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Flat dim f of a cache row: an int8 code (packed int4 in global halves: byte
// j holds dim j in its low nibble and dim j + half in its high nibble), or a
// float / bf16 value.
__device__ __forceinline__ int8_t load_val(const int8_t* row, int f, int half, int pack4) {
  if (!pack4) return row[f];
  return int8_t(f < half ? lo4(row[f]) : hi4(row[f - half]));
}
__device__ __forceinline__ float load_val(const float* row, int f, int, int) { return row[f]; }
__device__ __forceinline__ float load_val(const __nv_bfloat16* row, int f, int, int) {
  return __bfloat162float(row[f]);
}

template <typename S>
using staged_t = typename std::conditional<std::is_same<S, int8_t>::value, int8_t, float>::type;

// Shared memory of a block: qv, acc, yv [qg][D], sp [qg][bl], st [qg][4],
// psc [qg] and the key scales [DW_KT] in fp32, then the staged values.
inline size_t decode_smem(int qg, int D, int bl, size_t staged_size) {
  return sizeof(float) * (size_t(qg) * (3 * D + bl + 5) + DW_KT) + staged_size * DW_KT * D;
}

// T: q/out type; S: cache value type (int8_t codes with bf16 scales, or the
// fp cache's own type); QM: the scores' q (QMode); PV8: int8 value product.
template <typename T, typename S, int QM, bool PV8>
__global__ void __launch_bounds__(DW_NT) decode_walk(DecodeArgs a) {
  constexpr bool QUANT = std::is_same<S, int8_t>::value;
  using C = staged_t<S>;
  using PR = typename std::conditional<QUANT, __nv_bfloat16, S>::type;  // p_v's rounding
  extern __shared__ __align__(16) float smem[];
  const int n_rep = a.H / a.n_kv, D = a.D, bl = a.bl, qg = a.qg;
  const int b = blockIdx.x / a.n_kv, kv = blockIdx.x - b * a.n_kv;
  const int g0 = blockIdx.y * qg;
  const int nq = min(qg, a.Tc * n_rep - g0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kd = a.n_kv * D, width = QUANT && a.pack4 ? kd / 2 : kd, half = kd / 2;
  float* qv = smem;                  // [qg][D] q8, bf16(q) or q * scale
  float* acc = qv + qg * D;          // [qg][D]
  float* yv = acc + qg * D;          // [qg][D] the block's value sums (int32 with PV8)
  int* yi = reinterpret_cast<int*>(yv);
  float* sp = yv + qg * D;           // [qg][bl] scores, then p_v
  float* st = sp + qg * bl;          // [qg][4] scores scale, m, l, alpha
  float* psc = st + 4 * qg;          // [qg] PV8 scales
  float* tsc = psc + qg;             // [DW_KT] staged key scales
  C* tile = reinterpret_cast<C*>(tsc + DW_KT);   // [DW_KT][D] staged cache values

  // query row qi of this block -> offset of its [D] slice in q and out
  auto q_off = [&](int qi) {
    const int g = g0 + qi, t = g / n_rep, head = kv * n_rep + (g - t * n_rep);
    return ((size_t(b) * a.Tc + t) * a.H + head) * D;
  };
  const uint8_t* mrow = a.mask ? a.mask + size_t(b) * a.L : nullptr;
  const int cl = a.cache_len ? a.cache_len[b] : 0;
  // key-mask mode, or the chunk's rule: slot p is valid for token t iff p < cl + t + 1
  auto valid = [&](int qi, int key) {
    return mrow ? mrow[key] != 0 : key < cl + (g0 + qi) / n_rep + 1;
  };
  const int nvb = a.cache_len ? min((cl + a.Tc + bl - 1) / bl, a.L / bl) : a.nvb;

  const T* qb = static_cast<const T*>(a.q);
  for (int qi = warp; qi < nq; qi += DW_NW) {
    const T* qr = qb + q_off(qi);
    float qs = 1.f;
    if (QM == Q_INT8) {
      float mx = 0.f;
      for (int d = lane; d < D; d += 32) mx = fmaxf(mx, fabsf(to_f(qr[d])));
      mx = warp_max(mx);
      qs = fmaxf(mx, 1e-20f) * (1.0f / 127.0f);
    }
    for (int d = lane; d < D; d += 32) {
      const float x = to_f(qr[d]);
      qv[qi * D + d] = QM == Q_INT8 ? rintf(x / qs)
                     : QM == Q_BF16 ? round_to<__nv_bfloat16>(x) : x * a.scale;
      acc[qi * D + d] = 0.f;
    }
    if (lane == 0) {
      st[4 * qi + 0] = QM == Q_INT8 ? qs * a.scale : QM == Q_BF16 ? a.scale : 1.f;
      st[4 * qi + 1] = NEG_BIG;
      st[4 * qi + 2] = 0.f;
    }
  }
  __syncthreads();

  const S* kb = static_cast<const S*>(a.k) + size_t(b) * a.L * width;
  const S* vb = static_cast<const S*>(a.v) + size_t(b) * a.L * width;
  const __nv_bfloat16* ksr = a.ks ? a.ks + (size_t(b) * a.n_kv + kv) * a.L : nullptr;
  const __nv_bfloat16* vsr = a.vs ? a.vs + (size_t(b) * a.n_kv + kv) * a.L : nullptr;
  // this head's dims of keys [key0, key0 + nk) (and their k scales) to shared memory
  auto stage = [&](const S* rows, const __nv_bfloat16* scales, int key0, int nk) {
    for (int i = threadIdx.x; i < nk * D; i += DW_NT) {
      const int j = i / D, d = i - j * D;
      tile[i] = load_val(rows + size_t(key0 + j) * width, kv * D + d, half, a.pack4);
    }
    for (int j = threadIdx.x; j < nk; j += DW_NT)
      tsc[j] = scales ? __bfloat162float(scales[key0 + j]) : 1.f;
  };

  for (int jb = 0; jb < nvb; ++jb) {
    const int j0 = jb * bl;
    // scores, a warp per key
    for (int kt = 0; kt < bl; kt += DW_KT) {
      const int nk = min(DW_KT, bl - kt);
      stage(kb, ksr, j0 + kt, nk);
      __syncthreads();
      for (int j = warp; j < nk; j += DW_NW) {
        const C* row = tile + j * D;
        const float ksv = tsc[j];
        for (int qi = 0; qi < nq; ++qi) {
          float s;
          if (QM == Q_INT8) {
            int si = 0;
            for (int d = lane; d < D; d += 32) si += int(qv[qi * D + d]) * int(row[d]);
            s = float(warp_sum(si));
          } else {
            float sf = 0.f;
            for (int d = lane; d < D; d += 32) sf += qv[qi * D + d] * float(row[d]);
            s = warp_sum(sf);
          }
          if (lane == 0)
            sp[qi * bl + kt + j] = valid(qi, j0 + kt + j) ? s * (ksv * st[4 * qi + 0]) : NEG_BIG;
        }
      }
      __syncthreads();
    }
    // softmax statistics and p_v, a warp per query row
    for (int qi = warp; qi < nq; qi += DW_NW) {
      float mx = NEG_BIG;
      for (int j = lane; j < bl; j += 32) mx = fmaxf(mx, sp[qi * bl + j]);
      mx = warp_max(mx);
      const float m_old = st[4 * qi + 1];
      const float m_new = fmaxf(m_old, mx);
      const float alpha = expf(m_old - m_new);
      float lsum = 0.f, pmax = 0.f;
      for (int j = lane; j < bl; j += 32) {
        const float p = valid(qi, j0 + j) ? expf(sp[qi * bl + j] - m_new) : 0.f;
        lsum += p;
        const float pf = vsr ? p * __bfloat162float(vsr[j0 + j]) : p;
        pmax = fmaxf(pmax, pf);
        sp[qi * bl + j] = PV8 ? pf : round_to<PR>(pf);
      }
      lsum = warp_sum(lsum);
      if (PV8) {
        pmax = warp_max(pmax);
        const float sc = fmaxf(pmax, 1e-20f) * (1.0f / 127.0f);
        for (int j = lane; j < bl; j += 32) sp[qi * bl + j] = rintf(sp[qi * bl + j] / sc);
        if (lane == 0) psc[qi] = sc;
      }
      __syncwarp();
      if (lane == 0) {
        st[4 * qi + 1] = m_new;
        st[4 * qi + 2] = st[4 * qi + 2] * alpha + lsum;
        st[4 * qi + 3] = alpha;
      }
    }
    __syncthreads();
    // value product, a thread per (query row, dim), keys in order
    for (int i = threadIdx.x; i < nq * D; i += DW_NT) {
      if (PV8) yi[i] = 0;
      else yv[i] = 0.f;
    }
    for (int kt = 0; kt < bl; kt += DW_KT) {
      const int nk = min(DW_KT, bl - kt);
      stage(vb, nullptr, j0 + kt, nk);
      __syncthreads();
      for (int i = threadIdx.x; i < nq * D; i += DW_NT) {
        const int qi = i / D, d = i - qi * D;
        const float* pr = sp + qi * bl + kt;
        if (PV8) {
          int y = 0;
          for (int j = 0; j < nk; ++j) y += int(pr[j]) * int(tile[j * D + d]);
          yi[i] += y;
        } else {
          float y = yv[i];
          for (int j = 0; j < nk; ++j) y += pr[j] * float(tile[j * D + d]);
          yv[i] = y;
        }
      }
      __syncthreads();
    }
    for (int i = threadIdx.x; i < nq * D; i += DW_NT) {
      const int qi = i / D;
      const float y = PV8 ? float(yi[i]) * psc[qi] : yv[i];
      const float alpha = st[4 * qi + 3];
      acc[i] = acc[i] * (QUANT ? round_to<__nv_bfloat16>(alpha) : alpha) + y;
    }
    __syncthreads();
  }
  T* ob = static_cast<T*>(a.out);
  for (int i = threadIdx.x; i < nq * D; i += DW_NT) {
    const int qi = i / D, d = i - qi * D;
    const float l = st[4 * qi + 2];
    ob[q_off(qi) + d] = from_f<T>(acc[i] / fmaxf(QUANT ? round_to<__nv_bfloat16>(l) : l, 1e-30f));
  }
}

// Launch over grid (B * n_kv, query groups): as many query rows per block as
// fit (at most DW_QMAX). Returns a cudaError_t as int.
template <typename T, typename S, int QM, bool PV8>
int decode_launch(DecodeArgs a, int B, cudaStream_t stream) {
  const int nq_all = a.Tc * (a.H / a.n_kv);
  const size_t cs = sizeof(staged_t<S>);
  int qg = min(nq_all, DW_QMAX);
  while (qg > 1 && decode_smem(qg, a.D, a.bl, cs) > DW_SMEM_MAX) --qg;
  const size_t smem = decode_smem(qg, a.D, a.bl, cs);
  if (smem > DW_SMEM_MAX) return int(cudaErrorInvalidValue);
  a.qg = qg;
  const cudaError_t err = cudaFuncSetAttribute(
      decode_walk<T, S, QM, PV8>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(B * a.n_kv, (nq_all + qg - 1) / qg);
  decode_walk<T, S, QM, PV8><<<grid, DW_NT, smem, stream>>>(a);
  return int(cudaGetLastError());
}

}  // namespace wgt
