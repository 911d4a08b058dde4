// The engine of K8 (decode_attention_q.cu: wg_decode_attention_q_chunk, a
// chunk of Tc query tokens against the flat quantized cache, the verify pass
// of speculative decode) and of K4 (wg_decode_attention_q, one decode step
// over the same cache with an arbitrary key mask, Tc = 1) in every mode but
// the int8 value product (pv_int8, off on the main path), which stays on
// decode_walk.cuh with K11's fp32 cache, and of K12's attention phase
// (fused_layer.cu, which calls chunk_block from its own cooperative kernel
// on banded_q8's codes and scales, fp32 rows out). This engine reproduces
// walk_block's arithmetic exactly, per DECODE_BLOCK block and in block
// order, so K4 here equals K4 on the walk bit for bit (the walk route stays
// reachable as wg_decode_attention_q_walk for that comparison), and chunk
// token t equals K4 at position cache_len + t bit for bit:
//   * Q_INT8: q8 = rint(q / qs), qs = max(|q|max, 1e-20) * (1/127), per
//     (token, head) (or q8 and qs given: K12's input); s = int(q8 . k) *
//     (ks * (qs * scale)); Q_BF16: s =
//     bf16(q) . k in fp32, summed lane-strided over D then by the xor
//     butterfly (walk_block's warp_sum), times (ks * scale);
//   * the Rule says which keys a query row attends: K8's CausalChunk (slot
//     p is valid for token t iff p < cache_len + t + 1) or K4's KeyMask
//     (mask[b, p], over the wrapper's nvb blocks); invalid keys get -1e30
//     and p = 0;
//   * m_new = max(m, block max), alpha = exp(m - m_new), p = exp(s - m_new),
//     lsum lane-strided then the butterfly, l = l * alpha + lsum;
//   * p_v = bf16(p * vs); y = the key-ordered fp32 sum of p_v * v (each
//     product exact); acc = acc * bf16(alpha) + y;
//   * out = acc / max(bf16(l), 1e-30) in q's dtype.
// Bound: bytes (the codes and scales of the keys below cache_len + Tc; 7B at
// Tc = 9, cache_len 440 and 375: 3.8 MB, about 1.1 us at 3.35 TB/s; K4 at
// 7B, 2 rows, 480 valid slots: 4.1 MB, about 1.2 us).
// Design. A block of 256 threads takes one (row, kv head), up to 16 of its
// Tc * n_rep query rows and a slice of 32 value dims (grid B * n_kv x query
// groups x ceil(D / 32): 256 blocks at 7B, 128 at 1B, against the walk's
// 64 and 32; K4, one token, takes 64 value dims a block while n_rep <= 8:
// 128 blocks at 7B with 2 rows, 256 with the server's 4, one query row
// each, n_rep = Tc = 1). Each block recomputes the whole scores and
// softmax of its rows, which are cheap, and runs the value product of its
// own dims, so the block order of the recurrence stays inside one block.
// Per 256-key block:
//   * staging: the head's codes (its 128-byte run of the slot row; packed
//     int4 holds it in the low or the high nibbles) and the value slice are
//     loaded 16 bytes a thread into registers one block ahead, then written
//     to shared memory as int8 codes (times 16 for packed int4: the nibble
//     in the high half of each byte, by a mask) and as fp32 values (bit
//     operations, no int-to-float conversion); heads that straddle the two
//     nibble planes (an odd n_kv) or rows that are not 16-byte aligned take
//     a byte-wise path;
//   * Q_INT8 scores on the tensor cores: int8 mma.sync m16n8k32 with exact
//     int32 sums (the 16-row query tile padded with zeros), a warp per 32
//     keys; Q_BF16 scores a warp per key as in walk_block;
//   * softmax statistics a warp per query row, as in walk_block;
//   * the value product on the CUDA cores: a thread per (query row, dim)
//     chain over the block's keys in order, acc in registers;
//   * four barriers per block of 256 keys (the walk: three per 64 keys).
#pragma once

#include "decode_walk.cuh"

namespace wgt {

constexpr int DC_NT = 256;
constexpr int DC_NW = DC_NT / 32;
constexpr int DC_QG = 16;      // query rows per block (one mma row tile)
constexpr int DC_DS = 32;      // value dims per block
constexpr int DC_DS_STEP = 64; // value dims per block of K4's plan at few query rows
constexpr int DC_KCH = 8;      // 16-byte key chunks a thread holds ahead

struct ChunkArgs {
  const void* q;                 // [B, Tc, H*D] in T
  const int8_t* q8;              // Q_INT8 only: q already quantized [B, Tc, H*D] with
  const float* qsc;              // its scales [B, Tc, H], or both null
  const int8_t* k;               // the layer's cache values [B, L, width]
  const int8_t* v;
  const __nv_bfloat16* ks;       // [B, n_kv, L]
  const __nv_bfloat16* vs;
  const int* cache_len;          // [B] pre-chunk lengths (CausalChunk)
  const uint8_t* mask;           // [B, L] key mask (KeyMask)
  void* out;                     // [B, Tc, H*D] in T
  int Tc, H, n_kv, D, L, bl, pack4;
  int nvb;                       // key blocks to visit (KeyMask)
  int qg;                        // query rows per block
  float scale;
};

// The keys a block's query row qi attends, and the key blocks the block
// walks: K8's causal chunk (slot p is valid for token t iff p < cache_len +
// t + 1; min(ceil((cache_len + Tc) / bl), L / bl) blocks) or K4's key mask
// (mask[b, key]; the wrapper's nvb blocks).
struct CausalChunk {
  int cl, n_rep, g0, nvb;
  __device__ CausalChunk(const ChunkArgs& a, int b, int g0_)
      : cl(a.cache_len[b]), n_rep(a.H / a.n_kv), g0(g0_),
        nvb(min((a.cache_len[b] + a.Tc + a.bl - 1) / a.bl, a.L / a.bl)) {}
  __device__ bool valid(int qi, int key) const { return key < cl + (g0 + qi) / n_rep + 1; }
};
struct KeyMask {
  const uint8_t* m;
  int nvb;
  __device__ KeyMask(const ChunkArgs& a, int b, int) : m(a.mask + size_t(b) * a.L), nvb(a.nvb) {}
  __device__ bool valid(int, int key) const { return m[key] != 0; }
};

__host__ __device__ constexpr int dc_align16(int x) { return (x + 15) & ~15; }

// Shared memory of a block, in bytes: key codes kt [blp][KS] int8 (KS = Dp +
// 16, Dp = D rounded up to 32; the 16 bytes of padding keep the mma
// fragments' reads free of bank conflicts), values vf [blp][ds] fp32, scores
// / p_v sp [qg][spS] fp32, the query tile (Q_INT8: int8 [16][KS]; Q_BF16:
// bf16(q) as fp32 [qg][D]) and the statistics st [qg][4].
struct ChunkSmem {
  int KS, spS, kt, vf, sp, qt, st, bytes;
  __host__ __device__ ChunkSmem(int D, int bl, int qg, bool qint8, int ds) {
    const int blp = (bl + 7) & ~7;
    KS = ((D + 31) & ~31) + 16;
    spS = (bl + 3) & ~3;
    kt = 0;
    vf = dc_align16(kt + blp * KS);
    sp = vf + blp * ds * 4;
    qt = sp + qg * spS * 4;
    st = dc_align16(qt + (qint8 ? DC_QG * KS : qg * D * 4));
    bytes = st + qg * 16;
  }
};

// How a cache row's bytes hold a head: vec (the head's D bytes are one
// 16-byte-aligned run in one nibble plane, D % 16 == 0, and a block's
// chunks fit the registers held ahead: DC_KCH key chunks and DS / 16 value
// chunks a thread), else byte-wise.
__host__ __device__ inline bool chunk_vec(const ChunkArgs& a) {
  const int kd = a.n_kv * a.D, width = a.pack4 ? kd / 2 : kd;
  const bool planes = !a.pack4 || (kd / 2) % a.D == 0;
  return a.D % 16 == 0 && width % 16 == 0 && planes && a.bl % 8 == 0
         && a.bl * (a.D / 16) <= DC_NT * DC_KCH && a.bl <= DC_NT
         && (reinterpret_cast<uintptr_t>(a.k) & 15) == 0
         && (reinterpret_cast<uintptr_t>(a.v) & 15) == 0;
}

// 16 raw bytes -> 16 fp32 values: mode 0 int8 codes, 1 the low nibbles, 2 the
// high nibbles (the code + bias put into the low byte of 2^23, minus 2^23 +
// bias: exact)
__device__ __forceinline__ void values16(const uint4& w, int mode, float* out) {
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
  const float bias = mode == 0 ? 8388736.f : 8388616.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t u = mode == 0 ? ws[q] ^ 0x80808080u
                     : mode == 1 ? (ws[q] & 0x0F0F0F0Fu) ^ 0x08080808u
                                 : ((ws[q] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
    float4 f;
    f.x = __int_as_float(__byte_perm(u, 0x4B00u, 0x5440u)) - bias;
    f.y = __int_as_float(__byte_perm(u, 0x4B00u, 0x5441u)) - bias;
    f.z = __int_as_float(__byte_perm(u, 0x4B00u, 0x5442u)) - bias;
    f.w = __int_as_float(__byte_perm(u, 0x4B00u, 0x5443u)) - bias;
    *reinterpret_cast<float4*>(out + 4 * q) = f;
  }
}

// 16 raw bytes -> 16 int8 scores codes: mode 0 as they are, 1 / 2 the low /
// high nibble in the high half of each byte (the code times 16)
__device__ __forceinline__ uint4 codes16(uint4 w, int mode) {
  if (mode == 1) {
    w.x = (w.x << 4) & 0xF0F0F0F0u; w.y = (w.y << 4) & 0xF0F0F0F0u;
    w.z = (w.z << 4) & 0xF0F0F0F0u; w.w = (w.w << 4) & 0xF0F0F0F0u;
  } else if (mode == 2) {
    w.x &= 0xF0F0F0F0u; w.y &= 0xF0F0F0F0u; w.z &= 0xF0F0F0F0u; w.w &= 0xF0F0F0F0u;
  }
  return w;
}

// 16 bytes of the cache (read-only while the kernel runs; no L1 allocation)
__device__ __forceinline__ uint4 dc_ld16(const int8_t* p) {
  uint4 r;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}

__device__ __forceinline__ void mma_s8_16832(int d[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One block's work: row b, kv head kv, query group gy (rows [gy * qg, ...)
// of that kv head), value dims [d0, d0 + DS), with ChunkSmem's bytes of
// shared memory at dsm (all DC_NT threads of the block call it). T: q/out
// type; QM: Q_INT8 or Q_BF16; VEC: chunk_vec(a); Rule: CausalChunk (K8) or
// KeyMask (K4, K12); DS: DC_DS, or DC_DS_STEP for K4 and K12 at few query
// rows (each thread still owns at most two value chains).
template <typename T, int QM, bool VEC, class Rule, int DS>
__device__ __forceinline__ void chunk_block(const ChunkArgs& a, int b, int kv, int gy, int d0,
                                            unsigned char* dsm) {
  constexpr int VCH = DS / 16;   // 16-byte value chunks a thread holds ahead
  const int n_rep = a.H / a.n_kv, D = a.D, bl = a.bl, L = a.L;
  const int g0 = gy * a.qg, nq = min(a.qg, a.Tc * n_rep - g0);
  const int dsw = min(DS, D - d0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const ChunkSmem sm(D, bl, a.qg, QM == Q_INT8, DS);
  const int KS = sm.KS, spS = sm.spS, blp = (bl + 7) & ~7;
  int8_t* kt = reinterpret_cast<int8_t*>(dsm + sm.kt);
  float* vf = reinterpret_cast<float*>(dsm + sm.vf);
  float* sp = reinterpret_cast<float*>(dsm + sm.sp);
  int8_t* qt = reinterpret_cast<int8_t*>(dsm + sm.qt);
  float* qv = reinterpret_cast<float*>(dsm + sm.qt);
  float* st = reinterpret_cast<float*>(dsm + sm.st);

  const int kd = a.n_kv * D, half = kd / 2, width = a.pack4 ? half : kd;
  // the head's byte run and nibble plane (VEC: one run in one plane)
  const int hoff = a.pack4 && kv * D >= half ? kv * D - half : kv * D;
  const int mode = a.pack4 ? (kv * D >= half ? 2 : 1) : 0;
  const Rule rule(a, b, g0);
  const int nvb = rule.nvb;
  auto q_off = [&](int qi) {
    const int g = g0 + qi, t = g / n_rep, head = kv * n_rep + (g - t * n_rep);
    return ((size_t(b) * a.Tc + t) * a.H + head) * D;
  };
  auto valid = [&](int qi, int key) { return rule.valid(qi, key); };

  // zero the key tile (padding dims and keys stay zero) and the query tile,
  // once the block's previous item is done with shared memory
  __syncthreads();
  for (int i = tid * 16; i < sm.sp; i += DC_NT * 16)
    *reinterpret_cast<uint4*>(dsm + i) = make_uint4(0, 0, 0, 0);
  if (QM == Q_INT8)
    for (int i = tid * 16; i < DC_QG * KS; i += DC_NT * 16)
      *reinterpret_cast<uint4*>(qt + i) = make_uint4(0, 0, 0, 0);
  __syncthreads();
  const T* qb = static_cast<const T*>(a.q);
  for (int qi = warp; qi < nq; qi += DC_NW) {
    const T* qr = qb + q_off(qi);
    float qs = 1.f;
    if (QM == Q_INT8 && a.q8) {
      qs = a.qsc[q_off(qi) / D];
    } else if (QM == Q_INT8) {
      float mx = 0.f;
      for (int d = lane; d < D; d += 32) mx = fmaxf(mx, fabsf(to_f(qr[d])));
      mx = warp_max(mx);
      qs = fmaxf(mx, 1e-20f) * (1.0f / 127.0f);
    }
    for (int d = lane; d < D; d += 32) {
      if (QM == Q_INT8 && a.q8) qt[qi * KS + d] = a.q8[q_off(qi) + d];
      else if (QM == Q_INT8) qt[qi * KS + d] = int8_t(rintf(to_f(qr[d]) / qs));
      else qv[qi * D + d] = round_to<__nv_bfloat16>(to_f(qr[d]));
    }
    if (lane == 0) {
      st[4 * qi + 0] = QM == Q_INT8 ? qs * a.scale : a.scale;
      st[4 * qi + 1] = NEG_BIG;
      st[4 * qi + 2] = 0.f;
    }
  }

  const size_t row0 = size_t(b) * L;
  const __nv_bfloat16* ksr = a.ks + (size_t(b) * a.n_kv + kv) * L;
  const __nv_bfloat16* vsr = a.vs + (size_t(b) * a.n_kv + kv) * L;
  const int kcpr = D / 16, vcpr = dsw / 16;      // 16-byte chunks per key (VEC)
  uint4 kr[DC_KCH], vr[VCH];
  // VEC: the block's raw key and value chunks into registers
  auto fetch = [&](int j0) {
#pragma unroll
    for (int i = 0; i < DC_KCH; ++i) {
      const int c = tid + i * DC_NT, j = c / kcpr;
      if (j < bl)
        kr[i] = dc_ld16(a.k + (row0 + j0 + j) * width + hoff + (c - j * kcpr) * 16);
    }
#pragma unroll
    for (int i = 0; i < VCH; ++i) {
      const int c = tid + i * DC_NT, j = c / vcpr;
      if (j < bl)
        vr[i] = dc_ld16(a.v + (row0 + j0 + j) * width + hoff + d0 + (c - j * vcpr) * 16);
    }
  };
  // the block's codes and values into shared memory
  auto stage = [&](int j0) {
    if (VEC) {
#pragma unroll
      for (int i = 0; i < DC_KCH; ++i) {
        const int c = tid + i * DC_NT, j = c / kcpr;
        if (j < bl)
          *reinterpret_cast<uint4*>(kt + j * KS + (c - j * kcpr) * 16) = codes16(kr[i], mode);
      }
#pragma unroll
      for (int i = 0; i < VCH; ++i) {
        const int c = tid + i * DC_NT, j = c / vcpr;
        if (j < bl) values16(vr[i], mode, vf + j * DS + (c - j * vcpr) * 16);
      }
    } else {
      for (int i = tid; i < bl * D; i += DC_NT) {
        const int j = i / D, d = i - j * D, f = kv * D + d;
        const int8_t* row = a.k + (row0 + j0 + j) * width;
        kt[j * KS + d] =
            !a.pack4 ? row[f] : int8_t(16 * (f < half ? lo4(row[f]) : hi4(row[f - half])));
      }
      for (int i = tid; i < bl * dsw; i += DC_NT) {
        const int j = i / dsw, dl = i - j * dsw, f = kv * D + d0 + dl;
        const int8_t* row = a.v + (row0 + j0 + j) * width;
        vf[j * DS + dl] =
            float(!a.pack4 ? row[f] : f < half ? lo4(row[f]) : hi4(row[f - half]));
      }
    }
  };

  // value chains: thread tid owns chains tid and tid + DC_NT of nq * dsw
  const int nch = nq * dsw;
  float acc[2] = {0.f, 0.f};
  if (VEC && nvb > 0) fetch(0);
  for (int jb = 0; jb < nvb; ++jb) {
    const int j0 = jb * bl;
    __syncthreads();                 // the previous block's readers are done
    stage(j0);
    if (VEC && jb + 1 < nvb) fetch(j0 + bl);
    __syncthreads();
    // scores
    if (QM == Q_INT8) {
      const int g = lane >> 2, tq = lane & 3, ksteps = KS / 32;
      for (int nt = warp; nt * 8 < blp; nt += DC_NW) {
        int c[4] = {0, 0, 0, 0};
        for (int kk = 0; kk < ksteps; ++kk) {
          const int o = kk * 32 + tq * 4;
          const uint32_t af[4] = {*reinterpret_cast<const uint32_t*>(qt + g * KS + o),
                                  *reinterpret_cast<const uint32_t*>(qt + (g + 8) * KS + o),
                                  *reinterpret_cast<const uint32_t*>(qt + g * KS + o + 16),
                                  *reinterpret_cast<const uint32_t*>(qt + (g + 8) * KS + o + 16)};
          const int8_t* kr8 = kt + (nt * 8 + g) * KS + o;
          const uint32_t bf[2] = {*reinterpret_cast<const uint32_t*>(kr8),
                                  *reinterpret_cast<const uint32_t*>(kr8 + 16)};
          mma_s8_16832(c, af, bf);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = g + (e >> 1) * 8, key = nt * 8 + tq * 2 + (e & 1);
          if (qi < nq && key < bl) {
            const int si = a.pack4 ? c[e] >> 4 : c[e];
            const float ksv = __bfloat162float(ksr[j0 + key]);
            sp[qi * spS + key] =
                valid(qi, j0 + key) ? float(si) * (ksv * st[4 * qi + 0]) : NEG_BIG;
          }
        }
      }
    } else {
      for (int j = warp; j < bl; j += DC_NW) {
        const int8_t* row = kt + j * KS;
        const float ksv = __bfloat162float(ksr[j0 + j]);
        for (int qi = 0; qi < nq; ++qi) {
          float sf = 0.f;
          for (int d = lane; d < D; d += 32)
            sf += qv[qi * D + d] * float(a.pack4 ? int(row[d]) >> 4 : int(row[d]));
          const float s = warp_sum(sf);
          if (lane == 0)
            sp[qi * spS + j] = valid(qi, j0 + j) ? s * (ksv * st[4 * qi + 0]) : NEG_BIG;
        }
      }
    }
    __syncthreads();
    // softmax statistics and p_v, a warp per query row
    for (int qi = warp; qi < nq; qi += DC_NW) {
      float mx = NEG_BIG;
      for (int j = lane; j < bl; j += 32) mx = fmaxf(mx, sp[qi * spS + j]);
      mx = warp_max(mx);
      const float m_old = st[4 * qi + 1];
      const float m_new = fmaxf(m_old, mx);
      const float alpha = expf(m_old - m_new);
      float lsum = 0.f;
      for (int j = lane; j < bl; j += 32) {
        const float p = valid(qi, j0 + j) ? expf(sp[qi * spS + j] - m_new) : 0.f;
        lsum += p;
        const float pf = p * __bfloat162float(vsr[j0 + j]);
        sp[qi * spS + j] = round_to<__nv_bfloat16>(pf);
      }
      lsum = warp_sum(lsum);
      if (lane == 0) {
        st[4 * qi + 1] = m_new;
        st[4 * qi + 2] = st[4 * qi + 2] * alpha + lsum;
        st[4 * qi + 3] = alpha;
      }
    }
    __syncthreads();
    // value product: each chain's keys in order
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ci = tid + h * DC_NT;
      if (ci < nch) {
        const int qi = ci / dsw, dl = ci - qi * dsw;
        const float* pr = sp + qi * spS;
        const float* vc = vf + dl;
        float y = 0.f;
        int j = 0;
        for (; j + 4 <= bl; j += 4) {
          const float4 p4 = *reinterpret_cast<const float4*>(pr + j);
          y += p4.x * vc[(j + 0) * DS];
          y += p4.y * vc[(j + 1) * DS];
          y += p4.z * vc[(j + 2) * DS];
          y += p4.w * vc[(j + 3) * DS];
        }
        for (; j < bl; ++j) y += pr[j] * vc[j * DS];
        acc[h] = acc[h] * round_to<__nv_bfloat16>(st[4 * qi + 3]) + y;
      }
    }
  }
  __syncthreads();
  T* ob = static_cast<T*>(a.out);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int ci = tid + h * DC_NT;
    if (ci < nch) {
      const int qi = ci / dsw, dl = ci - qi * dsw;
      const float l = st[4 * qi + 2];
      ob[q_off(qi) + d0 + dl] =
          from_f<T>(acc[h] / fmaxf(round_to<__nv_bfloat16>(l), 1e-30f));
    }
  }
}

// Grid (B * n_kv, query groups, value slices of DS dims).
template <typename T, int QM, bool VEC, class Rule, int DS>
__global__ void __launch_bounds__(DC_NT, 2) chunk_walk(ChunkArgs a) {
  extern __shared__ __align__(16) unsigned char dsm[];
  const int b = blockIdx.x / a.n_kv;
  chunk_block<T, QM, VEC, Rule, DS>(a, b, blockIdx.x - b * a.n_kv, blockIdx.y, blockIdx.z * DS,
                                    dsm);
}

// Launch over grid (B * n_kv, query groups of DC_QG, value slices of DS):
// K8 takes DS = DC_DS; K4 (one token) DC_DS_STEP while its query rows a
// block hold at most two value chains a thread (n_rep <= 8), which halves
// its blocks (one wave of two blocks an SM at 7B, 4 rows) with the same
// chains. Returns a cudaError_t as int.
template <typename T, int QM, class Rule, int DS = DC_DS>
int chunk_launch(ChunkArgs a, int B, cudaStream_t stream) {
  const int nq_all = a.Tc * (a.H / a.n_kv);
  a.qg = min(nq_all, DC_QG);
  const ChunkSmem sm(a.D, a.bl, a.qg, QM == Q_INT8, DS);
  if (sm.bytes > int(DW_SMEM_MAX)) return int(cudaErrorInvalidValue);
  if (a.qg * DS > 2 * DC_NT) return int(cudaErrorInvalidValue);   // two chains a thread
  const dim3 grid(B * a.n_kv, (nq_all + a.qg - 1) / a.qg, (a.D + DS - 1) / DS);
  auto go = [&](auto kernel) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sm.bytes);
    if (err != cudaSuccess) return int(err);
    kernel<<<grid, DC_NT, sm.bytes, stream>>>(a);
    return int(cudaGetLastError());
  };
  return chunk_vec(a) ? go(chunk_walk<T, QM, true, Rule, DS>)
                      : go(chunk_walk<T, QM, false, Rule, DS>);
}

}  // namespace wgt
