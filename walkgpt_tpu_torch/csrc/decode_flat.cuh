// The engine of K11's bf16 route (decode_attention.cu: wg_decode_attention):
// one decode step of GQA attention over the flat bf16 cache of
// LLMConfig.fused_decode. It reproduces decode_walk.cuh:walk_block's
// arithmetic for the flat fp cache (QM = Q_F32, S = bf16) exactly, per
// `bl`-key block and in block order, so it equals the walk bit for bit (the
// walk stays reachable as wg_decode_attention_walk for that comparison, and
// keeps the fp32 cache):
//   * qv = fp32(q) * scale; s = the key's lane-strided fp32 sum over D
//     (lane l: d = l, l + 32, ...), then the xor butterfly of walk_block's
//     warp_sum; invalid keys -1e30 and p = 0;
//   * m_new = max(m, block max), alpha = exp(m - m_new), p = exp(s -
//     m_new), lsum lane-strided then the butterfly, l = l * alpha + lsum
//     with the unrounded alpha;
//   * p_v = bf16(p); y = the key-ordered fp32 sum of p_v * v; acc = acc *
//     alpha + y; out = acc / max(l, 1e-30) in bf16.
// Bound: bytes (dense 7B, 2 rows, 480 of 512 slots valid: the k and v rows
// of the valid keys, 15.7 MB, about 4.7 us at 3.35 TB/s).
// Design. The walk ran one block per (row, kv head): 64 blocks at the 7B
// step on 132 SMs, each loading its rows synchronously, 2 bytes a thread,
// three barriers per 64 keys. Here a block of 256 threads takes one (row,
// kv head), up to 16 of its n_rep query rows and a slice of 32 value dims
// (grid B * n_kv x query groups x ceil(D / 32): 256 blocks at 7B, 320 at
// 13B, two resident on an SM). Each block recomputes its rows' scores and
// softmax, which are cheap, and runs its own slice's value chains, so the
// block order of the recurrence stays inside one block. The block streams
// its cache through a ring of DF_ST slots of DF_KT keys, filled by 16-byte
// cp.async copies DF_ST - 1 tiles ahead: for each `bl`-key block the head's
// k rows tile by tile, then the value slice tile by tile; one barrier per
// tile (two at the block's last k tile, for the softmax). Scores: a warp
// per 8 keys of a tile; each lane forms its lane-strided partial sum for
// each key, and the butterflies of the 8 keys are taken together (at xor
// offsets 16, 8 and 4 a lane sends the half of its keys that its partner
// keeps: 7 exchanges, then offsets 2 and 1), the same sums of the same
// pairs as walk_block's warp_sum, 9 shuffles for 8 keys instead of 40.
// Value chains in registers, a thread per (query row, dim), at most two.
// Rows that are not 16-byte aligned (D % 8 != 0, an unaligned base) take a
// synchronous element-wise staging into the same ring.
#pragma once

#include "decode_walk.cuh"

namespace wgt {

constexpr int DF_NT = 256;
constexpr int DF_NW = DF_NT / 32;
constexpr int DF_QG = 16;      // query rows per block
constexpr int DF_DS = 32;      // value dims per block
constexpr int DF_KT = 64;      // keys per staged tile (DF_NW warps x 8 keys)
constexpr int DF_ST = 4;       // ring slots: DF_ST - 1 tiles in flight

struct FlatArgs {
  const __nv_bfloat16* q;        // [B, H*D]
  const __nv_bfloat16* k;        // the layer's cache [B, L, n_kv*D]
  const __nv_bfloat16* v;
  const uint8_t* mask;           // [B, L]
  __nv_bfloat16* out;            // [B, H*D]
  int H, n_kv, D, L, bl, nvb;
  int qg;                        // query rows per block
  float scale;
};

// Shared memory of a block, in bytes: the ring [DF_ST][DF_KT][D] bf16 (a k
// tile holds D dims a key, a value tile DF_DS), qv [qg][D] fp32, sp
// [qg][spS] fp32 (scores, then p_v) and st [qg][4] (m, l, alpha).
struct FlatSmem {
  int slot, spS, ring, qv, sp, st, bytes;
  __host__ __device__ FlatSmem(int D, int bl, int qg) {
    slot = DF_KT * (D > DF_DS ? D : DF_DS) * 2;
    spS = (bl + 3) & ~3;
    ring = 0;
    qv = DF_ST * slot;
    sp = qv + qg * D * 4;
    st = sp + qg * spS * 4;
    bytes = st + qg * 16;
  }
};

// 16-byte cp.async copies: every head row and value slice 16-byte aligned
__host__ __device__ inline bool flat_vec(const FlatArgs& a) {
  return a.D % 8 == 0 && (reinterpret_cast<uintptr_t>(a.k) & 15) == 0
         && (reinterpret_cast<uintptr_t>(a.v) & 15) == 0;
}

__device__ __forceinline__ void df_cp16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void df_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void df_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Block (b * n_kv + kv, query group, value slice of DF_DS dims).
template <bool VEC>
__global__ void __launch_bounds__(DF_NT, 2) flat_walk(FlatArgs a) {
  extern __shared__ __align__(16) unsigned char dsm[];
  const int n_rep = a.H / a.n_kv, D = a.D, bl = a.bl, L = a.L;
  const int b = blockIdx.x / a.n_kv, kv = blockIdx.x - b * a.n_kv;
  const int g0 = blockIdx.y * a.qg, nq = min(a.qg, n_rep - g0);
  const int d0 = blockIdx.z * DF_DS, dsw = min(DF_DS, D - d0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const FlatSmem sm(D, bl, a.qg);
  const int spS = sm.spS;
  float* qv = reinterpret_cast<float*>(dsm + sm.qv);
  float* sp = reinterpret_cast<float*>(dsm + sm.sp);
  float* st = reinterpret_cast<float*>(dsm + sm.st);
  auto slot = [&](int t) {
    return reinterpret_cast<__nv_bfloat16*>(dsm + sm.ring + (t % DF_ST) * sm.slot);
  };
  const int kd = a.n_kv * D;
  const uint8_t* mrow = a.mask + size_t(b) * L;
  const __nv_bfloat16* kb = a.k + size_t(b) * L * kd + kv * D;
  const __nv_bfloat16* vb = a.v + size_t(b) * L * kd + kv * D + d0;
  // query row qi of this block -> offset of its [D] slice in q and out
  auto q_off = [&](int qi) { return (size_t(b) * a.H + kv * n_rep + g0 + qi) * D; };

  for (int qi = warp; qi < nq; qi += DF_NW) {
    const __nv_bfloat16* qr = a.q + q_off(qi);
    for (int d = lane; d < D; d += 32) qv[qi * D + d] = to_f(qr[d]) * a.scale;
    if (lane == 0) {
      st[4 * qi + 0] = NEG_BIG;
      st[4 * qi + 1] = 0.f;
    }
  }

  // tile t of the stream: per key block jb, nkt k tiles, then nkt value tiles
  const int nkt = (bl + DF_KT - 1) / DF_KT, ntiles = a.nvb * 2 * nkt;
  auto fetch_tile = [&](int t) {
    const int jb = t / (2 * nkt), r = t - jb * 2 * nkt, kt = r < nkt ? r : r - nkt;
    const int key0 = jb * bl + kt * DF_KT, nk = min(DF_KT, bl - kt * DF_KT);
    const bool is_v = r >= nkt;
    const int w = is_v ? dsw : D, ws = is_v ? DF_DS : D;     // dims a key, slot row stride
    const __nv_bfloat16* src = (is_v ? vb : kb) + size_t(key0) * kd;
    __nv_bfloat16* dst = slot(t);
    if (VEC) {
      const int cpr = w / 8;
      for (int c = tid; c < nk * cpr; c += DF_NT) {
        const int j = c / cpr, e = (c - j * cpr) * 8;
        df_cp16(dst + j * ws + e, src + size_t(j) * kd + e);
      }
    } else {
      for (int i = tid; i < nk * w; i += DF_NT) {
        const int j = i / w, e = i - j * w;
        dst[j * ws + e] = src[size_t(j) * kd + e];
      }
    }
  };

  // value chains: thread tid owns chains tid and tid + DF_NT of nq * dsw
  const int nch = nq * dsw;
  float acc[2] = {0.f, 0.f}, y[2] = {0.f, 0.f};
#pragma unroll
  for (int t = 0; t < DF_ST - 1; ++t) {
    if (t < ntiles) fetch_tile(t);
    df_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    df_wait<DF_ST - 2>();
    __syncthreads();   // tile t landed for all; tile t - 1's slot is free
    if (t + DF_ST - 1 < ntiles) fetch_tile(t + DF_ST - 1);
    df_commit();
    const int jb = t / (2 * nkt), r = t - jb * 2 * nkt, j0 = jb * bl;
    const __nv_bfloat16* tile = slot(t);
    if (r < nkt) {
      // scores of this tile's keys, 8 a warp
      const int kt0 = r * DF_KT, nk = min(DF_KT, bl - kt0), c0 = warp * 8;
      for (int qi = 0; qi < nq; ++qi) {
        // each key's partial sum in walk_block's order (d = lane, lane + 32, ...)
        float v8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        const __nv_bfloat16* rows = tile + c0 * D;
        for (int d = lane; d < D; d += 32) {
          const float qd = qv[qi * D + d];
#pragma unroll
          for (int c = 0; c < 8; ++c) v8[c] += qd * to_f(rows[c * D + d]);
        }
#pragma unroll
        for (int c = 0; c < 8; ++c)
          if (c0 + c >= nk) v8[c] = 0.f;      // past the block's end: stale slot rows
        // the 8 butterflies together: at offset o a lane keeps the half of
        // its keys selected by (lane & o) and adds its partner's sums of them
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const bool up = lane & 16;
          const float send = up ? v8[c] : v8[c + 4], keep = up ? v8[c + 4] : v8[c];
          v8[c] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
        }
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const bool up = lane & 8;
          const float send = up ? v8[c] : v8[c + 2], keep = up ? v8[c + 2] : v8[c];
          v8[c] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
        }
        {
          const bool up = lane & 4;
          const float send = up ? v8[0] : v8[1], keep = up ? v8[1] : v8[0];
          v8[0] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
        }
        v8[0] += __shfl_xor_sync(0xffffffffu, v8[0], 2);
        v8[0] += __shfl_xor_sync(0xffffffffu, v8[0], 1);
        const int key = c0 + (lane >> 2);     // lane bits 4, 3, 2 name the key
        if ((lane & 3) == 0 && key < nk)
          sp[qi * spS + kt0 + key] = mrow[j0 + kt0 + key] != 0 ? v8[0] : NEG_BIG;
      }
      if (r == nkt - 1) {
        __syncthreads();
        // softmax statistics and p_v, a warp per query row (walk_block's)
        for (int qi = warp; qi < nq; qi += DF_NW) {
          float mx = NEG_BIG;
          for (int j = lane; j < bl; j += 32) mx = fmaxf(mx, sp[qi * spS + j]);
          mx = warp_max(mx);
          const float m_old = st[4 * qi + 0];
          const float m_new = fmaxf(m_old, mx);
          const float alpha = expf(m_old - m_new);
          float lsum = 0.f;
          for (int j = lane; j < bl; j += 32) {
            const float p = mrow[j0 + j] != 0 ? expf(sp[qi * spS + j] - m_new) : 0.f;
            lsum += p;
            sp[qi * spS + j] = round_to<__nv_bfloat16>(p);
          }
          lsum = warp_sum(lsum);
          if (lane == 0) {
            st[4 * qi + 0] = m_new;
            st[4 * qi + 1] = st[4 * qi + 1] * alpha + lsum;
            st[4 * qi + 2] = alpha;
          }
        }
      }
    } else {
      // value chains over this tile's keys in order
      const int kt0 = (r - nkt) * DF_KT, nk = min(DF_KT, bl - kt0);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ci = tid + h * DF_NT;
        if (ci < nch) {
          const int qi = ci / dsw, dl = ci - qi * dsw;
          const float* pr = sp + qi * spS + kt0;
          const __nv_bfloat16* vc = tile + dl;
          float yy = y[h];
          for (int j = 0; j < nk; ++j) yy += pr[j] * to_f(vc[j * DF_DS]);
          y[h] = yy;
          if (r == 2 * nkt - 1) {
            acc[h] = acc[h] * st[4 * qi + 2] + yy;
            y[h] = 0.f;
          }
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int ci = tid + h * DF_NT;
    if (ci < nch) {
      const int qi = ci / dsw, dl = ci - qi * dsw;
      a.out[q_off(qi) + d0 + dl] = from_f<__nv_bfloat16>(acc[h] / fmaxf(st[4 * qi + 1], 1e-30f));
    }
  }
}

// Launch over grid (B * n_kv, query groups of DF_QG, value slices of DF_DS).
// Returns a cudaError_t as int.
inline int flat_launch(FlatArgs a, int B, cudaStream_t stream) {
  const int n_rep = a.H / a.n_kv;
  a.qg = min(n_rep, DF_QG);
  const FlatSmem sm(a.D, a.bl, a.qg);
  if (sm.bytes > int(DW_SMEM_MAX)) return int(cudaErrorInvalidValue);
  const dim3 grid(B * a.n_kv, (n_rep + a.qg - 1) / a.qg, (a.D + DF_DS - 1) / DF_DS);
  auto go = [&](auto kernel) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sm.bytes);
    if (err != cudaSuccess) return int(err);
    kernel<<<grid, DF_NT, sm.bytes, stream>>>(a);
    return int(cudaGetLastError());
  };
  return flat_vec(a) ? go(flat_walk<true>) : go(flat_walk<false>);
}

}  // namespace wgt
