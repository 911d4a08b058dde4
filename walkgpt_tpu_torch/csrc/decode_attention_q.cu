// K4: one decode step of GQA attention over the flat quantized KV cache.
// Replaces walkgpt_tpu/ops/flash_attention.py:decode_attention_q
// (_decode_attn_q8_kernel, _decode_attn_q_kernel, _decode_attn_q_block,
// _decode_attn_q_finish). Semantics kept from the TPU kernel, which walks the
// cache in blocks of `bl` keys in order; these rounding points are part of
// its numerics:
//   * scores: with qdot8, q quantized per head (qs = max(|q|max, 1e-20) /
//     127 as a multiply by 1/127, q8 = round(q / qs)), an exact integer
//     q8 . k, then s * (ks * (qs * scale)); without, q rounded to bf16,
//     an fp32 q . k, then s * (ks * scale);
//   * masked keys get the finite -1e30 and p = 0; blocks at or past
//     nvb = ceil(valid_len / bl) are skipped entirely;
//   * per block: m_new = max(m, max s), alpha = exp(m - m_new), l = l * alpha
//     + sum p with the unrounded alpha, acc = acc * bf16(alpha) + p_v . v,
//     where p_v = bf16(p * vs), or with pv8 p * vs quantized per kv head per
//     block (psc = max(max, 1e-20) / 127 as a multiply, round(pv / psc)),
//     an exact integer product, times psc;
//   * out = acc / max(bf16(l), 1e-30), in q's dtype.
// Cache layout: values [B, L, width] int8 of the layer, width = n_kv*D, or
// n_kv*D/2 packed int4 in global halves (byte j holds flat dims j in its
// low nibble and j + n_kv*D/2 in its high nibble; a head's dims live in one
// plane or straddle both); scales [B, n_kv, L] bf16; mask [B, L] bytes.
// Bound: bytes. The layer's cache below valid_len is the traffic the step
// needs (7B, 2 rows, 480 of 512 slots valid, packed int4: 4.1 MB, about
// 1.2 us at 3.35 TB/s); the products are few. The kernel reads whole
// blocks of keys (4.3 MB there).
// Design: one block of 256 threads per (row, kv head), the n_rep query heads
// of that kv head together, looping over the valid key blocks in order.
// Scores: a warp per key (lanes over D, coalesced bytes of the key's row),
// shuffle sums (exact for the integer scores). Softmax statistics: a warp
// per query head. Value product: a thread per (query head, dim), keys in
// order. Everything between blocks stays in shared memory.
#include "attention_tile.cuh"

namespace {

using namespace wgt;

constexpr int NT = 256;
constexpr int NW = NT / 32;

struct Args {
  const void* q;
  const int8_t* k;
  const __nv_bfloat16* ks;
  const int8_t* v;
  const __nv_bfloat16* vs;
  const uint8_t* mask;
  void* out;
  int H, n_kv, D, L, bl, nvb, pack4;
  float scale;
};

// the integer value of flat dim f of a cache row
__device__ __forceinline__ int cache_val(const int8_t* row, int f, int half, int pack4) {
  if (!pack4) return row[f];
  return f < half ? lo4(row[f]) : hi4(row[f - half]);
}

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

template <typename T, bool QDOT8, bool PV8>
__global__ void __launch_bounds__(NT) decode_attn_q(Args a) {
  extern __shared__ float smem[];
  const int n_rep = a.H / a.n_kv, D = a.D, bl = a.bl;
  float* qv = smem;                   // [n_rep][D]: q8 or bf16(q)
  float* acc = qv + n_rep * D;        // [n_rep][D]
  float* sp = acc + n_rep * D;        // [n_rep][bl]: scores, then p_v
  float* st = sp + n_rep * bl;        // [n_rep][4]: q scale, m, l, alpha; psc in [n_rep]
  float* psc = st + 4 * n_rep;        // [n_rep]
  const int b = blockIdx.x / a.n_kv, kv = blockIdx.x - b * a.n_kv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kd = a.n_kv * D, width = a.pack4 ? kd / 2 : kd, half = kd / 2;
  const T* q = static_cast<const T*>(a.q) + size_t(b) * a.H * D + size_t(kv) * n_rep * D;

  // the query heads kv*n_rep + r, r < n_rep (one warp each)
  for (int r = warp; r < n_rep; r += NW) {
    float mx = 0.f;
    for (int d = lane; d < D; d += 32) mx = fmaxf(mx, fabsf(to_f(q[r * D + d])));
    mx = warp_max(mx);
    const float qs = fmaxf(mx, 1e-20f) * (1.0f / 127.0f);
    for (int d = lane; d < D; d += 32) {
      const float x = to_f(q[r * D + d]);
      qv[r * D + d] = QDOT8 ? rintf(x / qs) : round_to<__nv_bfloat16>(x);
      acc[r * D + d] = 0.f;
    }
    if (lane == 0) {
      st[4 * r + 0] = QDOT8 ? qs * a.scale : a.scale;
      st[4 * r + 1] = NEG_BIG;
      st[4 * r + 2] = 0.f;
    }
  }
  __syncthreads();

  const int8_t* kb = a.k + size_t(b) * a.L * width;
  const int8_t* vb = a.v + size_t(b) * a.L * width;
  const __nv_bfloat16* ksr = a.ks + (size_t(b) * a.n_kv + kv) * a.L;
  const __nv_bfloat16* vsr = a.vs + (size_t(b) * a.n_kv + kv) * a.L;
  const uint8_t* mrow = a.mask + size_t(b) * a.L;
  for (int jb = 0; jb < a.nvb; ++jb) {
    const int j0 = jb * bl;
    // scores, a warp per key
    for (int j = warp; j < bl; j += NW) {
      const int key = j0 + j;
      const int8_t* row = kb + size_t(key) * width;
      const bool valid = mrow[key] != 0;
      const float ksv = __bfloat162float(ksr[key]);
      for (int r = 0; r < n_rep; ++r) {
        float s;
        if (QDOT8) {
          int si = 0;
          for (int d = lane; d < D; d += 32)
            si += int(qv[r * D + d]) * cache_val(row, kv * D + d, half, a.pack4);
          s = float(warp_sum(si));
        } else {
          float sf = 0.f;
          for (int d = lane; d < D; d += 32)
            sf += qv[r * D + d] * float(cache_val(row, kv * D + d, half, a.pack4));
          s = warp_sum(sf);
        }
        if (lane == 0) sp[r * bl + j] = valid ? s * (ksv * st[4 * r + 0]) : NEG_BIG;
      }
    }
    __syncthreads();
    // softmax statistics and p_v, a warp per query head
    for (int r = warp; r < n_rep; r += NW) {
      float mx = NEG_BIG;
      for (int j = lane; j < bl; j += 32) mx = fmaxf(mx, sp[r * bl + j]);
      mx = warp_max(mx);
      const float m_old = st[4 * r + 1];
      const float m_new = fmaxf(m_old, mx);
      const float alpha = expf(m_old - m_new);
      float lsum = 0.f, pmax = 0.f;
      for (int j = lane; j < bl; j += 32) {
        const float p = mrow[j0 + j] ? expf(sp[r * bl + j] - m_new) : 0.f;
        lsum += p;
        const float pf = p * __bfloat162float(vsr[j0 + j]);
        pmax = fmaxf(pmax, pf);
        sp[r * bl + j] = PV8 ? pf : round_to<__nv_bfloat16>(pf);
      }
      lsum = warp_sum(lsum);
      if (PV8) {
        pmax = warp_max(pmax);
        const float sc = fmaxf(pmax, 1e-20f) * (1.0f / 127.0f);
        for (int j = lane; j < bl; j += 32) sp[r * bl + j] = rintf(sp[r * bl + j] / sc);
        if (lane == 0) psc[r] = sc;
      }
      __syncwarp();
      if (lane == 0) {
        st[4 * r + 1] = m_new;
        st[4 * r + 2] = st[4 * r + 2] * alpha + lsum;
        st[4 * r + 3] = alpha;
      }
    }
    __syncthreads();
    // value product, a thread per (query head, dim), keys in order
    for (int i = threadIdx.x; i < n_rep * D; i += NT) {
      const int r = i / D, d = i - r * D, f = kv * D + d;
      float y;
      if (PV8) {
        int yi = 0;
        for (int j = 0; j < bl; ++j)
          yi += int(sp[r * bl + j]) * cache_val(vb + size_t(j0 + j) * width, f, half, a.pack4);
        y = float(yi) * psc[r];
      } else {
        y = 0.f;
        for (int j = 0; j < bl; ++j)
          y += sp[r * bl + j] * float(cache_val(vb + size_t(j0 + j) * width, f, half, a.pack4));
      }
      acc[i] = acc[i] * round_to<__nv_bfloat16>(st[4 * r + 3]) + y;
    }
    __syncthreads();
  }
  T* out = static_cast<T*>(a.out) + size_t(b) * a.H * D + size_t(kv) * n_rep * D;
  for (int i = threadIdx.x; i < n_rep * D; i += NT) {
    const int r = i / D;
    out[i] = from_f<T>(acc[i] / fmaxf(round_to<__nv_bfloat16>(st[4 * r + 2]), 1e-30f));
  }
}

template <typename T, bool QDOT8, bool PV8>
int launch_one(const Args& a, int B, cudaStream_t st) {
  const int n_rep = a.H / a.n_kv;
  const size_t smem = sizeof(float) * (2 * size_t(n_rep) * a.D + size_t(n_rep) * a.bl
                                       + 5 * size_t(n_rep));
  cudaError_t err = cudaFuncSetAttribute(decode_attn_q<T, QDOT8, PV8>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  decode_attn_q<T, QDOT8, PV8><<<B * a.n_kv, NT, smem, st>>>(a);
  return int(cudaGetLastError());
}

// pv8 applies with qdot8 only, as in the TPU kernels
template <typename T>
int run(const Args& a, int B, int qdot8, int pv8, cudaStream_t st) {
  if (qdot8 && pv8) return launch_one<T, true, true>(a, B, st);
  if (qdot8) return launch_one<T, true, false>(a, B, st);
  return launch_one<T, false, false>(a, B, st);
}

}  // namespace

// q: [B, H*D]; k, v: the layer's [B, L, width] int8; ks, vs: [B, n_kv, L] bf16;
// mask: [B, L] bytes; out: [B, H*D] in q's dtype. nvb: key blocks to visit.
// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the launch.
extern "C" int wg_decode_attention_q(const void* q, const void* k, const void* ks,
                                     const void* v, const void* vs, const void* mask, void* out,
                                     int B, int H, int n_kv, int D, int L, int bl, int nvb,
                                     int pack4, int qdot8, int pv8, float scale, int dtype,
                                     void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || n_kv <= 0 || H % n_kv || bl <= 0 || L % bl || nvb < 0 || nvb * bl > L)
    return int(cudaErrorInvalidValue);
  const Args a{q, static_cast<const int8_t*>(k), static_cast<const __nv_bfloat16*>(ks),
               static_cast<const int8_t*>(v), static_cast<const __nv_bfloat16*>(vs),
               static_cast<const uint8_t*>(mask), out, H, n_kv, D, L, bl, nvb, pack4, scale};
  if (dtype == 0) return run<float>(a, B, qdot8, pv8, st);
  if (dtype == 1) return run<__nv_bfloat16>(a, B, qdot8, pv8, st);
  return int(cudaErrorInvalidValue);
}
