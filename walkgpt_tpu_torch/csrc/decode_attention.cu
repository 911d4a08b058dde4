// K11: one decode step of GQA attention over the flat bf16 (or fp32) KV cache.
// Replaces walkgpt_tpu/ops/flash_attention.py:decode_attention
// (_decode_attn_kernel), the flat cache of LLMConfig.fused_decode. Numerics
// kept from the TPU kernel, per length block of `bl` keys, every block
// visited: q upcast to fp32 and multiplied by 1/sqrt(D) before the dot with
// the cache row; invalid keys -1e30 with p = 0; the unrounded alpha; p cast
// to the cache's type for the value product, fp32 sums; l = l * alpha +
// sum p; out = acc / max(l, 1e-30). Precondition (as in the TPU kernel):
// every row has a valid key in its first block.
// Cache layout: the layer's [B, L, n_kv*D] rows in the cache's type; mask
// [B, L] bytes.
// Bound: bytes. The k and v rows of the valid keys (dense 7B, 2 rows, 480 of
// 512 slots, bf16: 15.7 MB, about 4.7 us at 3.35 TB/s); the products are
// few. Design: the bf16 cache runs decode_flat.cuh (blocks split by value
// slices, the cache streamed by cp.async DF_ST - 1 tiles ahead, the scores'
// butterflies taken 8 keys at a time), which gives the bits of the first
// engine, decode_walk.cuh (one block per (row, kv head)). The fp32 cache
// stays on the walk, and
// wg_decode_attention_walk runs the bf16 cache there for comparisons.
#include "decode_flat.cuh"

namespace {

using namespace wgt;

DecodeArgs walk_args(const void* q, const void* k, const void* v, const void* mask, void* out,
                     int H, int n_kv, int D, int L, int bl, float scale) {
  DecodeArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.mask = static_cast<const uint8_t*>(mask);
  a.out = out;
  a.H = H;
  a.n_kv = n_kv;
  a.D = D;
  a.L = L;
  a.bl = bl;
  a.nvb = L / bl;
  a.Tc = 1;
  a.scale = scale;
  return a;
}

bool bad_shape(int B, int H, int n_kv, int D, int L, int bl) {
  return B <= 0 || n_kv <= 0 || D <= 0 || H % n_kv || bl <= 0 || L % bl;
}

}  // namespace

// q: [B, H*D]; k, v: the layer's [B, L, n_kv*D] in q's dtype; mask: [B, L]
// bytes; out: [B, H*D]. dtype: 0 = float32 (the walk), 1 = bfloat16
// (decode_flat.cuh). Returns cudaGetLastError() after the launch.
extern "C" int wg_decode_attention(const void* q, const void* k, const void* v,
                                   const void* mask, void* out, int B, int H, int n_kv, int D,
                                   int L, int bl, float scale, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, H, n_kv, D, L, bl)) return int(cudaErrorInvalidValue);
  if (dtype == 0)
    return decode_launch<float, float, Q_F32, false>(
        walk_args(q, k, v, mask, out, H, n_kv, D, L, bl, scale), B, st);
  if (dtype != 1) return int(cudaErrorInvalidValue);
  FlatArgs a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.mask = static_cast<const uint8_t*>(mask);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.H = H;
  a.n_kv = n_kv;
  a.D = D;
  a.L = L;
  a.bl = bl;
  a.nvb = L / bl;
  a.scale = scale;
  return flat_launch(a, B, st);
}

// wg_decode_attention on the walk (decode_walk.cuh) in both dtypes, the same
// arguments: the route the bf16 engine is held against, bit for bit.
extern "C" int wg_decode_attention_walk(const void* q, const void* k, const void* v,
                                        const void* mask, void* out, int B, int H, int n_kv,
                                        int D, int L, int bl, float scale, int dtype,
                                        void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, H, n_kv, D, L, bl)) return int(cudaErrorInvalidValue);
  const DecodeArgs a = walk_args(q, k, v, mask, out, H, n_kv, D, L, bl, scale);
  if (dtype == 0) return decode_launch<float, float, Q_F32, false>(a, B, st);
  if (dtype == 1) return decode_launch<__nv_bfloat16, __nv_bfloat16, Q_F32, false>(a, B, st);
  return int(cudaErrorInvalidValue);
}
