// K4 and K8: GQA attention over the flat quantized KV cache, one decode step
// (wg_decode_attention_q) or a chunk of Tc tokens (wg_decode_attention_q_chunk).
// Replaces walkgpt_tpu/ops/flash_attention.py:decode_attention_q
// (_decode_attn_q8_kernel, _decode_attn_q_kernel, _decode_attn_q_block,
// _decode_attn_q_finish) and :decode_attention_q_chunk (_decode_attn_qc_kernel,
// the speculative verify). Both run the engine of decode_walk.cuh, which
// keeps the TPU kernels' rounding points per DECODE_BLOCK-key block, so a
// chunk token's output is the one-step kernel's at the same position over the
// same cache, bit for bit (the property speculative decode's token identity
// rests on).
// K4: a key mask [B, L]; blocks at or past nvb = ceil(valid_len / bl) are
// skipped. K8: no mask; slot p is valid for chunk token t iff p < cache_len +
// t + 1 (the chunk's K/V already sit at [cache_len, cache_len + Tc), caches
// compact per row), and each row visits min(ceil((cache_len + Tc) / bl), L /
// bl) blocks.
// Cache layout: the layer's values [B, L, width] int8, width = n_kv*D, or
// n_kv*D/2 packed int4 in global halves; scales [B, n_kv, L] bf16.
// Bound: bytes. The codes and scales of the keys a step or chunk needs, read
// once (7B, 2 rows, packed int4: K4 at 480 valid slots 4.1 MB, about 1.2 us
// at 3.35 TB/s; K8 with Tc = 9 at cache_len ~440 and ~375 about 3.8 MB,
// about 1.1 us); the products are few. The design stages each block's codes
// once in shared memory for all Tc * n_rep query rows of a (row, kv head),
// so a chunk reads the cache once, not once per token.
#include "decode_walk.cuh"

namespace {

using namespace wgt;

// pv8 applies with qdot8 only, as in the TPU kernels
template <typename T>
int run(const DecodeArgs& a, int B, int qdot8, int pv8, cudaStream_t st) {
  if (qdot8 && pv8) return decode_launch<T, int8_t, Q_INT8, true>(a, B, st);
  if (qdot8) return decode_launch<T, int8_t, Q_INT8, false>(a, B, st);
  return decode_launch<T, int8_t, Q_BF16, false>(a, B, st);
}

DecodeArgs quant_args(const void* q, const void* k, const void* ks, const void* v,
                      const void* vs, void* out, int H, int n_kv, int D, int L, int bl,
                      int pack4, float scale) {
  DecodeArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.ks = static_cast<const __nv_bfloat16*>(ks);
  a.vs = static_cast<const __nv_bfloat16*>(vs);
  a.out = out;
  a.H = H;
  a.n_kv = n_kv;
  a.D = D;
  a.L = L;
  a.bl = bl;
  a.pack4 = pack4;
  a.scale = scale;
  return a;
}

bool bad_shape(int B, int H, int n_kv, int D, int L, int bl) {
  return B <= 0 || n_kv <= 0 || D <= 0 || H % n_kv || bl <= 0 || L % bl;
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
  if (bad_shape(B, H, n_kv, D, L, bl) || nvb < 0 || nvb * bl > L)
    return int(cudaErrorInvalidValue);
  DecodeArgs a = quant_args(q, k, ks, v, vs, out, H, n_kv, D, L, bl, pack4, scale);
  a.mask = static_cast<const uint8_t*>(mask);
  a.nvb = nvb;
  a.Tc = 1;
  if (dtype == 0) return run<float>(a, B, qdot8, pv8, st);
  if (dtype == 1) return run<__nv_bfloat16>(a, B, qdot8, pv8, st);
  return int(cudaErrorInvalidValue);
}

// q: [B, Tc, H*D]; k, v, ks, vs as above; cache_len: [B] int32 pre-chunk
// lengths; out: [B, Tc, H*D] in q's dtype.
extern "C" int wg_decode_attention_q_chunk(const void* q, const void* k, const void* ks,
                                           const void* v, const void* vs, const void* cache_len,
                                           void* out, int B, int Tc, int H, int n_kv, int D,
                                           int L, int bl, int pack4, int qdot8, float scale,
                                           int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, H, n_kv, D, L, bl) || Tc <= 0) return int(cudaErrorInvalidValue);
  DecodeArgs a = quant_args(q, k, ks, v, vs, out, H, n_kv, D, L, bl, pack4, scale);
  a.cache_len = static_cast<const int*>(cache_len);
  a.Tc = Tc;
  if (dtype == 0) return run<float>(a, B, qdot8, 0, st);
  if (dtype == 1) return run<__nv_bfloat16>(a, B, qdot8, 0, st);
  return int(cudaErrorInvalidValue);
}
