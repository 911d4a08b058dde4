// K4 and K8: GQA attention over the flat quantized KV cache, one decode step
// (wg_decode_attention_q) or a chunk of Tc tokens (wg_decode_attention_q_chunk).
// Replaces walkgpt_tpu/ops/flash_attention.py:decode_attention_q
// (_decode_attn_q8_kernel, _decode_attn_q_kernel, _decode_attn_q_block,
// _decode_attn_q_finish) and :decode_attention_q_chunk (_decode_attn_qc_kernel,
// the speculative verify). Both run the engine of decode_chunk.cuh (K4 at
// Tc = 1 with a key mask); K4's int8 value product (pv_int8, not on the main
// path) runs the engine of decode_walk.cuh, whose rounding points per
// DECODE_BLOCK-key block both engines keep, so a chunk token's output is the
// one-step kernel's at the same position over the same cache, bit for bit
// (the property speculative decode's token identity rests on), and K4 on
// either engine gives the same bits. wg_decode_attention_q_walk runs K4 on
// the walk in every mode: the comparison that holds the two engines equal
// (chip_smoke.py, tools/decode_kernels.py) calls it; the wrapper never does.
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
// about 1.1 us); the products are few. The design (blocks split by value
// dims, 16-byte staging, int8 tensor-core scores) is in decode_chunk.cuh.
#include "decode_chunk.cuh"

namespace {

using namespace wgt;

// K4 on the walk; pv8 applies with qdot8 only, as in the TPU kernels
template <typename T>
int run_walk(const DecodeArgs& a, int B, int qdot8, int pv8, cudaStream_t st) {
  if (qdot8 && pv8) return decode_launch<T, int8_t, Q_INT8, true>(a, B, st);
  if (qdot8) return decode_launch<T, int8_t, Q_INT8, false>(a, B, st);
  return decode_launch<T, int8_t, Q_BF16, false>(a, B, st);
}

// K4: the chunk engine under a key mask (value slices of DC_DS_STEP dims
// while a block's n_rep query rows allow it), or the walk for the int8 value
// product (which the chunk engine does not have)
template <typename T, int QM>
int run_step(const ChunkArgs& c, int B, cudaStream_t st) {
  const int qg = min(c.H / c.n_kv, DC_QG);
  return qg * DC_DS_STEP <= 2 * DC_NT ? chunk_launch<T, QM, KeyMask, DC_DS_STEP>(c, B, st)
                                      : chunk_launch<T, QM, KeyMask, DC_DS>(c, B, st);
}

template <typename T>
int run(const DecodeArgs& a, const ChunkArgs& c, int B, int qdot8, int pv8, cudaStream_t st) {
  if (qdot8 && pv8) return run_walk<T>(a, B, qdot8, pv8, st);
  return qdot8 ? run_step<T, Q_INT8>(c, B, st) : run_step<T, Q_BF16>(c, B, st);
}

template <typename T>
int run_chunk(const ChunkArgs& a, int B, int qdot8, cudaStream_t st) {
  return qdot8 ? chunk_launch<T, Q_INT8, CausalChunk>(a, B, st)
               : chunk_launch<T, Q_BF16, CausalChunk>(a, B, st);
}

ChunkArgs chunk_args(const void* q, const void* k, const void* ks, const void* v,
                     const void* vs, void* out, int Tc, int H, int n_kv, int D, int L, int bl,
                     int pack4, float scale) {
  ChunkArgs a{};
  a.q = q;
  a.k = static_cast<const int8_t*>(k);
  a.v = static_cast<const int8_t*>(v);
  a.ks = static_cast<const __nv_bfloat16*>(ks);
  a.vs = static_cast<const __nv_bfloat16*>(vs);
  a.out = out;
  a.Tc = Tc;
  a.H = H;
  a.n_kv = n_kv;
  a.D = D;
  a.L = L;
  a.bl = bl;
  a.pack4 = pack4;
  a.scale = scale;
  return a;
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
// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q read and out written in
// fp16; the bf16 q's rounding points otherwise). Returns cudaGetLastError()
// after the launch.
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
  ChunkArgs c = chunk_args(q, k, ks, v, vs, out, 1, H, n_kv, D, L, bl, pack4, scale);
  c.mask = static_cast<const uint8_t*>(mask);
  c.nvb = nvb;
  if (dtype == 0) return run<float>(a, c, B, qdot8, pv8, st);
  if (dtype == 1) return run<__nv_bfloat16>(a, c, B, qdot8, pv8, st);
  if (dtype == 2) return run<__half>(a, c, B, qdot8, pv8, st);
  return int(cudaErrorInvalidValue);
}

// wg_decode_attention_q on the walk (decode_walk.cuh) in every mode, the same
// arguments: the route the chunk engine is held against, bit for bit.
extern "C" int wg_decode_attention_q_walk(const void* q, const void* k, const void* ks,
                                          const void* v, const void* vs, const void* mask,
                                          void* out, int B, int H, int n_kv, int D, int L,
                                          int bl, int nvb, int pack4, int qdot8, int pv8,
                                          float scale, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, H, n_kv, D, L, bl) || nvb < 0 || nvb * bl > L)
    return int(cudaErrorInvalidValue);
  DecodeArgs a = quant_args(q, k, ks, v, vs, out, H, n_kv, D, L, bl, pack4, scale);
  a.mask = static_cast<const uint8_t*>(mask);
  a.nvb = nvb;
  a.Tc = 1;
  if (dtype == 0) return run_walk<float>(a, B, qdot8, pv8, st);
  if (dtype == 1) return run_walk<__nv_bfloat16>(a, B, qdot8, pv8, st);
  if (dtype == 2) return run_walk<__half>(a, B, qdot8, pv8, st);
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
  ChunkArgs a = chunk_args(q, k, ks, v, vs, out, Tc, H, n_kv, D, L, bl, pack4, scale);
  a.cache_len = static_cast<const int*>(cache_len);
  if (dtype == 0) return run_chunk<float>(a, B, qdot8, st);
  if (dtype == 1) return run_chunk<__nv_bfloat16>(a, B, qdot8, st);
  return int(cudaErrorInvalidValue);
}
