// K1: causal (or full) self-attention with a per-batch key mask, for the LLM
// prefill. Replaces walkgpt_tpu/ops/flash_attention.py:flash_attention
// (_fwd_kernel). Semantics kept from the TPU kernel:
//   * q, k and v are upcast to fp32 and q is scaled after the upcast;
//   * the value product takes fp32 probabilities;
//   * a masked logit is the finite -1e30 (a fully masked row averages v
//     instead of producing NaN), causal keys k <= q;
//   * key tiles wholly above the diagonal are skipped.
// q, k, v: [B, H, N, D] with any batch/head/row strides and unit stride on D;
// key_valid: [B, N] uint8; out: [B, H, N, D] contiguous; lse: [B, H, N] fp32.
#include "attention_tile.cuh"

namespace {

using namespace wgt;

template <typename T>
struct FlashProb {
  struct Args {
    const T* q;
    const T* k;
    const T* v;
    const uint8_t* key_valid;
    T* out;
    float* lse;
    int H, N, D, causal;
    int64_t sqb, sqh, sqn, skb, skh, skn, svb, svh, svn;
    float scale;
  };
  const T* qp;
  const T* kp;
  const T* vp;
  const uint8_t* kv;
  T* op;
  float* lp;
  int64_t sqn, skn, svn;
  int D, nq, nk, nkt, q0, causal;
  float scale;

  __device__ FlashProb(const Args& a, int qtile, int bh) {
    const int b = bh / a.H, h = bh - b * a.H;
    q0 = qtile * BQ;
    D = a.D;
    nq = min(BQ, a.N - q0);
    nk = a.N;
    causal = a.causal;
    const int ntiles = (a.N + BK - 1) / BK;
    nkt = causal ? min(ntiles, (q0 + BQ - 1) / BK + 1) : ntiles;
    qp = a.q + b * a.sqb + h * a.sqh;
    kp = a.k + b * a.skb + h * a.skh;
    vp = a.v + b * a.svb + h * a.svh;
    sqn = a.sqn;
    skn = a.skn;
    svn = a.svn;
    kv = a.key_valid + int64_t(b) * a.N;
    op = a.out + int64_t(bh) * a.N * a.D;
    lp = a.lse + int64_t(bh) * a.N;
    scale = a.scale;
  }
  __device__ float q(int r, int d) const { return to_f(qp[(q0 + r) * sqn + d]) * scale; }
  __device__ float k(int key, int d) const { return to_f(kp[key * skn + d]); }
  __device__ float v(int key, int d) const { return to_f(vp[key * svn + d]); }
  __device__ float logit(float s, int row, int key) const {
    const bool ok = kv[key] != 0 && (!causal || key <= row);
    return ok ? s : NEG_BIG;
  }
  __device__ float p_round(float p) const { return p; }
  __device__ void out(int r, int d, float x) const {
    op[int64_t(q0 + r) * D + d] = from_f<T>(x);
  }
  __device__ void lse(int r, float x) const { lp[q0 + r] = x; }
};

template <typename T>
int run(const void* q, const void* k, const void* v, const void* key_valid, void* out,
        void* lse, int B, int H, int N, int D, const int64_t* s, int causal,
        float scale, cudaStream_t st) {
  typename FlashProb<T>::Args a{
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(key_valid), static_cast<T*>(out),
      static_cast<float*>(lse), H, N, D, causal,
      s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], scale};
  const dim3 grid((N + BQ - 1) / BQ, B * H);
  return int(launch<FlashProb<T>>(a, D, grid, st));
}

}  // namespace

// strides: int64[9] = (q: batch, head, row), (k: ...), (v: ...), in elements.
// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the launch.
extern "C" int wg_flash_attention_fwd(const void* q, const void* k, const void* v,
                                      const void* key_valid, void* out, void* lse,
                                      int B, int H, int N, int D,
                                      const int64_t* strides, int causal, float scale,
                                      int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(q, k, v, key_valid, out, lse, B, H, N, D, strides, causal, scale, st);
  if (dtype == 1)
    return run<__nv_bfloat16>(q, k, v, key_valid, out, lse, B, H, N, D, strides, causal,
                              scale, st);
  return int(cudaErrorInvalidValue);
}
