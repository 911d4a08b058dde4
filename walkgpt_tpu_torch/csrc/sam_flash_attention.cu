// K3: global attention with the decomposed rel-pos bias, for the 4 global
// blocks of the SAM ViT encoder (N = 64*64 = 4096 keys). Replaces
// walkgpt_tpu/ops/flash_attention.py:sam_flash_attention (_sam_fwd_kernel).
// Semantics kept from the TPU kernel:
//   * q * scale is rounded to the input dtype (the scale too) before q.k;
//   * logit = (q.k + rel_w[q, k % gw]) + rel_h[q, k / gw], built per key tile
//     from the two [N, gh] / [N, gw] operands, never materialised as [N, N];
//   * probabilities are rounded to the input dtype for the value product,
//     softmax statistics stay fp32.
// q, k, v: [B, H, N, D] with any batch/head/row strides and unit stride on D;
// rel_h: [B, H, N, gh], rel_w: [B, H, N, gw] contiguous; out [B, H, N, D]
// contiguous; lse [B, H, N] fp32.
#include "attention_tile.cuh"

namespace {

using namespace wgt;

template <typename T>
struct GlobalProb {
  struct Args {
    const T* q;
    const T* k;
    const T* v;
    const T* rel_h;
    const T* rel_w;
    T* out;
    float* lse;
    int H, N, D, gh, gw;
    int64_t sqb, sqh, sqn, skb, skh, skn, svb, svh, svn;
    float scale;
  };
  const T* qp;
  const T* kp;
  const T* vp;
  const T* rh;
  const T* rw;
  T* op;
  float* lp;
  int64_t sqn, skn, svn;
  int D, nq, nk, nkt, q0, gh, gw;
  float scale;

  __device__ GlobalProb(const Args& a, int qtile, int bh) {
    const int b = bh / a.H, h = bh - b * a.H;
    q0 = qtile * BQ;
    D = a.D;
    gh = a.gh;
    gw = a.gw;
    nq = min(BQ, a.N - q0);
    nk = a.N;
    nkt = (a.N + BK - 1) / BK;
    qp = a.q + b * a.sqb + h * a.sqh;
    kp = a.k + b * a.skb + h * a.skh;
    vp = a.v + b * a.svb + h * a.svh;
    sqn = a.sqn;
    skn = a.skn;
    svn = a.svn;
    rh = a.rel_h + int64_t(bh) * a.N * a.gh;
    rw = a.rel_w + int64_t(bh) * a.N * a.gw;
    op = a.out + int64_t(bh) * a.N * a.D;
    lp = a.lse + int64_t(bh) * a.N;
    scale = round_to<T>(a.scale);
  }
  __device__ float q(int r, int d) const {
    return round_to<T>(to_f(qp[(q0 + r) * sqn + d]) * scale);
  }
  __device__ float k(int key, int d) const { return to_f(kp[key * skn + d]); }
  __device__ float v(int key, int d) const { return to_f(vp[key * svn + d]); }
  __device__ float logit(float s, int row, int key) const {
    const int kh = key / gw;
    return (s + to_f(rw[int64_t(row) * gw + (key - kh * gw)])) + to_f(rh[int64_t(row) * gh + kh]);
  }
  __device__ float p_round(float p) const { return round_to<T>(p); }
  __device__ void out(int r, int d, float x) const {
    op[int64_t(q0 + r) * D + d] = from_f<T>(x);
  }
  __device__ void lse(int r, float x) const { lp[q0 + r] = x; }
};

template <typename T>
int run(const void* q, const void* k, const void* v, const void* rel_h, const void* rel_w,
        void* out, void* lse, int B, int H, int N, int D, int gh, int gw, const int64_t* s,
        float scale, cudaStream_t st) {
  typename GlobalProb<T>::Args a{
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(rel_h), static_cast<const T*>(rel_w), static_cast<T*>(out),
      static_cast<float*>(lse), H, N, D, gh, gw,
      s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], scale};
  const dim3 grid((N + BQ - 1) / BQ, B * H);
  return int(launch<GlobalProb<T>>(a, D, grid, st));
}

}  // namespace

// strides: int64[9] = (q: batch, head, row), (k: ...), (v: ...), in elements.
// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the launch.
extern "C" int wg_sam_flash_attention_fwd(const void* q, const void* k, const void* v,
                                          const void* rel_h, const void* rel_w, void* out,
                                          void* lse, int B, int H, int N, int D, int gh,
                                          int gw, const int64_t* strides, float scale,
                                          int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(q, k, v, rel_h, rel_w, out, lse, B, H, N, D, gh, gw, strides, scale,
                      st);
  if (dtype == 1)
    return run<__nv_bfloat16>(q, k, v, rel_h, rel_w, out, lse, B, H, N, D, gh, gw, strides,
                              scale, st);
  return int(cudaErrorInvalidValue);
}
