// K10b: the backward of K10 (whole-window attention with the decomposed
// rel-pos bias over the split-head layout). Replaces
// walkgpt_tpu/ops/flash_attention.py:_win_vjp_bwd (_win_bwd_kernel).
// Semantics kept from the TPU kernel:
//   * s = (q * scale rounded to the input dtype) . k, plus the bias
//     rel_h[q, k / ws] + rel_w[q, k % ws], exactly as the forward formed it;
//   * p = exp(s - lse) in fp32 (unrounded, unlike the forward's value
//     product), dv = p^T . g, ds = p * (g . v^T - delta), dq = ds . k *
//     scale, dk = ds^T . q * scale with the unscaled fp32 q;
//   * drel_h[q, r] = sum of ds over the keys of window row r, drel_w[q, c]
//     over window column c, returned in the rel tables' dtype. The TPU
//     kernel pads these to 128 lanes (ws_pad) for its layout; here they are
//     written at their width ws.
// The TPU kernel keeps a whole [196, 196] fp32 ds tile of 8 window-heads in
// VMEM; here the 196 tokens stream in 64-row tiles through K2b's two-pass
// engine (attention_bwd.cuh): a dq pass that also sums drel, and a dk/dv
// pass, both recomputing p from the forward's lse, no atomics.
// q, k, v, g, dq, dk, dv [BW, H, T, D] contiguous; rel_h, rel_w, drel_h,
// drel_w [BW, H, T, ws] contiguous, in q's dtype or fp32; lse and delta
// [BW, H, T] fp32.
// Bound on an H100: ViT-H, 2 images (50 windows, 16 heads of 80, bf16):
// q, k, v, out, g and the three gradients about 201 MB, rel and drel
// 17.6 MB, lse 0.6 MB: about 219 MB (65 us at 3.35 TB/s) against
// 25 GFLOP (25 us at the bf16 tensor-core rate): bound by bytes.
#include "attention_bwd.cuh"

namespace {

using namespace wgt;

template <typename T, typename R>
struct WindowSplitBwd {
  static constexpr bool REL = true;
  struct Args {
    const T* q;
    const T* k;
    const T* v;
    const R* rel_h;
    const R* rel_w;
    const T* g;
    const float* lse;
    const float* delta;
    T* dq;
    T* dk;
    T* dv;
    R* drel_h;
    R* drel_w;
    int T_, D, ws;
    float scale;
  };
  const T* qp;
  const T* kp;
  const T* vp;
  const T* gp;
  const R* rh;
  const R* rw;
  const float* lp;
  const float* dlp;
  T* dqp;
  T* dkp;
  T* dvp;
  R* drhp;
  R* drwp;
  int N, NK, D, gh, gw;
  float scale, qscale;

  __device__ WindowSplitBwd(const Args& a, int wh) {
    const int64_t off = int64_t(wh) * a.T_ * a.D;
    const int64_t roff = int64_t(wh) * a.T_ * a.ws;
    N = NK = a.T_;
    D = a.D;
    gh = gw = a.ws;
    scale = a.scale;
    qscale = round_to<T>(a.scale);
    qp = a.q + off;
    kp = a.k + off;
    vp = a.v + off;
    gp = a.g + off;
    dqp = a.dq + off;
    dkp = a.dk + off;
    dvp = a.dv + off;
    rh = a.rel_h + roff;
    rw = a.rel_w + roff;
    drhp = a.drel_h + roff;
    drwp = a.drel_w + roff;
    lp = a.lse + int64_t(wh) * a.T_;
    dlp = a.delta + int64_t(wh) * a.T_;
  }
  __device__ float qr(int r, int d) const { return to_f(qp[int64_t(r) * D + d]); }
  __device__ float qs(int r, int d) const { return round_to<T>(qr(r, d) * qscale); }
  __device__ float k(int key, int d) const { return to_f(kp[int64_t(key) * D + d]); }
  __device__ float v(int key, int d) const { return to_f(vp[int64_t(key) * D + d]); }
  __device__ float g(int r, int d) const { return to_f(gp[int64_t(r) * D + d]); }
  __device__ float lse(int r) const { return lp[r]; }
  __device__ float delta(int r) const { return dlp[r]; }
  __device__ float logit(float s, int row, int key) const {
    const int kh = key / gw;
    const int64_t o = int64_t(row) * gw;
    return s + (to_f(rh[o + kh]) + to_f(rw[o + (key - kh * gw)]));
  }
  __device__ bool valid(int, int) const { return true; }
  __device__ int dq_key_tiles(int) const { return (NK + BK - 1) / BK; }
  __device__ int dkv_first_qtile(int) const { return 0; }
  __device__ void dq(int r, int d, float x) const { dqp[int64_t(r) * D + d] = from_f<T>(x); }
  __device__ void dk(int key, int d, float x) const {
    dkp[int64_t(key) * D + d] = from_f<T>(x);
  }
  __device__ void dv(int key, int d, float x) const {
    dvp[int64_t(key) * D + d] = from_f<T>(x);
  }
  __device__ void drh(int r, int i, float x) const { drhp[int64_t(r) * gh + i] = from_f<R>(x); }
  __device__ void drw(int r, int i, float x) const { drwp[int64_t(r) * gw + i] = from_f<R>(x); }
};

template <typename T, typename R>
int run(const void* q, const void* k, const void* v, const void* rel_h, const void* rel_w,
        const void* g, const void* lse, const void* delta, void* dq, void* dk, void* dv,
        void* drel_h, void* drel_w, int BW, int H, int T_, int D, int ws, float scale,
        cudaStream_t st) {
  typename WindowSplitBwd<T, R>::Args a{
      static_cast<const T*>(q),      static_cast<const T*>(k),      static_cast<const T*>(v),
      static_cast<const R*>(rel_h),  static_cast<const R*>(rel_w),  static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<T*>(dq),
      static_cast<T*>(dk),           static_cast<T*>(dv),           static_cast<R*>(drel_h),
      static_cast<R*>(drel_w),       T_, D, ws, scale};
  return int(launch_bwd<WindowSplitBwd<T, R>>(a, D, BW * H, T_, T_, 2 * ws, st));
}

}  // namespace

// dtype / rel_dtype: 0 = float32, 1 = bfloat16; the rel tables are in q's
// dtype or in float32. Returns cudaGetLastError() after the two launches
// (dq + drel pass, then dk/dv pass).
extern "C" int wg_sam_window_split_bwd(const void* q, const void* k, const void* v,
                                       const void* rel_h, const void* rel_w, const void* g,
                                       const void* lse, const void* delta, void* dq, void* dk,
                                       void* dv, void* drel_h, void* drel_w, int BW, int H,
                                       int T, int D, int ws, float scale, int dtype,
                                       int rel_dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && rel_dtype == 0)
    return run<float, float>(q, k, v, rel_h, rel_w, g, lse, delta, dq, dk, dv, drel_h, drel_w,
                             BW, H, T, D, ws, scale, st);
  if (dtype == 1 && rel_dtype == 1)
    return run<__nv_bfloat16, __nv_bfloat16>(q, k, v, rel_h, rel_w, g, lse, delta, dq, dk, dv,
                                             drel_h, drel_w, BW, H, T, D, ws, scale, st);
  if (dtype == 1 && rel_dtype == 0)
    return run<__nv_bfloat16, float>(q, k, v, rel_h, rel_w, g, lse, delta, dq, dk, dv, drel_h,
                                     drel_w, BW, H, T, D, ws, scale, st);
  return int(cudaErrorInvalidValue);
}
