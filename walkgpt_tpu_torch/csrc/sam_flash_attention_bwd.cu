// K3b: the backward of K3 (global attention with the decomposed rel-pos
// bias, the SAM ViT encoder's global blocks over the 64x64 grid). Replaces
// walkgpt_tpu/ops/flash_attention.py:_sam_flash_bwd (_sam_dq_kernel and
// _sam_dkv_kernel). Semantics kept from the TPU kernels:
//   * s = (q * scale rounded to the input dtype) . k, then
//     (s + rel_w[q, k % gw]) + rel_h[q, k / gw], the bias built per key
//     tile from the [N, gh] and [N, gw] operands as the forward builds it;
//   * p = exp(s - lse) in fp32; dq and dk are scaled at the end;
//   * drel_h and drel_w accumulate in the dq pass, q-indexed, while the
//     key tiles stream (each (row, grid row) and (row, grid column) summed
//     by one thread in key order).
// q, k, v, g, dq, dk, dv [B, H, N, D] contiguous; rel_h, drel_h
// [B, H, N, gh]; rel_w, drel_w [B, H, N, gw]; lse and delta [B, H, N] fp32.
// Bound on an H100: ViT-H, 2 images, [2, 16, 4096, 80] bf16: five products
// of 2*D flops per (query, key) pair, about 430 GFLOP (434 us at the bf16
// tensor-core rate) against about 200 MB of traffic (60 us): bound by
// operations.
// This first version runs them on the CUDA cores in fp32.
#include "attention_bwd.cuh"

namespace {

using namespace wgt;

template <typename T>
struct GlobalBwd {
  static constexpr bool REL = true;
  struct Args {
    const T* q;
    const T* k;
    const T* v;
    const T* rel_h;
    const T* rel_w;
    const T* g;
    const float* lse;
    const float* delta;
    T* dq;
    T* dk;
    T* dv;
    T* drel_h;
    T* drel_w;
    int N, D, gh, gw;
    float scale;
  };
  const T* qp;
  const T* kp;
  const T* vp;
  const T* gp;
  const T* rh;
  const T* rw;
  const float* lp;
  const float* dlp;
  T* dqp;
  T* dkp;
  T* dvp;
  T* drhp;
  T* drwp;
  int N, NK, D, gh, gw;
  float scale, qscale;

  __device__ GlobalBwd(const Args& a, int bh) {
    const int64_t off = int64_t(bh) * a.N * a.D;
    N = NK = a.N;
    D = a.D;
    gh = a.gh;
    gw = a.gw;
    scale = a.scale;
    qscale = round_to<T>(a.scale);
    qp = a.q + off;
    kp = a.k + off;
    vp = a.v + off;
    gp = a.g + off;
    dqp = a.dq + off;
    dkp = a.dk + off;
    dvp = a.dv + off;
    rh = a.rel_h + int64_t(bh) * a.N * a.gh;
    drhp = a.drel_h + int64_t(bh) * a.N * a.gh;
    rw = a.rel_w + int64_t(bh) * a.N * a.gw;
    drwp = a.drel_w + int64_t(bh) * a.N * a.gw;
    lp = a.lse + int64_t(bh) * a.N;
    dlp = a.delta + int64_t(bh) * a.N;
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
    return (s + to_f(rw[int64_t(row) * gw + (key - kh * gw)])) + to_f(rh[int64_t(row) * gh + kh]);
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
  __device__ void drh(int r, int i, float x) const { drhp[int64_t(r) * gh + i] = from_f<T>(x); }
  __device__ void drw(int r, int i, float x) const { drwp[int64_t(r) * gw + i] = from_f<T>(x); }
};

template <typename T>
int run(const void* q, const void* k, const void* v, const void* rel_h, const void* rel_w,
        const void* g, const void* lse, const void* delta, void* dq, void* dk, void* dv,
        void* drel_h, void* drel_w, int B, int H, int N, int D, int gh, int gw, float scale,
        cudaStream_t st) {
  typename GlobalBwd<T>::Args a{
      static_cast<const T*>(q),      static_cast<const T*>(k),      static_cast<const T*>(v),
      static_cast<const T*>(rel_h),  static_cast<const T*>(rel_w),  static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<T*>(dq),
      static_cast<T*>(dk),           static_cast<T*>(dv),           static_cast<T*>(drel_h),
      static_cast<T*>(drel_w),       N, D, gh, gw, scale};
  return int(launch_bwd<GlobalBwd<T>>(a, D, B * H, N, N, gh + gw, st));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// two launches (dq + drel pass, then dk/dv pass).
extern "C" int wg_sam_flash_attention_bwd(const void* q, const void* k, const void* v,
                                          const void* rel_h, const void* rel_w, const void* g,
                                          const void* lse, const void* delta, void* dq, void* dk,
                                          void* dv, void* drel_h, void* drel_w, int B, int H,
                                          int N, int D, int gh, int gw, float scale, int dtype,
                                          void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(q, k, v, rel_h, rel_w, g, lse, delta, dq, dk, dv, drel_h, drel_w, B, H, N,
                      D, gh, gw, scale, st);
  if (dtype == 1)
    return run<__nv_bfloat16>(q, k, v, rel_h, rel_w, g, lse, delta, dq, dk, dv, drel_h, drel_w,
                              B, H, N, D, gh, gw, scale, st);
  return int(cudaErrorInvalidValue);
}
