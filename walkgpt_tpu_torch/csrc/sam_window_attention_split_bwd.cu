// K10b: the backward of K10 (whole-window attention with the decomposed
// rel-pos bias over the split-head layout). Replaces
// walkgpt_tpu/ops/flash_attention.py:_win_vjp_bwd (_win_bwd_kernel).
// Semantics kept from the TPU kernel:
//   * s = (q * scale rounded to the input dtype) . k, plus the bias
//     rel_h[q, k / ws] + rel_w[q, k % ws], exactly as the forward formed it;
//   * p = exp(s - lse) in fp32 (unrounded, unlike the forward's value
//     product), dv = p^T . g, ds = p * (g . v^T - delta), dq = ds . k *
//     scale, dk = ds^T . q * scale with the unscaled q;
//   * drel_h[q, r] = sum of ds over the keys of window row r, drel_w[q, c]
//     over window column c, returned in the rel tables' dtype. The TPU
//     kernel pads these to 128 lanes (ws_pad) for its layout; here they are
//     written at their width ws.
// The TPU kernel keeps a whole [196, 196] fp32 ds tile of 8 window-heads in
// VMEM; here the 196 tokens stream in 64-row tiles through K2b's two
// passes: a dq pass that also sums drel, and a dk/dv pass, both
// recomputing p from the forward's lse, no atomics.
// q, k, v, g, dq, dk, dv [BW, H, T, D] contiguous; rel_h, rel_w, drel_h,
// drel_w [BW, H, T, ws] contiguous, in q's dtype or fp32; lse and delta
// [BW, H, T] fp32.
// Bound on an H100: ViT-H, 2 images (50 windows, 16 heads of 80, bf16):
// q, k, v, out, g and the three gradients about 201 MB, rel and drel
// 17.6 MB, lse 0.6 MB: about 219 MB (65 us at 3.35 TB/s) against
// 25 GFLOP (25 us at the bf16 tensor-core rate): bound by bytes.
// Routes, as K2b's (sam_window_attention_bwd.cu):
//   * bf16 q, k, v (rel tables in bf16 or fp32): the tensor-core engine
//     (attention_mma_bwd.cuh), two launches, with K2b's staging, bias and
//     drel products, the rel rows staged in their own dtype (as K10's
//     forward stages them); with bf16 tables the expressions are K2b's in
//     K2b's order, so on the same values K10b's gradients equal K2b's bit
//     for bit;
//   * fp32: the CUDA-core engine (attention_bwd.cuh), two launches.
#include "attention_bwd.cuh"
#include "attention_mma_bwd.cuh"

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

// The bf16 route's problem on the tensor-core engine (K2b's WindowBwdMma
// over the split layout); R: the rel tables' type.
template <typename R>
struct WindowSplitBwdMma {
  using bf16 = tc::bf16;
  static constexpr bool REL = true;
  static constexpr bool ONE_HOT = true;
  static constexpr bool TWO_LAUNCHES = true;
  static constexpr bool FAST = false;
  struct Args {
    const bf16* q;
    const bf16* k;
    const bf16* v;
    const R* rel_h;
    const R* rel_w;
    const bf16* g;
    const float* lse;
    const float* delta;
    bf16* dq;
    bf16* dk;
    bf16* dv;
    R* drel_h;
    R* drel_w;
    int T_, D, gh, gw;   // gh = gw = ws
    float scale;
    bool vec, rel_w4;
  };
  __host__ __device__ static size_t dq_extra_bytes(const Args& a) {
    return tc::WinRel<R>::bytes(a.gw, a.T_);
  }
  static size_t dkv_extra_bytes(const Args& a) { return tc::WinRel<R>::rows_bytes(a.gw); }

  const bf16* q;   // the (window, head)'s row 0 of q, k, v, g
  const bf16* k;
  const bf16* v;
  const bf16* g;
  const R* rh;     // its rel_h and rel_w rows (row stride ws)
  const R* rw;
  const float* lse;
  const float* delta;
  bf16* dqp;
  bf16* dkp;
  bf16* dvp;
  R* drhp;
  R* drwp;
  int64_t sq, sk, sv, sg;
  static constexpr int64_t sl = 1;
  bool vec, rel_w4;
  int N, NK, D, gh, gw;
  float scale;
  bf16 qscale;
  tc::WinRel<R> rel;   // the dq pass's staged rows

  __device__ WindowSplitBwdMma(const Args& a, int wh) {
    const int64_t off = int64_t(wh) * a.T_ * a.D;
    const int64_t roff = int64_t(wh) * a.T_ * a.gw;
    N = NK = a.T_;
    D = a.D;
    gh = gw = a.gw;
    scale = a.scale;
    qscale = __float2bfloat16_rn(a.scale);
    vec = a.vec;
    rel_w4 = a.rel_w4;
    sq = sk = sv = sg = a.D;
    q = a.q + off;
    k = a.k + off;
    v = a.v + off;
    g = a.g + off;
    dqp = a.dq + off;
    dkp = a.dk + off;
    dvp = a.dv + off;
    rh = a.rel_h + roff;
    rw = a.rel_w + roff;
    drhp = a.drel_h + roff;
    drwp = a.drel_w + roff;
    lse = a.lse + int64_t(wh) * a.T_;
    delta = a.delta + int64_t(wh) * a.T_;
  }
  __device__ void stage(int q0, char* extra) {
    rel.stage(rh + q0 * gw, rw + q0 * gw, gw, min(tc::BQ, N - q0), gw, N, rel_w4, extra);
  }
  __device__ void bias_qk(float (&s)[tc::NT][4], int k0, int row, int) const {
    rel.add(s, k0, row);
  }
  __device__ const uint16_t* kidx() const { return rel.kidx; }
  __device__ size_t tab_bytes() const { return tc::WinRel<R>::rows_bytes(gw); }
  __device__ void stage_q(int q0, int, char* buf) const {
    tc::WinRel<R>::stage_rows(rh + q0 * gw, rw + q0 * gw, gw, min(tc::BQ, N - q0), gw, rel_w4,
                              buf);
  }
  __device__ void bias_kq(float (&s)[tc::NT][4], int, int, int key, const char* buf) const {
    tc::win_bias_kq<R>(s, buf, gw, key, NK);
  }
  __device__ bf16* dq_row(int r) const { return dqp + int64_t(r) * D; }
  __device__ bf16* dk_row(int key) const { return dkp + int64_t(key) * D; }
  __device__ bf16* dv_row(int key) const { return dvp + int64_t(key) * D; }
  __device__ void drh(int r, int i, float x) const { drhp[int64_t(r) * gh + i] = from_f<R>(x); }
  __device__ void drw(int r, int i, float x) const { drwp[int64_t(r) * gw + i] = from_f<R>(x); }
};

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename R>
int launch_split(const void* q, const void* k, const void* v, const void* rel_h,
                 const void* rel_w, const void* g, const void* lse, const void* delta, void* dq,
                 void* dk, void* dv, void* drel_h, void* drel_w, int BW, int H, int T_, int D,
                 int ws, float scale, cudaStream_t st) {
  using bf16 = tc::bf16;
  if (ws > 255) return int(cudaErrorInvalidValue);   // the key table's 8-bit fields
  typename WindowSplitBwdMma<R>::Args a{
      static_cast<const bf16*>(q),     static_cast<const bf16*>(k),
      static_cast<const bf16*>(v),     static_cast<const R*>(rel_h),
      static_cast<const R*>(rel_w),    static_cast<const bf16*>(g),
      static_cast<const float*>(lse),  static_cast<const float*>(delta),
      static_cast<bf16*>(dq),          static_cast<bf16*>(dk),
      static_cast<bf16*>(dv),          static_cast<R*>(drel_h),
      static_cast<R*>(drel_w),         T_, D, ws, ws, scale,
      D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(g) &&
          aligned16(dq) && aligned16(dk) && aligned16(dv),
      (ws * sizeof(R)) % 4 == 0 && reinterpret_cast<uintptr_t>(rel_h) % 4 == 0 &&
          reinterpret_cast<uintptr_t>(rel_w) % 4 == 0};
  return int(tc::launch_bwd<WindowSplitBwdMma<R>>(a, D, BW * H, T_, T_, st));
}

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
// dtype or in float32. fp32 q runs the CUDA-core engine, bf16 q the
// tensor-core engine; either way two launches, the dq + drel pass then the
// dk/dv pass. Returns cudaGetLastError() after the launches.
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
    return launch_split<__nv_bfloat16>(q, k, v, rel_h, rel_w, g, lse, delta, dq, dk, dv, drel_h,
                                       drel_w, BW, H, T, D, ws, scale, st);
  if (dtype == 1 && rel_dtype == 0)
    return launch_split<float>(q, k, v, rel_h, rel_w, g, lse, delta, dq, dk, dv, drel_h, drel_w,
                               BW, H, T, D, ws, scale, st);
  return int(cudaErrorInvalidValue);
}
