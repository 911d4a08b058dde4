// K10: whole-window attention with the decomposed rel-pos bias over the
// split-head layout. Replaces walkgpt_tpu/ops/flash_attention.py:
// sam_window_attention (_win_fwd_kernel). Semantics kept from the TPU kernel:
//   * q * scale is rounded to the input dtype before the q.k product (the
//     scale itself is rounded to the input dtype first);
//   * bias[q, k] = rel_h[q, k / ws] + rel_w[q, k % ws], formed in fp32 from
//     rel tables in q's dtype or in fp32, then added to the fp32 logit;
//   * probabilities are rounded to v's dtype for the value product, the
//     softmax denominator uses the unrounded ones; zero-padded window tokens
//     are attended (no mask).
// This is K2's per-head function in another layout, so each route runs K2's
// engine with a problem object that addresses q, k, v [BW, H, T, D] (any
// batch/head/row strides, unit stride on D) and rel_h, rel_w [BW, H, T, ws]
// contiguous; out [BW, H, T, D] contiguous, lse [BW, H, T] fp32. One block
// per (64-query tile, window*head). The TPU's grouping of 8 window-heads
// per grid step (WINDOW_GROUP) is a TPU grid choice and is not carried
// over: Hopper's 132 SMs take the 4 x 800 blocks of ViT-H's 2-image shape
// directly. Routes, as K2's (sam_window_attention.cu):
//   * bf16 q, k, v (rel tables in bf16 or fp32): the tensor-core engine
//     (attention_mma.cuh) with the tile's rel rows staged in shared memory
//     in their own dtype and the key -> (k / ws, k % ws) table;
//   * fp32: the CUDA-core engine (attention_tile.cuh).
// The logits, the bias and the products are K2's on each route, so on the
// same values K10's out and lse equal K2's bit for bit.
// Bound on an H100: ViT-H, 2 images, q/k/v [50, 16, 196, 80] bf16 with rel
// [50, 16, 196, 14]: q, k, v and out about 100 MB, rel 8.8 MB, lse 0.6 MB:
// about 110 MB (33 us at 3.35 TB/s) against 9.8 GFLOP (10 us at the bf16
// tensor-core rate): bound by bytes.
#include "attention_mma.cuh"
#include "attention_tile.cuh"

namespace {

using namespace wgt;

template <typename T, typename R>
struct WindowSplitProb {
  struct Args {
    const T* q;
    const T* k;
    const T* v;
    const R* rel_h;
    const R* rel_w;
    T* out;
    float* lse;
    int H, T_, D, ws;
    int64_t sqb, sqh, sqn, skb, skh, skn, svb, svh, svn;
    float scale;
  };
  const T* qp;
  const T* kp;
  const T* vp;
  const R* rh;
  const R* rw;
  T* op;
  float* lp;
  int64_t sqn, skn, svn;
  int D, nq, nk, nkt, q0, ws;
  float scale;

  __device__ WindowSplitProb(const Args& a, int qtile, int wh) {
    const int w = wh / a.H, h = wh - w * a.H;
    q0 = qtile * BQ;
    D = a.D;
    ws = a.ws;
    nq = min(BQ, a.T_ - q0);
    nk = a.T_;
    nkt = (a.T_ + BK - 1) / BK;
    qp = a.q + w * a.sqb + h * a.sqh;
    kp = a.k + w * a.skb + h * a.skh;
    vp = a.v + w * a.svb + h * a.svh;
    sqn = a.sqn;
    skn = a.skn;
    svn = a.svn;
    rh = a.rel_h + int64_t(wh) * a.T_ * a.ws;
    rw = a.rel_w + int64_t(wh) * a.T_ * a.ws;
    op = a.out + int64_t(wh) * a.T_ * a.D;
    lp = a.lse + int64_t(wh) * a.T_;
    scale = round_to<T>(a.scale);
  }
  __device__ float q(int r, int d) const {
    return round_to<T>(to_f(qp[(q0 + r) * sqn + d]) * scale);
  }
  __device__ float k(int key, int d) const { return to_f(kp[key * skn + d]); }
  __device__ float v(int key, int d) const { return to_f(vp[key * svn + d]); }
  __device__ float logit(float s, int row, int key) const {
    const int kh = key / ws;
    const int64_t o = int64_t(row) * ws;
    return s + (to_f(rh[o + kh]) + to_f(rw[o + (key - kh * ws)]));
  }
  __device__ float p_round(float p) const { return round_to<T>(p); }
  __device__ void out(int r, int d, float x) const {
    op[int64_t(q0 + r) * D + d] = from_f<T>(x);
  }
  __device__ void lse(int r, float x) const { lp[q0 + r] = x; }
};

// The bf16 route's problem on the tensor-core engine (K2's WindowMma over
// the split layout); R: the rel tables' type.
template <typename R>
struct WindowSplitMma {
  using bf16 = tc::bf16;
  static constexpr bool FAST = false;
  struct Args {
    const bf16* q;
    const bf16* k;
    const bf16* v;
    const R* rel_h;
    const R* rel_w;
    bf16* out;
    float* lse;
    int H, T_, D, ws;
    int64_t sqb, sqh, sqn, skb, skh, skn, svb, svh, svn;
    float scale;
    bool vec, rel_w4;
  };
  static size_t extra_bytes(const Args& a) { return tc::WinRel<R>::bytes(a.ws, a.T_); }

  const bf16* q;
  const bf16* k;
  const bf16* v;
  int64_t sq, sk, sv;
  bool vec;
  int D, nq, nk, nkt;
  bf16 qscale;
  tc::WinRel<R> rel;
  bf16* op;
  int64_t so;
  float* lp;

  __device__ WindowSplitMma(const Args& a, int qtile, int wh, char* extra) {
    const int w = wh / a.H, h = wh - w * a.H;
    const int q0 = qtile * tc::BQ;
    D = a.D;
    nq = min(tc::BQ, a.T_ - q0);
    nk = a.T_;
    nkt = (a.T_ + tc::BK - 1) / tc::BK;
    sq = a.sqn;
    sk = a.skn;
    sv = a.svn;
    q = a.q + w * a.sqb + h * a.sqh + q0 * a.sqn;
    k = a.k + w * a.skb + h * a.skh;
    v = a.v + w * a.svb + h * a.svh;
    vec = a.vec;
    qscale = __float2bfloat16_rn(a.scale);
    const int64_t ro = (int64_t(wh) * a.T_ + q0) * a.ws;
    rel.stage(a.rel_h + ro, a.rel_w + ro, a.ws, nq, a.ws, a.T_, a.rel_w4, extra);
    op = a.out + (int64_t(wh) * a.T_ + q0) * a.D;
    so = a.D;
    lp = a.lse + int64_t(wh) * a.T_ + q0;
  }
  __device__ void add_bias(float (&s)[tc::NT][4], int k0, int row) const { rel.add(s, k0, row); }
  __device__ void lse(int r, float x) const { lp[r] = x; }
};

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename R>
int launch_split(const void* q, const void* k, const void* v, const void* rel_h,
                 const void* rel_w, void* out, void* lse, int BW, int H, int T_, int D, int ws,
                 const int64_t* s, float scale, cudaStream_t st) {
  using bf16 = tc::bf16;
  if (ws > 255) return int(cudaErrorInvalidValue);   // the key table's 8-bit fields
  bool vec = D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  for (int i = 0; i < 9; ++i) vec = vec && s[i] % 8 == 0;
  typename WindowSplitMma<R>::Args a{
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const R*>(rel_h), static_cast<const R*>(rel_w), static_cast<bf16*>(out),
      static_cast<float*>(lse), H, T_, D, ws,
      s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], scale, vec,
      (ws * sizeof(R)) % 4 == 0 && reinterpret_cast<uintptr_t>(rel_h) % 4 == 0 &&
          reinterpret_cast<uintptr_t>(rel_w) % 4 == 0};
  const dim3 grid((T_ + tc::BQ - 1) / tc::BQ, BW * H);
  return int(tc::launch_fwd<WindowSplitMma<R>>(a, D, grid, st));
}

template <typename T, typename R>
int run(const void* q, const void* k, const void* v, const void* rel_h, const void* rel_w,
        void* out, void* lse, int BW, int H, int T_, int D, int ws, const int64_t* s,
        float scale, cudaStream_t st) {
  typename WindowSplitProb<T, R>::Args a{
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const R*>(rel_h), static_cast<const R*>(rel_w), static_cast<T*>(out),
      static_cast<float*>(lse), H, T_, D, ws,
      s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], scale};
  const dim3 grid((T_ + BQ - 1) / BQ, BW * H);
  return int(launch<WindowSplitProb<T, R>>(a, D, grid, st));
}

}  // namespace

// strides: int64[9] = (q: window, head, row), (k: ...), (v: ...), in elements.
// dtype / rel_dtype: 0 = float32, 1 = bfloat16; the rel tables are in q's
// dtype or in float32; bf16 q, k, v run the tensor-core engine, fp32 the
// CUDA-core one. Returns cudaGetLastError() after the launch.
extern "C" int wg_sam_window_split_fwd(const void* q, const void* k, const void* v,
                                       const void* rel_h, const void* rel_w, void* out,
                                       void* lse, int BW, int H, int T, int D, int ws,
                                       const int64_t* strides, float scale, int dtype,
                                       int rel_dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && rel_dtype == 0)
    return run<float, float>(q, k, v, rel_h, rel_w, out, lse, BW, H, T, D, ws, strides, scale,
                             st);
  if (dtype == 1 && rel_dtype == 1)
    return launch_split<__nv_bfloat16>(q, k, v, rel_h, rel_w, out, lse, BW, H, T, D, ws, strides,
                                       scale, st);
  if (dtype == 1 && rel_dtype == 0)
    return launch_split<float>(q, k, v, rel_h, rel_w, out, lse, BW, H, T, D, ws, strides, scale,
                               st);
  return int(cudaErrorInvalidValue);
}
