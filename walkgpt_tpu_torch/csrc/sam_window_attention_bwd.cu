// K2b: the backward of K2 (whole-window attention with the decomposed
// rel-pos bias over the packed layout, the SAM ViT encoder's windowed
// blocks). Replaces walkgpt_tpu/ops/flash_attention.py:_win_packed_vjp_bwd
// (_win_packed_bwd_kernel). Semantics kept from the TPU kernel:
//   * s = (q * scale rounded to the input dtype) . k, plus the bias
//     rel_h[q, k / ws] + rel_w[q, k % ws], exactly as the forward formed it;
//   * p = exp(s - lse) in fp32 (unrounded, unlike the forward's value
//     product), dv = p^T . g, dq = ds . k * scale, dk = ds^T . q * scale;
//   * drel_h[q, r] = sum of ds over the keys of window row r, drel_w[q, c]
//     over window column c (no scale);
//   * outputs in the packed layouts dqkv [BW, T, 3*H*D] and drel
//     [BW, T, 2*H*ws] in the input dtype.
// The TPU kernel keeps a window's whole [196, 196] fp32 ds tile in VMEM
// (154 KB); here the 196 tokens stream in 64-row tiles through the dq
// pass (which also sums drel) and the dk/dv pass (attention_bwd.cuh),
// reading q, k and v straight from the packed qkv lanes as K2 does.
// qkv [BW, T, 3*H*D], rel [BW, T, 2*H*ws], g [BW, T, H*D] contiguous; lse
// and delta [BW, T, H] fp32.
// Bound on an H100: ViT-H, 2 images (50 windows, 16 heads of 80) reads
// qkv, rel, g and writes dqkv, drel, about 194 MB (58 us at 3.35 TB/s);
// the products need about 25 GFLOP (25 us at the bf16 rate): bound by bytes.
#include "attention_bwd.cuh"

namespace {

using namespace wgt;

template <typename T>
struct WindowBwd {
  static constexpr bool REL = true;
  struct Args {
    const T* qkv;
    const T* rel;
    const T* g;
    const float* lse;
    const float* delta;
    T* dqkv;
    T* drel;
    int H, T_, D, ws;
    float scale;
  };
  const T* base;      // window's qkv rows, head hh's lanes
  const T* relb;
  const T* gb;
  const float* lp;
  const float* dlp;
  T* dqb;
  T* drb;
  int N, NK, D, H, hh, gh, gw, c, row3c, rel_w;
  float scale, qscale;

  __device__ WindowBwd(const Args& a, int wh) {
    const int w = wh / a.H;
    hh = wh - w * a.H;
    H = a.H;
    N = NK = a.T_;
    D = a.D;
    gh = gw = a.ws;
    c = a.H * a.D;
    row3c = 3 * c;
    rel_w = 2 * a.H * a.ws;
    scale = a.scale;
    qscale = round_to<T>(a.scale);
    base = a.qkv + int64_t(w) * a.T_ * row3c + hh * a.D;
    dqb = a.dqkv + int64_t(w) * a.T_ * row3c + hh * a.D;
    relb = a.rel + int64_t(w) * a.T_ * rel_w;
    drb = a.drel + int64_t(w) * a.T_ * rel_w;
    gb = a.g + int64_t(w) * a.T_ * c + hh * a.D;
    lp = a.lse + int64_t(w) * a.T_ * a.H + hh;
    dlp = a.delta + int64_t(w) * a.T_ * a.H + hh;
  }
  __device__ float qr(int r, int d) const { return to_f(base[int64_t(r) * row3c + d]); }
  __device__ float qs(int r, int d) const { return round_to<T>(qr(r, d) * qscale); }
  __device__ float k(int key, int d) const { return to_f(base[int64_t(key) * row3c + c + d]); }
  __device__ float v(int key, int d) const {
    return to_f(base[int64_t(key) * row3c + 2 * c + d]);
  }
  __device__ float g(int r, int d) const { return to_f(gb[int64_t(r) * c + d]); }
  __device__ float lse(int r) const { return lp[int64_t(r) * H]; }
  __device__ float delta(int r) const { return dlp[int64_t(r) * H]; }
  __device__ float logit(float s, int row, int key) const {
    const T* rr = relb + int64_t(row) * rel_w;
    const int kh = key / gw;
    return s + (to_f(rr[hh * gw + kh]) + to_f(rr[(H + hh) * gw + (key - kh * gw)]));
  }
  __device__ bool valid(int, int) const { return true; }
  __device__ int dq_key_tiles(int) const { return (NK + BK - 1) / BK; }
  __device__ int dkv_first_qtile(int) const { return 0; }
  __device__ void dq(int r, int d, float x) const {
    dqb[int64_t(r) * row3c + d] = from_f<T>(x);
  }
  __device__ void dk(int key, int d, float x) const {
    dqb[int64_t(key) * row3c + c + d] = from_f<T>(x);
  }
  __device__ void dv(int key, int d, float x) const {
    dqb[int64_t(key) * row3c + 2 * c + d] = from_f<T>(x);
  }
  __device__ void drh(int r, int i, float x) const {
    drb[int64_t(r) * rel_w + hh * gw + i] = from_f<T>(x);
  }
  __device__ void drw(int r, int i, float x) const {
    drb[int64_t(r) * rel_w + (H + hh) * gw + i] = from_f<T>(x);
  }
};

template <typename T>
int run(const void* qkv, const void* rel, const void* g, const void* lse, const void* delta,
        void* dqkv, void* drel, int BW, int T_, int H, int D, int ws, float scale,
        cudaStream_t st) {
  typename WindowBwd<T>::Args a{static_cast<const T*>(qkv), static_cast<const T*>(rel),
                                static_cast<const T*>(g), static_cast<const float*>(lse),
                                static_cast<const float*>(delta), static_cast<T*>(dqkv),
                                static_cast<T*>(drel), H, T_, D, ws, scale};
  return int(launch_bwd<WindowBwd<T>>(a, D, BW * H, T_, T_, 2 * ws, st));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// two launches (dq + drel pass, then dk/dv pass).
extern "C" int wg_sam_window_attention_bwd(const void* qkv, const void* rel, const void* g,
                                           const void* lse, const void* delta, void* dqkv,
                                           void* drel, int BW, int T, int H, int D, int ws,
                                           float scale, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(qkv, rel, g, lse, delta, dqkv, drel, BW, T, H, D, ws, scale, st);
  if (dtype == 1)
    return run<__nv_bfloat16>(qkv, rel, g, lse, delta, dqkv, drel, BW, T, H, D, ws, scale, st);
  return int(cudaErrorInvalidValue);
}
