// K2: whole-window attention with the decomposed rel-pos bias over the
// packed layout, for the 28 windowed blocks of the SAM ViT encoder. Replaces
// walkgpt_tpu/ops/flash_attention.py:sam_window_attention_packed
// (_win_packed_fwd_kernel). Semantics kept from the TPU kernel:
//   * q * scale is rounded to the input dtype before the q.k product (the
//     scale itself is rounded to the input dtype first);
//   * bias[q, k] = rel[w, q, hh*ws + k/ws] + rel[w, q, (H+hh)*ws + k%ws];
//   * probabilities are rounded to the input dtype for the value product,
//     the softmax denominator uses the unrounded ones.
// Layout: qkv [BW, T, 3*H*D] unsplit (head hh's q, k, v at lane offsets
// hh*D, C + hh*D, 2C + hh*D with C = H*D); rel [BW, T, 2*H*ws];
// out [BW, T, H*D] merged heads; lse [BW, T, H] fp32. No padding is written
// to device memory: T = 196 and D = 80 are bounded and masked in the block.
#include "attention_tile.cuh"

namespace {

using namespace wgt;

template <typename T>
struct WindowProb {
  struct Args {
    const T* qkv;
    const T* rel;
    T* out;
    float* lse;
    int H, T_, D, ws;
    float scale;
  };
  const T* base;     // window's qkv rows
  const T* relb;     // window's rel rows
  T* ob;
  float* lb;
  int D, nq, nk, nkt, q0, hh, H, ws, row3c, rel_w, c;
  float scale;

  __device__ WindowProb(const Args& a, int qtile, int wh) {
    const int w = wh / a.H;
    hh = wh - w * a.H;
    H = a.H;
    D = a.D;
    ws = a.ws;
    c = a.H * a.D;
    row3c = 3 * c;
    rel_w = 2 * a.H * a.ws;
    q0 = qtile * BQ;
    nq = min(BQ, a.T_ - q0);
    nk = a.T_;
    nkt = (a.T_ + BK - 1) / BK;
    base = a.qkv + int64_t(w) * a.T_ * row3c;
    relb = a.rel + int64_t(w) * a.T_ * rel_w;
    ob = a.out + int64_t(w) * a.T_ * c;
    lb = a.lse + int64_t(w) * a.T_ * a.H;
    scale = round_to<T>(a.scale);
  }
  __device__ float q(int r, int d) const {
    return round_to<T>(to_f(base[int64_t(q0 + r) * row3c + hh * D + d]) * scale);
  }
  __device__ float k(int key, int d) const {
    return to_f(base[int64_t(key) * row3c + c + hh * D + d]);
  }
  __device__ float v(int key, int d) const {
    return to_f(base[int64_t(key) * row3c + 2 * c + hh * D + d]);
  }
  __device__ float logit(float s, int row, int key) const {
    const T* rr = relb + int64_t(row) * rel_w;
    const int kh = key / ws;
    return s + (to_f(rr[hh * ws + kh]) + to_f(rr[(H + hh) * ws + (key - kh * ws)]));
  }
  __device__ float p_round(float p) const { return round_to<T>(p); }
  __device__ void out(int r, int d, float x) const {
    ob[int64_t(q0 + r) * c + hh * D + d] = from_f<T>(x);
  }
  __device__ void lse(int r, float x) const { lb[int64_t(q0 + r) * H + hh] = x; }
};

template <typename T>
int run(const void* qkv, const void* rel, void* out, void* lse, int BW, int T_, int H,
        int D, int ws, float scale, cudaStream_t st) {
  typename WindowProb<T>::Args a{static_cast<const T*>(qkv), static_cast<const T*>(rel),
                                 static_cast<T*>(out), static_cast<float*>(lse),
                                 H, T_, D, ws, scale};
  const dim3 grid((T_ + BQ - 1) / BQ, BW * H);
  return int(launch<WindowProb<T>>(a, D, grid, st));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the launch.
extern "C" int wg_sam_window_attention_fwd(const void* qkv, const void* rel, void* out,
                                           void* lse, int BW, int T, int H, int D, int ws,
                                           float scale, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<float>(qkv, rel, out, lse, BW, T, H, D, ws, scale, st);
  if (dtype == 1)
    return run<__nv_bfloat16>(qkv, rel, out, lse, BW, T, H, D, ws, scale, st);
  return int(cudaErrorInvalidValue);
}
