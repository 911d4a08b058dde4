// K1b: the backward of K1 (causal self-attention with a per-batch key mask,
// the LLM's training step). Replaces walkgpt_tpu/ops/flash_attention.py:
// _flash_bwd (_dq_kernel and _dkv_kernel). Semantics kept from the TPU
// kernels:
//   * q, k, v and g are upcast to fp32, s = (q * scale) . k in fp32;
//   * p = exp(s - lse) and exactly 0 at masked positions (a key with
//     key_valid 0, or above the diagonal), so a fully masked row, whose s
//     and lse are both about -1e30, gets no gradient instead of p ~ 1;
//   * dq pass: key tiles up to the diagonal; dk/dv pass: query tiles from
//     the diagonal on;
//   * dq and dk are scaled at the end; outputs in the input dtype.
// q, k, v, g, dq, dk, dv: [B, H, N, D] contiguous; key_valid [B, N] uint8;
// lse and delta = rowsum(g * out): [B, H, N] fp32.
// Bound on an H100: the training shape [2, 32, 767, 128] bf16 reads q, k,
// v, g and writes dq, dk, dv, about 88 MB (26 us at 3.35 TB/s), and needs
// five products of 2*D flops per causal (query, key) pair, about 24 GFLOP
// (24 us at the bf16 tensor-core rate): bound by bytes. This first version
// runs the products on the CUDA cores in fp32 (see attention_bwd.cuh).
#include "attention_bwd.cuh"

namespace {

using namespace wgt;

template <typename T>
struct FlashBwd {
  static constexpr bool REL = false;
  struct Args {
    const T* q;
    const T* k;
    const T* v;
    const uint8_t* key_valid;
    const T* g;
    const float* lse;
    const float* delta;
    T* dq;
    T* dk;
    T* dv;
    int H, N, D, causal;
    float scale;
  };
  const T* qp;
  const T* kp;
  const T* vp;
  const T* gp;
  const uint8_t* kv;
  const float* lp;
  const float* dlp;
  T* dqp;
  T* dkp;
  T* dvp;
  int N, NK, D, causal;
  float scale;

  __device__ FlashBwd(const Args& a, int bh) {
    const int b = bh / a.H;
    const int64_t off = int64_t(bh) * a.N * a.D;
    N = NK = a.N;
    D = a.D;
    causal = a.causal;
    scale = a.scale;
    qp = a.q + off;
    kp = a.k + off;
    vp = a.v + off;
    gp = a.g + off;
    dqp = a.dq + off;
    dkp = a.dk + off;
    dvp = a.dv + off;
    kv = a.key_valid + int64_t(b) * a.N;
    lp = a.lse + int64_t(bh) * a.N;
    dlp = a.delta + int64_t(bh) * a.N;
  }
  __device__ float qr(int r, int d) const { return to_f(qp[int64_t(r) * D + d]); }
  __device__ float qs(int r, int d) const { return qr(r, d) * scale; }
  __device__ float k(int key, int d) const { return to_f(kp[int64_t(key) * D + d]); }
  __device__ float v(int key, int d) const { return to_f(vp[int64_t(key) * D + d]); }
  __device__ float g(int r, int d) const { return to_f(gp[int64_t(r) * D + d]); }
  __device__ float lse(int r) const { return lp[r]; }
  __device__ float delta(int r) const { return dlp[r]; }
  __device__ float logit(float s, int, int) const { return s; }
  __device__ bool valid(int row, int key) const {
    return kv[key] != 0 && (!causal || key <= row);
  }
  __device__ int dq_key_tiles(int q0) const {
    const int ntiles = (NK + BK - 1) / BK;
    return causal ? min(ntiles, (q0 + BQ - 1) / BK + 1) : ntiles;
  }
  __device__ int dkv_first_qtile(int k0) const { return causal ? k0 / BQ : 0; }
  __device__ void dq(int r, int d, float x) const { dqp[int64_t(r) * D + d] = from_f<T>(x); }
  __device__ void dk(int key, int d, float x) const {
    dkp[int64_t(key) * D + d] = from_f<T>(x);
  }
  __device__ void dv(int key, int d, float x) const {
    dvp[int64_t(key) * D + d] = from_f<T>(x);
  }
};

template <typename T>
int run(const void* q, const void* k, const void* v, const void* key_valid, const void* g,
        const void* lse, const void* delta, void* dq, void* dk, void* dv, int B, int H, int N,
        int D, int causal, float scale, cudaStream_t st) {
  typename FlashBwd<T>::Args a{
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(key_valid), static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), H, N, D, causal, scale};
  return int(launch_bwd<FlashBwd<T>>(a, D, B * H, N, N, 0, st));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// two launches (dq pass, then dk/dv pass).
extern "C" int wg_flash_attention_bwd(const void* q, const void* k, const void* v,
                                      const void* key_valid, const void* g, const void* lse,
                                      const void* delta, void* dq, void* dk, void* dv, int B,
                                      int H, int N, int D, int causal, float scale, int dtype,
                                      void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(q, k, v, key_valid, g, lse, delta, dq, dk, dv, B, H, N, D, causal, scale,
                      st);
  if (dtype == 1)
    return run<__nv_bfloat16>(q, k, v, key_valid, g, lse, delta, dq, dk, dv, B, H, N, D, causal,
                              scale, st);
  return int(cudaErrorInvalidValue);
}
