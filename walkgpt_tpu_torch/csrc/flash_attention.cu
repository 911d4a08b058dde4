// K1: causal (or full) self-attention with a per-batch key mask, for the LLM
// prefill. Replaces walkgpt_tpu/ops/flash_attention.py:flash_attention
// (_fwd_kernel). Semantics kept from the TPU kernel:
//   * q, k and v are upcast to fp32 and q is scaled after the upcast;
//   * the value product takes fp32 probabilities;
//   * a masked logit is the finite -1e30 (a fully masked row averages v
//     over the keys of the tiles it visits instead of producing NaN),
//     causal keys k <= q;
//   * key tiles wholly above the diagonal are skipped.
// q, k, v: [B, H, N, D] with any batch/head/row strides and unit stride on D;
// key_valid: [B, N] uint8; out: [B, H, N, D] contiguous; lse: [B, H, N] fp32.
// Bound on an H100: the 7B prefill [2, 32, 447, 128] bf16 reads q, k, v and
// writes out and lse, about 29 MB (9 us at 3.35 TB/s), against two products
// of 2*D flops per causal pair, about 3.3 GFLOP (3 us at the bf16
// tensor-core rate): bound by bytes.
// Two routes, chosen by dtype:
//   * bf16 (the prefill, serving admit and training forward) runs on the
//     tensor-core engine of attention_mma.cuh: blocks of 4 warps over a
//     64-query tile, 16 rows a warp, key tiles of 64 double-buffered by
//     cp.async, stopping at the diagonal tile. Products:
//       - s: q is staged unscaled (its bf16 values are exact) and s is scale
//         times the fp32 sum of the exact products q . k (SCALE_ACC), as
//         K1b forms it, so the saved lse and K1b's recomputed p agree; it
//         differs from the TPU's fp32 (q * scale) . k only in fp32 rounding;
//       - p.v: p is fp32 and the TPU takes it unrounded; here it is split as
//         hi = bf16(p), lo = bf16(p - hi), two bf16 products into one fp32
//         sum (SPLIT_P: about 16 significant bits of p, bf16 alone keeps 8);
//       - the causal and key_valid masks set the fragment's logits to -1e30
//         (key_valid of a key tile is two ballots of its 64 bytes), and p =
//         exp(s - m) is formed by subtraction first (SUB_MAX), so a fully
//         masked row gets p = 1 for each visited key, as on the CUDA cores.
//     Query tiles run heaviest first (grid (B*H, tiles), the last tile of
//     each causal row first). N = 447 and 767 leave ragged tiles, so the
//     engine's general (bounds-checked) instantiation runs at every shape.
//   * fp16 (the prefill of `--precision fp16`) runs the bf16 route's
//     problem on the same engine with its FP16 trait: f16 mma.sync with fp32
//     sums, s from the scaled accumulator (fp16 products are exact in fp32
//     too), p split as hi = fp16(p), lo = fp16(p - hi), the output in fp16.
//     The TPU kernel upcasts q, k and v to fp32 whatever their type, so the
//     route keeps its arithmetic: the split keeps about 22 bits of p;
//   * fp32 (the fp32 parity runs, which need exact fp32 products) stays on
//     the CUDA-core engine of attention_tile.cuh.
#include "attention_mma.cuh"
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

// The bf16 route's problem on the tensor-core engine (F16: the fp16
// route's; its pointers hold fp16 values under the bf16 type, which the
// engine only copies).
template <bool F16>
struct FlashMma {
  using bf16 = tc::bf16;
  static constexpr bool FAST = false;
  static constexpr bool SCALE_ACC = true;
  static constexpr bool SPLIT_P = true;
  static constexpr bool SUB_MAX = true;
  static constexpr bool FP16 = F16;
  struct Args {
    const bf16* q;
    const bf16* k;
    const bf16* v;
    const uint8_t* key_valid;
    bf16* out;
    float* lse_out;
    int H, N, D, causal;
    int64_t sqb, sqh, sqn, skb, skh, skn, svb, svh, svn;
    float scale;
    bool vec;
  };
  static size_t extra_bytes(const Args&) { return 0; }

  const bf16* q;
  const bf16* k;
  const bf16* v;
  int64_t sq, sk, sv;
  bool vec;
  int D, nq, nk, nkt, q0, causal;
  float scale;
  const uint8_t* kv;
  bf16* op;
  int64_t so;
  float* lp;

  // block (x, y) = ((batch, head), y-th heaviest query tile)
  __device__ FlashMma(const Args& a, int x, int y, char*) {
    const int bh = x, b = bh / a.H, h = bh - b * a.H;
    const int ntiles = (a.N + tc::BQ - 1) / tc::BQ;
    const int qtile = a.causal ? ntiles - 1 - y : y;
    q0 = qtile * tc::BQ;
    D = a.D;
    nq = min(tc::BQ, a.N - q0);
    nk = a.N;
    causal = a.causal;
    nkt = causal ? min(ntiles, (q0 + nq - 1) / tc::BK + 1) : ntiles;
    sq = a.sqn;
    sk = a.skn;
    sv = a.svn;
    q = a.q + b * a.sqb + h * a.sqh + q0 * a.sqn;
    k = a.k + b * a.skb + h * a.skh;
    v = a.v + b * a.svb + h * a.svh;
    vec = a.vec;
    scale = a.scale;
    kv = a.key_valid + int64_t(b) * a.N;
    op = a.out + (int64_t(bh) * a.N + q0) * a.D;
    so = a.D;
    lp = a.lse_out + int64_t(bh) * a.N + q0;
  }
  // the masks on the warp's fragment: rows q0 + row, + 8 (local row, row +
  // 8), keys k0 + 8 n + 2 t + (e & 1); keys >= nk are the engine's
  __device__ void add_bias(float (&s)[tc::NT][4], int k0, int row) const {
    const int lane = threadIdx.x & 31, t = lane & 3;
    const uint32_t lo = __ballot_sync(0xffffffffu, k0 + lane < nk && kv[k0 + lane]);
    const uint32_t hi = __ballot_sync(0xffffffffu, k0 + 32 + lane < nk && kv[k0 + 32 + lane]);
    const uint64_t m = (uint64_t(hi) << 32) | lo;
    const int r0 = q0 + row;
    if (m == ~0ull && (!causal || k0 + tc::BK - 1 <= r0)) return;   // nothing masked
#pragma unroll
    for (int n = 0; n < tc::NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + 2 * t + (e & 1);
        if (!((m >> c) & 1) || (causal && k0 + c > r0 + 8 * (e >> 1))) s[n][e] = tc::NEG_BIG;
      }
  }
  __device__ void lse(int r, float x) const { lp[r] = x; }
};

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <bool F16>
int launch_mma(const void* q, const void* k, const void* v, const void* key_valid, void* out,
               void* lse, int B, int H, int N, int D, const int64_t* s, int causal, float scale,
               cudaStream_t st) {
  using bf16 = tc::bf16;
  using Prob = FlashMma<F16>;
  bool vec = D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  for (int i = 0; i < 9; ++i) vec = vec && s[i] % 8 == 0;
  typename Prob::Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                   static_cast<const bf16*>(v), static_cast<const uint8_t*>(key_valid),
                   static_cast<bf16*>(out), static_cast<float*>(lse), H, N, D, causal,
                   s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], scale, vec};
  const dim3 grid(B * H, (N + tc::BQ - 1) / tc::BQ);
  return int(tc::launch_fwd<Prob>(a, D, grid, st));
}

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
// dtype: 0 = float32 (CUDA-core engine), 1 = bfloat16, 2 = float16 (tensor-core
// engine).
// Returns cudaGetLastError() after the launch.
extern "C" int wg_flash_attention_fwd(const void* q, const void* k, const void* v,
                                      const void* key_valid, void* out, void* lse,
                                      int B, int H, int N, int D,
                                      const int64_t* strides, int causal, float scale,
                                      int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(q, k, v, key_valid, out, lse, B, H, N, D, strides, causal, scale, st);
  if (dtype == 1)
    return launch_mma<false>(q, k, v, key_valid, out, lse, B, H, N, D, strides, causal, scale,
                             st);
  if (dtype == 2)
    return launch_mma<true>(q, k, v, key_valid, out, lse, B, H, N, D, strides, causal, scale,
                            st);
  return int(cudaErrorInvalidValue);
}
