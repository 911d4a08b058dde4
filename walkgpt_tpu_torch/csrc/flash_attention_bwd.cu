// K1b: the backward of K1 (causal self-attention with a per-batch key mask,
// the LLM's training step). Replaces walkgpt_tpu/ops/flash_attention.py:
// _flash_bwd (_dq_kernel and _dkv_kernel). Semantics kept from the TPU
// kernels:
//   * q, k, v and g are upcast to fp32, s = (q * scale) . k in fp32;
//   * p = exp(s - lse) and exactly 0 at masked positions (a key with
//     key_valid 0, or above the diagonal), so a fully masked row, whose s
//     and lse are both about -1e30, gets no gradient instead of p ~ 1;
//   * dp = g . v, ds = p * (dp - delta); dq = ds . k * scale, dk = ds^T . q
//     * scale (q unscaled), dv = p^T . g, all in fp32;
//   * dq pass: key tiles up to the diagonal; dk/dv pass: query tiles from
//     the diagonal on;
//   * dq and dk are scaled at the end; outputs in the input dtype.
// q, k, v, g, dq, dk, dv: [B, H, N, D] contiguous; key_valid [B, N] uint8;
// lse and delta = rowsum(g * out): [B, H, N] fp32.
// Bound on an H100: the training shape [2, 32, 767, 128] bf16 reads q, k,
// v, g and writes dq, dk, dv, about 88 MB (26 us at 3.35 TB/s), and needs
// five products of 2*D flops per causal (query, key) pair, about 24 GFLOP
// (24 us at the bf16 tensor-core rate): bound by bytes.
// Two routes, chosen by dtype:
//   * bf16 (the training step's path) runs on the tensor cores, on the pair
//     layout of attention_mma_bwd.cuh: one launch holds both passes, blocks
//     of 8 warps over a 64-row tile (a dq pass per query tile, a dk/dv pass
//     per key tile), streamed tiles double-buffered by cp.async, ordered
//     heaviest first (the causal mask gives the last query tile's dq pass
//     and the first key tile's dk/dv pass 12 tiles each at N = 767, the
//     others fewer). Products, the numerics of this route:
//       - s: one bf16 mma.sync of the unscaled q and k, then the fp32
//         accumulator times scale. q and k are bf16 inputs, so every
//         product is exact and s differs from the TPU's fp32 (q * scale) .
//         k only in fp32 rounding. (K3b's route stages bf16(q * scale), which
//         is SAM's function, not K1's; a hi/lo split of q * scale would keep
//         about 16 bits and cost twice the products.) The dk/dv pass forms
//         s^T = scale (k . q^T) the same way; dk takes the unscaled q and is
//         scaled at the end, as the TPU does.
//       - dp = g . v^T: one bf16 product of two bf16 inputs, exact products.
//       - dv, dk and dq: p and ds are fp32; each is split as hi = bf16(x),
//         lo = bf16(x - hi), two bf16 products into one fp32 sum (about 16
//         significant bits of p and ds; bf16 alone would keep 8). Ten
//         mma.sync units of 2*D per pair for the function's five.
//       - p and lse: K1's bf16 forward (attention_mma.cuh, SCALE_ACC) forms
//         s the same way, scale times the fp32 sum of exact products, but
//         in its own tiles and sum order: p = exp(s - lse) matches the saved
//         lse to fp32 rounding, not bit for bit.
//     Masks: key_valid and the causal mask set s to -inf on the fragments
//     before p is formed (p exactly 0); key_valid of a key tile is two
//     ballots of its 64 bytes.
//     Layout: in the 4-warp layout of K3b a warp holds dk and dv of 16 keys,
//     2 x 16 x 128 fp32 at D = 128 (128 registers a thread), beside s^T,
//     dp^T and the split fragments: over 255 registers, so spills. The pair
//     layout gives warps w and w + 4 the same 16 rows: in the dk/dv pass
//     warp w forms s^T, p^T and dv, warp w + 4 dp^T, ds^T and dk (p^T crosses
//     through shared memory); in the dq pass warp w forms s and p, warp w +
//     4 dp and ds, and each sums half of dq's head dims. A warp holds one 16
//     x 128 accumulator at most (64 registers): 174 registers a thread, no
//     spills. Shared memory at D = 128: six 64-row tiles of 272-byte rows
//     and a 16 KB exchange, about 119 KB: one block (8 warps) an SM. No unchecked full-tile instantiation: 767 =
//     11 x 64 + 63 leaves a ragged tile on both sides.
//     Determinism: every output element is summed by one thread in tile
//     order, no atomics: two runs give the same bits.
//   * fp32 (the demo_config training parity) stays on the CUDA-core engine
//     of attention_bwd.cuh (two launches, fp32 products in the forward's
//     fma order).
#include "attention_bwd.cuh"
#include "attention_mma_bwd.cuh"

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

// The bf16 route's problem on the tensor-core engine's pair layout.
struct FlashBwdMma {
  using bf16 = tc::bf16;
  static constexpr bool SCALE_ACC = true;
  struct Args {
    const bf16* q;
    const bf16* k;
    const bf16* v;
    const uint8_t* key_valid;
    const bf16* g;
    const float* lse;
    const float* delta;
    bf16* dq;
    bf16* dk;
    bf16* dv;
    int H, N, D, causal;
    float scale;
    bool vec;
  };
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* g;
  const uint8_t* kv;
  const float* lse;
  const float* delta;
  bf16* dqp;
  bf16* dkp;
  bf16* dvp;
  int64_t sq, sk, sv, sg;
  bool vec;
  int N, NK, D, causal;
  float scale;

  __device__ FlashBwdMma(const Args& a, int bh) {
    const int64_t off = int64_t(bh) * a.N * a.D;
    N = NK = a.N;
    D = a.D;
    causal = a.causal;
    scale = a.scale;
    vec = a.vec;
    sq = sk = sv = sg = a.D;
    q = a.q + off;
    k = a.k + off;
    v = a.v + off;
    g = a.g + off;
    dqp = a.dq + off;
    dkp = a.dk + off;
    dvp = a.dv + off;
    kv = a.key_valid + int64_t(bh / a.H) * a.N;
    lse = a.lse + int64_t(bh) * a.N;
    delta = a.delta + int64_t(bh) * a.N;
  }
  __device__ int dq_key_tiles(int q0) const {
    const int ntiles = (NK + tc::BK - 1) / tc::BK;
    return causal ? min(ntiles, (q0 + tc::BQ - 1) / tc::BK + 1) : ntiles;
  }
  __device__ int dkv_first_qtile(int k0) const { return causal ? k0 / tc::BQ : 0; }
  // rows q0 + row, + 8; keys k0 + 8 n + 2 t + (e & 1): key_valid of the
  // tile's 64 keys as a 64-bit mask (two ballots), then the diagonal
  __device__ void mask_qk(float (&s)[tc::NT][4], int q0, int k0, int row) const {
    const int lane = threadIdx.x & 31, t = lane & 3;
    const uint32_t lo = __ballot_sync(0xffffffffu, k0 + lane < NK && kv[k0 + lane]);
    const uint32_t hi = __ballot_sync(0xffffffffu, k0 + 32 + lane < NK && kv[k0 + 32 + lane]);
    const uint64_t m = (uint64_t(hi) << 32) | lo;
    if (m == ~0ull && (!causal || k0 + tc::BK - 1 <= q0 + row)) return;   // nothing masked
#pragma unroll
    for (int n = 0; n < tc::NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + 2 * t + (e & 1);
        if (!((m >> c) & 1) || (causal && k0 + c > q0 + row + 8 * (e >> 1)))
          s[n][e] = -CUDART_INF_F;
      }
  }
  // rows keys k0 + key, + 8; columns queries q0 + 8 n + 2 t + (e & 1)
  __device__ void mask_kq(float (&s)[tc::NT][4], int q0, int k0, int key) const {
    const int t = threadIdx.x & 3;
    bool valid[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) valid[h] = k0 + key + 8 * h < NK && kv[k0 + key + 8 * h];
    if (valid[0] && valid[1] && (!causal || k0 + key + 8 <= q0)) return;   // nothing masked
#pragma unroll
    for (int n = 0; n < tc::NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        if (!valid[h] || (causal && k0 + key + 8 * h > q0 + 8 * n + 2 * t + (e & 1)))
          s[n][e] = -CUDART_INF_F;
      }
  }
  __device__ void dq(int r, int d, float x) const {
    dqp[int64_t(r) * D + d] = __float2bfloat16_rn(x);
  }
  __device__ void dk(int key, int d, float x) const {
    dkp[int64_t(key) * D + d] = __float2bfloat16_rn(x);
  }
  __device__ void dv(int key, int d, float x) const {
    dvp[int64_t(key) * D + d] = __float2bfloat16_rn(x);
  }
};

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

int launch_flash(const void* q, const void* k, const void* v, const void* key_valid,
                 const void* g, const void* lse, const void* delta, void* dq, void* dk, void* dv,
                 int B, int H, int N, int D, int causal, float scale, cudaStream_t st) {
  using bf16 = tc::bf16;
  const bool vec = D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(g);
  FlashBwdMma::Args a{static_cast<const bf16*>(q),       static_cast<const bf16*>(k),
                      static_cast<const bf16*>(v),       static_cast<const uint8_t*>(key_valid),
                      static_cast<const bf16*>(g),       static_cast<const float*>(lse),
                      static_cast<const float*>(delta),  static_cast<bf16*>(dq),
                      static_cast<bf16*>(dk),            static_cast<bf16*>(dv),
                      H, N, D, causal, scale, vec};
  return int(tc::launch_pair<FlashBwdMma>(a, D, B * H, N, st));
}

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

// dtype: 0 = float32 (CUDA-core engine: two launches, the dq pass then the
// dk/dv pass), 1 = bfloat16 (tensor-core engine: one launch of both
// passes). Returns cudaGetLastError() after the launches.
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
    return launch_flash(q, k, v, key_valid, g, lse, delta, dq, dk, dv, B, H, N, D, causal, scale,
                        st);
  return int(cudaErrorInvalidValue);
}
