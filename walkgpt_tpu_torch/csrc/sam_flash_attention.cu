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
// Bound on an H100: ViT-H, 2 images, [2, 16, 4096, 80] bf16: two products
// of 2*D flops per (query, key) pair, about 172 GFLOP (174 us at the bf16
// tensor-core rate) against about 70 MB of traffic (21 us): bound by
// operations.
// Two routes, chosen by dtype:
//   * bf16 (the encoder's path) runs on the tensor cores (attention_mma.cuh):
//     blocks of 4 warps over a 64-query tile, 16 rows a warp, key tiles of
//     64 double-buffered by cp.async; q.k and p.v are bf16 mma.sync
//     m16n8k16 with fp32 sums, D padded to a multiple of 16 with zeros; p
//     goes from the logits' registers into p.v as the A operand. The bias
//     is added to the fp32 logits in the TPU kernel's order. At the
//     production shapes (16-byte aligned rows, D % 16 == 0, N % 64 == 0,
//     gw = 64) an instantiation without bounds checks runs: the tile's
//     rel_w rows are staged once in shared memory and rel_h (one value a
//     row and key tile) is read from device memory; elsewhere both rel
//     tables are staged while gh + gw <= 256 and read from device memory
//     beyond. Shared memory at D = 80: Q 11 KB, K and V twice 44 KB, rel_w
//     9 KB, 64 KB; 161 registers: 3 blocks (12 warps) an SM. Rows whose
//     start is not 16-byte aligned (or D % 8 != 0, as in a D = 20 head
//     view) are loaded with 2-byte loads, in the kernel: no copy is made.
//   * fp32 (the demo_config parity runs, which need the einsum path's exact
//     products) stays on the CUDA-core engine of attention_tile.cuh: the
//     tensor cores have no exact fp32 product.
#include <type_traits>

#include "attention_mma.cuh"
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

// The bf16 route's problem on the tensor-core engine. FAST: the production
// shapes' instantiation (see launch_global below).
template <bool FAST_>
struct GlobalMma {
  using bf16 = tc::bf16;
  static constexpr bool FAST = FAST_;
  struct Args {
    const bf16* q;
    const bf16* k;
    const bf16* v;
    const bf16* rel_h;
    const bf16* rel_w;
    bf16* out;
    float* lse_out;
    int H, N, D, gh, gw;
    int64_t sqb, sqh, sqn, skb, skh, skn, svb, svh, svn;
    float scale;
    bool vec, rel_vec;
  };
  static size_t extra_bytes(const Args& a) {
    return FAST ? tc::rel_stage_bytes_fast() : tc::rel_stage_bytes(a.gh, a.gw);
  }

  const bf16* q;
  const bf16* k;
  const bf16* v;
  int64_t sq, sk, sv;
  bool vec;
  int D, nq, nk, nkt;
  bf16 qscale;
  tc::RelRows rel;
  bf16* op;
  int64_t so;
  float* lp;

  __device__ GlobalMma(const Args& a, int qtile, int bh, char* extra) {
    const int b = bh / a.H, h = bh - b * a.H;
    const int q0 = qtile * tc::BQ;
    D = a.D;
    nq = min(tc::BQ, a.N - q0);
    nk = a.N;
    nkt = (a.N + tc::BK - 1) / tc::BK;
    sq = a.sqn;
    sk = a.skn;
    sv = a.svn;
    q = a.q + b * a.sqb + h * a.sqh + q0 * a.sqn;
    k = a.k + b * a.skb + h * a.skh;
    v = a.v + b * a.svb + h * a.svh;
    vec = a.vec;
    qscale = __float2bfloat16_rn(a.scale);
    rel.stage<FAST>(a.rel_h + int64_t(bh) * a.N * a.gh, a.rel_w + int64_t(bh) * a.N * a.gw, q0, a.N,
              a.gh, a.gw, a.rel_vec, extra);
    op = a.out + (int64_t(bh) * a.N + q0) * a.D;
    so = a.D;
    lp = a.lse_out + int64_t(bh) * a.N + q0;
  }
  __device__ void add_bias(float (&s)[tc::NT][4], int k0, int row) const {
    rel.add<FAST>(s, k0, row, nq, nk);
  }
  __device__ void lse(int r, float x) const { lp[r] = x; }
};

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

int launch_global(const void* q, const void* k, const void* v, const void* rel_h,
                  const void* rel_w, void* out, void* lse, int B, int H, int N, int D, int gh,
                  int gw, const int64_t* s, float scale, cudaStream_t st) {
  using bf16 = tc::bf16;
  bool vec = D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  for (int i = 0; i < 9; ++i) vec = vec && s[i] % 8 == 0;
  const bool rel_vec = gh % 8 == 0 && gw % 8 == 0 && aligned16(rel_h) && aligned16(rel_w);
  const dim3 grid((N + tc::BQ - 1) / tc::BQ, B * H);
  // FAST: aligned rows, D a multiple of 16, whole tiles, and one key tile
  // per grid row (gw = 64, ViT-H's) with the rel rows staged: no bounds
  // checks and constant strides
  const bool fast = vec && rel_vec && D % 16 == 0 && N % tc::BQ == 0 && gw == tc::BK &&
                    tc::rel_staged(gh, gw);
  auto go = [&](auto fast_tag) {
    using P = GlobalMma<decltype(fast_tag)::value>;
    typename P::Args a{
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(rel_h), static_cast<const bf16*>(rel_w), static_cast<bf16*>(out),
        static_cast<float*>(lse), H, N, D, gh, gw,
        s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], scale, vec, rel_vec};
    return int(tc::launch_fwd<P>(a, D, grid, st));
  };
  return fast ? go(std::true_type{}) : go(std::false_type{});
}

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
// dtype: 0 = float32 (CUDA-core engine), 1 = bfloat16 (tensor-core engine).
// Returns cudaGetLastError() after the launch.
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
    return launch_global(q, k, v, rel_h, rel_w, out, lse, B, H, N, D, gh, gw, strides, scale, st);
  return int(cudaErrorInvalidValue);
}
