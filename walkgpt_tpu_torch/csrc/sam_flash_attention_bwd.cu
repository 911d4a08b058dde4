// K3b: the backward of K3 (global attention with the decomposed rel-pos
// bias, the SAM ViT encoder's global blocks over the 64x64 grid). Replaces
// walkgpt_tpu/ops/flash_attention.py:_sam_flash_bwd (_sam_dq_kernel and
// _sam_dkv_kernel). Semantics kept from the TPU kernels:
//   * s = (q * scale rounded to the input dtype) . k, then
//     (s + rel_w[q, k % gw]) + rel_h[q, k / gw], the bias built per key
//     tile from the [N, gh] and [N, gw] operands as the forward builds it;
//   * p = exp(s - lse) in fp32; dq and dk are scaled at the end;
//   * drel_h and drel_w accumulate in fp32 in the dq pass, q-indexed, while
//     the key tiles stream, each element by one owner in key order.
// q, k, v, g, dq, dk, dv [B, H, N, D] contiguous; rel_h, drel_h
// [B, H, N, gh]; rel_w, drel_w [B, H, N, gw]; lse and delta [B, H, N] fp32.
// Bound on an H100: ViT-H, 2 images, [2, 16, 4096, 80] bf16: five products
// of 2*D flops per (query, key) pair, about 430 GFLOP (434 us at the bf16
// tensor-core rate) against about 200 MB of traffic (60 us): bound by
// operations.
// Two routes, chosen by dtype:
//   * bf16 (the encoder backward's path) runs on the tensor cores
//     (attention_mma_bwd.cuh): one launch holds both passes, a dq pass of
//     4-warp blocks per 64-query tile and a dk/dv pass per 64-key tile,
//     streamed tiles double-buffered by cp.async. s = qs.k and dp = g.v
//     are single bf16 mma.sync products; dv = p^T.g, dk = ds^T.q and dq =
//     ds.k take the fp32 p and ds split as hi = bf16(x), lo = bf16(x - hi),
//     two bf16 products into one fp32 sum, so each keeps about 16
//     significant bits of p and ds (the TPU kernels form these three in
//     fp32; bf16 alone would keep 8). That is ten product units of 2*D per
//     (query, key) pair on the tensor cores for the function's five. At gw
//     = 64 (ViT-H) drel_h is the row sum of each key tile's ds fragment and
//     drel_w a running sum in registers; other grids sum a warp's ds block
//     from shared memory into [64][gh + gw] fp32 accumulators there. At the
//     production shapes (aligned rows, D % 16 == 0, N % 64 == 0, gw = 64)
//     an instantiation without bounds checks runs, and the dk/dv pass
//     stages of each query tile only the block's 64 columns of rel_w and
//     the words of rel_h that hold its grid row (also at other gw % 64 == 0). Shared memory at D = 80:
//     the dq pass Q, G, K and V twice and rel_w (75 KB), the dk/dv pass K,
//     V, Q and G twice and the rel tables twice (86 KB); about 241
//     registers: two blocks (8 warps) an SM. D % 8 != 0 or unaligned rows
//     take 2-byte loads.
//   * fp32 (the demo_config training parity) stays on the CUDA-core engine
//     of attention_bwd.cuh.
#include <type_traits>

#include "attention_bwd.cuh"
#include "attention_mma_bwd.cuh"

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

// The bf16 route's problem on the tensor-core engine. FAST: the production
// shapes' instantiation (see launch_global below).
template <bool FAST_>
struct GlobalBwdMma {
  using bf16 = tc::bf16;
  static constexpr bool REL = true;
  static constexpr bool ONE_HOT = false;
  static constexpr bool TWO_LAUNCHES = false;
  static constexpr bool FAST = FAST_;
  struct Args {
    const bf16* q;
    const bf16* k;
    const bf16* v;
    const bf16* rel_h;
    const bf16* rel_w;
    const bf16* g;
    const float* lse;
    const float* delta;
    bf16* dq;
    bf16* dk;
    bf16* dv;
    bf16* drel_h;
    bf16* drel_w;
    int N, D, gh, gw;
    float scale;
    bool vec, rel_vec;
  };
  __host__ __device__ static size_t dq_extra_bytes(const Args& a) {
    return FAST ? tc::rel_stage_bytes_fast() : tc::rel_stage_bytes(a.gh, a.gw);
  }
  // The dk/dv pass's per-tile tables. Where a key block of 64 covers 64
  // columns of one grid row (gw % 64 == 0, aligned tables): only those
  // columns of rel_w, and the 4-byte word of rel_h that holds the grid row;
  // else all of the 64 queries' rel rows.
  __host__ __device__ static bool dkv_cols(int gw, bool rel_vec) {
    return rel_vec && gw % tc::BK == 0;
  }
  __host__ __device__ static size_t dkv_tab_bytes(int gh, int gw, bool rel_vec) {
    return dkv_cols(gw, rel_vec)
               ? sizeof(bf16) * tc::BQ * (tc::BK + tc::REL_PAD) + sizeof(uint32_t) * tc::BQ
               : tc::rel_stage_bytes(gh, gw);
  }
  static size_t dkv_extra_bytes(const Args& a) { return dkv_tab_bytes(a.gh, a.gw, a.rel_vec); }

  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* g;
  const bf16* rh;   // the head's rel_h / rel_w (the dk/dv pass reads them here)
  const bf16* rw;
  const float* lse;
  const float* delta;
  bf16* dqp;
  bf16* dkp;
  bf16* dvp;
  bf16* drhp;
  bf16* drwp;
  int64_t sq, sk, sv, sg;
  static constexpr int64_t sl = 1;   // lse and delta rows
  bool vec, rel_vec;
  int N, NK, D, gh, gw;
  float scale;
  bf16 qscale;
  tc::RelRows rel;   // the dq pass's staged rows

  __device__ GlobalBwdMma(const Args& a, int bh) {
    const int64_t off = int64_t(bh) * a.N * a.D;
    N = NK = a.N;
    D = a.D;
    gh = a.gh;
    gw = a.gw;
    scale = a.scale;
    qscale = __float2bfloat16_rn(a.scale);
    vec = a.vec;
    rel_vec = a.rel_vec;
    sq = sk = sv = sg = a.D;
    q = a.q + off;
    k = a.k + off;
    v = a.v + off;
    g = a.g + off;
    dqp = a.dq + off;
    dkp = a.dk + off;
    dvp = a.dv + off;
    rh = a.rel_h + int64_t(bh) * a.N * a.gh;
    rw = a.rel_w + int64_t(bh) * a.N * a.gw;
    drhp = a.drel_h + int64_t(bh) * a.N * a.gh;
    drwp = a.drel_w + int64_t(bh) * a.N * a.gw;
    lse = a.lse + int64_t(bh) * a.N;
    delta = a.delta + int64_t(bh) * a.N;
  }
  __device__ void stage(int q0, char* extra) {
    rel.stage<FAST>(rh, rw, q0, N, gh, gw, rel_vec, extra);
  }
  __device__ void bias_qk(float (&s)[tc::NT][4], int k0, int row, int nq) const {
    rel.add<FAST>(s, k0, row, nq, NK);
  }
  __device__ size_t tab_bytes() const { return dkv_tab_bytes(gh, gw, rel_vec); }
  __device__ void stage_q(int q0, int k0, char* buf) const {
    constexpr int WS = tc::BK + tc::REL_PAD;
    if (FAST || dkv_cols(gw, rel_vec)) {
      // rel_w[q0 + r, c0 .. c0 + 63] as [64][72]; the word of rel_h[q0 + r, .]
      // that holds the block's grid row
      const int nr = min(tc::BQ, N - q0), kh = k0 / gw, c0 = k0 - kh * gw;
      bf16* dw = reinterpret_cast<bf16*>(buf);
      const bf16* sw = rw + int64_t(q0) * gw + c0;
      for (int i = threadIdx.x; i < tc::BQ * 8; i += tc::NTHREADS) {
        const int r = i >> 3, c = i & 7;
        const bool ok = r < nr;
        tc::cp_async16(dw + r * WS + 8 * c, sw + (ok ? r * gw + 8 * c : 0), ok ? 16 : 0);
      }
      uint32_t* dh = reinterpret_cast<uint32_t*>(dw + tc::BQ * WS);
      const bf16* sh = rh + int64_t(q0) * gh + (kh & ~1);
      for (int r = threadIdx.x; r < tc::BQ; r += tc::NTHREADS)
        tc::cp_async4(dh + r, sh + (r < nr ? r * gh : 0), r < nr ? 4 : 0);
    } else if (tc::rel_staged(gh, gw)) {
      tc::stage_rel(reinterpret_cast<bf16*>(buf), rh, rw, q0, N, gh, gw, rel_vec);
    }
  }
  // rows: keys key, key + 8 of the block at k0; columns: queries q0 + 8 n +
  // 2 t + j, from the staged tables or from device memory
  __device__ void bias_kq(float (&s)[tc::NT][4], int q0, int k0, int key,
                          const char* buf) const {
    const int t = threadIdx.x & 3;
    if (FAST || dkv_cols(gw, rel_vec)) {
      // the block is grid row k0 / gw, its columns k0 % gw .. + 63
      constexpr int WS = tc::BK + tc::REL_PAD;
      const bf16* tw = reinterpret_cast<const bf16*>(buf) + (key - k0);
      const uint32_t* th = reinterpret_cast<const uint32_t*>(
          reinterpret_cast<const bf16*>(buf) + tc::BQ * WS);
      const int shift = ((FAST ? k0 / tc::BK : k0 / gw) & 1) * 16;
#pragma unroll
      for (int n = 0; n < tc::NT; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = 8 * n + 2 * t + j;
          const float bh = __uint_as_float((th[c] >> shift) << 16);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            s[n][2 * h + j] = (s[n][2 * h + j] + __bfloat162float(tw[c * WS + 8 * h])) + bh;
        }
      return;
    }
    const bool staged = tc::rel_staged(gh, gw);
    const bf16* th = staged ? reinterpret_cast<const bf16*>(buf) : rh + int64_t(q0) * gh;
    const int hs = staged ? gh + tc::REL_PAD : gh, ws = staged ? gw + tc::REL_PAD : gw;
    const bf16* tw = staged ? th + tc::BQ * hs : rw + int64_t(q0) * gw;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kk = key + 8 * h;
      if (kk >= NK) continue;
      const int kh = kk / gw, kw = kk - kh * gw;
#pragma unroll
      for (int n = 0; n < tc::NT; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = 8 * n + 2 * t + j;
          if (q0 + c < N)
            s[n][2 * h + j] = (s[n][2 * h + j] + __bfloat162float(tw[c * ws + kw])) +
                              __bfloat162float(th[c * hs + kh]);
        }
    }
  }
  __device__ bf16* dq_row(int r) const { return dqp + int64_t(r) * D; }
  __device__ bf16* dk_row(int key) const { return dkp + int64_t(key) * D; }
  __device__ bf16* dv_row(int key) const { return dvp + int64_t(key) * D; }
  __device__ void drh(int r, int i, float x) const {
    drhp[int64_t(r) * gh + i] = __float2bfloat16_rn(x);
  }
  __device__ void drw(int r, int i, float x) const {
    drwp[int64_t(r) * gw + i] = __float2bfloat16_rn(x);
  }
};

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

int launch_global(const void* q, const void* k, const void* v, const void* rel_h,
                  const void* rel_w, const void* g, const void* lse, const void* delta, void* dq,
                  void* dk, void* dv, void* drel_h, void* drel_w, int B, int H, int N, int D,
                  int gh, int gw, float scale, cudaStream_t st) {
  using bf16 = tc::bf16;
  const bool vec = D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(g) &&
                   aligned16(dq) && aligned16(dk) && aligned16(dv);
  const bool rel_vec = gh % 8 == 0 && gw % 8 == 0 && aligned16(rel_h) && aligned16(rel_w);
  // FAST: aligned rows, D a multiple of 16, whole tiles, and one key tile
  // per grid row (gw = 64, ViT-H's) with the rel rows staged: drel_w in
  // registers and no bounds checks at all
  const bool fast = vec && rel_vec && D % 16 == 0 && N % 64 == 0 && gw == tc::BK &&
                    tc::rel_staged(gh, gw);
  auto go = [&](auto fast_tag) {
    using P = GlobalBwdMma<decltype(fast_tag)::value>;
    typename P::Args a{static_cast<const bf16*>(q),     static_cast<const bf16*>(k),
                       static_cast<const bf16*>(v),     static_cast<const bf16*>(rel_h),
                       static_cast<const bf16*>(rel_w), static_cast<const bf16*>(g),
                       static_cast<const float*>(lse),  static_cast<const float*>(delta),
                       static_cast<bf16*>(dq),          static_cast<bf16*>(dk),
                       static_cast<bf16*>(dv),          static_cast<bf16*>(drel_h),
                       static_cast<bf16*>(drel_w),      N, D, gh, gw, scale, vec, rel_vec};
    return int(tc::launch_bwd<P>(a, D, B * H, N, N, st));
  };
  return fast ? go(std::true_type{}) : go(std::false_type{});
}

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

// dtype: 0 = float32 (CUDA-core engine: two launches, the dq + drel pass
// then the dk/dv pass), 1 = bfloat16 (tensor-core engine: one launch of
// both passes). Returns cudaGetLastError() after the launches.
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
    return launch_global(q, k, v, rel_h, rel_w, g, lse, delta, dq, dk, dv, drel_h, drel_w, B, H,
                         N, D, gh, gw, scale, st);
  return int(cudaErrorInvalidValue);
}
