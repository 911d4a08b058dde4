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
// (154 KB); here the 196 tokens stream in 64-row tiles through a dq pass
// (which also sums drel) and a dk/dv pass, both recomputing p from the
// forward's lse, reading q, k and v straight from the packed qkv lanes as
// K2 does.
// qkv [BW, T, 3*H*D], rel [BW, T, 2*H*ws], g [BW, T, H*D] contiguous; lse
// and delta [BW, T, H] fp32.
// Bound on an H100: ViT-H, 2 images (50 windows, 16 heads of 80) reads
// qkv, rel, g and writes dqkv, drel, about 194 MB (58 us at 3.35 TB/s);
// the products need about 25 GFLOP (25 us at the bf16 rate): bound by bytes.
// Two routes, chosen by dtype:
//   * bf16 (the encoder backward's path) runs on the tensor cores
//     (attention_mma_bwd.cuh, K3b's engine): the dq pass (4-warp blocks per
//     64-query tile of each (window, head)), then the dk/dv pass (per
//     64-key tile), in two launches, each compiled for three blocks an SM.
//     s = qs.k and dp = g.v are single bf16 mma.sync products with fp32
//     sums; dv = p^T.g, dk = ds^T.q and dq = ds.k take the fp32 p and ds
//     split as hi = bf16(x), lo = bf16(x - hi), two bf16 products into one
//     fp32 sum (about 16 significant bits of p and ds). The dq pass stages
//     its tile's rel rows and K2's key -> (k / ws, k % ws) table (WinRel,
//     K2's forward staging: 4-byte copies, a head's rel rows are 28 bytes
//     at ws = 14) and forms the bias as K2 does; drel_h and drel_w are
//     products of the split ds with one-hot matrices built from the key
//     table (ws <= 16), fp32 sums in registers; a key tile of 64 cuts
//     window rows, whose sums then run over two steps. The dk/dv pass
//     stages each query tile's rel rows. A warp whose rows all lie past T
//     (3 of the last tile's 4 at T = 196) forms no products. q, k, v and g
//     rows are 16-byte cp.async copies where D % 8 == 0 (head slices 160
//     bytes apart at D = 80), 2-byte loads otherwise; dq, dk and dv leave
//     through shared memory in 16-byte row stores. Shared memory at D = 80
//     and ws = 14: the dq pass 70 KB (Q, G, K and V twice; rel rows and
//     key table), the dk/dv pass 74 KB.
//   * fp32 (the demo_config parity runs) stays on the CUDA-core engine of
//     attention_bwd.cuh: two launches, the dq + drel pass, then dk/dv.
#include "attention_bwd.cuh"
#include "attention_mma_bwd.cuh"

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

// The bf16 route's problem on the tensor-core engine. The expressions of
// the bias, the products and the drel sums are K10b's (WindowSplitBwdMma),
// in the same order, so on the same values the two give the same bits.
struct WindowBwdMma {
  using bf16 = tc::bf16;
  static constexpr bool REL = true;
  static constexpr bool ONE_HOT = true;
  static constexpr bool TWO_LAUNCHES = true;
  static constexpr bool FAST = false;
  struct Args {
    const bf16* qkv;
    const bf16* rel;
    const bf16* g;
    const float* lse;
    const float* delta;
    bf16* dqkv;
    bf16* drel;
    int H, T_, D, gh, gw;   // gh = gw = ws
    float scale;
    bool vec, rel_w4;
  };
  __host__ __device__ static size_t dq_extra_bytes(const Args& a) {
    return tc::WinRel<bf16>::bytes(a.gw, a.T_);
  }
  static size_t dkv_extra_bytes(const Args& a) { return tc::WinRel<bf16>::rows_bytes(a.gw); }

  const bf16* q;   // the (window, head)'s row 0 of q, k, v, g
  const bf16* k;
  const bf16* v;
  const bf16* g;
  const bf16* rh;  // its rel_h and rel_w rows (row stride rl)
  const bf16* rw;
  const float* lse;
  const float* delta;
  bf16* dqp;
  bf16* drhp;
  int64_t sq, sk, sv, sg, sl, rl;
  bool vec, rel_w4;
  int N, NK, D, H, gh, gw, c;
  float scale;
  bf16 qscale;
  tc::WinRel<bf16> rel;   // the dq pass's staged rows

  __device__ WindowBwdMma(const Args& a, int wh) {
    const int w = wh / a.H, hh = wh - w * a.H;
    c = a.H * a.D;
    N = NK = a.T_;
    D = a.D;
    H = a.H;
    gh = gw = a.gw;
    scale = a.scale;
    qscale = __float2bfloat16_rn(a.scale);
    vec = a.vec;
    rel_w4 = a.rel_w4;
    sq = sk = sv = 3 * c;
    sg = c;
    sl = a.H;
    rl = 2 * a.H * a.gw;
    const int64_t row0 = int64_t(w) * a.T_;
    q = a.qkv + row0 * 3 * c + hh * a.D;
    k = q + c;
    v = q + 2 * c;
    g = a.g + row0 * c + hh * a.D;
    dqp = a.dqkv + row0 * 3 * c + hh * a.D;
    rh = a.rel + row0 * rl + hh * a.gw;
    rw = rh + a.H * a.gw;
    drhp = a.drel + row0 * rl + hh * a.gw;
    lse = a.lse + row0 * a.H + hh;
    delta = a.delta + row0 * a.H + hh;
  }
  __device__ void stage(int q0, char* extra) {
    rel.stage(rh + q0 * rl, rw + q0 * rl, rl, min(tc::BQ, N - q0), gw, N, rel_w4, extra);
  }
  __device__ void bias_qk(float (&s)[tc::NT][4], int k0, int row, int) const {
    rel.add(s, k0, row);
  }
  __device__ const uint16_t* kidx() const { return rel.kidx; }
  __device__ size_t tab_bytes() const { return tc::WinRel<bf16>::rows_bytes(gw); }
  __device__ void stage_q(int q0, int, char* buf) const {
    tc::WinRel<bf16>::stage_rows(rh + q0 * rl, rw + q0 * rl, rl, min(tc::BQ, N - q0), gw,
                                 rel_w4, buf);
  }
  __device__ void bias_kq(float (&s)[tc::NT][4], int, int, int key, const char* buf) const {
    tc::win_bias_kq<bf16>(s, buf, gw, key, NK);
  }
  __device__ bf16* dq_row(int r) const { return dqp + r * sq; }
  __device__ bf16* dk_row(int key) const { return dqp + key * sq + c; }
  __device__ bf16* dv_row(int key) const { return dqp + key * sq + 2 * c; }
  __device__ void drh(int r, int i, float x) const {
    drhp[r * rl + i] = __float2bfloat16_rn(x);
  }
  __device__ void drw(int r, int i, float x) const {
    drhp[r * rl + H * gw + i] = __float2bfloat16_rn(x);
  }
};

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

int launch_window(const void* qkv, const void* rel, const void* g, const void* lse,
                  const void* delta, void* dqkv, void* drel, int BW, int T_, int H, int D,
                  int ws, float scale, cudaStream_t st) {
  using bf16 = tc::bf16;
  if (ws > 255) return int(cudaErrorInvalidValue);   // the key table's 8-bit fields
  WindowBwdMma::Args a{static_cast<const bf16*>(qkv), static_cast<const bf16*>(rel),
                       static_cast<const bf16*>(g), static_cast<const float*>(lse),
                       static_cast<const float*>(delta), static_cast<bf16*>(dqkv),
                       static_cast<bf16*>(drel), H, T_, D, ws, ws, scale,
                       D % 8 == 0 && aligned16(qkv) && aligned16(g) && aligned16(dqkv),
                       ws % 2 == 0 && reinterpret_cast<uintptr_t>(rel) % 4 == 0};
  return int(tc::launch_bwd<WindowBwdMma>(a, D, BW * H, T_, T_, st));
}

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

// delta[r] = the sum over d of g[r, d] * out[r, d] in fp32, for the rows
// of two contiguous [rows, D] matrices (the output gradient and the output
// of K2b or K10b, in either layout): ops/flash_attention._delta, the plain
// part of the TPU backwards, in one pass over g and out instead of three.
// A warp a row; each lane sums its columns d = lane, lane + 32, ... by fma
// (a product of two bf16 values is exact in fp32), then the lanes' sums are
// added in a fixed butterfly order. Bound by bytes: ViT-H's windows read
// 50 MB (15 us at 3.35 TB/s).
template <typename T>
__global__ void __launch_bounds__(256) row_dot_kernel(const T* g, const T* o, float* delta,
                                                      int rows, int D) {
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (r >= rows) return;   // uniform across the warp
  const T* gr = g + int64_t(r) * D;
  const T* orow = o + int64_t(r) * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f(gr[d]), to_f(orow[d]), acc);
#pragma unroll
  for (int m = 16; m; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) delta[r] = acc;
}

template <typename T>
int row_dot(const void* g, const void* out, void* delta, int rows, int D, cudaStream_t st) {
  row_dot_kernel<T><<<(rows + 7) / 8, 256, 0, st>>>(static_cast<const T*>(g),
                                                     static_cast<const T*>(out),
                                                     static_cast<float*>(delta), rows, D);
  return int(cudaGetLastError());
}

}  // namespace

// delta of K2b and K10b (row_dot_kernel): g and out [rows, D] contiguous,
// delta [rows] fp32. dtype: 0 = float32, 1 = bfloat16. Returns
// cudaGetLastError() after the launch.
extern "C" int wg_sam_window_delta(const void* g, const void* out, void* delta, int rows, int D,
                                   int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return row_dot<float>(g, out, delta, rows, D, st);
  if (dtype == 1) return row_dot<__nv_bfloat16>(g, out, delta, rows, D, st);
  return int(cudaErrorInvalidValue);
}

// dtype: 0 = float32 (CUDA-core engine), 1 = bfloat16 (tensor-core
// engine); either way two launches, the dq + drel pass then the dk/dv
// pass. Returns cudaGetLastError() after the launches.
extern "C" int wg_sam_window_attention_bwd(const void* qkv, const void* rel, const void* g,
                                           const void* lse, const void* delta, void* dqkv,
                                           void* drel, int BW, int T, int H, int D, int ws,
                                           float scale, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(qkv, rel, g, lse, delta, dqkv, drel, BW, T, H, D, ws, scale, st);
  if (dtype == 1)
    return launch_window(qkv, rel, g, lse, delta, dqkv, drel, BW, T, H, D, ws, scale, st);
  return int(cudaErrorInvalidValue);
}
