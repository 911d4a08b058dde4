// K2: whole-window attention with the decomposed rel-pos bias over the
// packed layout, for the 28 windowed blocks of the SAM ViT encoder. Replaces
// walkgpt_tpu/ops/flash_attention.py:sam_window_attention_packed
// (_win_packed_fwd_kernel). Semantics kept from the TPU kernel:
//   * q * scale is rounded to the input dtype before the q.k product (the
//     scale itself is rounded to the input dtype first);
//   * bias[q, k] = rel[w, q, hh*ws + k/ws] + rel[w, q, (H+hh)*ws + k%ws],
//     added to the fp32 logit as s + (rel_h + rel_w);
//   * probabilities are rounded to the input dtype for the value product,
//     the softmax denominator uses the unrounded ones.
// Layout: qkv [BW, T, 3*H*D] unsplit (head hh's q, k, v at lane offsets
// hh*D, C + hh*D, 2C + hh*D with C = H*D); rel [BW, T, 2*H*ws];
// out [BW, T, H*D] merged heads; lse [BW, T, H] fp32. No padding is written
// to device memory: T = 196 and D = 80 are bounded and masked in the block.
// Bound on an H100: ViT-H, 2 images, qkv [50, 196, 3840] and rel [50, 196,
// 448] bf16 in, out [50, 196, 1280] bf16 and lse out: about 110 MB (33 us
// at 3.35 TB/s) against 9.8 GFLOP (10 us at the bf16 tensor-core rate):
// bound by bytes.
// Two routes, chosen by dtype:
//   * bf16 (the encoder's path) runs on the tensor cores (attention_mma.cuh):
//     a block of 4 warps per (64-query tile, window * head), 16 rows a
//     warp, the window's keys in tiles of 64 double-buffered by cp.async;
//     q.k and p.v are bf16 mma.sync m16n8k16 products with fp32 sums, the
//     TPU kernel's own products (single bf16 products there too). The head
//     views are read in place: q, k and v rows at a stride of 3*H*D, 16-byte
//     cp.async where D % 8 == 0 (each head starts 2*D bytes apart), 2-byte
//     loads otherwise. The tile's rel rows (as bf16, [64][ws] twice) and a
//     key -> (k / ws, k % ws) table are staged in shared memory once, so
//     the bias of a fragment's key pair is a table read, a rel_h read and
//     a paired rel_w read (ws even); the per-logit device-memory gathers
//     and the integer divide of the CUDA-core route are gone. q * scale is
//     rounded in the query fragments' registers, and the output is written
//     in bf16 pairs.
//     Padding at T = 196: 4 query tiles and 4 key tiles of 64 cover 256 x
//     256 for 196 x 196, about 1.7x the products the function needs. Kept
//     as it is: skipping the groups of 16 keys past T (208 keys, not 256)
//     measured slower, and letting the warps whose rows all lie past T skip
//     their products no faster (the products are not what bounds the
//     kernel; see PERF.md).
//     Softmax: online, as the engine runs it (p rounded to bf16 at the
//     running max; the TPU rounds at the row's max; the CUDA-core route was
//     online too). Shared memory at D = 80: Q, K and V twice (55 KB) and the
//     rel rows and key table (4 KB); 137 registers a thread: three blocks
//     (12 warps) an SM.
//   * fp32 (the demo_config parity runs) stays on the CUDA-core engine of
//     attention_tile.cuh: the tensor cores have no exact fp32 product.
#include "attention_mma.cuh"
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

// The bf16 route's problem on the tensor-core engine.
struct WindowMma {
  using bf16 = tc::bf16;
  static constexpr bool FAST = false;
  struct Args {
    const bf16* qkv;
    const bf16* rel;
    bf16* out;
    float* lse;
    int H, T_, D, ws;
    float scale;
    bool vec, rel_w4;
  };
  static size_t extra_bytes(const Args& a) { return tc::WinRel<bf16>::bytes(a.ws, a.T_); }

  const bf16* q;
  const bf16* k;
  const bf16* v;
  int64_t sq, sk, sv;
  bool vec;
  int D, nq, nk, nkt, H;
  bf16 qscale;
  tc::WinRel<bf16> rel;
  bf16* op;
  int64_t so;
  float* lp;

  __device__ WindowMma(const Args& a, int qtile, int wh, char* extra) {
    const int w = wh / a.H, hh = wh - w * a.H;
    const int q0 = qtile * tc::BQ;
    const int c = a.H * a.D;
    H = a.H;
    D = a.D;
    nq = min(tc::BQ, a.T_ - q0);
    nk = a.T_;
    nkt = (a.T_ + tc::BK - 1) / tc::BK;
    sq = sk = sv = 3 * c;
    const bf16* base = a.qkv + int64_t(w) * a.T_ * 3 * c;
    q = base + int64_t(q0) * 3 * c + hh * a.D;
    k = base + c + hh * a.D;
    v = base + 2 * c + hh * a.D;
    vec = a.vec;
    qscale = __float2bfloat16_rn(a.scale);
    const int rl = 2 * a.H * a.ws;
    const bf16* rb = a.rel + (int64_t(w) * a.T_ + q0) * rl;
    rel.stage(rb + hh * a.ws, rb + (a.H + hh) * a.ws, rl, nq, a.ws, a.T_, a.rel_w4, extra);
    op = a.out + (int64_t(w) * a.T_ + q0) * c + hh * a.D;
    so = c;
    lp = a.lse + (int64_t(w) * a.T_ + q0) * a.H + hh;
  }
  __device__ void add_bias(float (&s)[tc::NT][4], int k0, int row) const { rel.add(s, k0, row); }
  __device__ void lse(int r, float x) const { lp[int64_t(r) * H] = x; }
};

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

int launch_window(const void* qkv, const void* rel, void* out, void* lse, int BW, int T_, int H,
                  int D, int ws, float scale, cudaStream_t st) {
  using bf16 = tc::bf16;
  if (ws > 255) return int(cudaErrorInvalidValue);   // the key table's 8-bit fields
  WindowMma::Args a{static_cast<const bf16*>(qkv), static_cast<const bf16*>(rel),
                    static_cast<bf16*>(out), static_cast<float*>(lse), H, T_, D, ws, scale,
                    D % 8 == 0 && aligned16(qkv),
                    ws % 2 == 0 && reinterpret_cast<uintptr_t>(rel) % 4 == 0};
  const dim3 grid((T_ + tc::BQ - 1) / tc::BQ, BW * H);
  return int(tc::launch_fwd<WindowMma>(a, D, grid, st));
}

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

// dtype: 0 = float32 (CUDA-core engine), 1 = bfloat16 (tensor-core engine).
// Returns cudaGetLastError() after the launch.
extern "C" int wg_sam_window_attention_fwd(const void* qkv, const void* rel, void* out,
                                           void* lse, int BW, int T, int H, int D, int ws,
                                           float scale, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<float>(qkv, rel, out, lse, BW, T, H, D, ws, scale, st);
  if (dtype == 1) return launch_window(qkv, rel, out, lse, BW, T, H, D, ws, scale, st);
  return int(cudaErrorInvalidValue);
}
