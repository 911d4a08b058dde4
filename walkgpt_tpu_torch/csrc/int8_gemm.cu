// K13a and K13b: per-token int8 quantization (wg_quantize_tokens) and the
// W8A8 GEMM with its epilogue (wg_w8a8_gemm). Replace
// walkgpt_tpu/ops/int8_gemm.py:quantize_tokens (_quant_kernel) and
// :w8a8_gemm (_w8a8_kernel). Semantics kept from the TPU kernels, which take
// core/nn.linear's "a8" decisions, per row of x [M, K] in its type T:
//   * ax = max |x| over the row (exact in any type);
//   * inv = T(127 / max(ax, 1e-8)), a true division in fp32 rounded to T;
//   * code = clip(rint(T(x * inv)), -127, 127): the product is rounded to T
//     first (as on hardware), then rounded half to even;
//   * sx = 1 / float(inv).
// K13b: acc = the exact int32 sum of codes x w_q; y = (float(acc) * sx) *
// ws, then + b in fp32, then the activation (none, exact-erf gelu or tanh
// gelu, the TPU kernel's formulas), then the cast to T. This is not
// nn.linear's epilogue, which casts to T before adding the bias.
// FMA contraction: nvcc would fuse a product and a following sum into one
// rounding; every product, sum and division where the TPU kernel rounds is
// written with __fmul_rn / __fadd_rn / __fdiv_rn, which are never
// contracted, so the file needs no -fmad=false.
// Bounds, at the ViT-H block shapes of 2 images at 1024^2 (9800 window
// rows for a windowed block's qkv and proj, 8192 rows elsewhere): K13a is
// bound by bytes (read x, write codes and scales: fc2's input [8192, 5120]
// bf16 is 126 MB, about 38 us at 3.35 TB/s). K13b's qkv, fc1 and fc2 are
// bound by operations (fc1 [8192, 1280] x [1280, 5120]: 107 G int8
// operations, about 54 us at 1,979 TOP/s).
// Design. K13a: one warp per row (8 rows per block of 256 threads), two
// passes over the row (absmax, then codes), 4 values per lane per load.
// K13b: a 64 x 128 output tile per block of 8 warps. The block first takes
// its rows' inv and sx (a warp per row, over all of K), then walks K in
// 64-byte steps: the x tile is quantized on the fly into shared memory (4
// codes per 32-bit word along K), the w_q tile is transposed into the same
// K-packed words, and each warp runs int8 mma.sync m16n8k32 on its 32 x 32
// sub-tile. The int32 sums are exact, so their order does not matter.
// Requires K % 4 == 0, N % 4 == 0 and 16-byte aligned x rows.
#include "attention_tile.cuh"

namespace {

using namespace wgt;

constexpr int QNT = 256;            // K13a: threads per block, a warp per row
constexpr int GNT = 256;            // K13b: threads per block (2 x 4 warps)
constexpr int GBM = 64;             // K13b: output rows per block
constexpr int GBN = 128;            // K13b: output columns per block
constexpr int GBK = 64;             // K13b: bytes of K per step
constexpr int GKW = GBK / 4;        // 32-bit words of K per step
constexpr int GST = GKW + 4;        // padded word stride: conflict-free fragment loads

// four consecutive values of a row as fp32 (p 16-byte aligned for float,
// 8-byte for bf16)
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(p2[0]), b = __bfloat1622float2(p2[1]);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// max |x| over a row of K values (K % 4 == 0), by one warp
template <typename T>
__device__ float row_absmax(const T* row, int K, int lane) {
  float mx = 0.f, v[4];
  for (int k = 4 * lane; k < K; k += 128) {
    load4(row + k, v);
    mx = fmaxf(mx, fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])), fmaxf(fabsf(v[2]), fabsf(v[3]))));
  }
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  return mx;
}

// inv = T(127 / max(ax, 1e-8)), as an fp32 value
template <typename T>
__device__ __forceinline__ float quant_inv(float ax) {
  return round_to<T>(__fdiv_rn(127.0f, fmaxf(ax, 1e-8f)));
}

// clip(rint(T(x * inv)), -127, 127); for bf16 the fp32 product of two bf16
// values is exact, so rounding it to bf16 is the bf16 product
template <typename T>
__device__ __forceinline__ int quant_code(float x, float inv) {
  return int(fminf(fmaxf(rintf(round_to<T>(__fmul_rn(x, inv))), -127.f), 127.f));
}

// four codes packed little-endian into one word (byte c = value c)
template <typename T>
__device__ __forceinline__ uint32_t quant_word(const float v[4], float inv) {
  uint32_t w = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) w |= (uint32_t(quant_code<T>(v[c], inv)) & 0xffu) << (8 * c);
  return w;
}

template <typename T>
__global__ void __launch_bounds__(QNT)
quantize_rows(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ sx, int M,
              int K) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * (QNT / 32) + (threadIdx.x >> 5);
  if (m >= M) return;
  const T* row = x + size_t(m) * K;
  const float inv = quant_inv<T>(row_absmax(row, K, lane));
  uint32_t* out = reinterpret_cast<uint32_t*>(xq + size_t(m) * K);
  float v[4];
  for (int k = 4 * lane; k < K; k += 128) {
    load4(row + k, v);
    out[k / 4] = quant_word<T>(v, inv);
  }
  if (lane == 0) sx[m] = __fdiv_rn(1.0f, inv);
}

// the TPU kernel's activations (walkgpt_tpu/ops/int8_gemm.py _ACTS):
// 1: y * 0.5 * (1 + erf(y / sqrt(2))); 2: y * 0.5 * (1 + tanh(0.79788... *
// (y + 0.044715 * y * y * y))); 0: y
__device__ __forceinline__ float w8a8_act(float y, int act) {
  if (act == 1)
    return __fmul_rn(__fmul_rn(y, 0.5f), __fadd_rn(1.f, erff(__fdiv_rn(y, 1.41421356237309505f))));
  if (act == 2) {
    const float y3 = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, y), y), y);
    const float t = tanhf(__fmul_rn(0.7978845608028654f, __fadd_rn(y, y3)));
    return __fmul_rn(__fmul_rn(y, 0.5f), __fadd_rn(1.f, t));
  }
  return y;
}

// d += a (16 x 32, row) . b (32 x 8, col), int8 in, int32 sums
__device__ __forceinline__ void mma_s8(int d[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T>
__global__ void __launch_bounds__(GNT)
w8a8_kernel(const T* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ ws,
            const float* __restrict__ bias, T* __restrict__ out, int M, int K, int N, int act) {
  __shared__ uint32_t As[GBM * GST];     // [row][word]: 4 codes along K per word
  __shared__ uint32_t Bs[GBN * GST];     // [column][word]: 4 weights along K per word
  __shared__ float inv_s[GBM], sx_s[GBM];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;

  // each row's quantizer over all of K, a warp per row
  for (int r = warp; r < GBM; r += GNT / 32) {
    const int m = m0 + r;
    const float inv = m < M ? quant_inv<T>(row_absmax(x + size_t(m) * K, K, lane)) : 1.f;
    if (lane == 0) {
      inv_s[r] = inv;
      sx_s[r] = __fdiv_rn(1.0f, inv);
    }
  }
  __syncthreads();

  const int wm = warp >> 2, wn = warp & 3;     // this warp's 32 x 32 sub-tile
  const int g = lane >> 2, tig = lane & 3;     // mma fragment coordinates
  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;

  for (int k0 = 0; k0 < K; k0 += GBK) {
    // x tile -> codes (K % 4 == 0: a word's 4 values are all in or all out)
    for (int i = tid; i < GBM * GKW; i += GNT) {
      const int r = i / GKW, kw = i - r * GKW, m = m0 + r, k = k0 + 4 * kw;
      uint32_t word = 0;
      if (m < M && k < K) {
        float v[4];
        load4(x + size_t(m) * K + k, v);
        word = quant_word<T>(v, inv_s[r]);
      }
      As[r * GST + kw] = word;
    }
    // w tile [64 k, 128 n] -> column-major words: a thread reads 4 k rows of
    // 4 neighbouring columns and transposes the 4 x 4 bytes
    for (int i = tid; i < GKW * (GBN / 4); i += GNT) {
      const int kw = i / (GBN / 4), nq = i - kw * (GBN / 4);
      const int k = k0 + 4 * kw, n = n0 + 4 * nq;
      uint32_t rows[4] = {0u, 0u, 0u, 0u};
      if (n < N && k < K) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          rows[j] = *reinterpret_cast<const uint32_t*>(w + size_t(k + j) * N + n);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        uint32_t word = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) word |= ((rows[j] >> (8 * c)) & 0xffu) << (8 * j);
        Bs[(4 * nq + c) * GST + kw] = word;
      }
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < GKW / 8; ++s) {        // k32 steps of this tile
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = wm * 32 + mt * 16 + g;
        af[mt][0] = As[r * GST + 8 * s + tig];
        af[mt][1] = As[(r + 8) * GST + 8 * s + tig];
        af[mt][2] = As[r * GST + 8 * s + 4 + tig];
        af[mt][3] = As[(r + 8) * GST + 8 * s + 4 + tig];
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = wn * 32 + nt * 8 + g;
        bf[nt][0] = Bs[c * GST + 8 * s + tig];
        bf[nt][1] = Bs[c * GST + 8 * s + 4 + tig];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], af[mt], bf[nt]);
    }
    __syncthreads();
  }

  // epilogue: accumulator c (0..3) of a fragment is row g (+8 for c >= 2),
  // column 2 * tig + (c & 1)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = wm * 32 + mt * 16 + g + 8 * (c >> 1);
        const int m = m0 + r, n = n0 + wn * 32 + nt * 8 + 2 * tig + (c & 1);
        if (m < M && n < N) {
          float y = __fmul_rn(__fmul_rn(float(acc[mt][nt][c]), sx_s[r]), ws[n]);
          if (bias) y = __fadd_rn(y, bias[n]);
          out[size_t(m) * N + n] = from_f<T>(w8a8_act(y, act));
        }
      }
}

bool bad_shape(int M, int K) { return M <= 0 || K <= 0 || K % 4; }

}  // namespace

// x: [M, K] (dtype 0 = float32, 1 = bfloat16); xq: [M, K] int8; sx: [M]
// float32. Returns cudaGetLastError() after the launch.
extern "C" int wg_quantize_tokens(const void* x, void* xq, void* sx, int M, int K, int dtype,
                                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(M, K)) return int(cudaErrorInvalidValue);
  const int blocks = (M + QNT / 32 - 1) / (QNT / 32);
  if (dtype == 0)
    quantize_rows<float><<<blocks, QNT, 0, st>>>(static_cast<const float*>(x),
                                                 static_cast<int8_t*>(xq),
                                                 static_cast<float*>(sx), M, K);
  else if (dtype == 1)
    quantize_rows<__nv_bfloat16><<<blocks, QNT, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xq), static_cast<float*>(sx),
        M, K);
  else
    return int(cudaErrorInvalidValue);
  return int(cudaGetLastError());
}

// x: [M, K] (dtype 0 = float32, 1 = bfloat16); w: [K, N] int8; ws: [N]
// float32; bias: [N] float32 or null; out: [M, N] in x's dtype. act: 0 none,
// 1 exact gelu, 2 tanh gelu. Returns cudaGetLastError() after the launch.
extern "C" int wg_w8a8_gemm(const void* x, const void* w, const void* ws, const void* bias,
                            void* out, int M, int K, int N, int act, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(M, K) || N <= 0 || N % 4 || act < 0 || act > 2)
    return int(cudaErrorInvalidValue);
  const dim3 grid((N + GBN - 1) / GBN, (M + GBM - 1) / GBM);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* s = static_cast<const float*>(ws);
  const float* b = static_cast<const float*>(bias);
  if (dtype == 0)
    w8a8_kernel<float><<<grid, GNT, 0, st>>>(static_cast<const float*>(x), wq, s, b,
                                             static_cast<float*>(out), M, K, N, act);
  else if (dtype == 1)
    w8a8_kernel<__nv_bfloat16><<<grid, GNT, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), wq, s, b, static_cast<__nv_bfloat16*>(out), M, K,
        N, act);
  else
    return int(cudaErrorInvalidValue);
  return int(cudaGetLastError());
}
