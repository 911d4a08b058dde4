// K5: one-launch int4 matmul for decode rows (the fused q/k/v projection
// and the int4 lm_head). Replaces walkgpt_tpu/ops/int4.py:int4_matmul_pallas
// (_mm_kernel). Semantics kept from the TPU kernel:
//   * the weight is packed in half pairs: byte [i, n] holds rows i (low
//     nibble, sign-extended) and i + K/2 (high nibble, arithmetic shift);
//   * acc = x[:, :K/2] lo + x[:, K/2:] hi in fp32, then (acc * scale[n])
//     cast to x's dtype.
// Bound: bytes. At 2 rows the packed weight is all the traffic (qkv4
// 4096x12288: 25.2 MB; lm_head 4096x32128: 65.8 MB), so a launch is bound
// by device memory at 3.35 TB/s; the products are few.
// Design: one block of 512 threads per 128 output columns. Each lane reads
// 4 neighbouring columns of a packed row (one 32-bit load, a warp covers
// 128 contiguous bytes), the 16 warps split the K/2 packed rows between
// them, and the x rows sit in shared memory as fp32. The warps' partial
// sums are added in warp order through shared memory, so the result does
// not depend on scheduling. x rows are taken 4 at a time (the weight is
// read again for each group of 4; decode has 2).
// x: [M, K] contiguous (fp32 or bf16); p: [K/2, N] int8, N % 128 == 0;
// s: [N] fp32; out: [M, N] in x's dtype.
#include "attention_tile.cuh"

namespace {

using namespace wgt;

constexpr int COLS = 128;     // output columns per block, 4 per lane
constexpr int WARPS = 16;     // warps splitting the packed rows
constexpr int MB = 4;         // x rows per pass

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
int4_mm_kernel(const T* __restrict__ x, const int8_t* __restrict__ p,
               const float* __restrict__ s, T* __restrict__ out, int M, int K2, int N) {
  extern __shared__ float smem[];
  float* xs = smem;                         // [MB][2*K2]
  float* red = smem + MB * 2 * K2;          // [WARPS][MB][COLS]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col0 = blockIdx.x * COLS;
  const int K = 2 * K2;
  for (int m0 = 0; m0 < M; m0 += MB) {
    const int mb = min(MB, M - m0);
    __syncthreads();
    for (int i = threadIdx.x; i < mb * K; i += blockDim.x) xs[i] = to_f(x[size_t(m0) * K + i]);
    __syncthreads();
    float acc[MB][4];
#pragma unroll
    for (int m = 0; m < MB; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;
#pragma unroll 4
    for (int r = warp; r < K2; r += WARPS) {
      const char4 w = *reinterpret_cast<const char4*>(p + size_t(r) * N + col0 + lane * 4);
      const int b[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        if (m < mb) {
          const float xl = xs[m * K + r], xh = xs[m * K + K2 + r];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[m][c] += xl * lo4(b[c]) + xh * hi4(b[c]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MB; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) red[(warp * MB + m) * COLS + lane * 4 + c] = acc[m][c];
    __syncthreads();
    for (int i = threadIdx.x; i < mb * COLS; i += blockDim.x) {
      const int m = i / COLS, c = i - m * COLS;
      float sum = 0.f;
      for (int w = 0; w < WARPS; ++w) sum += red[(w * MB + m) * COLS + c];
      const int col = col0 + c;
      out[size_t(m0 + m) * N + col] = from_f<T>(sum * s[col]);
    }
  }
}

template <typename T>
int run(const void* x, const void* p, const void* s, void* out, int M, int K2, int N,
        cudaStream_t st) {
  const size_t smem = sizeof(float) * (size_t(MB) * 2 * K2 + size_t(WARPS) * MB * COLS);
  cudaError_t err = cudaFuncSetAttribute(int4_mm_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  int4_mm_kernel<T><<<N / COLS, WARPS * 32, smem, st>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(p), static_cast<const float*>(s),
      static_cast<T*>(out), M, K2, N);
  return int(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the launch.
extern "C" int wg_int4_matmul(const void* x, const void* p, const void* s, void* out, int M,
                              int K2, int N, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N % COLS || M <= 0 || K2 <= 0) return int(cudaErrorInvalidValue);
  if (dtype == 0) return run<float>(x, p, s, out, M, K2, N, st);
  if (dtype == 1) return run<__nv_bfloat16>(x, p, s, out, M, K2, N, st);
  return int(cudaErrorInvalidValue);
}
