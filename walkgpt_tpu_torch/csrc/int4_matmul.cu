// K5: one-launch int4 matmul for decode rows (the fused q/k/v projection
// and the int4 lm_head). Replaces walkgpt_tpu/ops/int4.py:int4_matmul_pallas
// (_mm_kernel). Semantics kept from the TPU kernel:
//   * the weight is packed in half pairs: byte [i, n] holds rows i (low
//     nibble) and i + K/2 (high nibble), two's complement;
//   * acc = x[:, :K/2] lo + x[:, K/2:] hi in fp32, then (acc * scale[n])
//     cast to x's dtype.
// Bound: bytes. At 2 rows the packed weight is all the traffic (qkv4
// 4096x12288: 25.2 MB; lm_head 4096x32128: 65.8 MB), so a launch is bound
// by device memory at 3.35 TB/s; the products are few.
// Design: K6's gate/up engine (mlp4_stream.cuh) with one matrix, no
// activation, and the scale and cast in the epilogue. A block of 128
// threads per 32 output columns (384 blocks for qkv4, 1004 for the
// lm_head): 2 column groups of 16 x 64 row lanes, lane r summing the packed
// rows r, r + 64, ... in order (stream_nibbles: 16-byte non-allocating
// loads of 16 packed columns of a row, 8 rows in flight, or 4 in passes of
// 4 rows; nibbles turned into fp32 by a byte permute, two explicit FMAs a
// byte, lo first). The 64 lane partials are summed in lane order through
// shared memory. Every sum runs in an order fixed by the shapes alone, so
// row r of an M-row call is row r called alone, bit for bit, and two calls
// give the same bits. Rows run in passes of 1, 2 or 4 (a padded row
// computes zeros that are not written); x is staged in shared memory as
// fp32 with 16-byte loads where it is aligned. The launch plan is mirrored
// by ops/int4.py:int4_matmul_plan.
// x: [M, K] contiguous (fp32 or bf16); p: [K/2, N] int8; s: [N] fp32; out:
// [M, N] in x's dtype.
#include <type_traits>

#include "mlp4_stream.cuh"

// in wgt, so that the profiler's kernel names carry the package's namespace
namespace wgt {
namespace {

constexpr int NT = 128;        // threads per block
constexpr int CW = 32;         // output columns per block: 2 groups of 16
constexpr int RL = NT / 2;     // row lanes

// Shared memory (floats): the rows xs [MB][K], later the lane partials
// [RL][red_stride(MB)].
__host__ __device__ constexpr int red_stride(int MB) { return MB * CW + 4; }
size_t smem_floats(int MB, int K) {
  const size_t xs = size_t(MB) * K, red = size_t(RL) * red_stride(MB);
  return xs > red ? xs : red;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// rows m < mb of x (width K) into xs [MB][K] as fp32, rows mb..MB-1 as 0;
// vx: 16-byte loads (K a multiple of 16 bytes of T, x 16-byte aligned)
template <typename T, int MB>
__device__ __forceinline__ void stage_rows(const T* __restrict__ x, int mb, int K, bool vx,
                                           float* xs) {
  constexpr int V = 16 / sizeof(T);
  const int tid = threadIdx.x;
#pragma unroll
  for (int m = 0; m < MB; ++m) {
    const T* row = x + size_t(m) * K;
    float* dst = xs + m * K;
    if (m >= mb) {
      for (int i = tid; i < K; i += NT) dst[i] = 0.f;
    } else if (vx) {
      for (int i = tid * V; i < K; i += NT * V) {
        const uint4 v = *reinterpret_cast<const uint4*>(row + i);
        T e[V];
        memcpy(e, &v, 16);
#pragma unroll
        for (int j = 0; j < V; j += 4)
          *reinterpret_cast<float4*>(dst + i + j) =
              make_float4(to_f(e[j]), to_f(e[j + 1]), to_f(e[j + 2]), to_f(e[j + 3]));
      }
    } else {
      for (int i = tid; i < K; i += NT) dst[i] = to_f(row[i]);
    }
  }
}

template <typename T, int MB>
__global__ void __launch_bounds__(NT)
int4_mm_stream(const T* __restrict__ x, const int8_t* __restrict__ p,
               const float* __restrict__ s, T* __restrict__ out, int M, int K2, int N, int vec,
               int vx) {
  extern __shared__ __align__(16) float smem[];
  constexpr int RS = red_stride(MB), U = s4_u(MB);
  const int K = 2 * K2, tid = threadIdx.x, rl = tid / 2, ch = tid % 2;
  const int c0 = blockIdx.x * CW, col = c0 + ch * 16;
  const bool active = col < N, v16 = vec && col + 16 <= N;
  for (int m0 = 0; m0 < M; m0 += MB) {
    const int mb = min(MB, M - m0);
    __syncthreads();                       // the previous pass is done with smem
    stage_rows<T, MB>(x + size_t(m0) * K, mb, K, vx, smem);
    __syncthreads();
    float acc[MB][16];
#pragma unroll
    for (int m = 0; m < MB; ++m)
#pragma unroll
      for (int c = 0; c < 16; ++c) acc[m][c] = 0.f;
    if (active) stream_nibbles<MB, U>(acc, p + col, N, rl, RL, K2, N - col, v16, smem, K, K2);
    __syncthreads();                       // every lane is done with xs
    if (active) {
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        float* dst = smem + rl * RS + m * CW + ch * 16;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          *reinterpret_cast<float4*>(dst + 4 * q) =
              make_float4(acc[m][4 * q], acc[m][4 * q + 1], acc[m][4 * q + 2], acc[m][4 * q + 3]);
      }
    }
    __syncthreads();
    for (int o = tid; o < mb * CW; o += NT) {
      const int m = o / CW, c = o - m * CW, n = c0 + c;
      if (n >= N) continue;
      float sum = 0.f;
      for (int r = 0; r < RL; ++r) sum += smem[r * RS + m * CW + c];
      out[size_t(m0 + m) * N + n] = from_f<T>(sum * s[n]);
    }
  }
}

template <typename T, int MB>
int run_mb(const T* x, const int8_t* p, const float* s, T* out, int M, int K2, int N,
           cudaStream_t st) {
  const size_t smem = sizeof(float) * smem_floats(MB, 2 * K2);
  if (smem > 48 * 1024) {       // above the default limit: opt in
    const cudaError_t err = cudaFuncSetAttribute(
        int4_mm_stream<T, MB>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  const int vec = N % 16 == 0 && aligned16(p);
  const int vx = (2 * K2) % (16 / int(sizeof(T))) == 0 && aligned16(x);
  int4_mm_stream<T, MB><<<(N + CW - 1) / CW, NT, smem, st>>>(x, p, s, out, M, K2, N, vec, vx);
  return int(cudaGetLastError());
}

template <typename T>
int run(const void* x, const void* p, const void* s, void* out, int M, int K2, int N,
        cudaStream_t st) {
  const auto args = [&](auto mb_tag) {
    constexpr int MB = decltype(mb_tag)::value;
    return run_mb<T, MB>(static_cast<const T*>(x), static_cast<const int8_t*>(p),
                         static_cast<const float*>(s), static_cast<T*>(out), M, K2, N, st);
  };
  // rows per pass: 1 or 2 for a batch of that size, else 4
  if (M == 1) return args(std::integral_constant<int, 1>());
  if (M == 2) return args(std::integral_constant<int, 2>());
  return args(std::integral_constant<int, 4>());
}

}  // namespace
}  // namespace wgt

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Returns cudaGetLastError() after
// the launch.
extern "C" int wg_int4_matmul(const void* x, const void* p, const void* s, void* out, int M,
                              int K2, int N, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K2 <= 0 || N <= 0) return int(cudaErrorInvalidValue);
  if (dtype == 0) return wgt::run<float>(x, p, s, out, M, K2, N, st);
  if (dtype == 1) return wgt::run<__nv_bfloat16>(x, p, s, out, M, K2, N, st);
  if (dtype == 2) return wgt::run<__half>(x, p, s, out, M, K2, N, st);
  return int(cudaErrorInvalidValue);
}
