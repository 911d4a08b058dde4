// K7: the W8A8 MLP of a decode step. Replaces
// walkgpt_tpu/ops/int4.py:fused_mlp_int8 (_fused_mlp8_kernel, with the
// quantize_rows of its caller folded in). Semantics kept from the TPU kernel:
//   * x rows quantized per row: sx = max(|x|max, 1e-8) * (1/127), xq =
//     clip(round(x * (1 / sx))) (a multiply by the reciprocal, half to even);
//   * the three products are exact int32 sums of int8 x int8;
//   * g = (g32 * sx) * gs, act = silu(g) or exact gelu(g), times
//     (u32 * sx) * us, all fp32;
//   * the intermediate is requantized per (row, tile), tile = tile_for(I),
//     with the same rule; each tile's partial is (d32 * hs) * ds;
//   * the tiles are summed in tile order (the TPU grid's accumulation order).
// Bound: bytes. At 2 rows the int8 weights are the traffic (1B: 3 x 2048 x
// 5504 = 33.8 MB per launch, about 10 us at 3.35 TB/s).
// Design as K6 (fused_mlp_int4.cu): pass 1, one block of 256 threads per
// intermediate tile, lanes reading 4 neighbouring int8 columns at once,
// integer sums in registers (exact, so the split of rows between thread
// groups does not change them), the requantized tile in shared memory, the
// tile's scaled partial to scratch; pass 2 sums the partials in tile order.
// x: [M, H] (fp32 or bf16); gq, uq: [H, I] int8; gs, us: [I] fp32 (uq, us
// null for the gelu MLP); dq: [I, H] int8; ds: [H] fp32; scratch:
// [I/T, M, H] fp32; out: [M, H] in x's dtype. H % 4 == 0, T % 4 == 0.
#include "attention_tile.cuh"

namespace {

using namespace wgt;

constexpr int NT = 256;       // threads per block
constexpr int MB = 4;         // x rows per pass

// max |v| over n values of shared memory, by the whole block (red: NT floats).
__device__ float block_absmax(const float* v, int n, float* red) {
  float mx = 0.f;
  for (int i = threadIdx.x; i < n; i += NT) mx = fmaxf(mx, fabsf(v[i]));
  red[threadIdx.x] = mx;
  __syncthreads();
  for (int w = NT / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] = fmaxf(red[threadIdx.x], red[threadIdx.x + w]);
    __syncthreads();
  }
  const float r = red[0];
  __syncthreads();
  return r;
}

__device__ __forceinline__ float quant_scale(float amax) {
  return fmaxf(amax, 1e-8f) * (1.0f / 127.0f);
}

__device__ __forceinline__ int quant(float v, float inv) {
  return int(fminf(fmaxf(rintf(v * inv), -127.f), 127.f));
}

template <typename T>
__global__ void __launch_bounds__(NT)
mlp8_tiles(const T* __restrict__ x, const int8_t* __restrict__ gq, const float* __restrict__ gs,
           const int8_t* __restrict__ uq, const float* __restrict__ us,
           const int8_t* __restrict__ dq, const float* __restrict__ ds,
           float* __restrict__ scratch, int M, int H, int I, int TI, int gelu) {
  extern __shared__ float smem[];
  const int CG = TI / 4, RG = NT / CG;               // column groups, row groups
  float* xf = smem;                                  // [MB][H] x, then its codes
  int* red = reinterpret_cast<int*>(xf + MB * H);    // [2][RG][MB][TI]
  float* hf = reinterpret_cast<float*>(red + 2 * RG * MB * TI);   // [MB][TI]
  float* scl = hf + MB * TI;                         // [2][MB]: sx, hs
  float* tmp = scl + 2 * MB;                         // [NT]
  const int t = blockIdx.x;
  const int cg = threadIdx.x % CG, rg = threadIdx.x / CG;
  const int col = t * TI + cg * 4;
  for (int m0 = 0; m0 < M; m0 += MB) {
    const int mb = min(MB, M - m0);
    __syncthreads();
    for (int i = threadIdx.x; i < mb * H; i += NT) xf[i] = to_f(x[size_t(m0) * H + i]);
    __syncthreads();
    for (int m = 0; m < mb; ++m) {
      const float sx = quant_scale(block_absmax(xf + m * H, H, tmp));
      const float inv = 1.0f / sx;
      for (int i = threadIdx.x; i < H; i += NT) xf[m * H + i] = float(quant(xf[m * H + i], inv));
      if (threadIdx.x == 0) scl[m] = sx;
    }
    __syncthreads();
    int ag[MB][4], au[MB][4];
#pragma unroll
    for (int m = 0; m < MB; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) ag[m][c] = au[m][c] = 0;
#pragma unroll 2
    for (int r = rg; r < H; r += RG) {
      const char4 wg = *reinterpret_cast<const char4*>(gq + size_t(r) * I + col);
      const int bg[4] = {wg.x, wg.y, wg.z, wg.w};
      int bu[4] = {0, 0, 0, 0};
      if (uq) {
        const char4 wu = *reinterpret_cast<const char4*>(uq + size_t(r) * I + col);
        bu[0] = wu.x; bu[1] = wu.y; bu[2] = wu.z; bu[3] = wu.w;
      }
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        if (m < mb) {
          const int xv = int(xf[m * H + r]);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            ag[m][c] += xv * bg[c];
            au[m][c] += xv * bu[c];
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MB; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        red[((0 * RG + rg) * MB + m) * TI + cg * 4 + c] = ag[m][c];
        red[((1 * RG + rg) * MB + m) * TI + cg * 4 + c] = au[m][c];
      }
    __syncthreads();
    for (int i = threadIdx.x; i < mb * TI; i += NT) {
      const int m = i / TI, c = i - m * TI;
      int g = 0, u = 0;
      for (int q = 0; q < RG; ++q) {
        g += red[((0 * RG + q) * MB + m) * TI + c];
        u += red[((1 * RG + q) * MB + m) * TI + c];
      }
      const float sx = scl[m];
      float a = act_fn(float(g) * sx * gs[t * TI + c], gelu);
      if (uq) a = a * (float(u) * sx * us[t * TI + c]);
      hf[m * TI + c] = a;
    }
    __syncthreads();
    for (int m = 0; m < mb; ++m) {
      const float hsc = quant_scale(block_absmax(hf + m * TI, TI, tmp));
      const float inv = 1.0f / hsc;
      for (int c = threadIdx.x; c < TI; c += NT) hf[m * TI + c] = float(quant(hf[m * TI + c], inv));
      if (threadIdx.x == 0) scl[MB + m] = hsc;
    }
    __syncthreads();
    const int8_t* dt = dq + size_t(t) * TI * H;
    for (int n = threadIdx.x * 4; n < H; n += NT * 4) {
      int acc[MB][4];
#pragma unroll
      for (int m = 0; m < MB; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[m][c] = 0;
#pragma unroll 4
      for (int i = 0; i < TI; ++i) {
        const char4 w = *reinterpret_cast<const char4*>(dt + size_t(i) * H + n);
        const int b[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int m = 0; m < MB; ++m) {
          if (m < mb) {
            const int hv = int(hf[m * TI + i]);
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[m][c] += hv * b[c];
          }
        }
      }
      for (int m = 0; m < mb; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          scratch[(size_t(t) * M + m0 + m) * H + n + c] =
              float(acc[m][c]) * scl[MB + m] * ds[n + c];
    }
  }
}

template <typename T>
int run(const void* x, const void* gq, const void* gs, const void* uq, const void* us,
        const void* dq, const void* ds, void* scratch, void* out, int M, int H, int I, int TI,
        int gelu, cudaStream_t st) {
  const int RG = NT / (TI / 4);
  const size_t smem = sizeof(float) * (size_t(MB) * H + 2 * size_t(RG) * MB * TI
                                       + size_t(MB) * TI + 2 * MB + NT);
  cudaError_t err = cudaFuncSetAttribute(mlp8_tiles<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  mlp8_tiles<T><<<I / TI, NT, smem, st>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(gq), static_cast<const float*>(gs),
      static_cast<const int8_t*>(uq), static_cast<const float*>(us),
      static_cast<const int8_t*>(dq), static_cast<const float*>(ds),
      static_cast<float*>(scratch), M, H, I, TI, gelu);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const int MH = M * H;
  sum_tiles<T><<<(MH + 255) / 256, 256, 0, st>>>(static_cast<const float*>(scratch),
                                                static_cast<T*>(out), I / TI, MH);
  return int(cudaGetLastError());
}

}  // namespace

// uq/us may be null (the gelu MLP). dtype: 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() after the launches.
extern "C" int wg_fused_mlp_int8(const void* x, const void* gq, const void* gs, const void* uq,
                                 const void* us, const void* dq, const void* ds, void* scratch,
                                 void* out, int M, int H, int I, int TI, int gelu, int dtype,
                                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || H % 4 || TI % 4 || TI > 4 * NT || I % TI || (NT % (TI / 4)))
    return int(cudaErrorInvalidValue);
  if (dtype == 0)
    return run<float>(x, gq, gs, uq, us, dq, ds, scratch, out, M, H, I, TI, gelu, st);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, gq, gs, uq, us, dq, ds, scratch, out, M, H, I, TI, gelu, st);
  return int(cudaErrorInvalidValue);
}
