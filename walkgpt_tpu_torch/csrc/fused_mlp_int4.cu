// K6: the int4 MLP of a decode step, silu(x Wg) * (x Wu) Wd (or gelu(x W1) W2
// without the up projection). Replaces walkgpt_tpu/ops/int4.py:fused_mlp_int4
// (_fused_mlp_kernel). Semantics kept from the TPU kernel:
//   * gate and up are packed in half pairs (byte [i, c] = rows i, i + H/2);
//     g = (x lo + x hi) * gs in fp32, act = silu(g) or exact gelu(g), times
//     (x lo + x hi of up) * us;
//   * h = act rounded to bf16, whatever x's dtype;
//   * the down weight is packed tile-local (byte [t*T/2 + i, n] = rows
//     t*T + i and t*T + T/2 + i, T = tile_for(I)); each tile's partial
//     (h_lo lo + h_hi hi) is scaled by ds before the tiles are summed;
//   * the tiles are summed in tile order (the TPU grid's accumulation order).
// Bound: bytes. At 2 rows the packed weights are the traffic (7B: 3 x
// 4096 x 11008 / 2 = 67.6 MB per launch, about 20 us at 3.35 TB/s).
// Design: pass 1, one block of 256 threads per intermediate tile. The block
// computes the tile's g and u columns (lanes read 4 neighbouring packed
// columns at once; thread groups split the packed rows and their sums are
// added in group order), keeps h in shared memory, and writes the tile's
// scaled partial [M, H] of the down product to scratch (4 output columns per
// thread). Pass 2 sums the partials in tile order. No atomics: the result
// does not depend on the order in which the card runs the tiles. x rows are
// taken 4 at a time.
// x: [M, H] (fp32 or bf16); gp, up: [H/2, I] int8; gs, us: [I] fp32 (up,
// us null for the gelu MLP); dp: [I/2, H] int8; ds: [H] fp32; scratch:
// [I/T, M, H] fp32; out: [M, H] in x's dtype. H % 4 == 0, T % 4 == 0.
#include "attention_tile.cuh"

namespace {

using namespace wgt;

constexpr int NT = 256;       // threads per block
constexpr int MB = 4;         // x rows per pass

template <typename T>
__global__ void __launch_bounds__(NT)
mlp4_tiles(const T* __restrict__ x, const int8_t* __restrict__ gp, const float* __restrict__ gs,
           const int8_t* __restrict__ up, const float* __restrict__ us,
           const int8_t* __restrict__ dp, const float* __restrict__ ds,
           float* __restrict__ scratch, int M, int H, int I, int TI, int gelu) {
  extern __shared__ float smem[];
  const int H2 = H / 2, CG = TI / 4, RG = NT / CG;   // column groups, row groups
  float* xs = smem;                                  // [MB][H]
  float* red = xs + MB * H;                          // [2][RG][MB][TI]
  float* hs = red + 2 * RG * MB * TI;                // [MB][TI]
  const int t = blockIdx.x;
  const int cg = threadIdx.x % CG, rg = threadIdx.x / CG;
  const int col = t * TI + cg * 4;                   // first of this thread's 4 columns
  for (int m0 = 0; m0 < M; m0 += MB) {
    const int mb = min(MB, M - m0);
    __syncthreads();
    for (int i = threadIdx.x; i < mb * H; i += NT) xs[i] = to_f(x[size_t(m0) * H + i]);
    __syncthreads();
    if (rg < RG) {
      float ag[MB][4], au[MB][4];
#pragma unroll
      for (int m = 0; m < MB; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c) ag[m][c] = au[m][c] = 0.f;
#pragma unroll 2
      for (int r = rg; r < H2; r += RG) {
        const char4 wg = *reinterpret_cast<const char4*>(gp + size_t(r) * I + col);
        const int bg[4] = {wg.x, wg.y, wg.z, wg.w};
        int bu[4] = {0, 0, 0, 0};
        if (up) {
          const char4 wu = *reinterpret_cast<const char4*>(up + size_t(r) * I + col);
          bu[0] = wu.x; bu[1] = wu.y; bu[2] = wu.z; bu[3] = wu.w;
        }
#pragma unroll
        for (int m = 0; m < MB; ++m) {
          if (m < mb) {
            const float xl = xs[m * H + r], xh = xs[m * H + H2 + r];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              ag[m][c] += xl * lo4(bg[c]) + xh * hi4(bg[c]);
              au[m][c] += xl * lo4(bu[c]) + xh * hi4(bu[c]);
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
    }
    __syncthreads();
    for (int i = threadIdx.x; i < mb * TI; i += NT) {
      const int m = i / TI, c = i - m * TI;
      float g = 0.f, u = 0.f;
      for (int q = 0; q < RG; ++q) {
        g += red[((0 * RG + q) * MB + m) * TI + c];
        u += red[((1 * RG + q) * MB + m) * TI + c];
      }
      float a = act_fn(g * gs[t * TI + c], gelu);
      if (up) a = a * (u * us[t * TI + c]);
      hs[m * TI + c] = round_to<__nv_bfloat16>(a);
    }
    __syncthreads();
    const int half = TI / 2;
    const int8_t* dt = dp + size_t(t) * half * H;
    for (int n = threadIdx.x * 4; n < H; n += NT * 4) {
      float acc[MB][4];
#pragma unroll
      for (int m = 0; m < MB; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;
#pragma unroll 4
      for (int i = 0; i < half; ++i) {
        const char4 w = *reinterpret_cast<const char4*>(dt + size_t(i) * H + n);
        const int b[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int m = 0; m < MB; ++m) {
          if (m < mb) {
            const float hl = hs[m * TI + i], hh = hs[m * TI + half + i];
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[m][c] += hl * lo4(b[c]) + hh * hi4(b[c]);
          }
        }
      }
      for (int m = 0; m < mb; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          scratch[(size_t(t) * M + m0 + m) * H + n + c] = acc[m][c] * ds[n + c];
    }
  }
}

template <typename T>
int run(const void* x, const void* gp, const void* gs, const void* up, const void* us,
        const void* dp, const void* ds, void* scratch, void* out, int M, int H, int I, int TI,
        int gelu, cudaStream_t st) {
  const int RG = NT / (TI / 4);
  const size_t smem = sizeof(float) * (size_t(MB) * H + 2 * size_t(RG) * MB * TI
                                       + size_t(MB) * TI);
  cudaError_t err = cudaFuncSetAttribute(mlp4_tiles<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  mlp4_tiles<T><<<I / TI, NT, smem, st>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(gp), static_cast<const float*>(gs),
      static_cast<const int8_t*>(up), static_cast<const float*>(us),
      static_cast<const int8_t*>(dp), static_cast<const float*>(ds),
      static_cast<float*>(scratch), M, H, I, TI, gelu);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const int MH = M * H;
  sum_tiles<T><<<(MH + 255) / 256, 256, 0, st>>>(static_cast<const float*>(scratch),
                                                static_cast<T*>(out), I / TI, MH);
  return int(cudaGetLastError());
}

}  // namespace

// up/us may be null (the gelu MLP). dtype: 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() after the launches.
extern "C" int wg_fused_mlp_int4(const void* x, const void* gp, const void* gs, const void* up,
                                 const void* us, const void* dp, const void* ds, void* scratch,
                                 void* out, int M, int H, int I, int TI, int gelu, int dtype,
                                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || H % 4 || TI % 4 || TI > 4 * NT || I % TI || (NT % (TI / 4)))
    return int(cudaErrorInvalidValue);
  if (dtype == 0)
    return run<float>(x, gp, gs, up, us, dp, ds, scratch, out, M, H, I, TI, gelu, st);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, gp, gs, up, us, dp, ds, scratch, out, M, H, I, TI, gelu, st);
  return int(cudaErrorInvalidValue);
}
