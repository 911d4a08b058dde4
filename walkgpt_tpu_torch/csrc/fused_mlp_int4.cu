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
// Design: pass 1, one block of 256 threads per intermediate tile, running
// the tile code of mlp4_tile.cuh (shared with K12) on x rows taken 4 at a
// time; it writes the tile's scaled partial [M, H] of the down product to
// scratch. Pass 2 sums the partials in tile order. No atomics: the result
// does not depend on the order in which the card runs the tiles.
// x: [M, H] (fp32 or bf16); gp, up: [H/2, I] int8; gs, us: [I] fp32 (up,
// us null for the gelu MLP); dp: [I/2, H] int8; ds: [H] fp32; scratch:
// [I/T, M, H] fp32; out: [M, H] in x's dtype. H % 4 == 0, T % 4 == 0.
#include "mlp4_tile.cuh"

namespace {

using namespace wgt;

constexpr int NT = MLP4_NT;
constexpr int MB = MLP4_MB;

// one block per intermediate tile, MB x rows at a time
template <typename T>
__global__ void __launch_bounds__(NT)
mlp4_tiles(const T* __restrict__ x, const int8_t* __restrict__ gp, const float* __restrict__ gs,
           const int8_t* __restrict__ up, const float* __restrict__ us,
           const int8_t* __restrict__ dp, const float* __restrict__ ds,
           float* __restrict__ scratch, int M, int H, int I, int TI, int gelu) {
  extern __shared__ float smem[];
  float* xs = smem;                                  // [MB][H]
  for (int m0 = 0; m0 < M; m0 += MB) {
    const int mb = min(MB, M - m0);
    __syncthreads();
    for (int i = threadIdx.x; i < mb * H; i += NT) xs[i] = to_f(x[size_t(m0) * H + i]);
    mlp4_tile(xs, mb, m0, blockIdx.x, gp, gs, up, us, dp, ds, scratch, M, H, I, TI, gelu,
              xs + MB * H);
  }
}

template <typename T>
int run(const void* x, const void* gp, const void* gs, const void* up, const void* us,
        const void* dp, const void* ds, void* scratch, void* out, int M, int H, int I, int TI,
        int gelu, cudaStream_t st) {
  const size_t smem = sizeof(float) * (size_t(MB) * H + mlp4_work_floats(TI));
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
