// K6: the int4 MLP of a decode step, silu(x Wg) * (x Wu) Wd (or gelu(x W1) W2
// without the up projection). Replaces walkgpt_tpu/ops/int4.py:fused_mlp_int4
// (_fused_mlp_kernel). Semantics kept from the TPU kernel (mlp4_stream.cuh
// states them in full): fp32 sums of exact products of x and the 4-bit
// codes, h rounded to bf16, each tile's down partial scaled by ds, the tiles
// summed in tile order.
// Bound: bytes. At 2 rows the packed weights are the traffic (7B: 3 x 4096 x
// 11008 / 2 = 67.6 MB per launch, about 20 us at 3.35 TB/s).
// Design: fill the card with bytes in flight. The gate/up pass runs a block
// per 32 columns of I (344 blocks at 7B), the down pass a block per (tile,
// 512 output columns) (43 x 8 = 344 blocks), each thread streaming 16-byte
// loads, 8 rows deep, with nibbles turned into fp32 by bit operations; a
// third launch sums the tiles in order. Every sum has an order fixed by the
// shapes (no atomics), so the result is deterministic and a row's bits do
// not depend on the batch.
// x: [M, H] (fp32 or bf16); gp, up: [H/2, I] int8; gs, us: [I] fp32 (up, us
// null for the gelu MLP); dp: [I/2, H] int8; ds: [H] fp32; scratch: fp32,
// parts [I/T, M, H] followed by h [M, I] bf16 (ceil(M I / 2) floats); out:
// [M, H] in x's dtype. H % 4 == 0, T % 4 == 0.
#include <type_traits>

#include "mlp4_stream.cuh"

namespace {

using namespace wgt;

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, int MB>
int run_mb(const T* x, const int8_t* gp, const float* gs, const int8_t* up, const float* us,
           const int8_t* dp, const float* ds, float* parts, __nv_bfloat16* h, T* out, int M,
           int H, int I, int TI, int gelu, cudaStream_t st) {
  const size_t smem_a = sizeof(float) * gate_up_smem_floats(MB, H);
  const size_t smem_b = sizeof(float) * down_smem_floats(MB, TI);
  cudaError_t err = cudaFuncSetAttribute(mlp4_gate_up<T, MB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem_a));
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(mlp4_down<MB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem_b));
  if (err != cudaSuccess) return int(err);
  const int vec_a = I % 16 == 0 && aligned16(gp) && aligned16(up);
  const int vec_b = H % 16 == 0 && aligned16(dp);
  const int gu_blocks = (I + GU_CW - 1) / GU_CW;
  mlp4_gate_up<T, MB><<<gu_blocks, S4_NT, smem_a, st>>>(x, gp, gs, up, us, h, M, H, I, gelu, vec_a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const dim3 dn_grid((H + DN_NW - 1) / DN_NW, I / TI);
  mlp4_down<MB><<<dn_grid, S4_NT, smem_b, st>>>(h, dp, ds, parts, M, H, I, TI, vec_b);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const int MH = M * H;
  mlp4_sum_tiles<T><<<(MH + 255) / 256, 256, 0, st>>>(parts, out, I / TI, MH);
  return int(cudaGetLastError());
}

template <typename T>
int run(const void* x, const void* gp, const void* gs, const void* up, const void* us,
        const void* dp, const void* ds, void* scratch, void* out, int M, int H, int I, int TI,
        int gelu, cudaStream_t st) {
  float* parts = static_cast<float*>(scratch);
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(parts + size_t(I / TI) * M * H);
  const auto args = [&](auto mb_tag) {
    constexpr int MB = decltype(mb_tag)::value;
    return run_mb<T, MB>(static_cast<const T*>(x), static_cast<const int8_t*>(gp),
                         static_cast<const float*>(gs), static_cast<const int8_t*>(up),
                         static_cast<const float*>(us), static_cast<const int8_t*>(dp),
                         static_cast<const float*>(ds), parts, h, static_cast<T*>(out), M, H, I,
                         TI, gelu, st);
  };
  // rows per pass: 1 or 2 for a batch of that size, else 4 (a last pass of
  // fewer rows pads with zeros)
  if (M == 1) return args(std::integral_constant<int, 1>());
  if (M == 2) return args(std::integral_constant<int, 2>());
  return args(std::integral_constant<int, 4>());
}

}  // namespace

// up/us may be null (the gelu MLP). dtype: 0 = float32, 1 = bfloat16, 2 = float16
// (h stays bf16, as in the TPU kernel).
// Returns cudaGetLastError() after the launches.
extern "C" int wg_fused_mlp_int4(const void* x, const void* gp, const void* gs, const void* up,
                                 const void* us, const void* dp, const void* ds, void* scratch,
                                 void* out, int M, int H, int I, int TI, int gelu, int dtype,
                                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || H % 4 || TI % 4 || I % TI) return int(cudaErrorInvalidValue);
  if (dtype == 0)
    return run<float>(x, gp, gs, up, us, dp, ds, scratch, out, M, H, I, TI, gelu, st);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, gp, gs, up, us, dp, ds, scratch, out, M, H, I, TI, gelu, st);
  if (dtype == 2)
    return run<__half>(x, gp, gs, up, us, dp, ds, scratch, out, M, H, I, TI, gelu, st);
  return int(cudaErrorInvalidValue);
}
