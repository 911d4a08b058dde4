// One intermediate tile of the int4 MLP for up to MLP4_MB rows: the tile code
// of K6 (fused_mlp_int4.cu), also run by the MLP phase of K12
// (fused_layer.cu). Semantics (walkgpt_tpu/ops/int4.py _fused_mlp_kernel and
// walkgpt_tpu/ops/fused_layer.py _kernel):
//   * gate and up are packed in half pairs (byte [i, c] = rows i, i + H/2);
//     g = (x lo + x hi) * gs in fp32, act = silu(g) or exact gelu(g), times
//     (x lo + x hi of up) * us;
//   * h = act rounded to bf16;
//   * the down weight is packed tile-local (byte [t*T/2 + i, n] = rows
//     t*T + i and t*T + T/2 + i, T the tile); the tile's partial (h_lo lo +
//     h_hi hi) is scaled by ds and written to scratch (the caller sums the
//     tiles in tile order).
// A block of MLP4_NT threads computes the tile's g and u columns (lanes read
// 4 neighbouring packed columns at once; thread groups split the packed rows
// and their sums are added in group order), keeps h in shared memory, and
// writes the tile's scaled partial of the down product (4 output columns per
// thread). No atomics: the result does not depend on the order in which the
// card runs the tiles.
#pragma once

#include "attention_tile.cuh"

namespace wgt {

constexpr int MLP4_NT = 256;   // threads per block
constexpr int MLP4_MB = 4;     // rows per pass

// floats of shared memory the tile needs besides the rows: red
// [2][RG][MB][TI] and h [MB][TI], RG = MLP4_NT / (TI / 4)
inline size_t mlp4_work_floats(int TI) {
  const int RG = MLP4_NT / (TI / 4);
  return 2 * size_t(RG) * MLP4_MB * TI + size_t(MLP4_MB) * TI;
}

// Tile t for rows [m0, m0 + mb) of the input, mb <= MLP4_MB. xs: those rows
// [mb][H] in fp32 in shared memory (not modified); work: mlp4_work_floats(TI)
// floats of shared memory. gp, up: [H/2, I] int8; gs, us: [I] fp32 (up, us
// null for the gelu MLP); dp: [I/2, H] int8; ds: [H] fp32; scratch:
// [I/TI, M, H] fp32 receives rows m0.. of tile t. H % 4 == 0, TI % 4 == 0.
__device__ __forceinline__ void mlp4_tile(const float* xs, int mb, int m0, int t,
                                          const int8_t* __restrict__ gp,
                                          const float* __restrict__ gs,
                                          const int8_t* __restrict__ up,
                                          const float* __restrict__ us,
                                          const int8_t* __restrict__ dp,
                                          const float* __restrict__ ds,
                                          float* __restrict__ scratch, int M, int H, int I,
                                          int TI, int gelu, float* work) {
  constexpr int MB = MLP4_MB;
  const int H2 = H / 2, CG = TI / 4, RG = MLP4_NT / CG;   // column groups, row groups
  float* red = work;                                      // [2][RG][MB][TI]
  float* hs = red + 2 * RG * MB * TI;                     // [MB][TI]
  const int cg = threadIdx.x % CG, rg = threadIdx.x / CG;
  const int col = t * TI + cg * 4;                        // first of this thread's 4 columns
  __syncthreads();                                        // a previous tile is done with work
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
  for (int i = threadIdx.x; i < mb * TI; i += MLP4_NT) {
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
  for (int n = threadIdx.x * 4; n < H; n += MLP4_NT * 4) {
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

}  // namespace wgt
