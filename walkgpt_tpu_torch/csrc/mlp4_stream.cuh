// The tile code of K6 (fused_mlp_int4.cu): the int4 MLP of a decode step in
// three launches that stream the packed weights through every SM. Its
// product loop (stream_nibbles) is also K5's (int4_matmul.cu), and its two
// passes (gate_up_item, down_item) are also K12's MLP phases
// (fused_layer.cu), which run them grid-strided inside one cooperative
// launch. Semantics (walkgpt_tpu/ops/int4.py _fused_mlp_kernel):
//   * gate and up are packed in half pairs (byte [i, c] = rows i, i + H/2);
//     g = (x lo + x hi) * gs in fp32, act = silu(g) or exact gelu(g), times
//     (x lo + x hi of up) * us;
//   * h = act rounded to bf16;
//   * the down weight is packed tile-local (byte [t*T/2 + i, n] = rows
//     t*T + i and t*T + T/2 + i, T the tile); each tile's partial (h_lo lo +
//     h_hi hi) is scaled by ds; the tiles are summed in tile order.
// Every product of x (bf16, or fp32) or h (bf16) and a 4-bit code is formed
// by an explicit fmaf, and every fp32 sum runs in an order fixed by the
// shapes alone: a row's sums never depend on M or on the row's place in the
// batch, so row r of an M-row call is row r called alone, bit for bit, and
// two calls give the same bits.
// Nibbles become fp32 by bit operations, not int-to-float conversions: the
// code n + 8 (n ^ 8 on the raw nibble) is put into the low byte of 2^23
// (0x4B0000xx, one byte permute) and 2^23 + 8 is subtracted, which is exact.
// Weights are read 16 bytes a thread (16 neighbouring packed columns of one
// row) with non-allocating loads, 8 rows in flight per thread (4 in passes
// of 4 rows, so that two blocks fit an SM's registers).
//   1. mlp4_gate_up: a block per 32 columns of I (I / 32 blocks). Threads
//      0-127 take gate, 128-255 up; in each half, 2 column groups of 16 x 64
//      row lanes, lane r summing rows r, r + 64, ... in order; the 64 lane
//      partials are summed in lane order through shared memory; h is
//      written once, bf16 [M, I].
//   2. mlp4_down: a block per (tile t, 512 output columns): 8 row lanes (one
//      per warp, rows i, i + 8, ... of the tile) x 32 column groups of 16;
//      the lane partials are summed in lane order, scaled by ds and written
//      to parts [I/T, M, H].
//   3. mlp4_sum_tiles (sum_tiles, attention_tile.cuh): the tiles in tile
//      order.
// Rows run in passes of MB (1, 2 or 4; a padded row computes zeros that are
// not written). The launch plan is mirrored by ops/int4.py:fused_mlp_int4_plan.
#pragma once

#include "attention_tile.cuh"

namespace wgt {

constexpr int S4_NT = 256;     // threads per block
// weight rows in flight per thread: 8, or 4 in passes of 4 rows (whose
// accumulators need the registers)
__host__ __device__ constexpr int s4_u(int MB) { return MB > 2 ? 4 : 8; }
constexpr int GU_CW = 32;      // gate/up columns per block
constexpr int GU_RL = 64;      // row lanes per matrix
constexpr int DN_NW = 512;     // down output columns per block
constexpr int DN_RL = S4_NT / 32;   // row lanes (one per warp)

// 16 bytes of streamed weights (read once: no L1 allocation)
__device__ __forceinline__ uint4 ld_stream16(const int8_t* p) {
  uint4 r;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}

// 16 bytes at p, of which the first n exist (the others read as 0); vec:
// all 16 exist and p is 16-byte aligned
__device__ __forceinline__ uint4 ld_bytes16(const int8_t* p, int n, bool vec) {
  if (vec) return ld_stream16(p);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (j < n) w[j >> 2] |= uint32_t(uint8_t(p[j])) << (8 * (j & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The high bytes of 2^23 (0x4B000000) for the byte permute below. Kept in
// constant memory, so that the compiler holds it in a register and gives the
// permute its selector as an immediate (with both as literals it loads the
// selector into a register before every permute).
__constant__ uint32_t kMagic2p23 = 0x4B00u;

// byte j of u (0..15) as the float 2^23 + u, minus 2^23 + 8: the signed code
__device__ __forceinline__ float code_of(uint32_t u, int j) {
  return __int_as_float(__byte_perm(u, kMagic2p23, 0x5440u | unsigned(j))) - 8388616.f;
}

// acc[c] (16 columns) += xl * lo(byte c) + xh * hi(byte c), lo first
__device__ __forceinline__ void fma_nibbles(float (&acc)[16], const uint4& w, float xl,
                                            float xh) {
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t lo = (ws[q] & 0x0F0F0F0Fu) ^ 0x08080808u;
    const uint32_t hi = ((ws[q] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float& a = acc[4 * q + j];
      a = fmaf(xl, code_of(lo, j), a);
      a = fmaf(xh, code_of(hi, j), a);
    }
  }
}

// acc[m] (16 columns, m < MB) += x_lo[m] * lo + x_hi[m] * hi over the packed
// rows r = r0, r0 + RL, ... < R, in that order, U rows in flight: row r is
// the 16 bytes at wp + r * ld (n of them exist; v16: all 16, aligned),
// x_lo[m] = xs[m * xld + r] and x_hi[m] = xs[m * xld + hoff + r]. The
// product loop of K6's two passes and of K5.
template <int MB, int U>
__device__ __forceinline__ void stream_nibbles(float (&acc)[MB][16], const int8_t* wp, size_t ld,
                                               int r0, int RL, int R, int n, bool v16,
                                               const float* xs, int xld, int hoff) {
  for (int rb = r0; rb < R; rb += RL * U) {
    uint4 wv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = rb + u * RL;
      wv[u] = r < R ? ld_bytes16(wp + size_t(r) * ld, n, v16) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = rb + u * RL;
      if (r < R) {
#pragma unroll
        for (int m = 0; m < MB; ++m)
          fma_nibbles(acc[m], wv[u], xs[m * xld + r], xs[m * xld + hoff + r]);
      }
    }
  }
}

// Shared memory (floats) of mlp4_gate_up: the rows xs [MB][H], later the
// lane partials [2][GU_RL][GU_RS].
__host__ __device__ constexpr int gu_rs(int MB) { return MB * GU_CW + 4; }
inline size_t gate_up_smem_floats(int MB, int H) {
  const size_t xs = size_t(MB) * H, red = size_t(2) * GU_RL * gu_rs(MB);
  return xs > red ? xs : red;
}
// ... of mlp4_down: h of the tile hs [MB][TI], then the partials [DN_RL][MB][DN_NW].
inline size_t down_smem_floats(int MB, int TI) {
  return size_t(MB) * TI + size_t(DN_RL) * MB * DN_NW;
}

// One gate/up item: columns [c0, c0 + GU_CW) of I for every row. xload(r,
// i) gives element i of input row r as fp32; gp, up: [H/2, I] packed (up
// null: gelu MLP); gs, us: [I]; h: [M, I] bf16 out; smem:
// gate_up_smem_floats(MB, H) floats. vec: I % 16 == 0 and gp, up 16-byte
// aligned. Every thread of the block calls it.
template <int MB, int U, class XLoad>
__device__ __forceinline__ void gate_up_item(XLoad xload, int c0, const int8_t* __restrict__ gp,
                                             const float* __restrict__ gs,
                                             const int8_t* __restrict__ up,
                                             const float* __restrict__ us,
                                             __nv_bfloat16* __restrict__ h, int M, int H, int I,
                                             int gelu, int vec, float* smem) {
  constexpr int RS = gu_rs(MB);
  const int H2 = H / 2, tid = threadIdx.x;
  const int half = tid / (S4_NT / 2), rl = (tid % (S4_NT / 2)) / 2, ch = tid % 2;
  const int col = c0 + ch * 16;
  const int8_t* w = half ? up : gp;
  const bool active = w != nullptr && col < I;
  const bool v16 = vec && col + 16 <= I;
  const int8_t* wp = active ? w + col : nullptr;
  for (int m0 = 0; m0 < M; m0 += MB) {
    const int mb = min(MB, M - m0);
    __syncthreads();                       // the previous pass or item is done with smem
    for (int i = tid; i < MB * H; i += S4_NT) {
      const int m = i / H;
      smem[i] = m < mb ? xload(m0 + m, i - m * H) : 0.f;
    }
    __syncthreads();
    float acc[MB][16];
#pragma unroll
    for (int m = 0; m < MB; ++m)
#pragma unroll
      for (int c = 0; c < 16; ++c) acc[m][c] = 0.f;
    if (active) stream_nibbles<MB, U>(acc, wp, I, rl, GU_RL, H2, I - col, v16, smem, H, H2);
    __syncthreads();                       // every lane is done with xs
    if (active) {
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        float* dst = smem + (half * GU_RL + rl) * RS + m * GU_CW + ch * 16;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          *reinterpret_cast<float4*>(dst + 4 * q) =
              make_float4(acc[m][4 * q], acc[m][4 * q + 1], acc[m][4 * q + 2], acc[m][4 * q + 3]);
      }
    }
    __syncthreads();
    for (int o = tid; o < mb * GU_CW; o += S4_NT) {
      const int m = o / GU_CW, c = o - m * GU_CW;
      if (c0 + c >= I) continue;
      float g = 0.f, u = 0.f;
      for (int r = 0; r < GU_RL; ++r) g += smem[r * RS + m * GU_CW + c];
      if (up)
        for (int r = 0; r < GU_RL; ++r) u += smem[(GU_RL + r) * RS + m * GU_CW + c];
      float a = act_fn(g * gs[c0 + c], gelu);
      if (up) a = a * (u * us[c0 + c]);
      h[size_t(m0 + m) * I + c0 + c] = __float2bfloat16(a);
    }
  }
}

// One down item: tile t, output columns [n0, n0 + DN_NW). h: [M, I] bf16
// (read through L2: in K12 another block of the same launch wrote it); dp:
// [I/2, H] tile-local packed; ds: [H]; parts: [I/TI, M, H] fp32 out; smem:
// down_smem_floats(MB, TI) floats. vec: H % 16 == 0 and dp 16-byte
// aligned. Every thread of the block calls it.
template <int MB, int U>
__device__ __forceinline__ void down_item(const __nv_bfloat16* h, int t, int n0,
                                          const int8_t* __restrict__ dp,
                                          const float* __restrict__ ds, float* __restrict__ parts,
                                          int M, int H, int I, int TI, int vec, float* smem) {
  float* hs = smem;                          // [MB][TI]
  float* red = smem + MB * TI;               // [DN_RL][MB][DN_NW]
  const int tid = threadIdx.x, half = TI / 2;
  const int cg = tid % 32, rl = tid / 32;
  const int col = n0 + cg * 16;
  const bool active = col < H, v16 = vec && col + 16 <= H;
  const int8_t* wp = dp + size_t(t) * half * H + col;
  for (int m0 = 0; m0 < M; m0 += MB) {
    const int mb = min(MB, M - m0);
    __syncthreads();                         // the previous pass or item is done with smem
    for (int i = tid; i < MB * TI; i += S4_NT) {
      const int m = i / TI;
      hs[i] = m < mb
          ? __bfloat162float(__ldcg(h + size_t(m0 + m) * I + size_t(t) * TI + (i - m * TI)))
          : 0.f;
    }
    __syncthreads();
    float acc[MB][16];
#pragma unroll
    for (int m = 0; m < MB; ++m)
#pragma unroll
      for (int c = 0; c < 16; ++c) acc[m][c] = 0.f;
    if (active) {
      stream_nibbles<MB, U>(acc, wp, H, rl, DN_RL, half, H - col, v16, hs, TI, half);
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        float* dst = red + (rl * MB + m) * DN_NW + cg * 16;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          *reinterpret_cast<float4*>(dst + 4 * q) =
              make_float4(acc[m][4 * q], acc[m][4 * q + 1], acc[m][4 * q + 2], acc[m][4 * q + 3]);
      }
    }
    __syncthreads();
    for (int o = tid; o < mb * DN_NW; o += S4_NT) {
      const int m = o / DN_NW, c = o - m * DN_NW, n = n0 + c;
      if (n >= H) continue;
      float s = 0.f;
      for (int r = 0; r < DN_RL; ++r) s += red[(r * MB + m) * DN_NW + c];
      parts[(size_t(t) * M + m0 + m) * H + n] = s * ds[n];
    }
  }
}

// x: [M, H] (T); the rest as gate_up_item's. A block per GU_CW columns.
template <typename T, int MB>
__global__ void __launch_bounds__(S4_NT)
mlp4_gate_up(const T* __restrict__ x, const int8_t* __restrict__ gp,
             const float* __restrict__ gs, const int8_t* __restrict__ up,
             const float* __restrict__ us, __nv_bfloat16* __restrict__ h, int M, int H, int I,
             int gelu, int vec) {
  extern __shared__ __align__(16) float smem[];
  gate_up_item<MB, s4_u(MB)>([&](int r, int i) { return to_f(x[size_t(r) * H + i]); },
                             blockIdx.x * GU_CW, gp, gs, up, us, h, M, H, I, gelu, vec, smem);
}

// down_item's arguments. Grid (ceil(H / DN_NW), I / TI).
template <int MB>
__global__ void __launch_bounds__(S4_NT)
mlp4_down(const __nv_bfloat16* __restrict__ h, const int8_t* __restrict__ dp,
          const float* __restrict__ ds, float* __restrict__ parts, int M, int H, int I, int TI,
          int vec) {
  extern __shared__ __align__(16) float smem[];
  down_item<MB, s4_u(MB)>(h, blockIdx.y, blockIdx.x * DN_NW, dp, ds, parts, M, H, I, TI, vec,
                          smem);
}

// parts [n_tiles, MH] -> out [MH], the tiles in tile order
template <typename T>
__global__ void mlp4_sum_tiles(const float* __restrict__ parts, T* __restrict__ out, int n_tiles,
                               int MH) {
  sum_tiles(parts, out, n_tiles, MH);
}

}  // namespace wgt
