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
// Design: fill the card with bytes in flight, in three launches (as K6),
// each a single wave of blocks:
//   1. mlp8_gate_up: a block of 256 threads per 32 columns of I (172 blocks
//      at 1B). Threads 0-127 take gate, 128-255 up; in each half, 2 column
//      groups of 16 x 64 row-quad lanes, lane l summing the quads q = l,
//      l + 64, ... (rows 4q .. 4q + 3), reading its 16 columns of each of
//      the 4 rows as one 16-byte non-allocating load (two neighbouring
//      lanes read a whole 32-byte sector), 2 quads in flight (1 in passes of
//      4 rows). The first quads are loaded before the block quantizes its x
//      rows (each block does: max |x| by the block, codes packed 4 to a
//      word in shared memory). The lanes' int32 sums are added through
//      shared memory; act goes to scratch as fp32 [M, I].
//   2. mlp8_down: a block of 128 threads per (tile t, 256 output columns)
//      (43 x 8 = 344 at 1B): 16 column groups of 16 x 8 row-quad lanes. Each
//      block reads its tile's act and requantizes it itself (every block of
//      a tile derives the same codes from the same fp32 values); the tile's
//      partial (d32 * hs) * ds goes to scratch [I/T, M, H].
//   3. mlp8_sum_tiles: the tiles in tile order.
// Both passes hold a thread to 128 registers, so that 2 gate/up or 4 down
// blocks fit an SM and all of them run at once at 1B (without the cap the
// compiler takes 132-160 and a pass runs in two or three waves).
// Products (dp4a_quads.cuh, shared with K12's o-projection): __dp4a of
// the codes of one x row on 4 consecutive rows (one word) against the 4
// weights of one column on those rows. A loaded quad
// holds, for each 4 columns, 4 words of 4 columns each (one per row); 8
// byte permutes transpose them into 4 words of 4 rows each (one per
// column). So a quad of 64 weight bytes costs 32 permutes and 16 dp4a per x
// row: 1 instruction a weight byte at 2 rows (3 with a byte extract and an
// integer multiply-add per byte and row). The weights need no conversion.
// Every integer sum is exact, so splitting the rows between lanes and
// blocks leaves the int32 sums as they were: the float expressions above
// are the only roundings, written with the same operands in the same order
// as before. A row's output does not depend on the other rows of the call.
// Rows run in passes of 1, 2 or 4 (a padded row has zero codes and is not
// written). The launch plan is mirrored by ops/int4.py:fused_mlp_int8_plan.
// x: [M, H] (fp32 or bf16); gq, uq: [H, I] int8; gs, us: [I] fp32 (uq, us
// null for the gelu MLP); dq: [I, H] int8; ds: [H] fp32; scratch: fp32, act
// [M, I] followed by the parts [I/T, M, H]; out: [M, H] in x's dtype.
// H % 4 == 0, T % 4 == 0, I % T == 0.
#include <type_traits>

#include "dp4a_quads.cuh"

// in wgt, so that the profiler's kernel names carry the package's namespace
namespace wgt {
namespace {

// The block shapes (timed against others on the H100: one wave of blocks,
// whole 32-byte sectors, registers capped so that the blocks fit):
constexpr int G8_NT = 256;            // gate/up threads per block
constexpr int G8_MINB = 2;            // gate/up blocks an SM must fit (128 registers)
constexpr int G8_CG = 2;              // gate/up column groups of 16 per matrix
constexpr int G8_CW = 16 * G8_CG;     // gate/up columns per block
constexpr int G8_QL = G8_NT / 2 / G8_CG;   // gate/up quad lanes per matrix and group
constexpr int D8_NT = 128;            // down threads per block
constexpr int D8_MINB = 4;            // down blocks an SM must fit (128 registers)
constexpr int D8_CG = 16;             // down column groups of 16
constexpr int D8_NW = 16 * D8_CG;     // down output columns per block
constexpr int D8_QL = D8_NT / D8_CG;  // down quad lanes
constexpr int D8_RS = 17 * D8_CG;     // a down partials row (odd stride: no bank conflicts)
// row quads in flight per lane: 2, or 1 in passes of 4 rows (whose
// accumulators need the registers)
__host__ __device__ constexpr int quads_in_flight(int MB) { return MB > 2 ? 1 : 2; }
__host__ __device__ constexpr int g8_rs(int MB) { return 16 * MB + 4; }

__device__ __forceinline__ float quant_scale(float amax) {
  return fmaxf(amax, 1e-8f) * (1.0f / 127.0f);
}

__device__ __forceinline__ int quant(float v, float inv) {
  return int(fminf(fmaxf(rintf(v * inv), -127.f), 127.f));
}

// The codes of rows m < mb (n values each, row m at src + m * ld) into
// codes[m * n/4 + q] (byte j: value 4q + j), rows mb..MB-1 as zero codes,
// and each row's scale quant_scale(max |v|) into scl[m]: by the whole block
// (NT threads; red: NT / 32 * MB floats). Ends with a barrier.
template <typename T, int MB, int NT>
__device__ void quantize_rows(const T* __restrict__ src, size_t ld, int mb, int n,
                              uint32_t* codes, float* scl, float* red) {
  constexpr int NW = NT / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float mx[MB];
#pragma unroll
  for (int m = 0; m < MB; ++m) {
    mx[m] = 0.f;
    if (m < mb)
      for (int i = tid; i < n; i += NT) mx[m] = fmaxf(mx[m], fabsf(to_f(src[m * ld + i])));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx[m] = fmaxf(mx[m], __shfl_xor_sync(0xffffffffu, mx[m], o));
    if (lane == 0) red[m * NW + warp] = mx[m];
  }
  __syncthreads();
  const int nq = n / 4;
#pragma unroll
  for (int m = 0; m < MB; ++m) {
    float amax = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) amax = fmaxf(amax, red[m * NW + w]);
    const float sx = quant_scale(amax);
    const float inv = 1.0f / sx;
    if (tid == 0) scl[m] = sx;
    for (int q = tid; q < nq; q += NT) {
      uint32_t word = 0;
      if (m < mb) {
        const T* v = src + m * ld + 4 * q;
#pragma unroll
        for (int j = 0; j < 4; ++j) word |= uint32_t(quant(to_f(v[j]), inv) & 0xFF) << (8 * j);
      }
      codes[m * nq + q] = word;
    }
  }
  __syncthreads();
}

// Shared memory (32-bit words) of mlp8_gate_up: the lane partials
// [2][G8_CG][G8_QL][g8_rs], the x codes [MB][H/4], the sums
// [2][G8_CG][MB][16], sx [MB] and the absmax partials [MB][NW].
size_t gate_up_smem_words(int MB, int H) {
  return size_t(G8_NT) * g8_rs(MB) + size_t(MB) * (H / 4) + 2 * G8_CG * MB * 16 + MB +
         G8_NT / 32 * MB;
}
// ... of mlp8_down: the partials [NW][MB][D8_RS], the codes [MB][TI/4], hs
// [MB] and the absmax partials [MB][NW].
size_t down_smem_words(int MB, int TI) {
  return size_t(D8_NT / 32) * MB * D8_RS + size_t(MB) * (TI / 4) + MB + D8_NT / 32 * MB;
}

// x: [M, H] (T); gq, uq: [H, I] (uq null: gelu MLP); gs, us: [I]; act: [M,
// I] fp32 out. vec: I % 16 == 0 and gq, uq 16-byte aligned.
template <typename T, int MB>
__global__ void __launch_bounds__(G8_NT, G8_MINB)
mlp8_gate_up(const T* __restrict__ x, const int8_t* __restrict__ gq,
             const float* __restrict__ gs, const int8_t* __restrict__ uq,
             const float* __restrict__ us, float* __restrict__ act, int M, int H, int I,
             int gelu, int vec) {
  extern __shared__ __align__(16) int smem8[];
  constexpr int U = quads_in_flight(MB), RS = g8_rs(MB);
  // the lanes' sums: OUTS outputs, TPO neighbouring threads each
  constexpr int OUTS = 2 * G8_CG * MB * 16, TPO = G8_NT > OUTS ? G8_NT / OUTS : 1;
  const int tid = threadIdx.x, half = tid / (G8_NT / 2), cg = tid % G8_CG;
  const int ql = tid % (G8_NT / 2) / G8_CG;
  const int nq = H / 4, c0 = blockIdx.x * G8_CW, col = c0 + cg * 16;
  const int8_t* w = half ? uq : gq;
  const bool active = w != nullptr && col < I, v16 = vec && col + 16 <= I;
  const int8_t* wp = active ? w + col : nullptr;
  int* red = smem8;                                                // [2][G8_CG][G8_QL][RS]
  uint32_t* xq = reinterpret_cast<uint32_t*>(red + G8_NT * RS);    // [MB][nq]
  int* gu = reinterpret_cast<int*>(xq + MB * nq);                  // [2][G8_CG][MB][16]
  float* scl = reinterpret_cast<float*>(gu + 2 * G8_CG * MB * 16);  // [MB]
  float* amax = scl + MB;                                          // [MB][NW]
  for (int m0 = 0; m0 < M; m0 += MB) {
    const int mb = min(MB, M - m0);
    uint4 wv[U][4];
    if (active) load_quads<U>(wv, wp, I, ql, G8_QL, nq, I - col, v16);
    __syncthreads();                       // the previous pass is done with smem
    quantize_rows<T, MB, G8_NT>(x + size_t(m0) * H, H, mb, H, xq, scl, amax);
    int acc[MB][16];
#pragma unroll
    for (int m = 0; m < MB; ++m)
#pragma unroll
      for (int c = 0; c < 16; ++c) acc[m][c] = 0;
    if (active) {
      stream_quads<MB, U>(acc, wv, wp, I, ql, G8_QL, nq, I - col, v16, xq);
      int* dst = red + ((half * G8_CG + cg) * G8_QL + ql) * RS;
#pragma unroll
      for (int m = 0; m < MB; ++m)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          *reinterpret_cast<int4*>(dst + m * 16 + 4 * q) =
              make_int4(acc[m][4 * q], acc[m][4 * q + 1], acc[m][4 * q + 2], acc[m][4 * q + 3]);
    }
    __syncthreads();
    // the lanes' sums (exact in any order); output o = (matrix, group, row,
    // column) at gu[o]
    for (int base = 0; base < OUTS * TPO; base += G8_NT) {
      const int o = (base + tid) / TPO, part = (base + tid) % TPO;
      const int hg = o / (MB * 16), mc = o % (MB * 16);
      int sum = 0;
      if (o < OUTS && (hg < G8_CG || uq != nullptr))
        for (int l = part; l < G8_QL; l += TPO) sum += red[(hg * G8_QL + l) * RS + mc];
#pragma unroll
      for (int off = TPO / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (part == 0 && o < OUTS) gu[o] = sum;
    }
    __syncthreads();
    for (int o = tid; o < mb * G8_CW; o += G8_NT) {
      const int m = o / G8_CW, c = o - m * G8_CW, n = c0 + c;
      if (n >= I) continue;
      const int g = ((c / 16) * MB + m) * 16 + c % 16;    // gate's sum; up's G8_CG * MB * 16 on
      const float sx = scl[m];
      float a = act_fn(float(gu[g]) * sx * gs[n], gelu);
      if (uq) a = a * (float(gu[G8_CG * MB * 16 + g]) * sx * us[n]);
      act[size_t(m0 + m) * I + n] = a;
    }
  }
}

// act: [M, I] fp32; dq: [I, H]; ds: [H]; parts: [I/TI, M, H] fp32 out. Grid
// (ceil(H / D8_NW), I / TI). vec: H % 16 == 0 and dq 16-byte aligned.
template <int MB>
__global__ void __launch_bounds__(D8_NT, D8_MINB)
mlp8_down(const float* __restrict__ act, const int8_t* __restrict__ dq,
          const float* __restrict__ ds, float* __restrict__ parts, int M, int H, int I, int TI,
          int vec) {
  extern __shared__ __align__(16) int smem8[];
  constexpr int U = quads_in_flight(MB);
  const int tid = threadIdx.x, cg = tid % D8_CG, ql = tid / D8_CG;
  const int lane = tid & 31, warp = tid >> 5;
  const int t = blockIdx.y, n0 = blockIdx.x * D8_NW, col = n0 + cg * 16, nq = TI / 4;
  const bool active = col < H, v16 = vec && col + 16 <= H;
  const int8_t* wp = dq + size_t(t) * TI * H + col;
  constexpr int NW = D8_NT / 32;
  int* red = smem8;                                                  // [NW][MB][D8_RS]
  uint32_t* hq = reinterpret_cast<uint32_t*>(red + NW * MB * D8_RS);  // [MB][nq]
  float* hsc = reinterpret_cast<float*>(hq + MB * nq);               // [MB]
  float* amax = hsc + MB;                                            // [MB][NW]
  for (int m0 = 0; m0 < M; m0 += MB) {
    const int mb = min(MB, M - m0);
    uint4 wv[U][4];
    if (active) load_quads<U>(wv, wp, H, ql, D8_QL, nq, H - col, v16);
    __syncthreads();                       // the previous pass is done with smem
    quantize_rows<float, MB, D8_NT>(act + size_t(m0) * I + size_t(t) * TI, I, mb, TI, hq, hsc,
                                    amax);
    int acc[MB][16];
#pragma unroll
    for (int m = 0; m < MB; ++m)
#pragma unroll
      for (int c = 0; c < 16; ++c) acc[m][c] = 0;
    if (active) stream_quads<MB, U>(acc, wv, wp, H, ql, D8_QL, nq, H - col, v16, hq);
    // a warp holds 32 / D8_CG quad lanes of the same columns: add them, then
    // the warps through shared memory
#pragma unroll
    for (int off = D8_CG; off < 32; off <<= 1)
#pragma unroll
      for (int m = 0; m < MB; ++m)
#pragma unroll
        for (int c = 0; c < 16; ++c) acc[m][c] += __shfl_xor_sync(0xffffffffu, acc[m][c], off);
    if (lane < D8_CG && active) {
#pragma unroll
      for (int m = 0; m < MB; ++m)
#pragma unroll
        for (int c = 0; c < 16; ++c) red[(warp * MB + m) * D8_RS + cg * 17 + c] = acc[m][c];
    }
    __syncthreads();
    for (int o = tid; o < mb * D8_NW; o += D8_NT) {
      const int m = o / D8_NW, c = o - m * D8_NW, n = n0 + c;
      if (n >= H) continue;
      int d = 0;
#pragma unroll
      for (int w = 0; w < NW; ++w) d += red[(w * MB + m) * D8_RS + (c / 16) * 17 + c % 16];
      parts[(size_t(t) * M + m0 + m) * H + n] = float(d) * hsc[m] * ds[n];
    }
  }
}

// parts [n_tiles, MH] -> out [MH], the tiles in tile order
template <typename T>
__global__ void mlp8_sum_tiles(const float* __restrict__ parts, T* __restrict__ out, int n_tiles,
                               int MH) {
  sum_tiles(parts, out, n_tiles, MH);
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// dynamic shared memory above the default 48 KB needs an opt-in
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

template <typename T, int MB>
int run_mb(const T* x, const int8_t* gq, const float* gs, const int8_t* uq, const float* us,
           const int8_t* dq, const float* ds, float* act, float* parts, T* out, int M, int H,
           int I, int TI, int gelu, cudaStream_t st) {
  const size_t smem_a = 4 * gate_up_smem_words(MB, H), smem_b = 4 * down_smem_words(MB, TI);
  cudaError_t err = allow_smem(mlp8_gate_up<T, MB>, smem_a);
  if (err != cudaSuccess) return int(err);
  err = allow_smem(mlp8_down<MB>, smem_b);
  if (err != cudaSuccess) return int(err);
  const int vec_a = I % 16 == 0 && aligned16(gq) && aligned16(uq);
  const int vec_b = H % 16 == 0 && aligned16(dq);
  mlp8_gate_up<T, MB><<<(I + G8_CW - 1) / G8_CW, G8_NT, smem_a, st>>>(x, gq, gs, uq, us, act, M,
                                                                      H, I, gelu, vec_a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const dim3 dn_grid((H + D8_NW - 1) / D8_NW, I / TI);
  mlp8_down<MB><<<dn_grid, D8_NT, smem_b, st>>>(act, dq, ds, parts, M, H, I, TI, vec_b);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const int MH = M * H;
  mlp8_sum_tiles<T><<<(MH + 255) / 256, 256, 0, st>>>(parts, out, I / TI, MH);
  return int(cudaGetLastError());
}

template <typename T>
int run(const void* x, const void* gq, const void* gs, const void* uq, const void* us,
        const void* dq, const void* ds, void* scratch, void* out, int M, int H, int I, int TI,
        int gelu, cudaStream_t st) {
  float* act = static_cast<float*>(scratch);
  float* parts = act + size_t(M) * I;
  const auto args = [&](auto mb_tag) {
    constexpr int MB = decltype(mb_tag)::value;
    return run_mb<T, MB>(static_cast<const T*>(x), static_cast<const int8_t*>(gq),
                         static_cast<const float*>(gs), static_cast<const int8_t*>(uq),
                         static_cast<const float*>(us), static_cast<const int8_t*>(dq),
                         static_cast<const float*>(ds), act, parts, static_cast<T*>(out), M, H,
                         I, TI, gelu, st);
  };
  // rows per pass: 1 or 2 for a batch of that size, else 4 (a last pass of
  // fewer rows pads with zero codes)
  if (M == 1) return args(std::integral_constant<int, 1>());
  if (M == 2) return args(std::integral_constant<int, 2>());
  return args(std::integral_constant<int, 4>());
}

}  // namespace
}  // namespace wgt

// uq/us may be null (the gelu MLP). dtype: 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() after the launches.
extern "C" int wg_fused_mlp_int8(const void* x, const void* gq, const void* gs, const void* uq,
                                 const void* us, const void* dq, const void* ds, void* scratch,
                                 void* out, int M, int H, int I, int TI, int gelu, int dtype,
                                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || H % 4 || TI % 4 || TI <= 0 || I % TI) return int(cudaErrorInvalidValue);
  if (dtype == 0)
    return wgt::run<float>(x, gq, gs, uq, us, dq, ds, scratch, out, M, H, I, TI, gelu, st);
  if (dtype == 1)
    return wgt::run<__nv_bfloat16>(x, gq, gs, uq, us, dq, ds, scratch, out, M, H, I, TI, gelu,
                                   st);
  return int(cudaErrorInvalidValue);
}
