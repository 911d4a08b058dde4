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
// Design. K13a (quantize_rows) reads each row from device memory once: a
// row is held in registers between its absmax and its codes. A thread
// takes segments of 16 values (K % 16 == 0: two or four 16-byte loads, one
// 16-byte store of codes) or else of 4 (one 8- or 16-byte load, a 4-byte
// store), segment s of a row going to thread s mod TPR of the row's TPR
// threads (a warp, or 2, 4 or 8 warps for long rows, 256 / TPR rows a
// block); every load of a thread is issued before the reduction (the max
// by shuffles, then across the row's warps through shared memory). A row
// longer than 256 threads can hold (16384 bf16 or 8192 fp32 values at 16
// a segment) is read twice, 256 threads a row. The plan is mirrored by
// ops/int8_gemm.py:quantize_tokens_plan.
// K13b (wg_w8a8_gemm_tc) in three launches on the wrapper's scratch: K13a's
// quantize_rows writes the codes xq [M, K] and sx [M] once (the first
// design recomputed every row's absmax and codes in each of the N / 128
// column tiles); transpose_w writes w_q K-major, wt [N, K], since the int8
// wgmma takes both operands K-major; then w8a8_wgmma: a 128 x 128 output
// tile per block of two consumer warpgroups (64 rows each) and one
// producer warp, which keeps TMA loads of 128-byte K steps of xq and wt
// (128B swizzle) in a ring of three stages on mbarriers; each consumer
// issues four wgmma.mma_async m64n128k32 s8.s8 -> s32 per stage and frees
// the previous stage when its products are done; the epilogue runs from
// the accumulator registers with the first design's expressions. Two
// blocks an SM (97 KB of shared memory each), so one block's epilogue
// overlaps the other's main loop. The int32 sums are exact and the codes
// and epilogue are the same, so the output is the first design's bit for
// bit. K % 16 == 0 is TMA's row-stride rule; other shapes take the first
// design (wg_w8a8_gemm): a 64 x 128 output tile per block of 8 warps that
// takes its rows' inv and sx itself, then walks K in 64-byte steps,
// quantizing the x tile on the fly and transposing the w_q tile into
// K-packed words in shared memory, int8 mma.sync m16n8k32 on each warp's
// 32 x 32 sub-tile. Requires K % 4 == 0, N % 4 == 0 and 16-byte aligned x
// rows.
#include <cuda.h>   // CUtensorMap and its enums (cuTensorMapEncodeTiled is looked up at run time)

#include "attention_tile.cuh"

namespace {

using namespace wgt;

constexpr int QNT = 256;            // K13a: threads per block
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

// K13a's plan: values a segment, threads a row, segments a thread (a
// power of two) and whether the row is held (else read twice)
struct QuantPlan {
  int seg, tpr, spt, held;
};

// segments a thread may hold: 64 registers of raw values
__host__ __device__ constexpr int quant_spt_max(int seg, int elem) {
  return seg == 16 && elem == 4 ? 4 : 8;
}

inline QuantPlan quant_plan(int K, int elem) {
  QuantPlan p{};
  p.seg = K % 16 == 0 ? 16 : 4;
  const int nseg = K / p.seg, smax = quant_spt_max(p.seg, elem);
  p.tpr = 32;
  while (p.tpr < QNT && p.tpr * smax < nseg) p.tpr *= 2;
  p.held = p.tpr * smax >= nseg;
  const int need = (nseg + p.tpr - 1) / p.tpr;
  p.spt = 1;
  while (p.held && p.spt < need) p.spt *= 2;
  return p;
}

// a segment of SEG values of T as raw 32-bit words
template <typename T, int SEG>
struct Seg {
  static constexpr int W = SEG * int(sizeof(T)) / 4;
  uint32_t w[W];
};

// 16 bytes read once (no L1 allocation)
__device__ __forceinline__ uint4 ld_once16(const void* p) {
  uint4 r;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}

// segment s of a row (16-byte loads; 8 bytes for 4 bf16 values)
template <typename T, int SEG>
__device__ __forceinline__ void load_seg(Seg<T, SEG>& g, const T* row, int s) {
  const T* p = row + size_t(s) * SEG;
  if constexpr (Seg<T, SEG>::W >= 4) {
#pragma unroll
    for (int i = 0; i < Seg<T, SEG>::W / 4; ++i) {
      const uint4 v = ld_once16(reinterpret_cast<const char*>(p) + 16 * i);
      g.w[4 * i] = v.x; g.w[4 * i + 1] = v.y; g.w[4 * i + 2] = v.z; g.w[4 * i + 3] = v.w;
    }
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    g.w[0] = v.x; g.w[1] = v.y;
  }
}

// value j of a segment as fp32 (a bf16 value is the high half of its fp32)
template <typename T, int SEG>
__device__ __forceinline__ float seg_val(const Seg<T, SEG>& g, int j) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(g.w[j]);
  } else {
    const uint32_t w = g.w[j >> 1];
    return __uint_as_float(j & 1 ? w & 0xFFFF0000u : w << 16);
  }
}

template <typename T, int SEG>
__device__ __forceinline__ float seg_absmax(const Seg<T, SEG>& g, float mx) {
#pragma unroll
  for (int j = 0; j < SEG; ++j) mx = fmaxf(mx, fabsf(seg_val(g, j)));
  return mx;
}

// the codes of segment s of a row into its codes row (16- or 4-byte stores)
template <typename T, int SEG>
__device__ __forceinline__ void store_codes(const Seg<T, SEG>& g, float inv, int8_t* qrow, int s) {
  uint32_t c[SEG / 4];
#pragma unroll
  for (int k = 0; k < SEG / 4; ++k) {
    const float v[4] = {seg_val(g, 4 * k), seg_val(g, 4 * k + 1), seg_val(g, 4 * k + 2),
                        seg_val(g, 4 * k + 3)};
    c[k] = quant_word<T>(v, inv);
  }
  int8_t* q = qrow + size_t(s) * SEG;
  if constexpr (SEG == 16)
    *reinterpret_cast<uint4*>(q) = make_uint4(c[0], c[1], c[2], c[3]);
  else
    *reinterpret_cast<uint32_t*>(q) = c[0];
}

// K13a: rows of K values (K % 4 == 0; 16-byte aligned x, and rows 8-byte
// aligned for bf16) to codes xq [M, K] and scales sx [M]. TPR threads a row
// (a power of two from 32 to QNT); HELD: segment s of a row to thread s mod
// TPR, at most SPT a thread, all loaded before the row's absmax; else the
// row is read twice (absmax, then codes), TPR = QNT.
template <typename T, int SEG, int SPT, bool HELD>
__global__ void __launch_bounds__(QNT)
quantize_rows(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ sx, int M,
              int K, int TPR) {
  __shared__ float red[QNT / 32];
  const int nseg = K / SEG, rpb = QNT / TPR;
  const int t = threadIdx.x % TPR, r = threadIdx.x / TPR, lane = threadIdx.x & 31;
  const int m = blockIdx.x * rpb + r;
  const bool live = m < M;
  const T* row = x + size_t(live ? m : 0) * K;
  Seg<T, SEG> g[HELD ? SPT : 1];
  float mx = 0.f;
  if (HELD) {
#pragma unroll
    for (int i = 0; i < SPT; ++i)
      if (live && t + i * TPR < nseg) load_seg(g[i], row, t + i * TPR);
#pragma unroll
    for (int i = 0; i < SPT; ++i)
      if (live && t + i * TPR < nseg) mx = seg_absmax(g[i], mx);
  } else {
    for (int s = t; live && s < nseg; s += TPR) {
      load_seg(g[0], row, s);
      mx = seg_absmax(g[0], mx);
    }
  }
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (TPR > 32) {
    if (lane == 0) red[threadIdx.x >> 5] = mx;
    __syncthreads();
    const int w0 = r * (TPR / 32);
    for (int w = 0; w < TPR / 32; ++w) mx = fmaxf(mx, red[w0 + w]);
  }
  if (!live) return;
  const float inv = quant_inv<T>(mx);
  int8_t* qrow = xq + size_t(m) * K;
  if (HELD) {
#pragma unroll
    for (int i = 0; i < SPT; ++i)
      if (t + i * TPR < nseg) store_codes(g[i], inv, qrow, t + i * TPR);
  } else {
    for (int s = t; s < nseg; s += TPR) {
      load_seg(g[0], row, s);
      store_codes(g[0], inv, qrow, s);
    }
  }
  if (t == 0) sx[m] = __fdiv_rn(1.0f, inv);
}

template <typename T, int SEG, int SPT, bool HELD>
cudaError_t quant_go(const T* x, int8_t* xq, float* sx, int M, int K, int tpr, cudaStream_t st) {
  const int rpb = QNT / tpr;
  quantize_rows<T, SEG, SPT, HELD><<<(M + rpb - 1) / rpb, QNT, 0, st>>>(x, xq, sx, M, K, tpr);
  return cudaGetLastError();
}

template <typename T, int SEG>
cudaError_t quant_seg(const T* x, int8_t* xq, float* sx, int M, int K, const QuantPlan& p,
                      cudaStream_t st) {
  constexpr int SMAX = quant_spt_max(SEG, int(sizeof(T)));
  if (!p.held) return quant_go<T, SEG, 1, false>(x, xq, sx, M, K, p.tpr, st);
  switch (p.spt) {
    case 1: return quant_go<T, SEG, 1, true>(x, xq, sx, M, K, p.tpr, st);
    case 2: return quant_go<T, SEG, 2, true>(x, xq, sx, M, K, p.tpr, st);
    case 4: return quant_go<T, SEG, 4, true>(x, xq, sx, M, K, p.tpr, st);
    default: return quant_go<T, SEG, (SMAX > 4 ? 8 : 4), true>(x, xq, sx, M, K, p.tpr, st);
  }
}

// K13a's launch (also K13b's first on the tensor-core route)
template <typename T>
cudaError_t quantize(const T* x, int8_t* xq, float* sx, int M, int K, cudaStream_t st) {
  const QuantPlan p = quant_plan(K, int(sizeof(T)));
  return p.seg == 16 ? quant_seg<T, 16>(x, xq, sx, M, K, p, st)
                     : quant_seg<T, 4>(x, xq, sx, M, K, p, st);
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

// ---- K13b's tensor-core route (w8a8_wgmma) ----
constexpr int TBM = 128;            // output rows per block (two warpgroups of 64)
constexpr int TBN = 128;            // output columns per block
constexpr int TBK = 128;            // bytes of K per stage: one 128B swizzle row
constexpr int TST = 3;              // ring stages
constexpr int TNT = 288;            // two consumer warpgroups and one producer warp
constexpr int TA = TBM * TBK, TB = TBN * TBK;          // bytes of a stage's tiles
constexpr int TSMEM = TST * (TA + TB) + 1024 + 2 * TST * 8;   // + alignment, barriers

__device__ __forceinline__ uint32_t su32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
               : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}
// a box of the 2-D tensor map at (c0 bytes along K, c1 rows) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
// wgmma descriptor of a K-major tile of 128-byte rows in the 128B swizzle
// (8-row atoms 1024 bytes apart; the tile 1024-byte aligned)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t saddr) {
  return uint64_t((saddr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32)
         | (uint64_t(1) << 62);
}
// d (64 x 128 int32, the warpgroup's fragment) += a (64 x 32) . b (128 x 32)^T
__device__ __forceinline__ void wgmma_s8(int d[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void fence_acc(int d[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// w [K, N] -> wt [N, K] in 64 x 64 byte tiles (K % 4 == 0, N % 4 == 0)
__global__ void __launch_bounds__(256)
transpose_w(const int8_t* __restrict__ w, int8_t* __restrict__ wt, int K, int N) {
  __shared__ uint32_t tile[64][17];    // [k][word of 4 columns]
  const int k0 = blockIdx.y * 64, n0 = blockIdx.x * 64;
  for (int i = threadIdx.x; i < 64 * 16; i += 256) {
    const int r = i >> 4, c = i & 15, k = k0 + r, n = n0 + 4 * c;
    tile[r][c] = k < K && n < N ? *reinterpret_cast<const uint32_t*>(w + size_t(k) * N + n) : 0u;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 64 * 16; i += 256) {
    const int nn = i >> 4, c = i & 15, n = n0 + nn, k = k0 + 4 * c;
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      word |= ((tile[4 * c + j][nn >> 2] >> (8 * (nn & 3))) & 0xffu) << (8 * j);
    if (n < N && k < K) *reinterpret_cast<uint32_t*>(wt + size_t(n) * K + k) = word;
  }
}

// two output values of a row at columns n, n + 1
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ta: xq [M, K] codes, tb: wt [N, K], both K-major; sx [M] from quantize_rows
template <typename T>
__global__ void __launch_bounds__(TNT, 2)
w8a8_wgmma(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
           const float* __restrict__ sx, const float* __restrict__ ws,
           const float* __restrict__ bias, T* __restrict__ out, int M, int K, int N, int act) {
  extern __shared__ unsigned char graw[];
  const uint32_t raw = su32(graw), base = (raw + 1023u) & ~1023u;
  const uint32_t full0 = base + TST * (TA + TB), empty0 = full0 + TST * 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * TBM, n0 = blockIdx.x * TBN, nk = (K + TBK - 1) / TBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < TST; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2);     // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 8) {                      // the producer
    if (lane == 0)
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % TST;
        if (kt >= TST) mbar_wait(empty0 + 8 * s, ((kt / TST) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, TA + TB);
        tma_load(base + s * TA, &ta, kt * TBK, m0, full0 + 8 * s);
        tma_load(base + TST * TA + s * TB, &tb, kt * TBK, n0, full0 + 8 * s);
      }
    return;
  }
  const int wg = warp >> 2;             // this consumer's 64 rows of the tile
  int d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0;
  fence_acc(d);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % TST;
    mbar_wait(full0 + 8 * s, (kt / TST) & 1);
    const uint32_t a = base + s * TA + wg * 64 * TBK, b = base + TST * TA + s * TB;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < TBK / 32; ++kk) wgmma_s8(d, gmma_desc(a + 32 * kk), gmma_desc(b + 32 * kk));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    // the previous stage's products are done: free it
    if (kt > 0 && (threadIdx.x & 127) == 0) mbar_arrive(empty0 + 8 * ((kt - 1) % TST));
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(d);

  // epilogue: d[i] is row 16 * warp + lane / 4 (+ 8 for i % 4 >= 2) of this
  // warpgroup's 64, column 8 * (i / 4) + 2 * (lane % 4) + i % 2
  const int r0 = m0 + wg * 64 + 16 * (warp & 3) + (lane >> 2);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = r0 + 8 * r;
    if (m >= M) continue;
    const float sxm = sx[m];
    T* orow = out + size_t(m) * N;
#pragma unroll
    for (int j = 0; j < TBN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * (lane & 3);
      if (n >= N) continue;            // N % 4 == 0: n + 1 < N as well
      float y0 = __fmul_rn(__fmul_rn(float(d[4 * j + 2 * r]), sxm), ws[n]);
      float y1 = __fmul_rn(__fmul_rn(float(d[4 * j + 2 * r + 1]), sxm), ws[n + 1]);
      if (bias) {
        y0 = __fadd_rn(y0, bias[n]);
        y1 = __fadd_rn(y1, bias[n + 1]);
      }
      store2(orow + n, w8a8_act(y0, act), w8a8_act(y1, act));
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the tensor map of a K-major int8 matrix [rows, K] in boxes of 128 rows x
// 128 bytes, 128B swizzle, zeros past its edges. Returns 0 or an error code.
int kmajor_map(CUtensorMap* map, const void* p, int rows, int K) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return int(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {cuuint64_t(K), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(K)};
  const cuuint32_t box[2] = {TBK, 128}, one[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(p), dims,
                         strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 2000 + int(r);     // 2000 + CUresult: the encoder refused
}

template <typename T>
int w8a8_tc(const T* x, const int8_t* w, const float* ws, const float* bias, int8_t* xq,
            float* sx, int8_t* wt, T* out, int M, int K, int N, int act, cudaStream_t st) {
  cudaError_t err = quantize(x, xq, sx, M, K, st);
  if (err != cudaSuccess) return int(err);
  transpose_w<<<dim3((N + 63) / 64, (K + 63) / 64), 256, 0, st>>>(w, wt, K, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  CUtensorMap ta, tb;
  int rc = kmajor_map(&ta, xq, M, K);
  if (!rc) rc = kmajor_map(&tb, wt, N, K);
  if (rc) return rc;
  err = cudaFuncSetAttribute(w8a8_wgmma<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, TSMEM);
  if (err != cudaSuccess) return int(err);
  w8a8_wgmma<T><<<dim3((N + TBN - 1) / TBN, (M + TBM - 1) / TBM), TNT, TSMEM, st>>>(
      ta, tb, sx, ws, bias, out, M, K, N, act);
  return int(cudaGetLastError());
}

bool bad_shape(int M, int K) { return M <= 0 || K <= 0 || K % 4; }

}  // namespace

// x: [M, K] (dtype 0 = float32, 1 = bfloat16); xq: [M, K] int8; sx: [M]
// float32. Returns cudaGetLastError() after the launch.
extern "C" int wg_quantize_tokens(const void* x, void* xq, void* sx, int M, int K, int dtype,
                                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(M, K)) return int(cudaErrorInvalidValue);
  if (dtype == 0)
    return int(quantize(static_cast<const float*>(x), static_cast<int8_t*>(xq),
                        static_cast<float*>(sx), M, K, st));
  if (dtype == 1)
    return int(quantize(static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xq),
                        static_cast<float*>(sx), M, K, st));
  return int(cudaErrorInvalidValue);
}

// K13a's launch for x [M, K] in dtype, without launching: info[0..4] =
// values a segment, threads a row, segments a thread, whether a row is held
// in registers (1) or read twice (0), blocks. Returns 0 or the error the
// launch would meet for these shapes.
extern "C" int wg_quantize_tokens_info(int M, int K, int dtype, int* info) {
  if (bad_shape(M, K) || dtype < 0 || dtype > 1) return int(cudaErrorInvalidValue);
  const QuantPlan p = quant_plan(K, dtype == 0 ? 4 : 2);
  const int rpb = QNT / p.tpr;
  info[0] = p.seg;
  info[1] = p.tpr;
  info[2] = p.held ? p.spt : (K / p.seg + p.tpr - 1) / p.tpr;
  info[3] = p.held;
  info[4] = (M + rpb - 1) / rpb;
  return 0;
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

// K13b's tensor-core route (w8a8_wgmma), the arguments of wg_w8a8_gemm and
// the wrapper's scratch: xq [M, K] int8, sx [M] float32 (K13a's codes and
// scales) and wt [N, K] int8 (w_q K-major). Requires K % 16 == 0 (TMA's row
// strides), N % 4 == 0 and 16-byte aligned x rows and w_q. Returns
// cudaGetLastError() after the last launch, or 2000 + a CUresult where the
// tensor maps are refused.
extern "C" int wg_w8a8_gemm_tc(const void* x, const void* w, const void* ws, const void* bias,
                               void* xq, void* sx, void* wt, void* out, int M, int K, int N,
                               int act, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(M, K) || K % 16 || N <= 0 || N % 4 || act < 0 || act > 2)
    return int(cudaErrorInvalidValue);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* s = static_cast<const float*>(ws);
  const float* b = static_cast<const float*>(bias);
  int8_t* q = static_cast<int8_t*>(xq);
  float* sc = static_cast<float*>(sx);
  int8_t* t = static_cast<int8_t*>(wt);
  if (dtype == 0)
    return w8a8_tc(static_cast<const float*>(x), wq, s, b, q, sc, t, static_cast<float*>(out), M,
                   K, N, act, st);
  if (dtype == 1)
    return w8a8_tc(static_cast<const __nv_bfloat16*>(x), wq, s, b, q, sc, t,
                   static_cast<__nv_bfloat16*>(out), M, K, N, act, st);
  return int(cudaErrorInvalidValue);
}
