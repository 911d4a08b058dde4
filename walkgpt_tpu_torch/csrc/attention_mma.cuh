// Tensor-core forward-attention engine (bf16; fp16 for K1 through the FP16
// trait), the Hopper redesign of attention_tile.cuh for bf16 inputs. Built on it: K1
// (flash_attention.cu), K3 (sam_flash_attention.cu), K2
// (sam_window_attention.cu) and K10 (sam_window_attention_split.cu). Their
// fp32 routes stay on attention_tile.cuh: the tensor cores have no exact
// fp32 product.
//
// One block of 4 warps computes a 64-row query tile against every key tile,
// 64 keys at a time, with an fp32 online softmax. Each warp owns 16 query
// rows. Every product is a bf16 mma.sync.m16n8k16 with fp32 sums:
//   S = Q.K^T   A = the staged query rows (ldmatrix), each value scaled and
//               rounded in registers, B = K rows (ldmatrix); D is padded to
//               DP = 16 * KD with zeros;
//   O += P.V    A = p rounded to bf16, built from S's accumulator fragments
//               in registers (never through shared memory), B = V rows
//               (ldmatrix.trans).
// K and V tiles are double-buffered in shared memory by cp.async: the copy
// of tile t + 1 runs while tile t is multiplied, one barrier per tile.
//
// Fragment layout (mma.sync m16n8k16, lane = 4 g + t): an accumulator
// s[n][0..1] holds row g, columns 8 n + 2 t and + 1; s[n][2..3] row g + 8.
// A problem's bias hook sees the warp's 16 x 64 logits in that layout.
//
// Problem interface (device; the block's rows are local, 0 .. 63):
//   struct Args;  Prob(const Args&, int qtile, int bh, char* extra)
//                 (the constructor may stage tables in `extra` with all
//                 threads; the engine synchronises before they are read)
//   static size_t extra_bytes(const Args&)          host: staging bytes
//   const bf16 *q, *k, *v; int64_t sq, sk, sv;      the tile's row 0 (q)
//                 or the head's key 0 (k, v), and the row strides
//   bool vec;     every row start 16-byte aligned and D % 8 == 0: cp.async
//                 16-byte copies; otherwise plain 2-byte loads
//   static constexpr bool FAST;   the launcher's promise that vec holds, D
//                 is a multiple of 16 and every tile is full (N % 64 == 0)
//                 (for the rel-pos problems also gw == 64, rel rows staged):
//                 the instantiation drops every bounds check
//   int D, nq, nk, nkt;  head dim, rows in the tile, keys, key tiles
//   bf16 qscale;  q is staged as bf16(q * qscale) (not with SCALE_ACC)
//   void add_bias(float (&s)[8][4], int k0, int row) const
//                 adds the bias to the warp's fragment (rows row, row + 8;
//                 keys from k0) for keys < nk; keys >= nk are masked by the
//                 engine afterwards
//   bf16* op; int64_t so;   the output tile's row 0 and its row stride (an
//                 even D is written in bf16 pairs, so op and so are then even)
//   void lse(int row, float x) const
// Optional traits (static constexpr bool, false where a problem does not
// declare them; K2, K3 and K10 declare none and compile as before):
//   SCALE_ACC     q is staged unscaled (no qscale) and the logits are
//                 scale times the fp32 accumulator of the exact bf16 products
//                 q . k (K1's function; K1b forms them the same way); the
//                 problem then has `float scale`
//   SPLIT_P       O += P.V takes p split as hi = bf16(p), lo = bf16(p - hi),
//                 two bf16 products into one fp32 sum (about 16 significant
//                 bits of the fp32 p where bf16 alone keeps 8)
//   SUB_MAX       p = exp(s - m) with s - m formed first, so that a row whose
//                 logits all equal the finite masked -1e30 gets p = 1 for
//                 each, as the CUDA-core engine gives it (the fused form
//                 s log2e - m log2e leaves the rounding error of a product
//                 of magnitude 1e30 in the exponent)
//   FP16          q, k, v and out are fp16 (the pointers keep the bf16 type:
//                 the staging copies 16-bit values as they are): the
//                 products are f16 mma.sync with fp32 sums, p's fragments
//                 (and SPLIT_P's hi and lo) are rounded to fp16 and the
//                 output is written in fp16; needs SCALE_ACC (K1's fp16
//                 route). fp16's 11 significant bits make q . k exact in
//                 fp32 as bf16's do, and hi + lo keeps about 22 bits of p
//                 (a lo below fp16's normal range, 2^-14, loses bits: such
//                 a term weighs at most 2^-25 of the row's sum)
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace wgt {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 64;            // keys per tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = 32 * NWARPS;
constexpr int NT = BK / 8;        // n-tiles of 8 keys in a warp's logits
constexpr float NEG_BIG = -1e30f;  // the JAX kernels' finite "masked" logit

// bf16 elements per staged row: DP plus 8 of padding, so that the 8 rows an
// ldmatrix reads fall on distinct banks (a row stride of 4 mod 8 words)
template <int KD> __host__ __device__ constexpr int row_stride() { return 16 * KD + 8; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a . b, bf16 operands (H: fp16), fp32 sums
template <bool H = false>
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  if constexpr (H)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes from global to shared; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// exp(x) as 2^(x log2 e): one fma and one MUFU.EX2 (results below 2^-126
// flush to zero)
constexpr float LOG2E = 1.4426950408889634f;
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// two floats rounded to bf16 (H: fp16), packed low half first
template <bool H = false>
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  if constexpr (H) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}

// The A fragment of k-step j (keys 16 j .. +15) from a 16 x 64 fp32
// accumulator: rounded to bf16 (hi), and the rounding error rounded to bf16
// (lo), so that hi + lo keeps about 16 significant bits of x (H: fp16
// halves, about 22 bits).
template <bool H = false>
__device__ __forceinline__ void a_frag(const float (&s)[NT][4], int j, uint32_t a[4]) {
  a[0] = pack<H>(s[2 * j][0], s[2 * j][1]);
  a[1] = pack<H>(s[2 * j][2], s[2 * j][3]);
  a[2] = pack<H>(s[2 * j + 1][0], s[2 * j + 1][1]);
  a[3] = pack<H>(s[2 * j + 1][2], s[2 * j + 1][3]);
}
// the rounding errors of a packed pair: (x0 - hi.x, x1 - hi.y), packed
template <bool H = false>
__device__ __forceinline__ uint32_t pack_lo(float x0, float x1, uint32_t hi) {
  if constexpr (H) {
    const float2 h = __half22float2(*reinterpret_cast<const __half2*>(&hi));
    return pack<true>(x0 - h.x, x1 - h.y);
  } else {
    return pack(x0 - __uint_as_float(hi << 16), x1 - __uint_as_float(hi & 0xffff0000u));
  }
}
template <bool H = false>
__device__ __forceinline__ void a_frag_split(const float (&s)[NT][4], int j, uint32_t hi[4],
                                             uint32_t lo[4]) {
  a_frag<H>(s, j, hi);
  lo[0] = pack_lo<H>(s[2 * j][0], s[2 * j][1], hi[0]);
  lo[1] = pack_lo<H>(s[2 * j][2], s[2 * j][3], hi[1]);
  lo[2] = pack_lo<H>(s[2 * j + 1][0], s[2 * j + 1][1], hi[2]);
  lo[3] = pack_lo<H>(s[2 * j + 1][2], s[2 * j + 1][3], hi[3]);
}

// 64 rows of D values (row stride ld elements in global memory) into a
// staged [64][SS] tile; rows >= nr are zeros. vec: 16-byte cp.async copies
// (the caller commits and waits); otherwise plain loads. Columns D .. DP-1
// are never written: the engine zeroes the tiles once. FULL: the caller
// knows that vec holds, D == DP and nr == 64. NTH: the block's threads.
template <int SS, int DP, bool FULL = false, int NTH = NTHREADS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int64_t ld, int nr, int D,
                                          bool vec) {
  if (FULL) {
    constexpr int cpr = DP / 8, n = BQ * cpr;
#pragma unroll
    for (int k = 0; k < (n + NTH - 1) / NTH; ++k) {
      const int i = threadIdx.x + k * NTH, r = i / cpr, c = i - r * cpr;
      if (n % NTH == 0 || i < n) cp_async16(dst + r * SS + 8 * c, src + r * ld + 8 * c, 16);
    }
  } else if (vec && D == DP) {
    constexpr int cpr = DP / 8;   // a constant: no division at run time
    for (int i = threadIdx.x; i < BQ * cpr; i += NTH) {
      const int r = i / cpr, c = i - r * cpr;
      const bool ok = r < nr;
      cp_async16(dst + r * SS + 8 * c, src + (ok ? r * ld + 8 * c : 0), ok ? 16 : 0);
    }
  } else if (vec) {
    const int cpr = D >> 3;
    for (int i = threadIdx.x; i < BQ * cpr; i += NTH) {
      const int r = i / cpr, c = i - r * cpr;
      const bool ok = r < nr;
      cp_async16(dst + r * SS + 8 * c, src + (ok ? r * ld + 8 * c : 0), ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < BQ * D; i += NTH) {
      const int r = i / D, d = i - r * D;
      dst[r * SS + d] = r < nr ? src[r * ld + d] : __float2bfloat16_rn(0.f);
    }
  }
}

// rounds a staged tile in place to bf16(x * scale), as the TPU kernels form
// q * scale in the input dtype
// (a bf16 product rounds the exact product once, as fp32 then bf16 does);
// dst may be src
template <int SS, int DP>
__device__ __forceinline__ void scale_rows(bf16* dst, const bf16* src, bf16 scale) {
  const __nv_bfloat162 s2 = __bfloat162bfloat162(scale);
  for (int i = threadIdx.x; i < BQ * DP / 2; i += NTHREADS) {
    const int r = i / (DP / 2), d = 2 * (i - r * (DP / 2));
    *reinterpret_cast<__nv_bfloat162*>(dst + r * SS + d) =
        __hmul2(*reinterpret_cast<const __nv_bfloat162*>(src + r * SS + d), s2);
  }
}

template <int NTH = NTHREADS>
__device__ __forceinline__ void zero_smem(void* p, size_t bytes) {
  int4* q = static_cast<int4*>(p);
  for (size_t i = threadIdx.x; i < bytes / 16; i += NTH) q[i] = make_int4(0, 0, 0, 0);
}

// Warp-level products over staged tiles (row stride SS). acc[NT] (16 x 64)
// += A rows [16 x 16 KD] . B rows^T [64 x 16 KD]; A from a row block `a`
// (16 rows), B from `b` (64 rows), both non-transposed.
template <int KD, int SS>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const bf16* a, const bf16* b) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, a + (lane & 15) * SS + 16 * kk + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bf[4];
      ldsm_x4(bf, b + (16 * np + (lane & 7) + ((lane >> 4) & 1) * 8) * SS + 16 * kk +
                      ((lane >> 3) & 1) * 8);
      mma(acc[2 * np], af, bf[0], bf[1]);
      mma(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// mma_abt with B's values multiplied by `scale` as they are loaded (each
// product rounded to bf16 once)
template <int KD, int SS>
__device__ __forceinline__ void mma_abt_scaled(float (&acc)[NT][4], const bf16* a, const bf16* b,
                                               bf16 scale) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat162 s2 = __bfloat162bfloat162(scale);
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, a + (lane & 15) * SS + 16 * kk + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bf[4];
      ldsm_x4(bf, b + (16 * np + (lane & 7) + ((lane >> 4) & 1) * 8) * SS + 16 * kk +
                      ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 x = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&bf[i]), s2);
        bf[i] = *reinterpret_cast<const uint32_t*>(&x);
      }
      mma(acc[2 * np], af, bf[0], bf[1]);
      mma(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// out[2 KD][4] (16 x DP) += A (k-step j of the fragments `a`, 16 x 16) .
// B rows 16 j .. +15 of `b` [64][SS] (ldmatrix.trans: B's rows are the
// product's k index). H: fp16 operands.
template <int KD, int SS, bool H = false>
__device__ __forceinline__ void mma_ab(float (&out)[2 * KD][4], const uint32_t a[4], const bf16* b,
                                       int j) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int dp = 0; dp < KD; ++dp) {
    uint32_t bf[4];
    ldsm_x4_t(bf, b + (16 * j + (lane & 7) + ((lane >> 3) & 1) * 8) * SS + 16 * dp +
                      (lane >> 4) * 8);
    mma<H>(out[2 * dp], a, bf[0], bf[1]);
    mma<H>(out[2 * dp + 1], a, bf[2], bf[3]);
  }
}

// out += (hi + lo) . B, as mma_ab with two A fragments and one B load
template <int KD, int SS, bool H = false>
__device__ __forceinline__ void mma_ab2(float (&out)[2 * KD][4], const uint32_t hi[4],
                                        const uint32_t lo[4], const bf16* b, int j) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int dp = 0; dp < KD; ++dp) {
    uint32_t bf[4];
    ldsm_x4_t(bf, b + (16 * j + (lane & 7) + ((lane >> 3) & 1) * 8) * SS + 16 * dp +
                      (lane >> 4) * 8);
    mma<H>(out[2 * dp], hi, bf[0], bf[1]);
    mma<H>(out[2 * dp + 1], hi, bf[2], bf[3]);
    mma<H>(out[2 * dp], lo, bf[0], bf[1]);
    mma<H>(out[2 * dp + 1], lo, bf[2], bf[3]);
  }
}

#define WGT_FWD_TRAIT(NAME)                                                     \
  template <class P, class = void> struct has_##NAME : std::false_type {};     \
  template <class P>                                                            \
  struct has_##NAME<P, std::void_t<decltype(P::NAME)>>                          \
      : std::integral_constant<bool, P::NAME> {};
WGT_FWD_TRAIT(SCALE_ACC)
WGT_FWD_TRAIT(SPLIT_P)
WGT_FWD_TRAIT(SUB_MAX)
WGT_FWD_TRAIT(FP16)
#undef WGT_FWD_TRAIT

// bytes of the engine's own tiles: Q, and K and V twice each
template <int KD> __host__ __device__ constexpr size_t fwd_tile_bytes() {
  return sizeof(bf16) * size_t(5) * BQ * row_stride<KD>();
}


template <int KD, class Prob>
__device__ __forceinline__ void attention_mma_tile(const Prob& pr, char* smem) {
  constexpr int SS = row_stride<KD>();
  constexpr int DP = 16 * KD;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BQ * SS;            // [2][BK][SS]
  bf16* Vs = Ks + 2 * BK * SS;        // [2][BK][SS]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row = 16 * warp + g;     // this thread's rows: row, row + 8

  constexpr bool F = Prob::FAST;
  constexpr bool SCALE_ACC = has_SCALE_ACC<Prob>::value;
  constexpr bool SPLIT_P = has_SPLIT_P<Prob>::value;
  constexpr bool SUB_MAX = has_SUB_MAX<Prob>::value;
  constexpr bool H = has_FP16<Prob>::value;
  static_assert(!H || SCALE_ACC, "the fp16 route stages q unscaled");
  load_rows<SS, DP, F>(Qs, pr.q, pr.sq, pr.nq, pr.D, pr.vec);
  load_rows<SS, DP, F>(Ks, pr.k, pr.sk, min(BK, pr.nk), pr.D, pr.vec);
  load_rows<SS, DP, F>(Vs, pr.v, pr.sv, min(BK, pr.nk), pr.D, pr.vec);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  // the warp's query fragments, each value rounded to bf16(q * qscale) in
  // registers (as scale_rows would in shared memory); SCALE_ACC: unscaled
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    ldsm_x4(qf[kk], Qs + (16 * warp + (lane & 15)) * SS + 16 * kk + (lane >> 4) * 8);
    if constexpr (!SCALE_ACC) {
      const __nv_bfloat162 qs2 = __bfloat162bfloat162(pr.qscale);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 x =
            __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&qf[kk][i]), qs2);
        qf[kk][i] = *reinterpret_cast<const uint32_t*>(&x);
      }
    }
  }

  float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.f, 0.f};
  float acc[2 * KD][4];
#pragma unroll
  for (int i = 0; i < 2 * KD; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int kt = 0; kt < pr.nkt; ++kt) {
    const int k0 = kt * BK;
    const bf16* Kb = Ks + (kt & 1) * BK * SS;
    const bf16* Vb = Vs + (kt & 1) * BK * SS;
    if (kt > 0) {
      cp_wait<0>();
      __syncthreads();   // tile kt has landed; every warp is done with tile kt - 1
    }
    if (kt + 1 < pr.nkt) {   // into the buffer of tile kt - 1, while kt is multiplied
      const int k1 = k0 + BK, nk1 = min(BK, pr.nk - k1), b = (kt + 1) & 1;
      load_rows<SS, DP, F>(Ks + b * BK * SS, pr.k + k1 * pr.sk, pr.sk, nk1, pr.D,
                                         pr.vec);
      load_rows<SS, DP, F>(Vs + b * BK * SS, pr.v + k1 * pr.sv, pr.sv, nk1, pr.D,
                                         pr.vec);
      cp_commit();
    }

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bf[4];
        ldsm_x4(bf, Kb + (16 * np + (lane & 7) + ((lane >> 4) & 1) * 8) * SS + 16 * kk +
                        ((lane >> 3) & 1) * 8);
        mma<H>(s[2 * np], qf[kk], bf[0], bf[1]);
        mma<H>(s[2 * np + 1], qf[kk], bf[2], bf[3]);
      }
    }
    if constexpr (SCALE_ACC) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= pr.scale;
    }
    pr.add_bias(s, k0, row);

    if (!F && k0 + BK > pr.nk) {
      // keys past the end take no part at all (p = 0)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * n + 2 * t + (e & 1) >= pr.nk) s[n][e] = -CUDART_INF_F;
    }
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
    float alpha[2], ml[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float mn = fmaxf(m[h], mx[h]);
      alpha[h] = exp2_fast((m[h] - mn) * LOG2E);
      m[h] = mn;
      ml[h] = mn * LOG2E;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = SUB_MAX ? exp2_fast((s[n][e] - m[e >> 1]) * LOG2E)
                          : exp2_fast(fmaf(s[n][e], LOG2E, -ml[e >> 1]));
        rs[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
      l[h] = l[h] * alpha[h] + rs[h];
    }
    // once the row maxima settle, alpha is 1 for the whole warp: skip the
    // rescale (multiplying by 1 changes nothing)
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int i = 0; i < 2 * KD; ++i) {
        acc[i][0] *= alpha[0];
        acc[i][1] *= alpha[0];
        acc[i][2] *= alpha[1];
        acc[i][3] *= alpha[1];
      }
    }
    // P.V with p rounded to bf16 or fp16 (SPLIT_P: hi + lo), straight from
    // the logits' registers
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      if constexpr (SPLIT_P) {
        uint32_t hi[4], lo[4];
        a_frag_split<H>(s, j, hi, lo);
        mma_ab2<KD, SS, H>(acc, hi, lo, Vb, j);
      } else {
        uint32_t pa[4];
        a_frag<H>(s, j, pa);
        mma_ab<KD, SS, H>(acc, pa, Vb, j);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (!F && r >= pr.nq) continue;
    const float lm = fmaxf(l[h], 1e-30f);
    bf16* o = pr.op + int64_t(r) * pr.so;
#pragma unroll
    for (int i = 0; i < 2 * KD; ++i) {
      const int d = 8 * i + 2 * t;
      const float x0 = acc[i][2 * h] / lm, x1 = acc[i][2 * h + 1] / lm;
      if constexpr (H) {
        __half* oh = reinterpret_cast<__half*>(o);
        if (pr.D % 2 == 0) {
          if (d < pr.D) *reinterpret_cast<__half2*>(oh + d) = __floats2half2_rn(x0, x1);
        } else {
          if (d < pr.D) oh[d] = __float2half_rn(x0);
          if (d + 1 < pr.D) oh[d + 1] = __float2half_rn(x1);
        }
      } else if (pr.D % 2 == 0) {   // even D: every pair d, d + 1 is in the row, 4-byte aligned
        if (d < pr.D) *reinterpret_cast<__nv_bfloat162*>(o + d) = __floats2bfloat162_rn(x0, x1);
      } else {
        if (d < pr.D) o[d] = __float2bfloat16_rn(x0);
        if (d + 1 < pr.D) o[d + 1] = __float2bfloat16_rn(x1);
      }
    }
    if (t == 0) pr.lse(r, m[h] + logf(lm));
  }
}

template <class Prob, int KD>
__global__ void __launch_bounds__(NTHREADS) attention_mma_kernel(typename Prob::Args a) {
  extern __shared__ __align__(16) char smem[];
  const Prob pr(a, blockIdx.x, blockIdx.y, smem + fwd_tile_bytes<KD>());
  // only the columns D .. DP - 1 rely on zeros (load_rows writes every row)
  if (pr.D != 16 * KD) zero_smem(smem, fwd_tile_bytes<KD>());
  __syncthreads();
  attention_mma_tile<KD>(pr, smem);
}

template <class Prob, int KD>
cudaError_t launch_fwd_kd(const typename Prob::Args& a, dim3 grid, cudaStream_t st) {
  const size_t smem = fwd_tile_bytes<KD>() + Prob::extra_bytes(a);
  cudaError_t e = cudaFuncSetAttribute(attention_mma_kernel<Prob, KD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  attention_mma_kernel<Prob, KD><<<grid, NTHREADS, smem, st>>>(a);
  return cudaGetLastError();
}

// Instantiates the engine for head dims up to 128 (KD = ceil(D/16) <= 8).
template <class Prob>
cudaError_t launch_fwd(const typename Prob::Args& a, int D, dim3 grid, cudaStream_t st) {
  switch ((D + 15) / 16) {
    case 1: return launch_fwd_kd<Prob, 1>(a, grid, st);
    case 2: return launch_fwd_kd<Prob, 2>(a, grid, st);
    case 3: return launch_fwd_kd<Prob, 3>(a, grid, st);
    case 4: return launch_fwd_kd<Prob, 4>(a, grid, st);
    case 5: return launch_fwd_kd<Prob, 5>(a, grid, st);
    case 6: return launch_fwd_kd<Prob, 6>(a, grid, st);
    case 7: return launch_fwd_kd<Prob, 7>(a, grid, st);
    case 8: return launch_fwd_kd<Prob, 8>(a, grid, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The decomposed rel-pos bias of SAM's global blocks (K3, K3b), shared by
// the forward and the backward: logit = (s + rel_w[q, key % gw]) +
// rel_h[q, key / gw], the [N, N] bias never built.
// ---------------------------------------------------------------------------

// rel rows of a 64-query tile are staged in shared memory (as bf16, exact)
// when gh + gw is at most this; otherwise they are read from device memory
constexpr int REL_STAGE_MAX = 256;
constexpr int REL_PAD = 8;   // staged row = gh (or gw) + 8: conflict-free reads

__host__ __device__ inline bool rel_staged(int gh, int gw) { return gh + gw <= REL_STAGE_MAX; }
__host__ __device__ inline size_t rel_stage_bytes(int gh, int gw) {
  return rel_staged(gh, gw) ? sizeof(bf16) * BQ * (gh + gw + 2 * REL_PAD) : 0;
}
// FAST problems (gw == 64) stage rel_w only: rel_h is one value per row and
// key tile, read from device memory
__host__ __device__ inline size_t rel_stage_bytes_fast() {
  return sizeof(bf16) * BQ * (BK + REL_PAD);
}

// Copies the rows q0 .. q0 + 63 of rel_h [N, gh] and rel_w [N, gw] (rows
// >= n are zeros) into dst: [64][gh + 8], then [64][gw + 8]. vec (gh % 8
// == 0, gw % 8 == 0, 16-byte aligned tables): cp.async copies, which the
// caller commits and waits; otherwise plain loads.
__device__ __forceinline__ void stage_rel(bf16* dst, const bf16* rel_h, const bf16* rel_w, int q0,
                                          int n, int gh, int gw, bool vec) {
  const int nr = min(BQ, n - q0);
  bf16* dw = dst + BQ * (gh + REL_PAD);
#pragma unroll
  for (int tab = 0; tab < 2; ++tab) {
    const int w = tab ? gw : gh;
    const bf16* src = (tab ? rel_w : rel_h) + int64_t(q0) * w;
    bf16* d = tab ? dw : dst;
    if (vec) {
      const int cpr = w >> 3;
      for (int i = threadIdx.x; i < BQ * cpr; i += NTHREADS) {
        const int r = i / cpr, c = i - r * cpr;
        const bool ok = r < nr;
        cp_async16(d + r * (w + REL_PAD) + 8 * c, src + (ok ? r * w + 8 * c : 0), ok ? 16 : 0);
      }
    } else {
      for (int i = threadIdx.x; i < BQ * w; i += NTHREADS) {
        const int r = i / w, c = i - r * w;
        d[r * (w + REL_PAD) + c] = r < nr ? src[r * w + c] : __float2bfloat16_rn(0.f);
      }
    }
  }
}

// The rel rows of a 64-query tile, staged or in device memory.
struct RelRows {
  const bf16* rh;   // rel_h of the tile's row 0, row stride hs
  const bf16* rw;   // rel_w likewise, row stride ws
  int hs, ws, gh, gw;
  bool pairs;       // gw % 64 == 0 and rw 4-byte aligned: bf16x2 reads

  template <bool FAST>
  __device__ void stage(const bf16* rel_h, const bf16* rel_w, int q0, int n, int gh_, int gw_,
                        bool vec, char* extra) {
    gh = gh_;
    gw = gw_;
    if (FAST) {   // rel_w rows as [rows][72] by cp.async; every row is valid
      bf16* dw = reinterpret_cast<bf16*>(extra);
      const bf16* src = rel_w + int64_t(q0) * BK;
      for (int i = threadIdx.x; i < BQ * 8; i += NTHREADS)
        cp_async16(dw + (i >> 3) * (BK + REL_PAD) + 8 * (i & 7), src + 8 * i, 16);
      rw = dw;
      ws = BK + REL_PAD;
      rh = rel_h + int64_t(q0) * gh;
      hs = gh;
    } else if (rel_staged(gh, gw)) {
      stage_rel(reinterpret_cast<bf16*>(extra), rel_h, rel_w, q0, n, gh, gw, vec);
      rh = reinterpret_cast<const bf16*>(extra);
      rw = rh + BQ * (gh + REL_PAD);
      hs = gh + REL_PAD;
      ws = gw + REL_PAD;
    } else {
      rh = rel_h + int64_t(q0) * gh;
      rw = rel_w + int64_t(q0) * gw;
      hs = gh;
      ws = gw;
    }
    pairs = FAST || (gw % BK == 0 && (rel_staged(gh, gw) || vec));
  }

  // s[n][e] += bias for the warp fragment's rows row, row + 8 (local; rows
  // >= nq untouched) and keys k0 + 8 n + 2 t + (e & 1) < nk, in the TPU
  // kernel's order (s + rel_w) + rel_h
  // FAST: pairs holds and the tile is full
  template <bool FAST>
  __device__ __forceinline__ void add(float (&s)[NT][4], int k0, int row, int nq, int nk) const {
    const int t = threadIdx.x & 3;
    if (FAST || pairs) {
      // the tile lies in one grid row (kh) and covers 64 of its columns;
      // FAST: gw == 64 and staged, so the row strides are constants
      const int kh = FAST ? k0 / BK : k0 / gw, kw0 = (FAST ? 0 : k0 - kh * gw) + 2 * t;
      const int ws_ = FAST ? BK + REL_PAD : ws;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + 8 * h;
        if (!FAST && r >= nq) continue;
        const float bh = __bfloat162float(rh[r * hs + kh]);
        const __nv_bfloat162* wr = reinterpret_cast<const __nv_bfloat162*>(rw + r * ws_ + kw0);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float2 w = __bfloat1622float2(wr[4 * n]);
          s[n][2 * h] = (s[n][2 * h] + w.x) + bh;
          s[n][2 * h + 1] = (s[n][2 * h + 1] + w.y) + bh;
        }
      }
      return;
    }
    const int kh0 = k0 / gw, kw0 = k0 - kh0 * gw;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = 8 * n + 2 * t + j;
        if (k0 + c >= nk) continue;
        const int q = (kw0 + c) / gw;
        const int kh = kh0 + q, kw = kw0 + c - q * gw;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row + 8 * h;
          if (r < nq)
            s[n][2 * h + j] = (s[n][2 * h + j] + __bfloat162float(rw[r * ws + kw])) +
                              __bfloat162float(rh[r * hs + kh]);
        }
      }
  }
};

// ---------------------------------------------------------------------------
// The decomposed rel-pos bias of SAM's windowed blocks (K2, K10): logit = s +
// (rel_h[q, key / ws] + rel_w[q, key % ws]), formed in fp32 in the TPU
// kernel's order, the [T, T] bias never built.
// ---------------------------------------------------------------------------

// A 64-query tile's rel rows staged in shared memory once, as R (bf16 or
// fp32, exact), [64][ws] for rel_h and then for rel_w (rows past the tile's
// end zeros; with ws even every row starts 4-byte aligned for bf16 and
// 8-byte aligned for fp32), and a table of every key k < nkt * 64 to
// (k / ws) | (k % ws) << 8 (keys past T map to 0; the engine masks them),
// so that the bias costs shared-memory reads and no division.
template <typename R>
struct WinRel {
  const R* rh;
  const R* rw;
  const uint16_t* kidx;
  int ws;

  // the staged rows alone, then with the key table
  __host__ __device__ static size_t rows_bytes(int ws) {
    return (sizeof(R) * 2 * BQ * ws + 15) / 16 * 16;
  }
  __host__ __device__ static size_t bytes(int ws, int T) {
    return rows_bytes(ws) + sizeof(uint16_t) * size_t((T + BK - 1) / BK * BK);
  }
  // src_h, src_w: rel_h and rel_w of the tile's row 0 (row stride ld), into
  // dst as [64][ws] twice (rows >= nr zeros). A head's rel_h starts ws
  // elements apart, not 16-byte aligned: where rows are whole 4-byte words
  // (w4), 4-byte cp.async copies, which join the caller's next copy group;
  // else plain stores. The caller waits and synchronises before they are read.
  __device__ static void stage_rows(const R* src_h, const R* src_w, int64_t ld, int nr, int ws,
                                    bool w4, char* dst) {
    R* dh = reinterpret_cast<R*>(dst);
    R* dw = dh + BQ * ws;
    if (w4) {
      constexpr int E = 4 / sizeof(R);   // elements per word
      const int wpr = ws / E;            // words per row
      for (int i = threadIdx.x; i < BQ * wpr; i += NTHREADS) {
        const int r = i / wpr, c = E * (i - r * wpr);
        const bool ok = r < nr;
        cp_async4(dh + r * ws + c, src_h + (ok ? r * ld + c : 0), ok ? 4 : 0);
        cp_async4(dw + r * ws + c, src_w + (ok ? r * ld + c : 0), ok ? 4 : 0);
      }
    } else {
      for (int i = threadIdx.x; i < BQ * ws; i += NTHREADS) {
        const int r = i / ws, c = i - r * ws;
        if (r < nr) {
          dh[i] = src_h[r * ld + c];
          dw[i] = src_w[r * ld + c];
        } else {
          dh[i] = dw[i] = from_float(0.f);
        }
      }
    }
  }
  // the rows by stage_rows, then the key table
  __device__ void stage(const R* src_h, const R* src_w, int64_t ld, int nr, int ws_, int T,
                        bool w4, char* extra) {
    ws = ws_;
    stage_rows(src_h, src_w, ld, nr, ws, w4, extra);
    const R* dh = reinterpret_cast<const R*>(extra);
    const R* dw = dh + BQ * ws;
    uint16_t* kt = reinterpret_cast<uint16_t*>(extra + rows_bytes(ws));
    const int nk = (T + BK - 1) / BK * BK;
    for (int k = threadIdx.x; k < nk; k += NTHREADS) {
      const int kh = k / ws;
      kt[k] = k < T ? uint16_t(kh | (k - kh * ws) << 8) : uint16_t(0);
    }
    rh = dh;
    rw = dw;
    kidx = kt;
  }
  // s[n][e] += bias for the warp fragment's rows row, row + 8 (local) and
  // keys k0 + 8 n + 2 t + (e & 1)
  __device__ __forceinline__ void add(float (&s)[NT][4], int k0, int row) const {
    const int t = threadIdx.x & 3;
    const R* h0 = rh + row * ws;
    const R* w0 = rw + row * ws;
    if (ws % 2 == 0) {
      // a fragment's key pair k, k + 1 (k even) then lies in one grid row,
      // at the columns kw, kw + 1 (kw even): one read of rel_h and one
      // paired read of rel_w serve both keys (T = ws^2 is even, so a pair
      // never straddles T)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const uint32_t c = kidx[k0 + 8 * n + 2 * t];
        const int kh = c & 0xff, kw = c >> 8;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float bh = to_float(h0[8 * h * ws + kh]);
          const float2 bw = to_float2(w0 + 8 * h * ws + kw);
          s[n][2 * h] += bh + bw.x;
          s[n][2 * h + 1] += bh + bw.y;
        }
      }
      return;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint32_t c = kidx[k0 + 8 * n + 2 * t + j];
        const int kh = c & 0xff, kw = c >> 8;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          s[n][2 * h + j] += to_float(h0[8 * h * ws + kh]) + to_float(w0[8 * h * ws + kw]);
      }
  }
  __device__ __forceinline__ static float to_float(float x) { return x; }
  __device__ __forceinline__ static float to_float(bf16 x) { return __bfloat162float(x); }
  __device__ __forceinline__ static float2 to_float2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  __device__ __forceinline__ static float2 to_float2(const bf16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  __device__ __forceinline__ static R from_float(float x) {
    if constexpr (sizeof(R) == sizeof(float)) return x;
    else return __float2bfloat16_rn(x);
  }
};

}  // namespace tc
}  // namespace wgt
