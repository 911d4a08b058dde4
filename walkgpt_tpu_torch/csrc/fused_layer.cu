// K12: the fused decode-layer tail, one cooperative launch per layer:
// attention over the quantized flat cache, the W8A8 o-projection, the
// residual, RMSNorm and the int4 MLP. Replaces
// walkgpt_tpu/ops/fused_layer.py:fused_layer_tail (_kernel), the greedy
// decode step's layer tail of the int4x format (MHA, n_kv * D == hidden).
// The TPU kernel runs a sequential phased grid (attention per (row, length
// block), then o-proj column tiles, then MLP intermediate tiles accumulating
// into a resident output). On the card these phases depend on each other
// across the whole grid (the o-proj needs every head of a row, the norm the
// whole x2 row, the down product all of h), so the kernel is one
// cooperative launch whose blocks share the work of each phase, grid-strided
// over the items of the port's other engines, and meet at a grid barrier
// between phases (four barriers):
//   1. attention per (row, kv head, 64 value dims): decode_chunk.cuh's
//      chunk_block (K4's engine, key-mask rule) on the pre-quantized query
//      of banded_q8; the rows out / max(bf16(l), 1e-30) are kept in fp32
//      (unlike K4, no cast to the query's type) in the scratch attf [B, hd].
//      The engine repeats the walk's arithmetic, so the rows are the first
//      design's (decode_walk.cuh) bit for bit. Blocks without an attention
//      item (every block when none is idle) meanwhile ask L2 for the o-proj
//      weight (cp.async.bulk.prefetch.L2);
//   2. o-proj, 32 output columns an item: each block recomputes its rows'
//      absmax from attf, sr = max(absmax, 1e-8) * (1/127) and the codes
//      clip(rint(a / sr), -127, 127) with a true division (not nn.linear's
//      quantizer), then K7's product loop (dp4a_quads.cuh: 16-byte
//      non-allocating loads, __dp4a on byte-permuted quads) gives the exact
//      int32 product with o; part = (float(acc) * sr) * os, x2 =
//      bf16(float(x) + part), bf16 even for an fp32 x, into x2 [B, hd];
//   3. RMSNorm and gate/up: each block recomputes the rows' 1 / RMS from x2
//      into its shared memory (B floats) with IEEE sqrt and division (not
//      rsqrtf), and runs K6's gate/up pass (mlp4_stream.cuh gate_up_item,
//      32 columns of I an item) on hn = bf16((x2 * (1 / sqrt(mean(x2^2) +
//      eps))) * pn); h [B, I] in bf16 to scratch (block 0 also writes hn
//      there). hn is formed once a block into its shared memory (bf16)
//      where that fits within the largest other phase's memory (up to 4
//      rows at 7B, 2 at 13B), else from x2 as each pass of rows is staged
//      (the same values, slower on the H100 where both fit), so no batch
//      changes the launch's memory;
//   4. down: K6's down pass (down_item, a (tile, 512 columns) item) writes
//      each tile's scaled partial to parts [n_tiles, B, hd];
//   5. y = x2 + parts[0] + parts[1] + ... in tile order (the TPU grid's
//      accumulation order), fp32 out [B, hd].
// K6's passes sum in an order fixed by the shapes, so the partials are
// K6's on the same hn bit for bit (they are not mlp4_tile_parts' order: y
// stays within the bf16 bounds of the plain version). Length blocks at or
// past nvb = ceil(valid_len / bl) are skipped.
// FMA contraction: where the TPU kernel rounds between a product and a sum
// (the o-proj epilogue and residual, the norm), the code uses __fmul_rn /
// __fadd_rn / __fdiv_rn / __fsqrt_rn, which are never contracted; the
// attention and the MLP passes are K4's and K6's code as they stand.
// Bound: bytes. 7B, 2 rows, 480 of 512 slots valid: o 16.8 MB, the packed
// gate/up/down 67.6 MB, the K/V int4 rows and scales below valid_len 3.9 MB:
// about 88 MB, 26 us at 3.35 TB/s. The design reads each weight once per
// launch; the phases' scratches are small and stay in L2.
// Grid: two 256-thread blocks an SM (__launch_bounds__(256, 2): 128
// registers; shared memory at most ChunkSmem's 106 KB at D = 128, and no
// phase's memory grows with the rows but for B floats), at most the
// largest phase's item count. A block that does not fit makes the
// cooperative launch fail: the error is returned. The launch plan is
// mirrored by ops/fused_layer.py:fused_layer_tail_plan. Items were sized
// against others on the H100 (tools/decode_kernels.py --k12-build): K8's
// 32-dim attention slices (no faster at 2 rows in the latest measurement,
// slower at 4, where they take two waves), 16-column o-proj items and a
// hand-off from the gate/up to the down pass by per-item flags in place of
// a barrier.
#include <cooperative_groups.h>

#include <algorithm>

#include "decode_chunk.cuh"
#include "dp4a_quads.cuh"

// 1: block 0 reads the global timer at the launch's start, after each grid
// barrier and after a fifth barrier that ends the sum, and writes the six
// readings (ns) over the start of the hn scratch row: a measurement build
// of tools/decode_kernels.py (--k12-phase-times), never the package's
#ifndef FL_PHASE_TIMES
#define FL_PHASE_TIMES 0
#endif

// in wgt, so that the profiler's kernel names carry the package's namespace
namespace wgt {
namespace {

namespace cg = cooperative_groups;

constexpr int NT = 256;                // threads per block
constexpr int ADS = DC_DS_STEP;        // attention value dims per item (K4's slices)
constexpr int MINB = 2;                // blocks an SM must fit
constexpr int OCG = 2;                 // o-proj column groups of 16 per item
constexpr int OCW = 16 * OCG;          // o-proj output columns per item
constexpr int OQL = NT / OCG;          // o-proj quad lanes per column group
constexpr size_t PF_CHUNK = 16384;     // bytes per L2 prefetch instruction
static_assert(NT == DC_NT && NT == S4_NT, "one block shape for every engine");

__host__ __device__ inline size_t smin(size_t a, size_t b) { return a < b ? a : b; }

// row quads (o-proj) and packed rows (MLP) in flight per thread
__host__ __device__ constexpr int o_u(int MB) { return MB > 2 ? 1 : 2; }
__host__ __device__ constexpr int mlp_u(int MB) { return s4_u(MB); }

struct TailArgs {
  ChunkArgs att;                       // phase 1 (q8, qsc, cache, mask, nvb; out = attf)
  int att_vec;                         // chunk_vec(att)
  const void* x;                       // [B, hd]: the layer's input (x_bf16: bf16, else fp32)
  const int8_t* ow;                    // [hd, hd] o-proj codes
  const float* os;                     // [hd] o-proj scales
  const void* pn;                      // [hd] post-norm scale (pn_bf16: bf16, else fp32)
  const int8_t *gp, *up, *dp;          // packed MLP weights (up null: gelu MLP)
  const float *gs, *us, *ds;
  float* attf;                         // scratch [B, hd]
  float* x2;                           // scratch [B, hd], bf16-rounded values
  float* y;                            // out [B, hd]
  float* hn;                           // scratch [B, hd], the normed rows (bf16 values; block 0)
  __nv_bfloat16* h;                    // scratch [B, I]
  float* parts;                        // scratch [I / TI, B, hd]
  int B, hd, I, TI, gelu;
  int x_bf16, pn_bf16;
  int hn_held;                         // 1: hn [B][hd] in shared memory (bf16)
  int vec_o, vec_gu, vec_dn;           // 16-byte weight loads (shapes and alignment allow)
  int n_att;                           // attention items
  float eps;
  int empty;                           // 1: every phase empty (the barriers alone)
};

// element i of a vector in bf16 (bf16 set) or fp32, as fp32
__device__ __forceinline__ float load_either(const void* p, size_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// tree reductions over the block (tmp: NT floats of shared memory)
__device__ float block_max(float v, float* tmp) {
  tmp[threadIdx.x] = v;
  __syncthreads();
  for (int w = NT / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) tmp[threadIdx.x] = fmaxf(tmp[threadIdx.x], tmp[threadIdx.x + w]);
    __syncthreads();
  }
  const float r = tmp[0];
  __syncthreads();
  return r;
}

__device__ float block_sum(float v, float* tmp) {
  tmp[threadIdx.x] = v;
  __syncthreads();
  for (int w = NT / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) tmp[threadIdx.x] = __fadd_rn(tmp[threadIdx.x], tmp[threadIdx.x + w]);
    __syncthreads();
  }
  const float r = tmp[0];
  __syncthreads();
  return r;
}

// shared memory of each phase, in bytes
int att_smem(int D, int bl) { return ChunkSmem(D, bl, 1, true, ADS).bytes; }
// codes [MB][hd / 4] words, the warps' sums [NT / 32][OCG][MB][16], sr [MB], tmp [NT]
size_t oproj_smem(int MB, int hd) {
  return 4 * (size_t(MB) * (hd / 4) + size_t(NT / 32) * OCG * MB * 16 + MB + NT);
}
// tmp [NT] and the rows' 1 / rms [B], then hn [B][hd] in bf16 when held
// (each rounded up to 16 bytes), then K6's gate/up smem (floats from its
// offset)
__host__ __device__ inline size_t hn_offset(int B) { return (size_t(NT + B) + 3) / 4 * 4; }
__host__ __device__ inline size_t gu_offset(int B, int hd, int held) {
  return hn_offset(B) + (held ? (size_t(B) * hd / 2 + 3) / 4 * 4 : 0);
}
size_t gate_up_smem(int MB, int B, int hd, int held) {
  return 4 * (gu_offset(B, hd, held) + gate_up_smem_floats(MB, hd));
}
size_t down_smem(int MB, int TI) { return 4 * down_smem_floats(MB, TI); }

// the launch's shared memory: the largest phase's with hn formed on the fly
size_t tail_smem(int MB, int B, int D, int bl, int hd, int TI) {
  return std::max(std::max(size_t(att_smem(D, bl)), oproj_smem(MB, hd)),
                  std::max(gate_up_smem(MB, B, hd, 0), down_smem(MB, TI)));
}

// whether hn is held in shared memory: where that fits within tail_smem
int hold_hn(int MB, int B, int D, int bl, int hd, int TI) {
  return gate_up_smem(MB, B, hd, 1) <= tail_smem(MB, B, D, bl, hd, TI);
}

// ask L2 for [p, p + bytes) (its 16-byte aligned part), in PF_CHUNK pieces
// dealt to n threads, this one idx
__device__ void prefetch_l2(const void* p, size_t bytes, size_t idx, size_t n) {
  const uintptr_t a0 = (reinterpret_cast<uintptr_t>(p) + 15) & ~uintptr_t(15);
  const uintptr_t a1 = (reinterpret_cast<uintptr_t>(p) + bytes) & ~uintptr_t(15);
  for (uintptr_t a = a0 + idx * PF_CHUNK; a < a1; a += n * PF_CHUNK) {
    const uint32_t sz = uint32_t(smin(PF_CHUNK, size_t(a1 - a)));
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(a), "r"(sz) : "memory");
  }
}

// Phase 1's idle blocks (or every block when none is idle): the o weight
// (measured on the H100: faster than none, and than adding the first
// gate/up rows)
__device__ void prefetch_weights(const TailArgs& a) {
  const int grid = gridDim.x, idle = grid > a.n_att ? grid - a.n_att : grid;
  const int first = grid > a.n_att ? a.n_att : 0;
  if (int(blockIdx.x) < first) return;
  const size_t idx = size_t(blockIdx.x - first) * NT + threadIdx.x, n = size_t(idle) * NT;
  prefetch_l2(a.ow, size_t(a.hd) * a.hd, idx, n);
}

__device__ void attention_phase(const TailArgs& a, unsigned char* smem) {
  const int n_sl = (a.att.D + ADS - 1) / ADS;
  for (int it = blockIdx.x; it < a.n_att; it += gridDim.x) {
    const int bkv = it / n_sl, sl = it - bkv * n_sl, b = bkv / a.att.n_kv;
    const int kv = bkv - b * a.att.n_kv;
    if (a.att_vec)
      chunk_block<float, Q_INT8, true, KeyMask, ADS>(a.att, b, kv, 0, sl * ADS, smem);
    else
      chunk_block<float, Q_INT8, false, KeyMask, ADS>(a.att, b, kv, 0, sl * ADS, smem);
  }
}

template <int MB>
__device__ void oproj_phase(const TailArgs& a, unsigned char* smem) {
  constexpr int U = o_u(MB);
  const int hd = a.hd, nq = hd / 4, n_items = (hd + OCW - 1) / OCW;
  if (int(blockIdx.x) >= n_items) return;
  uint32_t* codes = reinterpret_cast<uint32_t*>(smem);                 // [MB][nq]
  int* red = reinterpret_cast<int*>(codes + MB * nq);                  // [NT/32][OCG][MB][16]
  float* sr_s = reinterpret_cast<float*>(red + (NT / 32) * OCG * MB * 16);   // [MB]
  float* tmp = sr_s + MB;                                              // [NT]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cgi = tid % OCG, ql = tid / OCG;
  for (int m0 = 0; m0 < a.B; m0 += MB) {
    const int mb = min(MB, a.B - m0);
    __syncthreads();                     // the previous pass is done with codes and sr
    for (int m = 0; m < MB; ++m) {
      const float* row = a.attf + size_t(m0 + m) * hd;
      float sr = 1.f;
      if (m < mb) {
        float mx = 0.f;
        for (int i = tid; i < hd; i += NT) mx = fmaxf(mx, fabsf(__ldcg(row + i)));
        sr = __fmul_rn(fmaxf(block_max(mx, tmp), 1e-8f), 1.0f / 127.0f);
      }
      for (int q = tid; q < nq; q += NT) {
        uint32_t word = 0;
        if (m < mb) {
          const float4 v = __ldcg(reinterpret_cast<const float4*>(row) + q);
          const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = int(fminf(fmaxf(rintf(__fdiv_rn(vs[j], sr)), -127.f), 127.f));
            word |= (uint32_t(c) & 0xFFu) << (8 * j);
          }
        }
        codes[m * nq + q] = word;
      }
      if (tid == 0) sr_s[m] = sr;
    }
    __syncthreads();
    for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
      const int c0 = it * OCW, col = c0 + cgi * 16;
      const bool active = col < hd, v16 = a.vec_o && col + 16 <= hd;
      const int8_t* wp = a.ow + (active ? col : 0);
      int acc[MB][16];
#pragma unroll
      for (int m = 0; m < MB; ++m)
#pragma unroll
        for (int c = 0; c < 16; ++c) acc[m][c] = 0;
      if (active) {
        uint4 wv[U][4];
        load_quads<U>(wv, wp, hd, ql, OQL, nq, hd - col, v16);
        stream_quads<MB, U>(acc, wv, wp, hd, ql, OQL, nq, hd - col, v16, codes);
      }
      // the quad lanes of a warp that share a column group (lanes of one
      // parity), then the warps through shared memory: exact in any order
#pragma unroll
      for (int off = OCG; off < 32; off <<= 1)
#pragma unroll
        for (int m = 0; m < MB; ++m)
#pragma unroll
          for (int c = 0; c < 16; ++c) acc[m][c] += __shfl_xor_sync(0xffffffffu, acc[m][c], off);
      if (lane < OCG) {
#pragma unroll
        for (int m = 0; m < MB; ++m)
#pragma unroll
          for (int c = 0; c < 16; ++c) red[((warp * OCG + lane) * MB + m) * 16 + c] = acc[m][c];
      }
      __syncthreads();
      for (int o = tid; o < mb * OCW; o += NT) {
        const int m = o / OCW, c = o - m * OCW, n = c0 + c;
        if (n >= hd) continue;
        int s = 0;
#pragma unroll
        for (int w = 0; w < NT / 32; ++w) s += red[((w * OCG + c / 16) * MB + m) * 16 + c % 16];
        const float part = __fmul_rn(__fmul_rn(float(s), sr_s[m]), a.os[n]);
        const size_t at = size_t(m0 + m) * hd + n;
        a.x2[at] = round_to<__nv_bfloat16>(__fadd_rn(load_either(a.x, at, a.x_bf16), part));
      }
      __syncthreads();                   // red is rewritten by the next item
    }
  }
}

template <int MB>
__device__ void gate_up_phase(const TailArgs& a, float* smem) {
  const int hd = a.hd, n_items = (a.I + GU_CW - 1) / GU_CW;
  if (int(blockIdx.x) >= n_items) return;
  float* tmp = smem;                     // [NT]
  float* rn = smem + NT;                 // [B]
  float* gu = smem + gu_offset(a.B, hd, a.hn_held);
  for (int m = 0; m < a.B; ++m) {
    const float* row = a.x2 + size_t(m) * hd;
    float ss = 0.f;
    for (int i = threadIdx.x; i < hd; i += NT) {
      const float v = __ldcg(row + i);
      ss = __fadd_rn(ss, __fmul_rn(v, v));
    }
    const float var = __fdiv_rn(block_sum(ss, tmp), float(hd));
    if (threadIdx.x == 0) rn[m] = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, a.eps)));
  }
  __syncthreads();
  // hn = bf16((x2 * r) * pn); block 0 also writes it out
  const auto hn = [&](int r, int i) {
    return round_to<__nv_bfloat16>(__fmul_rn(__fmul_rn(__ldcg(a.x2 + size_t(r) * hd + i), rn[r]),
                                             load_either(a.pn, i, a.pn_bf16)));
  };
  if (a.hn_held) {
    __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem + hn_offset(a.B));   // [B][hd]
    for (int i = threadIdx.x; i < a.B * hd; i += NT) {
      const float v = hn(i / hd, i % hd);
      hs[i] = __float2bfloat16_rn(v);
      if (blockIdx.x == 0) a.hn[i] = v;
    }
    // gate_up_item's first barrier orders these writes before its reads
    const auto held = [&](int r, int i) { return __bfloat162float(hs[size_t(r) * hd + i]); };
    for (int it = blockIdx.x; it < n_items; it += gridDim.x)
      gate_up_item<MB, mlp_u(MB)>(held, it * GU_CW, a.gp, a.gs, a.up, a.us, a.h, a.B, hd, a.I,
                                  a.gelu, a.vec_gu, gu);
    return;
  }
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < a.B * hd; i += NT) a.hn[i] = hn(i / hd, i % hd);
  for (int it = blockIdx.x; it < n_items; it += gridDim.x)
    gate_up_item<MB, mlp_u(MB)>(hn, it * GU_CW, a.gp, a.gs, a.up, a.us, a.h, a.B, hd, a.I,
                                a.gelu, a.vec_gu, gu);
}

template <int MB>
__device__ void down_phase(const TailArgs& a, float* smem) {
  const int n_cols = (a.hd + DN_NW - 1) / DN_NW, n_items = n_cols * (a.I / a.TI);
  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    const int t = it / n_cols;
    down_item<MB, mlp_u(MB)>(a.h, t, (it - t * n_cols) * DN_NW, a.dp, a.ds, a.parts, a.B, a.hd,
                             a.I, a.TI, a.vec_dn, smem);
  }
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <int MB>
__global__ void __launch_bounds__(NT, MINB) fused_tail(TailArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  float* smem_f = reinterpret_cast<float*>(smem);
  unsigned long long ts[6];
  if (FL_PHASE_TIMES) ts[0] = global_ns();
  if (!a.empty) {
    prefetch_weights(a);
    attention_phase(a, smem);
  }
  grid.sync();
  if (FL_PHASE_TIMES) ts[1] = global_ns();
  if (!a.empty) oproj_phase<MB>(a, smem);
  grid.sync();
  if (FL_PHASE_TIMES) ts[2] = global_ns();
  if (!a.empty) gate_up_phase<MB>(a, smem_f);
  grid.sync();
  if (FL_PHASE_TIMES) ts[3] = global_ns();
  if (!a.empty) down_phase<MB>(a, smem_f);
  grid.sync();
  if (FL_PHASE_TIMES) ts[4] = global_ns();
  if (a.empty) return;
  const int n_tiles = a.I / a.TI, bh = a.B * a.hd;
  for (int i = blockIdx.x * NT + threadIdx.x; i < bh; i += gridDim.x * NT) {
    float y = __ldcg(a.x2 + i);
    for (int t = 0; t < n_tiles; ++t) y = __fadd_rn(y, __ldcg(a.parts + size_t(t) * bh + i));
    a.y[i] = y;
  }
  if (FL_PHASE_TIMES) {
    grid.sync();
    ts[5] = global_ns();
    if (blockIdx.x == 0 && threadIdx.x == 0)
      for (int k = 0; k < 6; ++k) reinterpret_cast<unsigned long long*>(a.hn)[k] = ts[k];
  }
}

// the launch's grid (blocks), occupancy and the kernel's attributes
struct Plan {
  size_t smem;
  int blocks, per_sm, sms;
  cudaFuncAttributes attr;
};

// items of the largest phase
int max_items(const TailArgs& a) {
  const int o = (a.hd + OCW - 1) / OCW, gu = (a.I + GU_CW - 1) / GU_CW;
  const int dn = (a.hd + DN_NW - 1) / DN_NW * (a.I / a.TI), sum = (a.B * a.hd + NT - 1) / NT;
  return std::max(std::max(std::max(a.n_att, o), std::max(gu, dn)), sum);
}

// The runtime's answers for one kernel and shared memory size on one
// device are kept (asking costs more host time than the launch itself).
template <int MB>
int plan_tail(const TailArgs& a, Plan* p) {
  static Plan cached{};
  static int cached_dev = -1;
  const size_t smem = tail_smem(MB, a.B, a.att.D, a.att.bl, a.hd, a.TI);
  if (smem > DW_SMEM_MAX) return int(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  if (dev != cached_dev || smem != cached.smem) {
    Plan q{};
    q.smem = smem;
    auto kernel = fused_tail<MB>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
    if ((err = cudaFuncGetAttributes(&q.attr, kernel)) != cudaSuccess) return int(err);
    err = cudaDeviceGetAttribute(&q.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return int(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&q.per_sm, kernel, NT, smem);
    if (err != cudaSuccess) return int(err);
    if (q.per_sm < 1) return int(cudaErrorInvalidConfiguration);
    cached = q;
    cached_dev = dev;
  }
  *p = cached;
  p->blocks = std::min(p->per_sm * p->sms, max_items(a));
  return 0;
}

template <int MB>
int launch_tail(TailArgs a, cudaStream_t st, int* info) {
  a.hn_held = hold_hn(MB, a.B, a.att.D, a.att.bl, a.hd, a.TI);
  Plan p{};
  const int rc = plan_tail<MB>(a, &p);
  if (rc) return rc;
  if (info) {                            // the plan only, no launch
    info[0] = p.blocks;
    info[1] = p.per_sm;
    info[2] = p.sms;
    info[3] = p.attr.numRegs;
    info[4] = int(p.smem);
    info[5] = int(p.attr.localSizeBytes);
    info[6] = MB;
    info[7] = a.hn_held;
    return 0;
  }
  void* args[] = {&a};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(fused_tail<MB>), dim3(p.blocks), dim3(NT), args, p.smem, st);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

// rows per pass: 1 or 2 for a batch of that size, else 4 (a last pass of
// fewer rows pads with zeros)
int launch_rows(const TailArgs& a, cudaStream_t st, int* info) {
  if (a.B == 1) return launch_tail<1>(a, st, info);
  if (a.B == 2) return launch_tail<2>(a, st, info);
  return launch_tail<4>(a, st, info);
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

int run(const void* q8, const void* qs, const void* k, const void* ks, const void* v,
        const void* vs, const void* mask, const void* x, const void* ow, const void* os,
        const void* pn, const void* gp, const void* gs, const void* up, const void* us,
        const void* dp, const void* ds, void* attf, void* x2, void* tail, void* y, int B,
        int n_kv, int D, int L, int bl, int nvb, int pack4, int I, int TI, int gelu,
        float scale, float eps, int x_dtype, int pn_dtype, int empty, void* stream, int* info) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int hd = n_kv * D;
  if (B <= 0 || n_kv <= 0 || D <= 0 || bl <= 0 || L % bl || nvb < 0 || nvb * bl > L
      || hd % 4 || TI < 4 || TI % 4 || I % TI)
    return int(cudaErrorInvalidValue);
  TailArgs a{};
  const size_t bh = size_t(B) * hd;
  const size_t h_rows = (size_t(I) + 2 * hd - 1) / (2 * hd);   // h [B, I] bf16 in rows of bh
  a.attf = static_cast<float*>(attf);
  a.x2 = static_cast<float*>(x2);
  a.hn = static_cast<float*>(tail);
  a.h = reinterpret_cast<__nv_bfloat16*>(a.hn + bh);
  a.parts = a.hn + (1 + h_rows) * bh;
  a.y = static_cast<float*>(y);
  a.att.q = q8;
  a.att.q8 = static_cast<const int8_t*>(q8);
  a.att.qsc = static_cast<const float*>(qs);
  a.att.k = static_cast<const int8_t*>(k);
  a.att.v = static_cast<const int8_t*>(v);
  a.att.ks = static_cast<const __nv_bfloat16*>(ks);
  a.att.vs = static_cast<const __nv_bfloat16*>(vs);
  a.att.mask = static_cast<const uint8_t*>(mask);
  a.att.out = a.attf;
  a.att.Tc = 1;
  a.att.H = n_kv;
  a.att.n_kv = n_kv;
  a.att.D = D;
  a.att.L = L;
  a.att.bl = bl;
  a.att.pack4 = pack4;
  a.att.nvb = nvb;
  a.att.qg = 1;
  a.att.scale = scale;
  a.att_vec = chunk_vec(a.att);
  a.x = x;
  a.ow = static_cast<const int8_t*>(ow);
  a.os = static_cast<const float*>(os);
  a.pn = pn;
  a.gp = static_cast<const int8_t*>(gp);
  a.up = static_cast<const int8_t*>(up);
  a.dp = static_cast<const int8_t*>(dp);
  a.gs = static_cast<const float*>(gs);
  a.us = static_cast<const float*>(us);
  a.ds = static_cast<const float*>(ds);
  a.B = B;
  a.hd = hd;
  a.I = I;
  a.TI = TI;
  a.gelu = gelu;
  a.vec_o = hd % 16 == 0 && aligned16(ow);
  a.vec_gu = I % 16 == 0 && aligned16(gp) && aligned16(up);
  a.vec_dn = hd % 16 == 0 && aligned16(dp);
  a.n_att = B * n_kv * ((D + ADS - 1) / ADS);
  a.eps = eps;
  a.empty = empty;
  if (x_dtype < 0 || x_dtype > 1 || pn_dtype < 0 || pn_dtype > 1)
    return int(cudaErrorInvalidValue);
  a.x_bf16 = x_dtype;
  a.pn_bf16 = pn_dtype;
  return launch_rows(a, st, info);
}

}  // namespace
}  // namespace wgt

// One layer's tail. q8: [B, hd] int8 and qs: [B, H] fp32 (banded_q8 of q,
// head h at [b, h]); k, v: the layer's [B, L, width] int8 cache; ks, vs:
// [B, H, L] bf16; mask: [B, L] bytes; x: [B, hd] in x_dtype; ow: [hd, hd]
// int8; os: [hd] fp32; pn: [hd] in pn_dtype; gp, up: [hd/2, I] int8 (up,
// us null for the gelu MLP); gs, us: [I] fp32; dp: [I/2, hd] int8; ds:
// [hd] fp32; scratches attf, x2: [B, hd] fp32; parts: fp32, hn [B, hd],
// then h [B, I] in bf16 (ceil(I / (2 hd)) rows of [B, hd]), then the
// partials [I/TI, B, hd]; y: [B, hd] fp32. dtypes: 0 = float32, 1 =
// bfloat16. Returns the launch's CUDA error.
extern "C" int wg_fused_layer_tail(const void* q8, const void* qs, const void* k, const void* ks,
                                   const void* v, const void* vs, const void* mask,
                                   const void* x, const void* ow, const void* os, const void* pn,
                                   const void* gp, const void* gs, const void* up,
                                   const void* us, const void* dp, const void* ds, void* attf,
                                   void* x2, void* parts, void* y, int B, int n_kv, int D, int L,
                                   int bl, int nvb, int pack4, int I, int TI, int gelu,
                                   float scale, float eps, int x_dtype, int pn_dtype,
                                   void* stream) {
  return wgt::run(q8, qs, k, ks, v, vs, mask, x, ow, os, pn, gp, gs, up, us, dp, ds, attf, x2,
                  parts, y, B, n_kv, D, L, bl, nvb, pack4, I, TI, gelu, scale, eps, x_dtype,
                  pn_dtype, 0, stream, nullptr);
}

// The same launch with every phase empty: its four grid barriers and the
// launch alone (what the barriers cost). Arguments as wg_fused_layer_tail's.
extern "C" int wg_fused_layer_tail_barriers(
    const void* q8, const void* qs, const void* k, const void* ks, const void* v, const void* vs,
    const void* mask, const void* x, const void* ow, const void* os, const void* pn,
    const void* gp, const void* gs, const void* up, const void* us, const void* dp,
    const void* ds, void* attf, void* x2, void* parts, void* y, int B, int n_kv, int D, int L,
    int bl, int nvb, int pack4, int I, int TI, int gelu, float scale, float eps, int x_dtype,
    int pn_dtype, void* stream) {
  return wgt::run(q8, qs, k, ks, v, vs, mask, x, ow, os, pn, gp, gs, up, us, dp, ds, attf, x2,
                  parts, y, B, n_kv, D, L, bl, nvb, pack4, I, TI, gelu, scale, eps, x_dtype,
                  pn_dtype, 1, stream, nullptr);
}

// The launch the shapes would take, without launching: info[0..7] = blocks,
// blocks an SM (occupancy), SMs, registers a thread, dynamic shared memory
// a block (bytes), local memory a thread (spills, bytes), rows per pass,
// whether hn is held in shared memory.
// Returns 0 or the CUDA error the launch would meet.
extern "C" int wg_fused_layer_tail_info(int B, int n_kv, int D, int L, int bl, int pack4, int I,
                                        int TI, int x_dtype, int pn_dtype, int* info) {
  return wgt::run(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                  nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                  nullptr, nullptr, nullptr, nullptr, B, n_kv, D, L, bl, 0, pack4, I, TI, 1, 1.f,
                  1e-6f, x_dtype, pn_dtype, 0, nullptr, info);
}
