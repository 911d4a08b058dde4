// The int8 product loop of K7 (fused_mlp_int8.cu: its gate/up and down
// passes) and of K12's o-projection (fused_layer.cu): a lane streams row
// quads (4 consecutive weight rows, 16 neighbouring columns of each, one
// 16-byte non-allocating load per row) and takes the exact int32 dot of one
// x row's 4 codes (one word) with each column's 4 weights by __dp4a. A
// loaded quad holds, for each 4 columns, 4 words of 4 columns each (one per
// row); 8 byte permutes transpose them into 4 words of 4 rows each (one per
// column), so a quad of 64 weight bytes costs 32 permutes and 16 dp4a per x
// row. Every sum is an exact integer: splitting the rows between lanes,
// warps or blocks leaves it as it is.
#pragma once

#include "mlp4_stream.cuh"

namespace wgt {

// U quads q = qb, qb + QL, ... of a lane: w[u][i] = the 16 bytes at
// wp + (4q + i) * ld (n of them exist; v16: all 16, aligned), zeros past nq
template <int U>
__device__ __forceinline__ void load_quads(uint4 (&w)[U][4], const int8_t* wp, size_t ld, int qb,
                                           int QL, int nq, int n, bool v16) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int q = qb + u * QL;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[u][i] = q < nq ? ld_bytes16(wp + size_t(4 * q + i) * ld, n, v16) : make_uint4(0, 0, 0, 0);
  }
}

// acc[m][c] += the dot of the 4 codes xw[m] (byte i: row i of the quad)
// and the weights of column c on the quad's rows (w[i]: 16 columns of row i)
template <int MB>
__device__ __forceinline__ void dp4a_quad(int (&acc)[MB][16], const uint4 (&w)[4],
                                          const uint32_t (&xw)[MB]) {
  const uint32_t r[4][4] = {{w[0].x, w[0].y, w[0].z, w[0].w}, {w[1].x, w[1].y, w[1].z, w[1].w},
                            {w[2].x, w[2].y, w[2].z, w[2].w}, {w[3].x, w[3].y, w[3].z, w[3].w}};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // columns 4j .. 4j + 3 of rows a, b, c, d -> one word per column
    const uint32_t ab_lo = __byte_perm(r[0][j], r[1][j], 0x5140);   // a0 b0 a1 b1
    const uint32_t cd_lo = __byte_perm(r[2][j], r[3][j], 0x5140);
    const uint32_t ab_hi = __byte_perm(r[0][j], r[1][j], 0x7362);   // a2 b2 a3 b3
    const uint32_t cd_hi = __byte_perm(r[2][j], r[3][j], 0x7362);
    const uint32_t col[4] = {__byte_perm(ab_lo, cd_lo, 0x5410), __byte_perm(ab_lo, cd_lo, 0x7632),
                             __byte_perm(ab_hi, cd_hi, 0x5410), __byte_perm(ab_hi, cd_hi, 0x7632)};
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int m = 0; m < MB; ++m)
        acc[m][4 * j + k] = __dp4a(int(col[k]), int(xw[m]), acc[m][4 * j + k]);
  }
}

// the lane's products over its quads q = q0, q0 + QL, ... < nq, U at a
// time; w holds the first U, already loaded
template <int MB, int U>
__device__ __forceinline__ void stream_quads(int (&acc)[MB][16], uint4 (&w)[U][4],
                                             const int8_t* wp, size_t ld, int q0, int QL, int nq,
                                             int n, bool v16, const uint32_t* codes) {
  for (int qb = q0; qb < nq; qb += QL * U) {
    if (qb != q0) load_quads<U>(w, wp, ld, qb, QL, nq, n, v16);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int q = qb + u * QL;
      if (q < nq) {
        uint32_t xw[MB];
#pragma unroll
        for (int m = 0; m < MB; ++m) xw[m] = codes[m * nq + q];
        dp4a_quad<MB>(acc, w[u], xw);
      }
    }
  }
}

}  // namespace wgt
