// Occ decoding of one 128-row block of the search lattice, shared by the
// kernels of this directory (layout in bwtpu/index.py: words 0-3 hold the
// block's per-base checkpoint counts, words 4-11 its 128 BWT codes packed
// 2 bits each, 12-15 the SA-sample marks, 16 the mark rank; words 17-20
// and 21-28 repeat 0-3 and 4-11 for the next block).
//
// Bit work is unsigned: `1u << 32` is undefined in C++, so the rank mask
// keeps the reference's `nb >= 16 -> 0xFFFFFFFF` case
// (bwtpu/kernels/pallas_step.py:_swar_rank).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bwtpu {

__device__ __forceinline__ uint32_t pick4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d, uint32_t i) {
  return i == 0 ? a : i == 1 ? b : i == 2 ? c : d;
}

// count of base c among the first m bases of a block's 8 packed words
__device__ __forceinline__ int swar_rank(const uint32_t (&w)[8], uint32_t c, int m) {
  const uint32_t pattern = c * 0x55555555u;
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    int nb = m - 16 * k;
    nb = nb < 0 ? 0 : (nb > 16 ? 16 : nb);
    const uint32_t mask = nb >= 16 ? 0xFFFFFFFFu : ((1u << (2 * nb)) - 1u);
    const uint32_t y = w[k] ^ pattern;
    cnt += __popc(~(y | (y >> 1)) & 0x55555555u & mask);
  }
  return cnt;
}

// C[c + 1] for a base code c in [0, 4), from the four values C[1..4]
__device__ __forceinline__ int c_base(const int (&c14)[4], int c) {
  return c == 0 ? c14[0] : c == 1 ? c14[1] : c == 2 ? c14[2] : c14[3];
}

// 1 when the '$' row lies in block j before row i (Occ(0, i) counts it)
__device__ __forceinline__ int dollar_corr(int c, int dollar_row, int j, int i) {
  return (c == 0 && (dollar_row >> 7) == j && dollar_row < i) ? 1 : 0;
}

// Occ(c, i) without the '$' correction, from a block's checkpoint words
// (ck) and BWT words (w): m = i & 127
__device__ __forceinline__ int block_occ(int4 ck, const uint32_t (&w)[8], int c, int m) {
  return (int)pick4(ck.x, ck.y, ck.z, ck.w, c) + swar_rank(w, c, m);
}

// words 4-11 of a record as 8 unsigned words
__device__ __forceinline__ void bwt_words(int4 b0, int4 b1, uint32_t (&w)[8]) {
  w[0] = b0.x; w[1] = b0.y; w[2] = b0.z; w[3] = b0.w;
  w[4] = b1.x; w[5] = b1.y; w[6] = b1.z; w[7] = b1.w;
}

}  // namespace bwtpu
