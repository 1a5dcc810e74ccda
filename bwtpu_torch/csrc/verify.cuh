// Mismatch count of one candidate against its 2-bit packed read, for
// verify.cu's verify_locv_kernel (the XOR/popcount body of
// bwtpu/kernels/pallas_step.py::_verify_kernel and of
// bwtpu/kernels/verify2.py::verify_packed_locv).
//
// `word_at(q)` yields text word q (q = 0..W) of the window that starts at
// the candidate's word cand >> 4, 0 past the row's end. The window is
// shifted by the bit phase ob = 2 * (cand & 15), XORed with the read,
// each mismatching base folded onto its even bit, the ambiguity bits ORed
// in, the result masked to the read length and popcounted.
//
// `x << 32` is undefined in C++: the shift keeps the reference's
// `ob == 0` guard (pallas_step.py:294).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bwtpu {

constexpr int kNmInvalid = 255;

template <typename WordAt>
__device__ __forceinline__ int window_nm(WordAt word_at, uint32_t ob,
                                         const int* __restrict__ rw,
                                         const int* __restrict__ ab,
                                         const int* __restrict__ lm, int W) {
  uint32_t lo = word_at(0);
  int count = 0;
  for (int q = 0; q < W; ++q) {
    const uint32_t hi = word_at(q + 1);
    const uint32_t window = (lo >> ob) | (ob == 0 ? 0u : (hi << (32u - ob)));
    const uint32_t x = window ^ (uint32_t)__ldg(rw + q);
    uint32_t pair = (x | (x >> 1)) & 0x55555555u;
    pair = (pair | (uint32_t)__ldg(ab + q)) & (uint32_t)__ldg(lm + q);
    count += __popc(pair);
    lo = hi;
  }
  return count;
}

}  // namespace bwtpu
