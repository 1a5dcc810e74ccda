// Candidate mismatch count for sa_rate > 1: one thread per candidate.
//
// Replaces bwtpu/kernels/verify2.py::verify_packed at sa_rate > 1: the
// stride-8 text-row gather and word funnel (verify2.py:181-197) plus
// bwtpu/kernels/pallas_step.py::verify_nm_pallas (_verify_kernel): align
// the text window to the candidate's bit phase, XOR with the 2-bit
// packed read, fold each mismatching base onto its even bit, OR the
// ambiguity bits, mask to the read length, popcount.
//
// What bounds it on an H100: one dependent load of W+1 text words from a
// 64 B text row (row w>>3, words [w&7, (w&7)+W]) per candidate, plus
// 3 x W read-side words; the arithmetic is a few dozen integer ops. The
// row gather, the funnel and the popcount are fused, so nothing between
// them goes to device memory.
//
// `x << 32` is undefined in C++: the bit-phase shift keeps the
// reference's `ob == 0` guard (pallas_step.py:294).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNmInvalid = 255;

__global__ void verify_nm_kernel(const int* __restrict__ text_rows, int row_width,
                                 long long text_len,
                                 const int* __restrict__ cand,
                                 const bool* __restrict__ cvalid,
                                 const int* __restrict__ read_words,
                                 const int* __restrict__ amb_bits,
                                 const int* __restrict__ len_mask,
                                 const int* __restrict__ lens, int n_cand,
                                 int W, int* __restrict__ nm) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_cand) return;
  const int c = cand[i];
  if (!(cvalid[i] && c >= 0 && (long long)c + lens[i] <= text_len)) {
    nm[i] = kNmInvalid;
    return;
  }
  const int w = c >> 4;
  const int* row = text_rows + (size_t)(w >> 3) * row_width;
  const int sub = w & 7;
  const uint32_t ob = (uint32_t)(c & 15) * 2u;
  const int* rw = read_words + (size_t)i * W;
  const int* ab = amb_bits + (size_t)i * W;
  const int* lm = len_mask + (size_t)i * W;
  // words past the row's end read as 0, like the reference's zero-filled
  // funnel shift (never reached when rows are built for this read length)
  uint32_t lo = sub < row_width ? (uint32_t)__ldg(row + sub) : 0u;
  int count = 0;
  for (int q = 0; q < W; ++q) {
    const int col = sub + q + 1;
    const uint32_t hi = col < row_width ? (uint32_t)__ldg(row + col) : 0u;
    const uint32_t window = (lo >> ob) | (ob == 0 ? 0u : (hi << (32u - ob)));
    const uint32_t x = window ^ (uint32_t)__ldg(rw + q);
    uint32_t pair = (x | (x >> 1)) & 0x55555555u;
    pair = (pair | (uint32_t)__ldg(ab + q)) & (uint32_t)__ldg(lm + q);
    count += __popc(pair);
    lo = hi;
  }
  nm[i] = count;
}

}  // namespace

extern "C" int bwtpu_verify_nm(const void* text_rows, int row_width,
                               long long text_len, const void* cand,
                               const void* cvalid, const void* read_words,
                               const void* amb_bits, const void* len_mask,
                               const void* lens, int n_cand, int W, void* nm,
                               void* stream) {
  if (n_cand > 0) {
    const int threads = 256;
    const int blocks = (n_cand + threads - 1) / threads;
    verify_nm_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int*)text_rows, row_width, text_len, (const int*)cand,
        (const bool*)cvalid, (const int*)read_words, (const int*)amb_bits,
        (const int*)len_mask, (const int*)lens, n_cand, W, (int*)nm);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* bwtpu_cuda_error_name(int err) {
  return cudaGetErrorName((cudaError_t)err);
}
