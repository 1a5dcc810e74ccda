// Candidate mismatch counts: one thread per candidate.
//
// verify_nm_kernel (sa_rate > 1, or locv off) replaces
// bwtpu/kernels/verify2.py::verify_packed: the stride-8 text-row gather
// and word funnel (verify2.py:181-197) plus
// bwtpu/kernels/pallas_step.py::verify_nm_pallas (_verify_kernel). What
// bounds it on an H100: one dependent load of W+1 text words from a 64 B
// text row (row w>>3, words [w&7, (w&7)+W]) per candidate, plus 3 x W
// read-side words.
//
// verify_locv_kernel (sa_rate == 1 with the fused locate+verify table)
// replaces the row take, SA mask, word funnel and popcount of
// bwtpu/engine.py:548-554 and verify2.py::verify_packed_locv: one load of
// the candidate's locv row (SA value, then 2W+1 text words from ws =
// clip((SA >> 4) - W, 0, n_words - 1)) yields the position and the
// window. The funnel shift q = (cand >> 4) - ws is applied as the
// reference applies it, bit by bit for the bits b <= W, so q & mask. What
// bounds it: one dependent 64 B row load (L 100) per candidate from a
// table of n rows (~300 MB at E. coli scale), plus 3 x W read-side words.
//
// In both, the row load, the funnel and the popcount are fused, so nothing
// between them goes to device memory; the popcount is verify.cuh's.

#include "verify.cuh"

namespace {

using bwtpu::kNmInvalid;
using bwtpu::window_nm;

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
  // words past the row's end read as 0, like the reference's zero-filled
  // funnel shift (never reached when rows are built for this read length)
  auto word_at = [&](int q) -> uint32_t {
    return sub + q < row_width ? (uint32_t)__ldg(row + sub + q) : 0u;
  };
  const size_t o = (size_t)i * W;
  nm[i] = window_nm(word_at, (uint32_t)(c & 15) * 2u, read_words + o,
                    amb_bits + o, len_mask + o, W);
}

__global__ void verify_locv_kernel(const int* __restrict__ locv,
                                   long long text_len,
                                   const int* __restrict__ rows,
                                   const bool* __restrict__ valid,
                                   const int* __restrict__ off,
                                   const int* __restrict__ read_words,
                                   const int* __restrict__ amb_bits,
                                   const int* __restrict__ len_mask,
                                   const int* __restrict__ lens, int n_cand,
                                   int W, int* __restrict__ pos,
                                   int* __restrict__ nm) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_cand) return;
  if (!valid[i]) {
    pos[i] = -1;
    nm[i] = kNmInvalid;
    return;
  }
  const int R2 = 2 * W + 1;  // text words of a row, after the SA value
  const int* rec = locv + (size_t)rows[i] * (R2 + 1);
  const int spos = __ldg(rec);
  pos[i] = spos;
  const int c = spos - off[i];
  if (!(spos >= 0 && c >= 0 && (long long)c + lens[i] <= text_len)) {
    nm[i] = kNmInvalid;
    return;
  }
  const int nw = (int)((text_len + 15) >> 4);
  int ws = (spos >> 4) - W;
  ws = ws < 0 ? 0 : ws;
  ws = ws > (nw > 0 ? nw - 1 : 0) ? (nw > 0 ? nw - 1 : 0) : ws;
  const int mask = (1 << (32 - __clz(W))) - 1;  // the bits b <= W
  const int s = ((c >> 4) - ws) & mask;
  auto word_at = [&](int q) -> uint32_t {
    return s + q < R2 ? (uint32_t)__ldg(rec + 1 + s + q) : 0u;
  };
  const size_t o = (size_t)i * W;
  nm[i] = window_nm(word_at, (uint32_t)(c & 15) * 2u, read_words + o,
                    amb_bits + o, len_mask + o, W);
}

constexpr int kThreads = 256;

}  // namespace

extern "C" int bwtpu_verify_nm(const void* text_rows, int row_width,
                               long long text_len, const void* cand,
                               const void* cvalid, const void* read_words,
                               const void* amb_bits, const void* len_mask,
                               const void* lens, int n_cand, int W, void* nm,
                               void* stream) {
  if (n_cand > 0) {
    const int blocks = (n_cand + kThreads - 1) / kThreads;
    verify_nm_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)text_rows, row_width, text_len, (const int*)cand,
        (const bool*)cvalid, (const int*)read_words, (const int*)amb_bits,
        (const int*)len_mask, (const int*)lens, n_cand, W, (int*)nm);
  }
  return (int)cudaGetLastError();
}

extern "C" int bwtpu_verify_locv(const void* locv, long long text_len,
                                 const void* rows, const void* valid,
                                 const void* off, const void* read_words,
                                 const void* amb_bits, const void* len_mask,
                                 const void* lens, int n_cand, int W, void* pos,
                                 void* nm, void* stream) {
  if (n_cand > 0) {
    const int blocks = (n_cand + kThreads - 1) / kThreads;
    verify_locv_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)locv, text_len, (const int*)rows, (const bool*)valid,
        (const int*)off, (const int*)read_words, (const int*)amb_bits,
        (const int*)len_mask, (const int*)lens, n_cand, W, (int*)pos,
        (int*)nm);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* bwtpu_cuda_error_name(int err) {
  return cudaGetErrorName((cudaError_t)err);
}
