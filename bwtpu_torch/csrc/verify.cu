// Candidate mismatch counts: one thread per candidate.
//
// verify_nm_kernel (sa_rate > 1, or locv off) replaces
// bwtpu/kernels/pallas_step.py::verify_nm_pallas (_verify_kernel), the
// stride-8 text-row gather and word funnel of
// bwtpu/kernels/verify2.py::verify_packed (verify2.py:181-197) and the
// per-candidate row take around them in bwtpu/engine.py:523-541, 560-566.
// It takes the compacted candidates as locate left them (slot j: position
// spos[j] of lane sel[j] // max_loc, j < *count, count on the device) and
// the read-level rows, and computes each candidate's read row, seed offset
// and validity itself, so nothing is gathered per candidate into device
// memory. What bounds it on an H100: per candidate, three dependent rounds
// of loads (sel; its seed offset; its text row) and the 3 x W read-side
// words, which neighbouring candidates of one read share (they are
// neighbours in compact order, so those rows come from L1 or L2). So:
//   - W is a template parameter (instances for W = 1 .. kMaxW, the wrapper
//     dispatches): the window loop unrolls and every load of a candidate is
//     issued before the first XOR. Reads wider than kMaxW words (over 320
//     bases) take verify_nm_wide_kernel, which has W at run time and streams
//     the window a word at a time (window_nm of verify.cuh) from the row, so
//     it holds no array and needs no local memory, at the price of loads
//     issued one word after another;
//   - the text-row load needs only the candidate's start (not the read's
//     length) to stay in range, so it is issued together with the read's
//     rows and length; the length test comes after;
//   - a 64 B text row (row width a multiple of 4 words) is loaded as 16 B
//     vectors and the window [w & 7, (w & 7) + W] selected in registers by a
//     three-stage funnel; other row widths load their W + 1 words one by
//     one;
//   - the read planes may have any row stride (0 for the block path's one
//     shared length mask), so no contiguous copy is made for the kernel.
// Measured on an H100 and not kept: issuing the read's rows together with
// the seed offset (no faster), loading from the located position alone
// the two text rows that hold every window of a seed offset up to 112
// (slower), and one fused 128 B read table in place of the three planes
// (no faster, and one more launch to build it).
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
// between them goes to device memory.

#include "verify.cuh"

namespace {

using bwtpu::kNmInvalid;
using bwtpu::window_nm;

constexpr int kThreads = 256;
constexpr int kMaxW = 20;  // widest read with a template instance: 320 bases

// The read-level row of one candidate: three W-word planes with their row
// strides in words (the layout of verify2.pack_reads).
struct ReadRows {
  const int* rw;
  const int* ab;
  const int* lm;
  long long s_rw, s_ab, s_lm;
};

// x[q] = x[q + K] for every q when `on`: one stage of the window
// select. K is a template parameter so that every index is a constant and
// x stays in registers (a loop over K put x in local memory).
template <int K, int N>
__device__ __forceinline__ void shift_if(uint32_t (&x)[N], bool on) {
#pragma unroll
  for (int q = 0; q + K < N; ++q) x[q] = on ? x[q + K] : x[q];
}

template <int W, bool kVecRows>
__global__ void verify_nm_kernel(const int* __restrict__ text_rows, int row_width,
                                 long long text_len, const int* __restrict__ spos,
                                 const int* __restrict__ sel, const int* __restrict__ count,
                                 const int* __restrict__ seed_off, ReadRows rr,
                                 const int* __restrict__ lens, int max_loc, int n_slots,
                                 int cap, int* __restrict__ cand_out,
                                 int* __restrict__ nm_out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= cap) return;
  const int lane = __ldg(sel + j) / max_loc;  // sel names a lane on every slot
  const int b = lane / n_slots;
  const int sp = __ldg(spos + j);
  const bool live = j < __ldg(count) && sp >= 0;
  const int c = sp - __ldg(seed_off + lane);
  cand_out[j] = c;
  // c < text_len keeps the text row in range (the wrapper checks that the
  // rows cover text_len); the read's length is tested after the loads
  if (!(live && c >= 0 && (long long)c < text_len)) {
    nm_out[j] = kNmInvalid;
    return;
  }
  uint32_t rw[W], ab[W], lm[W];
#pragma unroll
  for (int q = 0; q < W; ++q) {
    rw[q] = (uint32_t)__ldg(rr.rw + (size_t)b * rr.s_rw + q);
    ab[q] = (uint32_t)__ldg(rr.ab + (size_t)b * rr.s_ab + q);
    lm[q] = (uint32_t)__ldg(rr.lm + (size_t)b * rr.s_lm + q);
  }
  const int len = __ldg(lens + b);
  const int w = c >> 4;
  const int sub = w & 7;
  const int* row = text_rows + (size_t)(w >> 3) * row_width;
  uint32_t x[kVecRows ? 4 * ((W + 8 + 3) / 4) : W + 1];
  if constexpr (kVecRows) {  // the whole row (W + 8 words at most), then the window
    constexpr int kV = (W + 8 + 3) / 4;
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      // words past the row's end read as 0, like the reference's
      // zero-filled funnel (never reached when rows are built for this
      // read length)
      const int4 t = 4 * v < row_width ? __ldg((const int4*)row + v) : make_int4(0, 0, 0, 0);
      x[4 * v] = t.x; x[4 * v + 1] = t.y; x[4 * v + 2] = t.z; x[4 * v + 3] = t.w;
    }
    shift_if<1>(x, sub & 1);
    shift_if<2>(x, sub & 2);
    shift_if<4>(x, sub & 4);
  } else {
#pragma unroll
    for (int q = 0; q <= W; ++q) x[q] = sub + q < row_width ? (uint32_t)__ldg(row + sub + q) : 0u;
  }
  const uint32_t ob = (uint32_t)(c & 15) * 2u;
  int nm = 0;
#pragma unroll
  for (int q = 0; q < W; ++q) {
    const uint32_t xo = __funnelshift_r(x[q], x[q + 1], ob) ^ rw[q];  // ob = 0: x[q]
    nm += __popc((((xo | (xo >> 1)) & 0x55555555u) | ab[q]) & lm[q]);
  }
  nm_out[j] = (long long)c + len <= text_len ? nm : kNmInvalid;
}

// Any W (the wrapper sends W > kMaxW here): the same candidate, validity
// and length rules as verify_nm_kernel, the window read word by word.
__global__ void verify_nm_wide_kernel(const int* __restrict__ text_rows, int row_width,
                                      long long text_len, const int* __restrict__ spos,
                                      const int* __restrict__ sel,
                                      const int* __restrict__ count,
                                      const int* __restrict__ seed_off, ReadRows rr,
                                      const int* __restrict__ lens, int W, int max_loc,
                                      int n_slots, int cap, int* __restrict__ cand_out,
                                      int* __restrict__ nm_out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= cap) return;
  const int lane = __ldg(sel + j) / max_loc;
  const int b = lane / n_slots;
  const int sp = __ldg(spos + j);
  const bool live = j < __ldg(count) && sp >= 0;
  const int c = sp - __ldg(seed_off + lane);
  cand_out[j] = c;
  if (!(live && c >= 0 && (long long)c + __ldg(lens + b) <= text_len)) {
    nm_out[j] = kNmInvalid;
    return;
  }
  const int w = c >> 4;
  const int sub = w & 7;
  const int* row = text_rows + (size_t)(w >> 3) * row_width;
  auto word_at = [&](int q) -> uint32_t {
    return sub + q < row_width ? (uint32_t)__ldg(row + sub + q) : 0u;
  };
  nm_out[j] = window_nm(word_at, (uint32_t)(c & 15) * 2u, rr.rw + (size_t)b * rr.s_rw,
                        rr.ab + (size_t)b * rr.s_ab, rr.lm + (size_t)b * rr.s_lm, W);
}

template <int W>
cudaError_t launch_nm(int w, bool vec_rows, dim3 grid, cudaStream_t stream,
                      const int* text_rows, int row_width, long long text_len,
                      const int* spos, const int* sel, const int* count,
                      const int* seed_off, ReadRows rr, const int* lens, int max_loc,
                      int n_slots, int cap, int* cand, int* nm) {
  if constexpr (W > kMaxW) {
    verify_nm_wide_kernel<<<grid, kThreads, 0, stream>>>(text_rows, row_width, text_len,
                                                         spos, sel, count, seed_off, rr, lens,
                                                         w, max_loc, n_slots, cap, cand, nm);
    return cudaSuccess;
  } else {
    if (w != W) {
      return launch_nm<W + 1>(w, vec_rows, grid, stream, text_rows, row_width, text_len,
                              spos, sel, count, seed_off, rr, lens, max_loc, n_slots, cap,
                              cand, nm);
    }
    auto* f = vec_rows ? &verify_nm_kernel<W, true> : &verify_nm_kernel<W, false>;
    f<<<grid, kThreads, 0, stream>>>(text_rows, row_width, text_len, spos, sel, count,
                                     seed_off, rr, lens, max_loc, n_slots, cap, cand, nm);
    return cudaSuccess;
  }
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

}  // namespace

// vec_rows: the text rows are 16 B aligned with a width that is a multiple
// of 4 words.
extern "C" int bwtpu_verify_nm(const void* text_rows, int row_width, long long text_len,
                               const void* spos, const void* sel, const void* count,
                               const void* seed_off, const void* read_words,
                               long long rw_stride, const void* amb_bits, long long ab_stride,
                               const void* len_mask, long long lm_stride, const void* lens,
                               int W, int max_loc, int n_slots, int cap, int vec_rows,
                               void* cand, void* nm, void* stream) {
  if (cap > 0) {
    const ReadRows rr{(const int*)read_words, (const int*)amb_bits, (const int*)len_mask,
                      rw_stride, ab_stride, lm_stride};
    const cudaError_t err = launch_nm<1>(
        W, vec_rows != 0, dim3((cap + kThreads - 1) / kThreads), (cudaStream_t)stream,
        (const int*)text_rows, row_width, text_len, (const int*)spos, (const int*)sel,
        (const int*)count, (const int*)seed_off, rr, (const int*)lens, max_loc, n_slots, cap,
        (int*)cand, (int*)nm);
    if (err != cudaSuccess) return (int)err;
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
