// Banded Smith-Waterman best local score, one thread per lane.
//
// sw_band_kernel replaces bwtpu/sw.py:28 sw_score_batch (jnp code that XLA
// fused on the TPU: a fori_loop over the read rows with the 2 * band + 1
// band cells of a row vectorised over the lanes). The recurrence, exactly
// as the reference orders it, for read row i = 1..L (every row, however
// short the read) and band cell w = 0..2 * band, text position
// j = i + w - band:
//   cur[w] = max(0, prev[w] + s(text[j - 1], read[i - 1]), prev[w + 1] + gap)
//   cur[w] = 0 unless 1 <= j <= text_len and i <= read_len      (mask 1)
//   cur[w] = max(cur[w], max(cur[w - 1] + gap, 0)), w = 1..2 band (in order)
//   cur[w] = 0 unless 1 <= j <= text_len and i <= read_len      (mask 2)
//   best   = max(best, cur[w])
// with prev[2 band + 1] = 0 and s = match or mismatch; text indexes clip to
// [0, Lt - 1] as the reference's take_along_axis does.
//
// What bounds it on an H100: the work per lane is a serial recurrence of L
// rows, each ~10 integer operations on each of the 17 cells (band 8) and
// one new read code and text code; the lane's inputs (L + Lt int32 codes)
// are read once. At the --rescore path's shapes (B <= 16,384 primaries,
// L 100, Lt <= 116) that is ~14 MB and ~0.2 G operations, a few
// microseconds at the card's rates, while a lane's own chain is ~100 rows
// deep. So the design keeps everything of a lane in registers: `band` is a
// template parameter, so the band arrays index by constants (a run-time
// index put verify_nm's window in local memory once), and the text codes a
// row needs sit in a (2 band + 1)-code register window that slides one
// position per row and takes in one new code, loaded one row ahead with the
// next read code. Small CTAs spread a 16,384-lane batch over all SMs.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;  // 16,384 lanes -> 512 CTAs over 132 SMs
constexpr int kMaxBand = 16;

__device__ __forceinline__ int clip(int x, int hi) { return x < 0 ? 0 : (x > hi ? hi : x); }

template <int BAND>
__global__ void sw_band_kernel(const int* __restrict__ text, int Lt,
                               const int* __restrict__ text_lens,
                               const int* __restrict__ reads, int L,
                               const int* __restrict__ read_lens, int B, int match,
                               int mismatch, int gap, int* __restrict__ best_out) {
  constexpr int W = 2 * BAND + 1;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int* trow = text + (size_t)b * Lt;
  const int* rrow = reads + (size_t)b * L;
  const int tl = __ldg(text_lens + b);
  const int rl = __ldg(read_lens + b);
  auto text_at = [&](int idx) -> int { return Lt > 0 ? __ldg(trow + clip(idx, Lt - 1)) : 0; };
  // t[w] = text[clip(i + w - band - 1)] for the row i about to run: the
  // window of row 0, shifted in the loop before each row
  int t[W], prev[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    t[w] = text_at(w - BAND - 1);
    prev[w] = 0;
  }
  int best = 0;
  int t_next = text_at(BAND), r_next = L > 0 ? __ldg(rrow) : 0;
  for (int i = 1; i <= L; ++i) {
#pragma unroll
    for (int w = 0; w + 1 < W; ++w) t[w] = t[w + 1];
    t[W - 1] = t_next;
    const int rc = r_next;
    if (i < L) {  // the next row's codes, loaded while this row computes
      t_next = text_at(i + BAND);
      r_next = __ldg(rrow + i);
    }
    const bool in_read = i <= rl;
    int cur[W];
    bool ok[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int j = i + w - BAND;
      ok[w] = in_read && j >= 1 && j <= tl;
      const int s = t[w] == rc ? match : mismatch;
      const int up = w + 1 < W ? prev[w + 1] : 0;
      const int c = max(0, max(prev[w] + s, up + gap));
      cur[w] = ok[w] ? c : 0;
    }
#pragma unroll
    for (int w = 1; w < W; ++w) cur[w] = max(cur[w], max(cur[w - 1] + gap, 0));
#pragma unroll
    for (int w = 0; w < W; ++w) {
      prev[w] = ok[w] ? cur[w] : 0;
      best = max(best, prev[w]);
    }
  }
  best_out[b] = best;
}

template <int BAND>
cudaError_t launch(int band, dim3 grid, cudaStream_t stream, const int* text, int Lt,
                   const int* text_lens, const int* reads, int L, const int* read_lens, int B,
                   int match, int mismatch, int gap, int* out) {
  if constexpr (BAND > kMaxBand) {
    return cudaErrorInvalidValue;
  } else {
    if (band != BAND) {
      return launch<BAND + 1>(band, grid, stream, text, Lt, text_lens, reads, L, read_lens, B,
                              match, mismatch, gap, out);
    }
    sw_band_kernel<BAND><<<grid, kThreads, 0, stream>>>(text, Lt, text_lens, reads, L,
                                                        read_lens, B, match, mismatch, gap, out);
    return cudaSuccess;
  }
}

}  // namespace

extern "C" int bwtpu_sw_max_band() { return kMaxBand; }

extern "C" int bwtpu_sw_band(const void* text, int Lt, const void* text_lens, const void* reads,
                             int L, const void* read_lens, int B, int band, int match,
                             int mismatch, int gap, void* out, void* stream) {
  if (B > 0) {
    const cudaError_t err =
        launch<0>(band, dim3((B + kThreads - 1) / kThreads), (cudaStream_t)stream,
                  (const int*)text, Lt, (const int*)text_lens, (const int*)reads, L,
                  (const int*)read_lens, B, match, mismatch, gap, (int*)out);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* bwtpu_cuda_error_name(int err) {
  return cudaGetErrorName((cudaError_t)err);
}
