// Banded Smith-Waterman best local score: one thread per lane, one warp
// of 32 lanes per CTA, the lanes' rows in shared memory before the row loop.
//
// sw_band_kernel replaces bwtpu/sw.py:28 sw_score_batch (jnp code that XLA
// fused on the TPU: a fori_loop over the read rows with the 2 * band + 1
// band cells of a row vectorised over the lanes). The reference's
// recurrence, for read row i = 1..L and band cell w = 0..2 * band, text
// position j = i + w - band:
//   cur[w] = max(0, prev[w] + s(text[j - 1], read[i - 1]), prev[w + 1] + gap)
//   cur[w] = 0 unless 1 <= j <= text_len and i <= read_len      (mask 1)
//   cur[w] = max(cur[w], max(cur[w - 1] + gap, 0)), w = 1..2 band (in order)
//   cur[w] = 0 unless 1 <= j <= text_len and i <= read_len      (mask 2)
//   best   = max(best, cur[w])
// with prev[2 band + 1] = 0, s = match or mismatch and text indexes
// clipped to [0, Lt - 1]. The kernel computes the same values in this
// order (sw.py's sw_score_plain takes it too):
//   - a lane runs rows 1..end, end = min(L, read_len, text_len + band)
//     (0 when text_len < 1): every later row has no cell inside the read
//     and the text, so it is all zeros and leaves best as it is;
//   - row i's valid cells are the contiguous range w in [lo, hi], lo =
//     max(0, band + 1 - i), hi = min(2 band, text_len - i + band). Rows
//     band < i <= text_len - band have every cell valid and run no mask;
//     the edge rows mask by a bit mask of [lo, hi], built once a row;
//   - the update is one DPX instruction, cur = __viaddmax_s32_relu(prev[w],
//     s, up + gap) = max(prev[w] + s, up + gap, 0), and the scan step is
//     cur[w] = __viaddmax_s32(cur[w - 1], gap, cur[w]): cur[w] >= 0 after
//     mask 1, so max(cur[w], max(cur[w - 1] + gap, 0)) equals
//     max(cur[w], cur[w - 1] + gap) for any gap.
// Codes compare as int32 values (dna's 0-4; N = 4 matches N).
//
// What bounds it on an H100: at the --rescore path's shapes (16,384 lanes,
// L 100, Lt 116, band 8) the inputs are ~14 MB (~4.3 us at 3.35 TB/s) and
// the row work ~0.28 G integer operations, but 16,384 lanes are 512
// warps, about one warp per scheduler of the 132 SMs: a warp's own loop
// of ~100 rows sets the time (4,096 lanes take nearly as long as 16,384;
// scripts/torch_sw_ab.py --lanes). The design this replaced loaded each
// row's codes from device memory one row ahead, masked every cell of every
// row and ran all L rows; a first redesign that staged 64-row tiles with
// 4 B cp.async spent, by clock64 counts on the card, about as many cycles
// of a warp issuing those copies as in its ~100 rows. Here:
//   - a CTA's lanes are consecutive rows of `reads` and of `text`, so each
//     block is one contiguous run: one bulk copy each (cp.async.bulk, an
//     mbarrier counting its bytes), issued by one thread, lands every code
//     the lanes need in shared memory (4 B cp.async where the run is not
//     16 B aligned); the row loop then reads only shared memory (two loads
//     a row) and registers;
//   - `band` is a template parameter (instances 0..16), so the 2 band + 1
//     cells and the sliding window of text codes index by constants and
//     stay in registers (a run-time index put verify_nm's window in local
//     memory once);
//   - per cell and row: a compare and a select for s, an add for up + gap,
//     the DPX update, the DPX scan step, a window move and half a
//     three-way max (__vimax3_s32) for best;
//   - the rows run as three loops: the edge rows 1..band, the interior
//     rows (no mask, no branch, unrolled by 4, so the compiler overlaps
//     one row's scan with the next row's update) and the edge rows past
//     text_len - band. One loop with a branch a row between the two kinds
//     took ~1.45x as long (scripts/torch_sw_ab.py).
// Rows too long for 32 lanes in a CTA's 227 KB of shared memory run with
// fewer lanes per CTA. Tried on the card and dropped (scripts/torch_sw_ab.py
// with the variant as a source): a two-block or log-depth scan (no faster;
// the log-depth one indexed the band at run time and spilled), dropping
// the scan or the best tracking altogether (only 7 % and 3 % faster, so
// the DP arithmetic is not the limit), one band split over two threads
// with two shuffles a row (faster at 4,096 lanes, slower at 16,384 and
// 65,536), 32- or 64-lane CTAs with 64- or 128-row tiles staged by 4 B
// cp.async (the staging cost), and no unrolling of the one-loop form.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;          // one warp per CTA, one lane per thread
constexpr int kMaxBand = 16;
constexpr int kMaxSmem = 232448;      // shared memory one CTA may have (227 KB)

// Hopper's bulk copy (cp.async.bulk, the TMA without a tensor map) and
// the mbarrier that counts its bytes
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// one thread: an mbarrier that completes a phase on one arrival (and the
// bytes that arrival expects)
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the arrival: the phase completes once `bytes` more bytes have landed
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// wait until the phase with this parity (0 for the first) has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// a bulk copy takes 16 B aligned sources and sizes (the shared blocks are)
__device__ __forceinline__ bool bulk_ok(const int* src, int n) {
  return n > 0 && n % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0;
}

// One row of the band: prev -> the row's final cells (in place), best
// raised by them. MASKED rows keep only the cells whose bit is set in
// `valid` (before and after the scan); the others have every cell valid.
template <int BAND, bool MASKED>
__device__ __forceinline__ void band_row(int (&prev)[2 * BAND + 1],
                                         const int (&t)[2 * BAND + 1], int rc, uint64_t valid,
                                         int match, int mismatch, int gap, int& best) {
  constexpr int W = 2 * BAND + 1;
  int cur[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int s = t[w] == rc ? match : mismatch;
    const int up = (w + 1 < W ? prev[w + 1] : 0) + gap;
    cur[w] = __viaddmax_s32_relu(prev[w], s, up);  // max(prev + s, up + gap, 0)
    if (MASKED) cur[w] = (valid >> w) & 1 ? cur[w] : 0;
  }
#pragma unroll
  for (int w = 1; w < W; ++w) cur[w] = __viaddmax_s32(cur[w - 1], gap, cur[w]);
#pragma unroll
  for (int w = 0; w < W; ++w) {
    if (MASKED) cur[w] = (valid >> w) & 1 ? cur[w] : 0;
    prev[w] = cur[w];
  }
#pragma unroll
  for (int w = 0; w + 1 < W; w += 2) best = __vimax3_s32(best, cur[w], cur[w + 1]);
  if (W % 2) best = max(best, cur[W - 1]);
}

// CTA: lanes b0 .. b0 + n_lanes - 1, b0 = blockIdx.x * lanes; shared
// memory: the mbarrier, then the lanes' read rows and text rows as they
// lie in device memory (each block 16 B aligned)
template <int BAND>
__global__ void __launch_bounds__(kThreads)
    sw_band_kernel(const int* __restrict__ text, int Lt, const int* __restrict__ text_lens,
                   const int* __restrict__ reads, int L, const int* __restrict__ read_lens,
                   int B, int lanes, int match, int mismatch, int gap,
                   int* __restrict__ best_out) {
  constexpr int W = 2 * BAND + 1;
  extern __shared__ __align__(16) int smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  int* s_read = smem + 4;
  int* s_text = s_read + (lanes * L + 3) / 4 * 4;
  const int lane = threadIdx.x;
  const int b0 = blockIdx.x * lanes;
  const int n_lanes = min(lanes, B - b0);
  // the CTA's rows lie together in device memory: one bulk copy each (4 B
  // cp.async by the warp where the bulk copy's alignment does not hold)
  const int *rsrc = reads + (size_t)b0 * L, *tsrc = text + (size_t)b0 * Lt;
  const int nr = n_lanes * L, nt = n_lanes * Lt;
  const bool bulk_r = bulk_ok(rsrc, nr), bulk_t = bulk_ok(tsrc, nt);
  if (lane == 0) {
    mbar_init(bar);
    mbar_expect(bar, (bulk_r ? 4u * nr : 0u) + (bulk_t ? 4u * nt : 0u));
    if (bulk_r) bulk_copy(s_read, rsrc, 4u * nr, bar);
    if (bulk_t) bulk_copy(s_text, tsrc, 4u * nt, bar);
  }
  if (!bulk_r)
    for (int f = lane; f < nr; f += 32) cp_async4(s_read + f, rsrc + f);
  if (!bulk_t)
    for (int f = lane; f < nt; f += 32) cp_async4(s_text + f, tsrc + f);

  int tl = 0, end = 0;  // the lane's rows: 1..end (none past n_lanes)
  if (lane < n_lanes) {
    tl = __ldg(text_lens + b0 + lane);
    const int rl = __ldg(read_lens + b0 + lane);
    end = min(L, rl);
    if (tl < 1) end = 0;
    else if (tl <= L) end = min(end, tl + BAND);
    end = max(end, 0);
  }
  const int* sr = s_read + lane * L;
  const int* st = s_text + lane * Lt;
  const int last = Lt - 1;  // text indexes clip to it, as the reference's take does
  cp_async_wait_all();
  __syncwarp();
  mbar_wait(bar, 0);

  // t[w] = text[i + w - band - 1] for the row i that just ran: row 0's
  // window (indexes -band - 1..band - 1; only those in [0, text_len)
  // matter), shifted before each row, which brings in one code
  int t[W], prev[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int idx = w - BAND - 1;
    t[w] = idx >= 0 && idx < tl && end > 0 && Lt > 0 ? st[min(idx, last)] : 0;
    prev[w] = 0;
  }
  int best = 0;
  auto edge_row = [&](int i) {
#pragma unroll
    for (int w = 0; w + 1 < W; ++w) t[w] = t[w + 1];
    t[W - 1] = Lt > 0 ? st[min(i + BAND - 1, last)] : 0;
    const int lo = max(0, BAND + 1 - i), hi = min(2 * BAND, tl - i + BAND);
    const uint64_t valid = ((2ull << hi) - 1) & ~((1ull << lo) - 1);
    band_row<BAND, true>(prev, t, sr[i - 1], valid, match, mismatch, gap, best);
  };
  int i = 1;
  for (; i <= min(end, BAND); ++i) edge_row(i);
  const int mid = min(end, tl - BAND);  // rows i <= mid have every cell valid
#pragma unroll 4
  for (; i <= mid; ++i) {
#pragma unroll
    for (int w = 0; w + 1 < W; ++w) t[w] = t[w + 1];
    t[W - 1] = Lt > 0 ? st[min(i + BAND - 1, last)] : 0;
    band_row<BAND, false>(prev, t, sr[i - 1], 0, match, mismatch, gap, best);
  }
  for (; i <= end; ++i) edge_row(i);
  if (lane < n_lanes) best_out[b0 + lane] = best;
}

template <int BAND>
cudaError_t launch(int band, int lanes, size_t smem, cudaStream_t stream, const int* text,
                   int Lt, const int* text_lens, const int* reads, int L, const int* read_lens,
                   int B, int match, int mismatch, int gap, int* out) {
  if constexpr (BAND > kMaxBand) {
    return cudaErrorInvalidValue;
  } else {
    if (band != BAND) {
      return launch<BAND + 1>(band, lanes, smem, stream, text, Lt, text_lens, reads, L,
                              read_lens, B, match, mismatch, gap, out);
    }
    static bool opted_in = false;  // shared memory past 48 KB, asked once per instance
    if (!opted_in) {
      const cudaError_t err = cudaFuncSetAttribute(
          sw_band_kernel<BAND>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (err != cudaSuccess) return err;
      opted_in = true;
    }
    sw_band_kernel<BAND><<<(B + lanes - 1) / lanes, kThreads, smem, stream>>>(
        text, Lt, text_lens, reads, L, read_lens, B, lanes, match, mismatch, gap, out);
    return cudaSuccess;
  }
}

// shared memory of a CTA of `lanes` lanes: the mbarrier and both row
// blocks, each rounded up to 16 B
size_t smem_bytes(int lanes, int L, int Lt) {
  return 16 + ((size_t)lanes * L + 3) / 4 * 16 + ((size_t)lanes * Lt + 3) / 4 * 16;
}

}  // namespace

extern "C" int bwtpu_sw_max_band() { return kMaxBand; }

// Rows too long for 32 lanes' rows in 227 KB of shared memory take fewer
// lanes per CTA; a lane whose rows alone do not fit (L + Lt over ~58,000
// codes) is refused with cudaErrorInvalidValue.
extern "C" int bwtpu_sw_band(const void* text, int Lt, const void* text_lens, const void* reads,
                             int L, const void* read_lens, int B, int band, int match,
                             int mismatch, int gap, void* out, void* stream) {
  if (B > 0) {
    int lanes = kThreads;
    while (lanes > 1 && smem_bytes(lanes, L, Lt) > (size_t)kMaxSmem) --lanes;
    if (smem_bytes(lanes, L, Lt) > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
    const cudaError_t err =
        launch<0>(band, lanes, smem_bytes(lanes, L, Lt), (cudaStream_t)stream,
                  (const int*)text, Lt, (const int*)text_lens, (const int*)reads, L,
                  (const int*)read_lens, B, match, mismatch, gap, (int*)out);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* bwtpu_cuda_error_name(int err) {
  return cudaGetErrorName((cudaError_t)err);
}
