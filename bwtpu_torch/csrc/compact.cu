// Fixed-capacity stream compaction in lane order, on the device: one
// memset and one kernel a call.
//
//   compact_mask   the True lanes of a bool mask: sel[p] = lane for the
//                  lane at position p < cap, and over[lane] = position
//                  >= cap (the callers' `valid & cumsum(valid) > cap`);
//   compact_slots  lane l owns slots l*H + j for j < c_l, c_l = counts[l]
//                  clamped to [0, H]: sel[cum_l + j] = l*H + j below cap,
//                  and dropped[l] = c_l > 0 && cum_l + c_l > cap.
//
// Both write count = min(total, cap) and overflow = max(total - cap, 0)
// as 0-dim int32, and leave sel 0 from count on.
//
// Replaces bwtpu/kernels/compact.py::compact (:18) and ::compact_counts
// (:39), jnp that XLA fused on the TPU: a cumsum and a scatter, and for
// compact_counts a cumsum over the lanes, a scatter-max of each live
// lane's base at its first slot and a cummax; in the port's plain torch
// each of those ops is a launch of its own. A mask is the case H = 1 of
// the slot form (c = valid, and `dropped` is then exactly `position >=
// cap`), so both kernels share one body: a CTA takes its tile of kTile
// lanes from a ticket, kItems consecutive lanes a thread; the lanes'
// counts are scanned in the CTA and across CTAs by the decoupled
// look-back of scan.cuh, and each lane writes its own slots and flag. The
// last tile writes count and overflow. The one memset zeroes sel, the
// scalars, the ticket and the look-back words.
//
// What bounds it on an H100: bytes, and few of them: each lane's count (4
// B, 1 B for a mask) read once, its flag (1 B) written once, and sel (4 B
// a slot, up to cap) written by the memset and by the lanes. At the main
// path's shapes (32,768 to 1,048,576 lanes; cap = loc_factor x the
// read-strand rows) that is a few MB, microseconds at 3.35 TB/s, so a
// call's time is its two launches and the look-back's chain across tiles;
// 2,048 lanes a tile keep the tiles few. Measured: PERF.md §6
// (chip_smoke.py phase 3).

#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

using namespace bwtpu;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                    // consecutive lanes a thread
constexpr int kTile = kThreads * kItems;     // lanes a CTA

// scalars: count, overflow, the ticket; flags: one look-back word a tile
template <typename T>
__device__ __forceinline__ void compact_body(const T* __restrict__ in, int n, int H, int cap,
                                             int* __restrict__ sel, bool* __restrict__ flag,
                                             int* __restrict__ scalars,
                                             unsigned* __restrict__ flags, int nb) {
  __shared__ int s_tile, s_prefix;
  __shared__ int s_warp[kWarps];
  const int l = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = atomicAdd(scalars + 2, 1);
  __syncthreads();
  const int tile = s_tile;
  const int first = tile * kTile + (int)threadIdx.x * kItems;

  int c[kItems];
  int own = 0;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int i = first + r;
    int v = i < n ? (int)in[i] : 0;
    v = v < 0 ? 0 : (v > H ? H : v);
    c[r] = v;
    own += v;
  }
  const int2 scan = block_exclusive_scan<kWarps>(own, s_warp);
  const int mine = scan.x, run = scan.y;
  if (warp == 0) {
    const int excl = tile_lookback(flags, tile, run);
    if (l == 0) s_prefix = excl;
  }
  __syncthreads();
  int p = s_prefix + mine;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int i = first + r;
    if (i < n) {
      flag[i] = c[r] > 0 && p + c[r] > cap;
      const int base = i * H;
      for (int j = 0; j < c[r] && p + j < cap; ++j) sel[p + j] = base + j;
      p += c[r];
    }
  }
  if (threadIdx.x == 0 && tile == nb - 1) {
    const int total = s_prefix + run;
    scalars[0] = total < cap ? total : cap;
    scalars[1] = total > cap ? total - cap : 0;
  }
}

__global__ void __launch_bounds__(kThreads) compact_mask_kernel(
    const bool* __restrict__ valid, int n, int cap, int* __restrict__ sel,
    bool* __restrict__ over, int* __restrict__ scalars, unsigned* __restrict__ flags, int nb) {
  compact_body(valid, n, 1, cap, sel, over, scalars, flags, nb);
}

__global__ void __launch_bounds__(kThreads) compact_slots_kernel(
    const int* __restrict__ counts, int n, int H, int cap, int* __restrict__ sel,
    bool* __restrict__ dropped, int* __restrict__ scalars, unsigned* __restrict__ flags,
    int nb) {
  compact_body(counts, n, H, cap, sel, dropped, scalars, flags, nb);
}

int tiles(int n) { return n > 0 ? (n + kTile - 1) / kTile : 1; }

// The int32 workspace: sel[cap], count, overflow, the ticket, one
// look-back word a tile; zeroed by one memset on `s`.
int prepare(int n, int H, int cap, void* ws, int ws_words, cudaStream_t s) {
  if (n < 0 || H < 1 || cap < 0 || ws_words != cap + 3 + tiles(n) ||
      (long long)n * H >= (long long)kScanAgg)
    return (int)cudaErrorInvalidValue;
  return (int)cudaMemsetAsync(ws, 0, (size_t)ws_words * sizeof(int), s);
}

}  // namespace

// Lanes a CTA: the wrappers size the workspace's look-back words by it.
extern "C" int bwtpu_compact_tile() { return kTile; }

// compact(valid, cap) on `stream`: sel, count, overflow in `ws` (see
// prepare), over bool[n].
extern "C" int bwtpu_compact_mask(const void* valid, int n, int cap, void* ws, int ws_words,
                                  void* over, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int err = prepare(n, 1, cap, ws, ws_words, s);
  if (err != 0) return err;
  int* w = (int*)ws;
  compact_mask_kernel<<<tiles(n), kThreads, 0, s>>>((const bool*)valid, n, cap, w, (bool*)over,
                                                     w + cap, (unsigned*)(w + cap + 3),
                                                     tiles(n));
  return (int)cudaGetLastError();
}

// compact_counts(counts, H, cap) on `stream`: sel, count, overflow in `ws`,
// dropped bool[n].
extern "C" int bwtpu_compact_slots(const void* counts, int n, int H, int cap, void* ws,
                                   int ws_words, void* dropped, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int err = prepare(n, H, cap, ws, ws_words, s);
  if (err != 0) return err;
  int* w = (int*)ws;
  compact_slots_kernel<<<tiles(n), kThreads, 0, s>>>((const int*)counts, n, H, cap, w,
                                                      (bool*)dropped, w + cap,
                                                      (unsigned*)(w + cap + 3), tiles(n));
  return (int)cudaGetLastError();
}

extern "C" const char* bwtpu_cuda_error_name(int err) {
  return cudaGetErrorName((cudaError_t)err);
}
