// The single-pass scan of the port's stream compactions, shared by
// searchk.cu's exit kernel and compact.cu's two kernels: a block scan of
// the threads' counts, then a decoupled look-back between CTAs.
//
// A CTA takes its tile from a ticket counter (atomicAdd on a word that
// starts at 0), so that it only ever waits on tiles whose CTAs have
// started. It scans its threads' counts (block_exclusive_scan); then one
// warp publishes the tile's count at once (kScanAgg) and its inclusive
// prefix (kScanPrefix) once its predecessors' are known, reading them 32
// tiles at a time (tile_lookback). The ticket and the look-back words
// start at 0: the caller zeroes them with one cudaMemsetAsync on the
// kernel's stream, which a CUDA graph capture records. A tile's prefix
// must stay below 2^30.

#pragma once

#include <cuda_runtime.h>

namespace bwtpu {

constexpr unsigned kScanAgg = 1u << 30;     // look-back word: aggregate only
constexpr unsigned kScanPrefix = 2u << 30;  // look-back word: inclusive prefix
constexpr unsigned kScanValue = kScanAgg - 1u;

__device__ __forceinline__ unsigned scan_load_volatile(const unsigned* p) {
  return *reinterpret_cast<const volatile unsigned*>(p);
}

// The exclusive prefix of `own` among the CTA's NWARPS * 32 threads (all of
// them call it) in .x, the CTA's sum in .y. s_warp: NWARPS ints of shared
// memory. One __syncthreads.
template <int NWARPS>
__device__ __forceinline__ int2 block_exclusive_scan(int own, int* s_warp) {
  const int l = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = own;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (l >= o) incl += n;
  }
  if (l == 31) s_warp[warp] = incl;
  __syncthreads();
  int below = 0, run = 0;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) {
    const int c = s_warp[w];
    below += w < warp ? c : 0;
    run += c;
  }
  return make_int2(below + incl - own, run);
}

// Decoupled look-back, run by one whole warp of the CTA that owns `tile`
// (its count `run`): publishes the count, sums its predecessors' words
// until one holds an inclusive prefix, publishes its own inclusive prefix
// and returns the tile's exclusive prefix (in every lane).
__device__ __forceinline__ int tile_lookback(unsigned* flags, int tile, int run) {
  const int l = threadIdx.x & 31;
  int excl = 0;
  if (l == 0) atomicExch(&flags[tile], (tile == 0 ? kScanPrefix : kScanAgg) | (unsigned)run);
  for (int top = tile - 1; top >= 0; top -= 32) {
    const int j = top - l;
    unsigned v;
    do {
      v = j >= 0 ? scan_load_volatile(flags + j) : kScanPrefix;
    } while (__any_sync(0xFFFFFFFFu, (v >> 30) == 0u));
    const unsigned pre = __ballot_sync(0xFFFFFFFFu, (v >> 30) == 2u);
    const int stop = pre ? __ffs(pre) - 1 : 32;
    int add = l <= stop ? (int)(v & kScanValue) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) add += __shfl_xor_sync(0xFFFFFFFFu, add, o);
    excl += add;
    if (pre) break;
  }
  if (l == 0 && tile > 0) atomicExch(&flags[tile], kScanPrefix | (unsigned)(excl + run));
  return excl;
}

}  // namespace bwtpu
