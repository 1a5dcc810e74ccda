// Two-record backward search, valid at any interval width: the straggler
// finisher of both search paths. One thread owns one lane's whole chain.
//
// Replaces bwtpu/kernels/pallas_step.py::search_step_pallas
// (_search_step_kernel) and the fori_loop of L - d steps around it in
// bwtpu/kernels/search2.py::_two_gather_search, together with the
// compaction around it in _fixup_stragglers[_packed]: per step, Occ(c, sp)
// from the record of block sp >> 7 and Occ(c, ep) from the record of block
// ep >> 7 (words 0-11 of each), the C[] base, the '$' correction and the
// ambiguity mask. It gives the same bits as common.occ for any width.
//
// Lanes come compacted: lane sel[j] for j < *count, where count stays on
// the device (no host sync); threads with j >= count exit. Each lane reads
// sp0/ep0[lane] and writes its result to sp/ep[lane] IN PLACE (the caller's
// tensors), in place of a scatter back.
//
// What bounds it on an H100: a lane's chain is up to L - d dependent steps,
// each one round trip to L2 for the two 48 B records (the lattice, 4.6 MB
// at E. coli scale, stays in the 50 MB L2), then the SWAR ranks. The bytes
// are few (~0.4 MB for a block's finisher); the latency of the chain is the
// floor. So:
//   - the lane's pattern is loaded before the chain, all words at once,
//     into registers (2-bit packed rows: a window of 16 words, reloaded
//     only by slices longer than ~250 bases; rows of W = 7 words are 28 B,
//     not 16 B aligned, so these are 4 B loads, issued together). Each step
//     takes its code and ambiguity field by a shift, so the chain loads
//     nothing but lattice records. (The 1-step path's int32 planes are
//     read one step ahead instead.)
//   - both records' loads are issued together, before either rank;
//   - CTAs of 32 threads, so a block's finisher (~100-500 lanes) spreads
//     over the SMs instead of sitting on two.
// Measured on an H100 (PERF.md, chip_smoke.py phase 3): one lane alone runs
// ~0.53 us per step, ~0.45 us with a lattice small enough for L1, and the
// main path's ~100-lane calls sit within ~10 % of that. A group of four
// threads per lane (one 16 B piece of each record per thread, the rank
// split, sums by shuffles) and CTAs of 64 or 128 threads ran within ~2 % of
// this design and were dropped: the chain's own per-step latency, mostly
// the rank arithmetic after each load, is the whole cost.
//
// Index ranges: the chain is exact, so sp and ep stay in [0, n] and
// i >> 7 <= n_blocks is a lattice row for both (n_blocks + 1 rows).

#include "occ.cuh"

namespace {

using namespace bwtpu;

// Bases [off, off + slen) of a lane's 2-bit packed row (base b at word
// b >> 4, bits 2 * (b & 15); the ambiguity row likewise), walked from base
// off + slen - 1 - d down to off. Words [top - kWin + 1, top] are held in
// registers, word `top` in slot kWin - 1.
struct PackedCursor {
  static constexpr int kWin = 16;
  const int* w;
  const int* a;
  int g;     // base of the next step
  int lo;    // lowest word the chain reads
  int left;  // words held below the top slot
  uint32_t pw[kWin], pa[kWin];

  __device__ __forceinline__ void load(int top) {
#pragma unroll
    for (int k = 0; k < kWin; ++k) {
      const int wi = top - (kWin - 1) + k;
      pw[k] = wi >= lo ? (uint32_t)__ldg(w + wi) : 0u;
      pa[k] = wi >= lo ? (uint32_t)__ldg(a + wi) : 0u;
    }
    left = kWin - 1;
  }

  __device__ __forceinline__ PackedCursor(const int* words, const int* amb, int off,
                                          int slen, int d)
      : w(words), a(amb), g(off + slen - 1 - d), lo(off >> 4) {
    if (slen > d) load(g >> 4);
  }

  // 2-bit code and ambiguity field of base g; then step to g - 1
  __device__ __forceinline__ void next(int& c, int& amb) {
    const int sh = 2 * (g & 15);
    c = (int)((pw[kWin - 1] >> sh) & 3u);
    amb = (int)((pa[kWin - 1] >> sh) & 3u);
    if ((g & 15) == 0 && g > 0) {  // leaving word g >> 4
      if (left == 0) {
        load((g >> 4) - 1);
      } else {
#pragma unroll
        for (int k = kWin - 1; k > 0; --k) {
          pw[k] = pw[k - 1];
          pa[k] = pa[k - 1];
        }
        --left;
      }
    }
    --g;
  }
};

// Columns [L - len, L - 1 - d] of a lane's right-aligned int32 code and
// ambiguity planes (the 1-step path's), walked down from L - 1 - d, the
// next step's pair loaded one step ahead.
struct PlaneCursor {
  const int* codes;
  const int* amb;
  int pos, lo, c_next, a_next;

  __device__ __forceinline__ PlaneCursor(const int* codes_row, const int* amb_row, int L,
                                         int len, int d)
      : codes(codes_row), amb(amb_row), pos(L - 1 - d), lo(L - len) {
    if (pos >= lo) {
      c_next = __ldg(codes + pos);
      a_next = __ldg(amb + pos);
    }
  }

  __device__ __forceinline__ void next(int& c, int& a) {
    c = c_next;
    a = a_next;
    if (--pos >= lo) {
      c_next = __ldg(codes + pos);
      a_next = __ldg(amb + pos);
    }
  }
};

// The chain of one lane from (sp, ep), nsteps steps of `cur`.
template <class Cursor>
__device__ __forceinline__ void chain(const int4* __restrict__ lattice, const int (&c14)[4],
                                      int dollar_row, Cursor& cur, int nsteps, int& sp,
                                      int& ep) {
  for (int t = 0; t < nsteps; ++t) {
    int c, a;
    cur.next(c, a);
    if (a == 1) {
      sp = 0;
      ep = 0;
      continue;
    }
    const int j = sp >> 7, je = ep >> 7;
    const int4* rs = lattice + (size_t)j * 8;
    const int4* re = lattice + (size_t)je * 8;
    const int4 s0 = __ldg(rs), s1 = __ldg(rs + 1), s2 = __ldg(rs + 2);
    const int4 e0 = __ldg(re), e1 = __ldg(re + 1), e2 = __ldg(re + 2);
    uint32_t ws[8], we[8];
    bwt_words(s1, s2, ws);
    bwt_words(e1, e2, we);
    const int cb = c_base(c14, c);
    sp = cb + block_occ(s0, ws, c, sp & 127) - dollar_corr(c, dollar_row, j, sp);
    ep = cb + block_occ(e0, we, c, ep & 127) - dollar_corr(c, dollar_row, je, ep);
  }
}

__global__ void chain2_packed_kernel(const int4* __restrict__ lattice,
                                     const int* __restrict__ C, int dollar_row,
                                     const int* __restrict__ words,
                                     const int* __restrict__ amb_bits, int W, int off,
                                     int slen, const int* __restrict__ sp0,
                                     const int* __restrict__ ep0,
                                     const int* __restrict__ sel,
                                     const int* __restrict__ count, int d,
                                     int* __restrict__ sp, int* __restrict__ ep) {
  const int j = (int)(blockIdx.x * blockDim.x + threadIdx.x);
  if (j >= __ldg(count)) return;
  const int lane = __ldg(sel + j);
  const int c14[4] = {__ldg(C + 1), __ldg(C + 2), __ldg(C + 3), __ldg(C + 4)};
  PackedCursor cur(words + (size_t)lane * W, amb_bits + (size_t)lane * W, off, slen, d);
  int s = __ldg(sp0 + lane), e = __ldg(ep0 + lane);
  chain(lattice, c14, dollar_row, cur, slen - d, s, e);
  sp[lane] = s;
  ep[lane] = e;
}

__global__ void chain2_planes_kernel(const int4* __restrict__ lattice,
                                     const int* __restrict__ C, int dollar_row,
                                     const int* __restrict__ ra_codes,
                                     const int* __restrict__ ra_amb,
                                     const int* __restrict__ lens, int L,
                                     const int* __restrict__ sp0,
                                     const int* __restrict__ ep0,
                                     const int* __restrict__ sel,
                                     const int* __restrict__ count, int d,
                                     int* __restrict__ sp, int* __restrict__ ep) {
  const int j = (int)(blockIdx.x * blockDim.x + threadIdx.x);
  if (j >= __ldg(count)) return;
  const int lane = __ldg(sel + j);
  const int c14[4] = {__ldg(C + 1), __ldg(C + 2), __ldg(C + 3), __ldg(C + 4)};
  int len = __ldg(lens + lane);
  len = len > L ? L : len;
  PlaneCursor cur(ra_codes + (size_t)lane * L, ra_amb + (size_t)lane * L, L, len, d);
  int s = __ldg(sp0 + lane), e = __ldg(ep0 + lane);
  chain(lattice, c14, dollar_row, cur, len - d, s, e);
  sp[lane] = s;
  ep[lane] = e;
}

}  // namespace

constexpr int kCta = 32;  // threads per CTA (see the head of this file)

// The grid covers `cap` lanes, the most `count` can hold.
extern "C" int bwtpu_search_chain2_packed(const void* lattice, const void* C,
                                          int dollar_row, const void* words,
                                          const void* amb_bits, int W, int off, int slen,
                                          const void* sp0, const void* ep0,
                                          const void* sel, const void* count, int cap,
                                          int d, void* sp, void* ep, void* stream) {
  if (cap > 0) {
    chain2_packed_kernel<<<(cap + kCta - 1) / kCta, kCta, 0, (cudaStream_t)stream>>>(
        (const int4*)lattice, (const int*)C, dollar_row, (const int*)words,
        (const int*)amb_bits, W, off, slen, (const int*)sp0, (const int*)ep0,
        (const int*)sel, (const int*)count, d, (int*)sp, (int*)ep);
  }
  return (int)cudaGetLastError();
}

extern "C" int bwtpu_search_chain2_planes(const void* lattice, const void* C,
                                          int dollar_row, const void* ra_codes,
                                          const void* ra_amb, const void* lens, int L,
                                          const void* sp0, const void* ep0,
                                          const void* sel, const void* count, int cap,
                                          int d, void* sp, void* ep, void* stream) {
  if (cap > 0) {
    chain2_planes_kernel<<<(cap + kCta - 1) / kCta, kCta, 0, (cudaStream_t)stream>>>(
        (const int4*)lattice, (const int*)C, dollar_row, (const int*)ra_codes,
        (const int*)ra_amb, (const int*)lens, L, (const int*)sp0, (const int*)ep0,
        (const int*)sel, (const int*)count, d, (int*)sp, (int*)ep);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* bwtpu_cuda_error_name(int err) {
  return cudaGetErrorName((cudaError_t)err);
}
