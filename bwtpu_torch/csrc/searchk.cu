// Multi-step early-stop backward search with its whole-batch exit, on the
// device: everything of search_early_stop_packed before its finisher.
//
// Replaces the jnp program bwtpu/kernels/searchk.py::search_early_stop_packed
// (one jax.jit with a while_loop): the k-mer start key and table row
// (prep.kmer_key_packed), the wide phase (common.occ on the two-record
// lattice), and the multi-step trips on the s-mer lattice
// (occk_pair_from_record, prep.smer_codes_packed), up to the finisher's
// input. Record layouts: bwtpu/index.py (search lattice: occ.cuh; s-mer
// lattice: OCCK_BLOCK / OCCK_WIDTH, R rows a record, words 0..A-1 the
// folds, words A..A+R/4-1 the rows' s-mer codes, one byte each).
//
// The reference tests `(t < T) & ((n_pool > cap) | (t < min_trips))` before
// each trip. A lane's trips depend only on its own row and the index, and
// the pool only loses lanes, so here each lane runs its trips until it
// leaves the pool and records `leave` (the trip count when it stopped or
// straggled; T if never) into a histogram of T + 1 bins. The exit trip t*
// is the first t >= min_trips whose pool #{leave > t} is <= cap, else T.
// A lane with leave > t* is unfinished in the reference (the finisher
// restarts it from sp0, ep0 or forces it empty), so its later state is
// never read: exit_kernel finds t* from the histogram and ORs leave > t*
// into each lane's unfinished flag, with no host sync and no second pass.
//
// What bounds it on an H100: a lane's trips are a chain of dependent loads
// of a 512 B (step 3) or 2 KB (step 4) record, each from a random block of
// a lattice that sits in L2 at bacterial scale (9.3 MB at E. coli). So one
// group of R / 16 threads (16 for step 3, 32 for step 4) owns a lane: each
// thread loads one 16 B piece of the record's code bytes (pieces wholly at
// or past the interval's end are not loaded), compares 4 bytes at a time
// with __vcmpeq4, masks by the interval's two ends, and a shuffle sum over
// the group gives both counts; the fold word is one broadcast load. The
// lane's pattern bits are read a word at a time as the trips walk down the
// row (two words of each plane held in registers). Stopped lanes stop: no
// dead gathers of record 0 as on the TPU. Each CTA sums its lanes' `leave`
// in shared memory before one atomic per bin.
// Measured on an H100 (PERF.md, chip_smoke.py phase 3): 0.019 ms for one
// block's 32,768 lanes (k = 0 and each k = 2 seed), ~9x its bytes bound;
// the plain torch version in the same order takes 20-70 ms.
//
// Index ranges: sp stays in [0, n] on pool lanes, so sp >> log2(R) is at
// most the terminator record n_blocksK; a record's counted window is
// clamped at R rows (ep - base may exceed R: that lane straggles, and its
// sp/ep, garbage as in the reference, are replaced by the finisher).

#include "occ.cuh"

namespace {

using namespace bwtpu;

constexpr int kCta = 256;         // threads per CTA of the search kernel
constexpr int kSmemBins = 8192;   // histogram bins kept in shared memory

// `nbits` (<= 26) bits from base slot j of a 2-bit packed row
__device__ __forceinline__ uint32_t extract_bits(const int* row, int j, int nbits) {
  const int w = j >> 4, b = 2 * (j & 15);
  uint32_t v = (uint32_t)__ldg(row + w) >> b;
  if (b + nbits > 32) v |= (uint32_t)__ldg(row + w + 1) << (32 - b);
  return v & ((1u << nbits) - 1u);
}

// the n 2-bit fields of v (LSB-first) as one code, field 0 most significant
__device__ __forceinline__ int msb_first(uint32_t v, int n) {
  int code = 0;
  for (int f = 0; f < n; ++f) code = (code << 2) | (int)((v >> (2 * f)) & 3u);
  return code;
}

// bytes [0, n) of a 4-byte word as a mask of their low bits (n clamped)
__device__ __forceinline__ uint32_t low_bytes(int n) {
  return n <= 0 ? 0u : n >= 4 ? 0x01010101u : 0x01010101u & ((1u << (8 * n)) - 1u);
}

// s-mer codes of a lane's row, walked down the row group by group: words
// wi and wi + 1 of the bases and of the ambiguity bits in registers
struct SmerCursor {
  const int* w;
  const int* a;
  int W;
  int wi = -2;
  uint32_t w0 = 0, w1 = 0, a0 = 0, a1 = 0;

  __device__ __forceinline__ SmerCursor(const int* words, const int* amb, int nw)
      : w(words), a(amb), W(nw) {}

  // code (first base most significant) and ambiguity of bases [j, j + S)
  template <int S>
  __device__ __forceinline__ void get(int j, int& code, bool& amb) {
    const int want = j >> 4;
    if (want == wi - 1) {  // the walk moved down one word
      w1 = w0;
      a1 = a0;
      w0 = (uint32_t)__ldg(w + want);
      a0 = (uint32_t)__ldg(a + want);
    } else if (want != wi) {
      w0 = (uint32_t)__ldg(w + want);
      a0 = (uint32_t)__ldg(a + want);
      w1 = want + 1 < W ? (uint32_t)__ldg(w + want + 1) : 0u;
      a1 = want + 1 < W ? (uint32_t)__ldg(a + want + 1) : 0u;
    }
    wi = want;
    const int b = 2 * (j & 15);
    const uint32_t m = (1u << (2 * S)) - 1u;
    const uint32_t v = (uint32_t)(((((uint64_t)w1) << 32) | w0) >> b) & m;
    const uint32_t va = (uint32_t)(((((uint64_t)a1) << 32) | a0) >> b) & m;
    code = msb_first(v, S);
    amb = va != 0u;
  }
};

// C[c + 1] + Occ(c, i) from the search lattice's record of block i >> 7
__device__ __forceinline__ int lf(const int4* __restrict__ lattice, const int (&c14)[4],
                                  int dollar_row, int c, int i) {
  const int j = i >> 7;
  const int4* r = lattice + (size_t)j * 8;
  uint32_t w[8];
  bwt_words(__ldg(r + 1), __ldg(r + 2), w);
  return c_base(c14, c) + block_occ(__ldg(r), w, c, i & 127) -
         dollar_corr(c, dollar_row, j, i);
}

template <int STEP>
__global__ void __launch_bounds__(kCta) multistep_kernel(
    const int4* __restrict__ lattice, const int* __restrict__ latk,
    const int* __restrict__ latk_inv, const int* __restrict__ C, int dollar_row,
    const int* __restrict__ kmer_table, const int* __restrict__ words,
    const int* __restrict__ amb_bits, int B, int W, int off, int L, int d, int stop_width,
    int min_trips, int wide_steps, int T, int* __restrict__ sp0_out,
    int* __restrict__ ep0_out, int* __restrict__ sp_out, int* __restrict__ ep_out,
    int* __restrict__ rem_out, int* __restrict__ leave_out, bool* __restrict__ own_out,
    int* __restrict__ hist) {
  constexpr int A = 1 << (2 * STEP);          // s-mer alphabet: fold words
  constexpr int LOG2R = STEP == 3 ? 8 : 9;    // R rows a record
  constexpr int R = 1 << LOG2R;
  constexpr int WK = STEP == 3 ? 128 : 512;   // record words
  constexpr int G = R / 16;                   // threads a lane: one 16 B piece each
  extern __shared__ int s_hist[];
  const bool smem = T + 1 <= kSmemBins;
  if (smem)
    for (int i = threadIdx.x; i <= T; i += blockDim.x) s_hist[i] = 0;
  __syncthreads();

  const int gi = threadIdx.x % G;
  const unsigned gmask = G == 32 ? 0xFFFFFFFFu : (0xFFFFu << (threadIdx.x & 16));
  const int lane = (int)((blockIdx.x * blockDim.x + threadIdx.x) / G);
  if (lane < B) {
    const int* row = words + (size_t)lane * W;
    const int* arow = amb_bits + (size_t)lane * W;
    // prologue: the k-mer start interval of bases [off + L - d, off + L)
    const int chain = L - d;
    const int j0 = off + chain;
    int sp = 0, ep = 0;
    if (extract_bits(arow, j0, 2 * d) == 0u) {
      const int key = msb_first(extract_bits(row, j0, 2 * d), d);
      sp = __ldg(kmer_table + 2 * key);
      ep = __ldg(kmer_table + 2 * key + 1);
    }
    const int sp0 = sp, ep0 = ep;
    int rem = chain;
    bool stopped = min_trips > 0 ? ep - sp <= 0 : ep - sp <= stop_width;
    bool strag = false;

    // wide phase: two-record 1-step narrowings, any width
    const int c14[4] = {__ldg(C + 1), __ldg(C + 2), __ldg(C + 3), __ldg(C + 4)};
    for (int ws = 0; ws < wide_steps && !stopped; ++ws) {
      const int posn = j0 - 1 - ws;
      if (extract_bits(arow, posn, 2) != 0u) {
        sp = 0;
        ep = 0;
      } else {
        const int c = (int)extract_bits(row, posn, 2);
        const int s = lf(lattice, c14, dollar_row, c, sp);
        ep = lf(lattice, c14, dollar_row, c, ep);
        sp = s;
      }
      rem -= 1;
      stopped = ep - sp <= 0;
    }

    // multi-step trips t = 0 .. T-1 on groups g = T-1-t, base0 + STEP * g
    int leave = stopped ? 0 : T;
    if (!stopped) {
      const int base0 = off + (chain - wide_steps) % STEP;
      SmerCursor cur(row, arow, W);
      int inv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) inv[q] = __ldg(latk_inv + q);
      for (int t = 0; t < T; ++t) {
        int code;
        bool amb;
        cur.get<STEP>(base0 + STEP * (T - 1 - t), code, amb);
        const int blk = sp >> LOG2R;
        const int base = blk << LOG2R;
        const int msp = sp - base, mep = ep - base;
        const bool sK = mep > R;
        if (amb) {
          sp = 0;
          ep = 0;
        } else {
          const int* rec = latk + (size_t)blk * WK;
          const int fold = __ldg(rec + code);
          const int lim = mep < R ? mep : R;
          int cs = 0, ce = 0;
          if (16 * gi < lim) {
            const int4 piece = __ldg(reinterpret_cast<const int4*>(rec + A) + gi);
            const uint32_t pat = (uint32_t)code * 0x01010101u;
            const uint32_t pw[4] = {(uint32_t)piece.x, (uint32_t)piece.y, (uint32_t)piece.z,
                                    (uint32_t)piece.w};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const uint32_t eq = __vcmpeq4(pw[k], pat) & 0x01010101u;
              const int pos = 16 * gi + 4 * k;
              cs += __popc(eq & low_bytes(msp - pos));
              ce += __popc(eq & low_bytes(lim - pos));
            }
          }
#pragma unroll
          for (int o = G / 2; o > 0; o >>= 1) {
            cs += __shfl_xor_sync(gmask, cs, o, G);
            ce += __shfl_xor_sync(gmask, ce, o, G);
          }
          if (code == 0) {  // rows with SA[r] < STEP store code 0 outside the folds
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int r = inv[q];
              if (r >= 0 && r >= base) {
                cs -= r - base < msp;
                ce -= r - base < mep;
              }
            }
          }
          sp = fold + cs;
          ep = fold + ce;
        }
        rem -= STEP;
        const int width = ep - sp;
        const bool may_stop = width <= stop_width && (t + 1 >= min_trips || width <= 0);
        strag = sK;
        stopped = !sK && may_stop;
        if (strag || stopped) {
          leave = t + 1;
          break;
        }
      }
    }
    if (gi == 0) {
      sp0_out[lane] = sp0;
      ep0_out[lane] = ep0;
      sp_out[lane] = sp;
      ep_out[lane] = ep;
      rem_out[lane] = rem;
      leave_out[lane] = leave;
      own_out[lane] = (!stopped && rem > 0) || strag;
      atomicAdd(smem ? &s_hist[leave] : &hist[leave], 1);
    }
  }
  if (smem) {
    __syncthreads();
    for (int i = threadIdx.x; i <= T; i += blockDim.x)
      if (s_hist[i]) atomicAdd(&hist[i], s_hist[i]);
  }
}

// The exit trip from the histogram (every CTA's first warp finds it: the
// pool at trip t is B minus the lanes with leave <= t), then each lane's
// unfinished flag ORs in leave > t*, and its rem becomes 0 where set.
__global__ void exit_kernel(const int* __restrict__ hist, int T, int min_trips, int cap,
                            int B, const int* __restrict__ leave, bool* __restrict__ unfinished,
                            int* __restrict__ rem, int* __restrict__ trips) {
  __shared__ int s_exit;
  if (threadIdx.x < 32) {
    const int l = threadIdx.x;
    int carry = 0, found = T;
    for (int c0 = 0; c0 <= T; c0 += 32) {
      const int t = c0 + l;
      int h = t <= T ? __ldcg(hist + t) : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int n = __shfl_up_sync(0xFFFFFFFFu, h, o);
        if (l >= o) h += n;
      }
      const bool ok = t == T || (t < T && t >= min_trips && B - (carry + h) <= cap);
      const unsigned hit = __ballot_sync(0xFFFFFFFFu, ok);
      if (hit) {
        found = c0 + __ffs(hit) - 1;
        break;
      }
      carry += __shfl_sync(0xFFFFFFFFu, h, 31);
    }
    if (l == 0) s_exit = found;
  }
  __syncthreads();
  const int ts = s_exit;
  if (blockIdx.x == 0 && threadIdx.x == 0) *trips = ts;
  const int i = (int)(blockIdx.x * blockDim.x + threadIdx.x);
  if (i < B && (unfinished[i] || leave[i] > ts)) {
    unfinished[i] = true;
    rem[i] = 0;
  }
}

}  // namespace

// Both kernels on `stream`: the search over B lanes (one group of R / 16
// threads each), then the exit over the histogram `hist` (T + 1 zeroed
// bins). Outputs: sp0, ep0, sp, ep, rem, leave (int32[B]), unfinished
// (bool[B]), trips (int32 scalar).
extern "C" int bwtpu_search_multistep(
    const void* lattice, const void* latk, const void* latk_inv, const void* C,
    int dollar_row, const void* kmer_table, const void* words, const void* amb_bits, int B,
    int W, int off, int L, int d, int step, int stop_width, int min_trips, int wide_steps,
    int T, int cap, void* sp0, void* ep0, void* sp, void* ep, void* rem, void* leave,
    void* unfinished, void* hist, void* trips, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = T + 1 <= kSmemBins ? (size_t)(T + 1) * sizeof(int) : 0;
  if (B > 0) {
    const int lanes_per_cta = kCta / (step == 3 ? 16 : 32);
    const int grid = (B + lanes_per_cta - 1) / lanes_per_cta;
#define BWTPU_MULTISTEP_ARGS                                                             \
  (const int4*)lattice, (const int*)latk, (const int*)latk_inv, (const int*)C, dollar_row, \
      (const int*)kmer_table, (const int*)words, (const int*)amb_bits, B, W, off, L, d,     \
      stop_width, min_trips, wide_steps, T, (int*)sp0, (int*)ep0, (int*)sp, (int*)ep,       \
      (int*)rem, (int*)leave, (bool*)unfinished, (int*)hist
    if (step == 3)
      multistep_kernel<3><<<grid, kCta, smem, s>>>(BWTPU_MULTISTEP_ARGS);
    else
      multistep_kernel<4><<<grid, kCta, smem, s>>>(BWTPU_MULTISTEP_ARGS);
#undef BWTPU_MULTISTEP_ARGS
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  exit_kernel<<<B > 0 ? (B + 255) / 256 : 1, 256, 0, s>>>(
      (const int*)hist, T, min_trips, cap, B, (const int*)leave, (bool*)unfinished,
      (int*)rem, (int*)trips);
  return (int)cudaGetLastError();
}

extern "C" const char* bwtpu_cuda_error_name(int err) {
  return cudaGetErrorName((cudaError_t)err);
}
