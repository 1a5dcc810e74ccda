// Multi-step early-stop backward search with its whole-batch exit and the
// finisher's compaction, on the device: everything of
// search_early_stop_packed except the finisher's two-record chain
// (search2.cu, launched next on the compacted lanes).
//
// Replaces the jnp program bwtpu/kernels/searchk.py::search_early_stop_packed
// (one jax.jit with a while_loop): the k-mer start key and table row
// (prep.kmer_key_packed), the wide phase (common.occ on the two-record
// lattice), and the multi-step trips on the s-mer lattice
// (occk_pair_from_record, prep.smer_codes_packed); and of its finisher
// bwtpu/kernels/search2.py::_fixup_stragglers_packed the compaction
// (compact) and the capacity cut (over_lane). Record layouts:
// bwtpu/index.py (search lattice: occ.cuh; s-mer lattice: OCCK_BLOCK /
// OCCK_WIDTH, R rows a record, words 0..A-1 the folds, words A..A+R/4-1
// the rows' s-mer codes, one byte each).
//
// The reference tests `(t < T) & ((n_pool > cap) | (t < min_trips))` before
// each trip. A lane's trips depend only on its own row and the index, and
// the pool only loses lanes, so here each lane runs its trips until it
// leaves the pool and records `leave` (the trip count when it stopped or
// straggled; T if never) into a histogram of T + 1 bins. The exit trip t*
// is the first t >= min_trips whose pool #{leave > t} is <= cap, else T.
// A lane with leave > t* is unfinished in the reference (the finisher
// restarts it from sp0, ep0 or forces it empty), so its later state is
// never read. exit_kernel finds t* from the histogram, ORs leave > t* into
// each lane's unfinished flag, and compacts the unfinished lanes in lane
// order into sel[0, min(total, cap)) with a single-pass scan (decoupled
// look-back between CTAs, each CTA's tile taken from a ticket counter so
// that none waits on a CTA that has not started); an unfinished lane at
// position >= cap is forced empty and flagged (over_lane), as the
// reference's cut `cumsum(unfinished) > cap` does after its finisher, which
// never reads such a lane. Nothing syncs with the host.
//
// What bounds it on an H100: a lane's trips are a chain of dependent loads
// of a 512 B (step 3) or 2 KB (step 4) record, each from a random block of
// a lattice that sits in L2 at bacterial scale (9.3 MB at E. coli; ~93 MB,
// past L2, for one shard of a chr21-length genome). The bytes are few and
// the longest lane's chain sets the time. So a trip is kept short:
//   - a group of G threads owns a lane (G a template parameter, one per
//     step, SEARCHK_G3 / SEARCHK_G4); each thread loads its R / G code bytes
//     of the record as 16 B pieces (pieces wholly at or past the clamped
//     interval end are not loaded), issued together with the fold word's
//     broadcast load, compares 4 bytes at a time with __vcmpeq4 and masks
//     by the interval's two ends;
//   - both counts (each <= R <= 512) travel in one word, cs | ce << 16, so
//     the group's shuffle tree is log2(G) shuffles a trip;
//   - the lane's s-mer codes and ambiguity flags are decoded by the group
//     together into shared memory before the trips, kChunk trips at a time
//     (one entry a trip), so a trip reads its code with one shared load and
//     no branch on the row's words;
//   - no register array is indexed at run time (it would live in local
//     memory).
// Stopped lanes stop: no dead gathers of record 0 as on the TPU. Each CTA
// sums its lanes' `leave` in shared memory before one atomic per bin.
// Measured on an H100: PERF.md §6 (chip_smoke.py phase 3,
// scripts/torch_searchk_ab.py).
//
// Index ranges: sp stays in [0, n] on pool lanes, so sp >> log2(R) is at
// most the terminator record n_blocksK; a record's counted window is
// clamped at R rows (ep - base may exceed R: that lane straggles, and its
// sp/ep, garbage as in the reference, are replaced by the finisher).

#include <type_traits>

#include "occ.cuh"
#include "scan.cuh"

#ifndef SEARCHK_G3
#define SEARCHK_G3 2
#endif
#ifndef SEARCHK_G4
#define SEARCHK_G4 4
#endif

namespace {

using namespace bwtpu;

constexpr int kCta = 256;         // threads per CTA of the search kernel
constexpr int kSmemBins = 8192;   // histogram bins kept in shared memory
constexpr int kChunk = 4;         // trips whose codes are staged at once
constexpr int kExitItems = 8;     // lanes per thread of the exit kernel
constexpr int kExitTile = 256 * kExitItems;  // lanes per exit CTA

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

// one staged trip: the s-mer code, with kAmb set when a base is ambiguous
template <int STEP>
struct Staged {
  using type = typename std::conditional<STEP == 3, uint8_t, uint16_t>::type;
  static constexpr int kAmb = STEP == 3 ? 0x80 : 0x100;
};

// The group's threads decode trips [t0, t0 + kChunk) (those below T) of
// a lane into its staged codes: trip t reads bases base0 + STEP * (T-1-t).
template <int STEP, int G>
__device__ __forceinline__ void stage(typename Staged<STEP>::type* codes, const int* row,
                                      const int* arow, int base0, int T, int t0, int gi) {
  for (int u = gi; u < kChunk && t0 + u < T; u += G) {
    const int j = base0 + STEP * (T - 1 - (t0 + u));
    const uint32_t a = extract_bits(arow, j, 2 * STEP), w = extract_bits(row, j, 2 * STEP);
    codes[u] = (typename Staged<STEP>::type)(msb_first(w, STEP) |
                                             (a != 0u ? Staged<STEP>::kAmb : 0));
  }
}

template <int STEP, int G>
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
  constexpr int LANES = kCta / G;             // lanes a CTA
  constexpr int PIECES = R / 16 / G;          // 16 B code pieces a thread
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0 && PIECES >= 1, "group size");
  using code_t = typename Staged<STEP>::type;
  constexpr int AMB = Staged<STEP>::kAmb;
  extern __shared__ int s_hist[];
  __shared__ code_t s_codes[LANES][kChunk];
  const bool smem = T + 1 <= kSmemBins;
  if (smem)
    for (int i = threadIdx.x; i <= T; i += blockDim.x) s_hist[i] = 0;
  __syncthreads();

  const int gi = threadIdx.x % G;
  const int grp = threadIdx.x / G;
  const unsigned gmask =
      G == 32 ? 0xFFFFFFFFu : (((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1)));
  const int lane = blockIdx.x * LANES + grp;
  if (lane < B) {
    const int* row = words + (size_t)lane * W;
    const int* arow = amb_bits + (size_t)lane * W;
    // prologue: the k-mer start interval of bases [off + L - d, off + L);
    // both planes' words are loaded together, and the first trips' codes
    // are staged (the same rows' words) while the table entry is in flight
    const int chain = L - d;
    const int j0 = off + chain;
    const uint32_t ka = extract_bits(arow, j0, 2 * d), kw = extract_bits(row, j0, 2 * d);
    int sp = 0, ep = 0;
    if (ka == 0u) {
      const int key = msb_first(kw, d);
      sp = __ldg(kmer_table + 2 * key);
      ep = __ldg(kmer_table + 2 * key + 1);
    }
    const int base0 = off + (chain - wide_steps) % STEP;
    code_t* codes = s_codes[grp];
    stage<STEP, G>(codes, row, arow, base0, T, 0, gi);
    __syncwarp(gmask);
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
      int inv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) inv[q] = __ldg(latk_inv + q);
      for (int t = 0; t < T; ++t) {
        const int tc = t % kChunk;
        if (tc == 0 && t > 0) {  // the group decodes the next kChunk trips' codes
          __syncwarp(gmask);
          stage<STEP, G>(codes, row, arow, base0, T, t, gi);
          __syncwarp(gmask);
        }
        const int cv = codes[tc];
        const int blk = sp >> LOG2R;
        const int base = blk << LOG2R;
        const int msp = sp - base, mep = ep - base;
        const bool sK = mep > R;
        if (cv & AMB) {
          sp = 0;
          ep = 0;
        } else {
          const int code = cv;
          const int* rec = latk + (size_t)blk * WK;
          const int lim = mep < R ? mep : R;
          const int4* pieces = reinterpret_cast<const int4*>(rec + A);
          const int fold = __ldg(rec + code);
          int4 pc[PIECES];
#pragma unroll
          for (int k = 0; k < PIECES; ++k) {
            const int p = gi + G * k;
            pc[k] = 16 * p < lim ? __ldg(pieces + p) : make_int4(0, 0, 0, 0);
          }
          const uint32_t pat = (uint32_t)code * 0x01010101u;
          int cs = 0, ce = 0;
#pragma unroll
          for (int k = 0; k < PIECES; ++k) {
            const int pos = 16 * (gi + G * k);
            const uint32_t pw[4] = {(uint32_t)pc[k].x, (uint32_t)pc[k].y, (uint32_t)pc[k].z,
                                    (uint32_t)pc[k].w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const uint32_t eq = __vcmpeq4(pw[q], pat) & 0x01010101u;
              cs += __popc(eq & low_bytes(msp - pos - 4 * q));
              ce += __popc(eq & low_bytes(lim - pos - 4 * q));
            }
          }
          int both = cs | (ce << 16);  // each count <= R <= 512
#pragma unroll
          for (int o = G / 2; o > 0; o >>= 1) both += __shfl_xor_sync(gmask, both, o, G);
          cs = both & 0xFFFF;
          ce = both >> 16;
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
// unfinished flag ORs in leave > t* (its rem becomes 0), and the unfinished
// lanes are compacted in lane order. A CTA's tile is its ticket (taken by
// its second warp while the first scans the histogram): kExitTile lanes,
// kExitItems consecutive lanes a thread, loaded together; one block scan
// of the threads' counts and the decoupled look-back of scan.cuh. Position
// < cap: sel[position] = lane; else the lane is forced empty (sp = ep = 0)
// and over_lane = 1. The last tile writes the total (n_unf) and count =
// min(total, cap); tile 0 writes trips.
__global__ void __launch_bounds__(256) exit_kernel(
    const int* __restrict__ hist, int T, int min_trips, int cap, int B,
    const int* __restrict__ leave, bool* __restrict__ unfinished, int* __restrict__ rem,
    int* __restrict__ sp, int* __restrict__ ep, int* __restrict__ over_lane,
    int* __restrict__ trips, int* __restrict__ count, int* __restrict__ n_unf,
    int* __restrict__ ticket, unsigned* __restrict__ flags, int* __restrict__ sel, int nb) {
  __shared__ int s_exit, s_tile, s_prefix;
  __shared__ int s_warp[8];
  const int l = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 32) s_tile = atomicAdd(ticket, 1);
  if (warp == 0) {
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
  const int ts = s_exit, tile = s_tile;
  const int first = tile * kExitTile + (int)threadIdx.x * kExitItems;

  // this thread's lanes [first, first + kExitItems): flags and count
  bool f[kExitItems];
  int own = 0;
  if (first + kExitItems <= B) {
    const uint2 u = *reinterpret_cast<const uint2*>(unfinished + first);
    const int4 v0 = *reinterpret_cast<const int4*>(leave + first);
    const int4 v1 = *reinterpret_cast<const int4*>(leave + first + 4);
    const int lv[kExitItems] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
    for (int r = 0; r < kExitItems; ++r)
      f[r] = ((r < 4 ? u.x >> (8 * r) : u.y >> (8 * (r - 4))) & 0xFFu) != 0u || lv[r] > ts;
  } else {
#pragma unroll
    for (int r = 0; r < kExitItems; ++r) {
      const int i = first + r;
      f[r] = i < B && (unfinished[i] || leave[i] > ts);
    }
  }
#pragma unroll
  for (int r = 0; r < kExitItems; ++r) own += f[r];

  // the threads' exclusive prefix within the tile, the tile's count, and
  // the tile's prefix
  const int2 scan = block_exclusive_scan<8>(own, s_warp);
  const int mine = scan.x, run = scan.y;
  if (warp == 0) {
    const int excl = tile_lookback(flags, tile, run);
    if (l == 0) s_prefix = excl;
  }
  __syncthreads();
  int p = s_prefix + mine;
  int over[kExitItems];
#pragma unroll
  for (int r = 0; r < kExitItems; ++r) {
    const int i = first + r;
    over[r] = 0;
    if (f[r]) {  // f[r] implies i < B
      unfinished[i] = true;
      rem[i] = 0;
      if (p < cap) {
        sel[p] = i;
      } else {
        sp[i] = 0;
        ep[i] = 0;
        over[r] = 1;
      }
      ++p;
    }
  }
  if (first + kExitItems <= B) {  // two 16 B stores
    *reinterpret_cast<int4*>(over_lane + first) = make_int4(over[0], over[1], over[2], over[3]);
    *reinterpret_cast<int4*>(over_lane + first + 4) =
        make_int4(over[4], over[5], over[6], over[7]);
  } else {
#pragma unroll
    for (int r = 0; r < kExitItems; ++r)
      if (first + r < B) over_lane[first + r] = over[r];
  }
  if (threadIdx.x == 0) {
    if (tile == nb - 1) {
      const int total = s_prefix + run;
      *n_unf = total;
      *count = total < cap ? total : cap;
    }
    if (tile == 0) *trips = ts;
  }
}

}  // namespace

// Lanes per CTA of the exit kernel: the wrapper sizes the workspace's
// look-back words by it.
extern "C" int bwtpu_searchk_exit_tile() { return kExitTile; }

// Everything on `stream`: one memset of the int32 workspace `ws` (ws_words
// words: hist[T + 1], trips, count, n_unf, the exit tickets, one look-back
// word per exit CTA, sel[cap]), the search over B lanes (one group of G
// threads each), then the exit over the histogram. Outputs: sp0, ep0, sp,
// ep, rem, leave, over_lane (int32[B]), unfinished (bool[B]), and in ws
// trips, count, n_unf (int32 scalars) and sel (int32[cap], 0 past count).
extern "C" int bwtpu_search_multistep(
    const void* lattice, const void* latk, const void* latk_inv, const void* C,
    int dollar_row, const void* kmer_table, const void* words, const void* amb_bits, int B,
    int W, int off, int L, int d, int step, int stop_width, int min_trips, int wide_steps,
    int T, int cap, void* sp0, void* ep0, void* sp, void* ep, void* rem, void* leave,
    void* unfinished, void* over_lane, void* ws, int ws_words, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nb = B > 0 ? (B + kExitTile - 1) / kExitTile : 1;
  if (ws_words != T + 5 + nb + cap || B >= (int)kScanAgg || cap < 0)
    return (int)cudaErrorInvalidValue;
  int* w = (int*)ws;
  cudaError_t err = cudaMemsetAsync(ws, 0, (size_t)ws_words * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = T + 1 <= kSmemBins ? (size_t)(T + 1) * sizeof(int) : 0;
  if (B > 0) {
    const int G = step == 3 ? SEARCHK_G3 : SEARCHK_G4;
    const int lanes_per_cta = kCta / G;
    const int grid = (B + lanes_per_cta - 1) / lanes_per_cta;
#define BWTPU_MULTISTEP_ARGS                                                             \
  (const int4*)lattice, (const int*)latk, (const int*)latk_inv, (const int*)C, dollar_row, \
      (const int*)kmer_table, (const int*)words, (const int*)amb_bits, B, W, off, L, d,     \
      stop_width, min_trips, wide_steps, T, (int*)sp0, (int*)ep0, (int*)sp, (int*)ep,       \
      (int*)rem, (int*)leave, (bool*)unfinished, w
    if (step == 3)
      multistep_kernel<3, SEARCHK_G3><<<grid, kCta, smem, s>>>(BWTPU_MULTISTEP_ARGS);
    else
      multistep_kernel<4, SEARCHK_G4><<<grid, kCta, smem, s>>>(BWTPU_MULTISTEP_ARGS);
#undef BWTPU_MULTISTEP_ARGS
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  exit_kernel<<<nb, 256, 0, s>>>(w, T, min_trips, cap, B, (const int*)leave,
                                 (bool*)unfinished, (int*)rem, (int*)sp, (int*)ep,
                                 (int*)over_lane, w + T + 1, w + T + 2, w + T + 3, w + T + 4,
                                 (unsigned*)(w + T + 5), w + T + 5 + nb, nb);
  return (int)cudaGetLastError();
}

extern "C" const char* bwtpu_cuda_error_name(int err) {
  return cudaGetErrorName((cudaError_t)err);
}
