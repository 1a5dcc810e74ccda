// One-record backward search (the 1-step mainline): one thread owns one
// lane's whole chain.
//
// Replaces the mainline of bwtpu/kernels/search2.py::backward_search_ra,
// i.e. the fori_loop of L - d steps over bwtpu/kernels/pallas_step.py::
// search_step1_pallas (_search_step1_kernel): per step, both bounds of the
// interval [sp, ep) from ONE 128 B record, the one of block j = sp >> 7,
// which carries block j (words 0-11) and block j + 1 (words 17-28). A lane
// whose ep lies past block j + 1 is flagged a straggler (sticky); its
// interval is then finished by the two-record chain (search2.cu).
//
// What bounds it on an H100: a lane's chain is up to L - d dependent steps,
// each one round trip to L2 for the record (the lattice, 4.6 MB at E. coli
// scale, stays in the 50 MB L2) and then the SWAR ranks of sp and ep; a
// Read-list batch is 32,768 lanes x 89 steps (k = 0) or 98,304 x 23 (k = 2
// seeds). So nothing but the record load may sit on the chain:
//   - the lane's pattern is staged before the chain: its active columns
//     [L - len, L - 1 - d] of both int32 planes, packed into registers (2
//     bits per code, 1 bit per ambiguity flag, 128 steps at a time; longer
//     rows are restaged every 128 steps, so L has no limit). Each step
//     takes its code and flag by a shift. A warp stages its 32 rows
//     together: coalesced 128 B loads of 32 columns of each row into a
//     shared-memory tile, which each thread then packs along its own row.
//   - the record's address depends on sp alone, so its load is issued
//     before the ambiguity flag is looked at; a flagged base empties the
//     interval after the load. Only the 32 B sectors the two ranks read are
//     loaded (predicated loads, no branch): block j's second BWT sector
//     when a rank lies past its row 64, block j + 1's words only when ep
//     lies there, and their last two sectors only past its row 48.
//   - 64-thread CTAs: 32,768 lanes make 512 CTAs and 98,304 seed lanes
//     1,536, so every one of the 132 SMs gets work (256-thread CTAs leave
//     4 SMs idle at 32,768 lanes).
//   - a thread stops at its lane's first straggle (flagged before the
//     ambiguity mask, as the reference flags it): the fixup overwrites such
//     lanes or forces them empty, so their sp and ep are left as they were
//     at that step (the plain version goes on with a stale ep).
//
// Index ranges: sp lies in [0, n] on every lane until it straggles, so
// sp >> 7 <= n >> 7 <= n_blocks is a lattice row (the lattice has
// n_blocks + 1 rows). ep is never used as an index here.

#include "occ.cuh"

namespace {

using namespace bwtpu;

constexpr int kSteps = 128;  // steps staged at a time
constexpr int kWarps = 2;    // warps per CTA
constexpr unsigned kFull = 0xFFFFFFFFu;

// Steps [q0, q0 + kSteps) of a lane, packed: the code of step q0 + s at
// bits 2 * (s & 15) of c[s >> 4], its ambiguity flag (== 1) at bit s & 31
// of a[s >> 5]. A step reads column top - s (top = L - 1 - d - q0).
struct Staged {
  uint32_t c[kSteps / 16];
  uint32_t a[kSteps / 32];

  // code and flag of the next step; then shift to the one after
  __device__ __forceinline__ void next(int t, int& code, bool& flag) {
    code = (int)(c[0] & 3u);
    flag = a[0] & 1u;
    c[0] >>= 2;
    a[0] >>= 1;
    if ((t & 15) == 15) {
#pragma unroll
      for (int k = 0; k + 1 < kSteps / 16; ++k) c[k] = c[k + 1];
    }
    if ((t & 31) == 31) {
#pragma unroll
      for (int k = 0; k + 1 < kSteps / 32; ++k) a[k] = a[k + 1];
    }
  }
};

// Stage the warp's 32 rows (row0 .. row0 + 31; rows >= B read
// nothing): columns [top - kSteps + 1, top] clipped below at lo, the least
// first active column of the warp's lanes. All 32 threads of the warp call
// it. 32 columns at a time: thread t loads column c0 + t of each of the 32
// rows from both planes (coalesced 128 B requests, all 64 in flight), the
// code and its flag are merged into one word of the shared-memory tile
// (this warp's [32][33] words), and thread t packs row row0 + t.
__device__ __forceinline__ void stage_warp(const int* __restrict__ codes,
                                           const int* __restrict__ amb, int B, int L,
                                           int row0, int top, int lo,
                                           uint32_t (*tile)[33], Staged& st) {
  const int t = threadIdx.x & 31;
#pragma unroll
  for (int m = 0; m < kSteps / 32; ++m) {
    st.c[2 * m] = st.c[2 * m + 1] = 0u;
    st.a[m] = 0u;
    const int c_hi = top - 32 * m;  // column of step 32m
    if (c_hi < lo) continue;        // warp-uniform: no lane needs these
    const int col = c_hi - 31 + t;  // step 32m + 31 - t
    const bool col_ok = col >= lo;
    int vc[32], va[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const bool ok = col_ok && row0 + r < B;
      const size_t e = (size_t)(row0 + r) * L + col;
      vc[r] = ok ? __ldg(codes + e) : 0;
      va[r] = ok ? __ldg(amb + e) : 0;
    }
#pragma unroll
    for (int r = 0; r < 32; ++r) tile[r][t] = ((uint32_t)vc[r] & 3u) | (va[r] == 1 ? 4u : 0u);
    __syncwarp();
    uint32_t c_lo = 0u, c_hi16 = 0u, a32 = 0u;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const uint32_t v = tile[t][i];  // column c_hi - 31 + i: step 32m + 31 - i
      const uint32_t bits = (v & 3u) << (2 * (15 - (i & 15)));
      if (i < 16) c_hi16 |= bits; else c_lo |= bits;
      a32 |= (v >> 2) << (31 - i);
    }
    st.c[2 * m] = c_lo;
    st.c[2 * m + 1] = c_hi16;
    st.a[m] = a32;
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kWarps * 32)
    search_chain1_kernel(const int4* __restrict__ lattice, const int* __restrict__ C,
                         int dollar_row, const int* __restrict__ ra_codes,
                         const int* __restrict__ ra_amb, const int* __restrict__ lens,
                         const int* __restrict__ sp0, const int* __restrict__ ep0,
                         int n_lanes, int L, int d, int* __restrict__ sp_out,
                         int* __restrict__ ep_out, bool* __restrict__ strag_out) {
  __shared__ uint32_t tiles[kWarps][32][33];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n_lanes;  // every thread of the warp stages
  const int c14[4] = {__ldg(C + 1), __ldg(C + 2), __ldg(C + 3), __ldg(C + 4)};
  int len = live ? __ldg(lens + i) : 0;
  len = len > L ? L : len;
  const int nsteps = len > d ? len - d : 0;
  int sp = live ? __ldg(sp0 + i) : 0, ep = live ? __ldg(ep0 + i) : 0;
  const int warp_steps = __reduce_max_sync(kFull, nsteps);
  const int lo = __reduce_min_sync(kFull, nsteps > 0 ? L - len : L);
  uint32_t(*tile)[33] = tiles[threadIdx.x >> 5];
  const int row0 = i - (threadIdx.x & 31);
  bool strag = false;
  for (int q0 = 0; q0 < warp_steps; q0 += kSteps) {
    Staged st;
    stage_warp(ra_codes, ra_amb, n_lanes, L, row0, L - 1 - d - q0, lo, tile, st);
    const int n_here = strag ? 0 : min(kSteps, nsteps - q0);
    for (int t = 0; t < n_here; ++t) {
      int c;
      bool amb;
      st.next(t, c, amb);
      const int j = sp >> 7, je = ep >> 7;
      if (je > j + 1) {  // flagged before the ambiguity mask, as the reference
        strag = true;
        break;
      }
      const int4* rec = lattice + (size_t)j * 8;  // 32 words = 8 int4
      const bool nxt = je != j;  // ep in block j + 1: words 17-20 and 21-28
      const int m_s = sp & 127, m_e = ep & 127;
      // a rank below row 64 of a block needs none of its BWT words 8-11
      // (the record's second 32 B sector), below row 48 of the next block
      // none of its words 24-31 (the fourth)
      const bool hi = m_s > 64 || (!nxt && m_e > 64);
      const int4 z = make_int4(0, 0, 0, 0);
      const int4 ck = __ldg(rec);
      const int4 b0 = __ldg(rec + 1);
      const int4 b1 = hi ? __ldg(rec + 2) : z;
      int4 n0 = z, n1 = z, n2 = z, n3 = z;
      if (nxt) {
        n0 = __ldg(rec + 4);
        n1 = __ldg(rec + 5);
        if (m_e > 48) {
          n2 = __ldg(rec + 6);
          n3 = __ldg(rec + 7);
        }
      }
      uint32_t w[8], wn[8], we[8];
      bwt_words(b0, b1, w);
      bwt_words(make_int4(n1.y, n1.z, n1.w, n2.x), make_int4(n2.y, n2.z, n2.w, n3.x), wn);
#pragma unroll
      for (int k = 0; k < 8; ++k) we[k] = nxt ? wn[k] : w[k];
      const int4 ck_e = nxt ? make_int4(n0.y, n0.z, n0.w, n1.x) : ck;
      const int o_sp = block_occ(ck, w, c, m_s) - dollar_corr(c, dollar_row, j, sp);
      const int o_ep = block_occ(ck_e, we, c, m_e) - dollar_corr(c, dollar_row, je, ep);
      const int cb = c_base(c14, c);
      sp = amb ? 0 : cb + o_sp;
      ep = amb ? 0 : cb + o_ep;
    }
    __syncwarp();
  }
  if (live) {
    sp_out[i] = sp;
    ep_out[i] = ep;
    strag_out[i] = strag;
  }
}

}  // namespace

extern "C" int bwtpu_search_chain1(const void* lattice, const void* C,
                                   int dollar_row, const void* ra_codes,
                                   const void* ra_amb, const void* lens,
                                   const void* sp0, const void* ep0, int n_lanes,
                                   int L, int d, void* sp, void* ep, void* strag,
                                   void* stream) {
  if (n_lanes > 0) {
    const int threads = kWarps * 32;
    search_chain1_kernel<<<(n_lanes + threads - 1) / threads, threads, 0,
                           (cudaStream_t)stream>>>(
        (const int4*)lattice, (const int*)C, dollar_row, (const int*)ra_codes,
        (const int*)ra_amb, (const int*)lens, (const int*)sp0, (const int*)ep0,
        n_lanes, L, d, (int*)sp, (int*)ep, (bool*)strag);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* bwtpu_cuda_error_name(int err) {
  return cudaGetErrorName((cudaError_t)err);
}
