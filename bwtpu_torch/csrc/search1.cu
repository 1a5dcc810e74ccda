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
// What bounds it on an H100: one dependent record load per step (three
// 16 B vectors of words 0-11, four more when ep lies in block j + 1), so a
// lane's chain is up to L - d serial load latencies; the lattice (4.6 MB at
// E. coli scale) stays in the 50 MB L2. A thread runs only its active steps
// (t < lens - d; the reference's inactive steps are no-ops), skips the load
// on an ambiguous base, and stops at its first straggle: the fixup
// overwrites such lanes or forces them empty, so their sp and ep are left
// as they were at that step (the plain version goes on with a stale ep).
// The code planes are read one row per thread, so those loads are not
// coalesced.
//
// Index ranges: sp lies in [0, n] on every lane until it straggles, so
// sp >> 7 <= n >> 7 <= n_blocks is a lattice row (the lattice has
// n_blocks + 1 rows). ep is never used as an index here.

#include "occ.cuh"

namespace {

using namespace bwtpu;

__global__ void search_chain1_kernel(const int4* __restrict__ lattice,
                                     const int* __restrict__ C, int dollar_row,
                                     const int* __restrict__ ra_codes,
                                     const int* __restrict__ ra_amb,
                                     const int* __restrict__ lens,
                                     const int* __restrict__ sp0,
                                     const int* __restrict__ ep0, int n_lanes,
                                     int L, int d, int* __restrict__ sp_out,
                                     int* __restrict__ ep_out,
                                     bool* __restrict__ strag_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_lanes) return;
  const int c14[4] = {__ldg(C + 1), __ldg(C + 2), __ldg(C + 3), __ldg(C + 4)};
  const int* codes = ra_codes + (size_t)i * L;
  const int* amb = ra_amb + (size_t)i * L;
  int len = __ldg(lens + i);
  len = len > L ? L : len;
  int sp = __ldg(sp0 + i), ep = __ldg(ep0 + i);
  bool strag = false;
  for (int t = 0; t < len - d; ++t) {
    const int pos = L - 1 - d - t;
    const int j = sp >> 7, jep = ep >> 7;
    if (jep > j + 1) {  // flagged before the ambiguity mask, as the reference
      strag = true;
      break;
    }
    if (__ldg(amb + pos) == 1) {
      sp = 0;
      ep = 0;
      continue;
    }
    const int c = __ldg(codes + pos);
    const int4* rec = lattice + (size_t)j * 8;  // 32 words = 8 int4
    const int4 ck = __ldg(rec);
    uint32_t w[8];
    bwt_words(__ldg(rec + 1), __ldg(rec + 2), w);
    const int o_sp = block_occ(ck, w, c, sp & 127) - dollar_corr(c, dollar_row, j, sp);
    int o_ep;
    if (jep == j) {
      o_ep = block_occ(ck, w, c, ep & 127);
    } else {  // block j + 1: words 17-20 (counts) and 21-28 (BWT)
      const int4 n0 = __ldg(rec + 4), n1 = __ldg(rec + 5);
      const int4 n2 = __ldg(rec + 6), n3 = __ldg(rec + 7);
      const int4 ck_n = make_int4(n0.y, n0.z, n0.w, n1.x);
      uint32_t wn[8];
      bwt_words(make_int4(n1.y, n1.z, n1.w, n2.x), make_int4(n2.y, n2.z, n2.w, n3.x), wn);
      o_ep = block_occ(ck_n, wn, c, ep & 127);
    }
    o_ep -= dollar_corr(c, dollar_row, jep, ep);
    const int cb = c_base(c14, c);
    sp = cb + o_sp;
    ep = cb + o_ep;
  }
  sp_out[i] = sp;
  ep_out[i] = ep;
  strag_out[i] = strag;
}

}  // namespace

extern "C" int bwtpu_search_chain1(const void* lattice, const void* C,
                                   int dollar_row, const void* ra_codes,
                                   const void* ra_amb, const void* lens,
                                   const void* sp0, const void* ep0, int n_lanes,
                                   int L, int d, void* sp, void* ep, void* strag,
                                   void* stream) {
  if (n_lanes > 0) {
    const int threads = 256;
    const int blocks = (n_lanes + threads - 1) / threads;
    search_chain1_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int4*)lattice, (const int*)C, dollar_row, (const int*)ra_codes,
        (const int*)ra_amb, (const int*)lens, (const int*)sp0, (const int*)ep0,
        n_lanes, L, d, (int*)sp, (int*)ep, (bool*)strag);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* bwtpu_cuda_error_name(int err) {
  return cudaGetErrorName((cudaError_t)err);
}
