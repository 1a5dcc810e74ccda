// Two-record backward search, valid at any interval width: one thread owns
// one lane's whole chain.
//
// Replaces bwtpu/kernels/pallas_step.py::search_step_pallas
// (_search_step_kernel) and the fori_loop of L - d steps around it in
// bwtpu/kernels/search2.py::_two_gather_search: per step, Occ(c, sp) from
// the record of block sp >> 7 and Occ(c, ep) from the record of block
// ep >> 7 (words 0-11 of each), the C[] base, the '$' correction and the
// ambiguity mask. It gives the same bits as common.occ for any width. The
// straggler fixups of both search paths run it on their compacted lanes.
//
// What bounds it on an H100: two dependent record loads per step, one when
// both bounds lie in the same block, so a lane's chain is up to L - d
// serial L2 latencies (the lattice stays in L2 at bacterial scale). A
// thread runs only its active steps (t < lens - d) and skips the loads on
// an ambiguous base. The code planes are read one row per thread, so
// those loads are not coalesced.
//
// Index ranges: the chain is exact, so sp and ep stay in [0, n] and
// i >> 7 <= n_blocks is a lattice row for both (n_blocks + 1 rows).

#include "occ.cuh"

namespace {

using namespace bwtpu;

__device__ __forceinline__ void load_block(const int4* rec, int4& ck, uint32_t (&w)[8]) {
  ck = __ldg(rec);
  bwt_words(__ldg(rec + 1), __ldg(rec + 2), w);
}

__global__ void search_chain2_kernel(const int4* __restrict__ lattice,
                                     const int* __restrict__ C, int dollar_row,
                                     const int* __restrict__ ra_codes,
                                     const int* __restrict__ ra_amb,
                                     const int* __restrict__ lens,
                                     const int* __restrict__ sp0,
                                     const int* __restrict__ ep0, int n_lanes,
                                     int L, int d, int* __restrict__ sp_out,
                                     int* __restrict__ ep_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_lanes) return;
  const int c14[4] = {__ldg(C + 1), __ldg(C + 2), __ldg(C + 3), __ldg(C + 4)};
  const int* codes = ra_codes + (size_t)i * L;
  const int* amb = ra_amb + (size_t)i * L;
  int len = __ldg(lens + i);
  len = len > L ? L : len;
  int sp = __ldg(sp0 + i), ep = __ldg(ep0 + i);
  for (int t = 0; t < len - d; ++t) {
    const int pos = L - 1 - d - t;
    if (__ldg(amb + pos) == 1) {
      sp = 0;
      ep = 0;
      continue;
    }
    const int c = __ldg(codes + pos);
    const int j = sp >> 7, jep = ep >> 7;
    int4 ck;
    uint32_t w[8];
    load_block(lattice + (size_t)j * 8, ck, w);
    const int o_sp = block_occ(ck, w, c, sp & 127) - dollar_corr(c, dollar_row, j, sp);
    if (jep != j) load_block(lattice + (size_t)jep * 8, ck, w);
    const int o_ep = block_occ(ck, w, c, ep & 127) - dollar_corr(c, dollar_row, jep, ep);
    const int cb = c_base(c14, c);
    sp = cb + o_sp;
    ep = cb + o_ep;
  }
  sp_out[i] = sp;
  ep_out[i] = ep;
}

}  // namespace

extern "C" int bwtpu_search_chain2(const void* lattice, const void* C,
                                   int dollar_row, const void* ra_codes,
                                   const void* ra_amb, const void* lens,
                                   const void* sp0, const void* ep0, int n_lanes,
                                   int L, int d, void* sp, void* ep, void* stream) {
  if (n_lanes > 0) {
    const int threads = 256;
    const int blocks = (n_lanes + threads - 1) / threads;
    search_chain2_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int4*)lattice, (const int*)C, dollar_row, (const int*)ra_codes,
        (const int*)ra_amb, (const int*)lens, (const int*)sp0, (const int*)ep0,
        n_lanes, L, d, (int*)sp, (int*)ep);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* bwtpu_cuda_error_name(int err) {
  return cudaGetErrorName((cudaError_t)err);
}
