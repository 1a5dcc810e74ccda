// LF-walk locate for sa_rate > 1: one thread owns one lane's whole walk.
//
// Replaces bwtpu/kernels/locate.py::locate_rows at sa_rate > 1, i.e. the
// fori_loop of sa_rate trips over bwtpu/kernels/pallas_step.py::
// locate_step_pallas (_locate_step_kernel): mark test + in-block mark
// rank, else one LF step, per trip, from the lane's 128 B record of the
// search lattice (layout in bwtpu/index.py). It also replaces the row
// gather before it (engine.py: rows.reshape(-1).index_select(0, sel)):
// lane j < *count walks SA row rows[sel[j]], with count on the device;
// lanes j >= count report -1.
//
// What bounds it on an H100: each trip is one dependent record load, so a
// lane's walk is up to sa_rate serial L2 round trips (at E. coli scale the
// 4.6 MB lattice sits in the 50 MB L2), then one dependent ssa load. The
// bytes are few (~3 MB for a block's 65,536 lanes). So each trip issues
// its five 16 B loads (words 0-19: checkpoints, BWT, marks, mark rank)
// together, and C[1..4] sits in registers before the walk, so nothing but
// the record loads is on the chain. Threads exit as soon as their mark bit
// is set; the fixed-trip masked loop and the dead-lane clamp to block 0 of
// the TPU version are not needed. Measured on an H100 (PERF.md): ~0.011 ms
// for a k = 2 block's 65,536 lanes (up to 8 trips), as before this design:
// about 8 dependent round trips of ~0.5 us plus the ssa load and the launch.
//
// Edge kept from the reference: a lane not found within sa_rate trips
// reports ssa[0] + 0.

#include "occ.cuh"

namespace {

using bwtpu::pick4;
using bwtpu::swar_rank;

__global__ void locate_walk_kernel(const int4* __restrict__ lattice,
                                   const int* __restrict__ ssa,
                                   const int* __restrict__ C,
                                   const int* __restrict__ rows,
                                   const int* __restrict__ sel,
                                   const int* __restrict__ count, int cap,
                                   int sa_rate, int dollar_row,
                                   int* __restrict__ pos) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cap) return;
  if (i >= __ldg(count)) {
    pos[i] = -1;
    return;
  }
  const int c14[4] = {__ldg(C + 1), __ldg(C + 2), __ldg(C + 3), __ldg(C + 4)};
  int r = __ldg(rows + __ldg(sel + i));
  int rank = 0, steps = 0;
  for (int t = 0; t < sa_rate; ++t) {
    const int4* rec = lattice + (size_t)(r >> 7) * 8;  // 32 words = 8 int4
    const int4 ck = __ldg(rec);
    const int4 b0 = __ldg(rec + 1);
    const int4 b1 = __ldg(rec + 2);
    const int4 mk = __ldg(rec + 3);
    const int4 rk = __ldg(rec + 4);  // word 16: the block's mark rank
    const int m = r & 127;
    const uint32_t mw0 = mk.x, mw1 = mk.y, mw2 = mk.z, mw3 = mk.w;
    if ((pick4(mw0, mw1, mw2, mw3, m >> 5) >> (m & 31)) & 1u) {
      int inrank = 0;
      const uint32_t mws[4] = {mw0, mw1, mw2, mw3};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        int nbits = m - 32 * k;
        nbits = nbits < 0 ? 0 : (nbits > 32 ? 32 : nbits);
        const uint32_t mask = nbits >= 32 ? 0xFFFFFFFFu : ((1u << nbits) - 1u);
        inrank += __popc(mws[k] & mask);
      }
      rank = rk.x + inrank;
      steps = t;
      break;
    }
    const uint32_t w[8] = {(uint32_t)b0.x, (uint32_t)b0.y, (uint32_t)b0.z,
                           (uint32_t)b0.w, (uint32_t)b1.x, (uint32_t)b1.y,
                           (uint32_t)b1.z, (uint32_t)b1.w};
    const int wi = m >> 4;
    const uint32_t word = wi < 4 ? pick4(w[0], w[1], w[2], w[3], wi)
                                 : pick4(w[4], w[5], w[6], w[7], wi - 4);
    const uint32_t c = (word >> (2 * (m & 15))) & 3u;
    const int occ_ck = (int)pick4(ck.x, ck.y, ck.z, ck.w, c);
    const int corr = (c == 0 && (dollar_row >> 7) == (r >> 7) && dollar_row < r) ? 1 : 0;
    r = bwtpu::c_base(c14, (int)c) + occ_ck + swar_rank(w, c, m) - corr;
  }
  pos[i] = __ldg(ssa + rank) + steps;
}

}  // namespace

// cap = sel's length (the most count can hold)
extern "C" int bwtpu_locate_walk(const void* lattice, const void* ssa,
                                 const void* C, const void* rows, const void* sel,
                                 const void* count, int cap, int sa_rate,
                                 int dollar_row, void* pos, void* stream) {
  if (cap > 0) {
    const int threads = 256;
    const int blocks = (cap + threads - 1) / threads;
    locate_walk_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int4*)lattice, (const int*)ssa, (const int*)C, (const int*)rows,
        (const int*)sel, (const int*)count, cap, sa_rate, dollar_row, (int*)pos);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* bwtpu_cuda_error_name(int err) {
  return cudaGetErrorName((cudaError_t)err);
}
