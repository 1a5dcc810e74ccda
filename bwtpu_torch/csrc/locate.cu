// LF-walk locate for sa_rate > 1: one thread owns one lane's whole walk.
//
// Replaces bwtpu/kernels/locate.py::locate_rows at sa_rate > 1, i.e. the
// fori_loop of sa_rate trips over bwtpu/kernels/pallas_step.py::
// locate_step_pallas (_locate_step_kernel): mark test + in-block mark
// rank, else one LF step, per trip, from the lane's 128 B record of the
// search lattice (layout in bwtpu/index.py).
//
// What bounds it on an H100: each trip is one dependent 128 B record
// load (only words 0-16 are read, as four 16 B vector loads plus one),
// so a lane's walk is up to sa_rate serial load latencies. At E. coli
// scale the 4.6 MB lattice sits in the 50 MB L2. Threads exit as soon as
// their mark bit is set; the fixed-trip masked loop and the dead-lane
// clamp to block 0 of the TPU version are not needed.
//
// Edge kept from the reference: a lane not found within sa_rate trips
// reports ssa[0] + 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t pick4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d, uint32_t i) {
  return i == 0 ? a : i == 1 ? b : i == 2 ? c : d;
}

// count of base c among the first m bases of a block's 8 packed words
__device__ __forceinline__ int swar_rank(const uint32_t (&w)[8], uint32_t c, int m) {
  const uint32_t pattern = c * 0x55555555u;
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    int nb = m - 16 * k;
    nb = nb < 0 ? 0 : (nb > 16 ? 16 : nb);
    const uint32_t mask = nb >= 16 ? 0xFFFFFFFFu : ((1u << (2 * nb)) - 1u);
    const uint32_t y = w[k] ^ pattern;
    cnt += __popc(~(y | (y >> 1)) & 0x55555555u & mask);
  }
  return cnt;
}

__global__ void locate_walk_kernel(const int4* __restrict__ lattice,
                                   const int* __restrict__ ssa,
                                   const int* __restrict__ C,
                                   const int* __restrict__ rows,
                                   const bool* __restrict__ valid,
                                   int n_lanes, int sa_rate, int dollar_row,
                                   int* __restrict__ pos) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_lanes) return;
  if (!valid[i]) {
    pos[i] = -1;
    return;
  }
  int r = rows[i];
  int rank = 0, steps = 0;
  for (int t = 0; t < sa_rate; ++t) {
    const int4* rec = lattice + (size_t)(r >> 7) * 8;  // 32 words = 8 int4
    const int4 ck = __ldg(rec);
    const int4 b0 = __ldg(rec + 1);
    const int4 b1 = __ldg(rec + 2);
    const int4 mk = __ldg(rec + 3);
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
      rank = __ldg(reinterpret_cast<const int*>(rec + 4)) + inrank;  // word 16
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
    r = __ldg(C + c + 1) + occ_ck + swar_rank(w, c, m) - corr;
  }
  pos[i] = __ldg(ssa + rank) + steps;
}

}  // namespace

extern "C" int bwtpu_locate_walk(const void* lattice, const void* ssa,
                                 const void* C, const void* rows,
                                 const void* valid, int n_lanes, int sa_rate,
                                 int dollar_row, void* pos, void* stream) {
  if (n_lanes > 0) {
    const int threads = 256;
    const int blocks = (n_lanes + threads - 1) / threads;
    locate_walk_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int4*)lattice, (const int*)ssa, (const int*)C, (const int*)rows,
        (const bool*)valid, n_lanes, sa_rate, dollar_row, (int*)pos);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* bwtpu_cuda_error_name(int err) {
  return cudaGetErrorName((cudaError_t)err);
}
