// Row gather with a column sum: out[0, :] = sum of table[idx[j], :] over
// the first n_blocks * G indices, as int32 wrapping mod 2^32.
//
// Replaces scripts/pallas_gather_ab.py::build_dma_gather, the hand-built
// Pallas gather of the TPU's gather-cost A/B (indices scalar-prefetched,
// K row DMAs in flight, rows accumulated into row 0 of an (8, Wr) block).
// Here one CTA takes G indices. A row group of lanes_per_row lanes reads a
// row with coalesced 16 B loads (4 B when the width is not a multiple of
// 4 words), so a 64 B row (Wr 16) takes 4 lanes and a 512 B row (Wr 128)
// a whole warp. Each group keeps K rows in flight: it issues the index
// loads and row loads of K rows before it adds any of them, the
// counterpart of the TPU kernel's K outstanding DMAs. Wider rows than
// 32 x 4 words take several CTAs along grid.y, one column chunk each.
//
// The groups' partial sums are reduced within the warp by shuffles, then
// across warps in shared memory, and each CTA atomicAdds its chunk into
// row 0; unsigned adds wrap exactly like the int32 sum of the plain
// version. Indices must lie in [0, N), as index_select requires.
//
// What bounds it on an H100: one row load per index, each a random 16-512
// B piece of a table that is usually larger than the 50 MB L2, so the
// card's random-access rate for rows of that size, not its 3.35 TB/s
// stream rate. scripts/torch_gather_ab.py measures it: from a 297 MB
// table, 32 B rows (Wr 8) cost as much per row as 64 B rows (Wr 16), and
// the L2 fetch granularity hint (32, 64 or 128 B) changes neither. 64 B
// is the card's smallest random access, and its rate of such accesses
// (about half of 3.35 TB/s in 64 B pieces) sets the pace; this design
// already runs at that rate. Tried and dropped, as no faster beyond the
// spread between runs: a persistent grid (as many CTAs as the SMs hold,
// each walking tiles of 1,024 indices with the next tile's indices loaded
// ahead into registers and stored to shared memory, and its sums kept in
// registers to the end); the same with each tile brought in by one bulk
// copy (cp.async.bulk and an mbarrier); and a grid of 1 or 2 CTAs per SM,
// which was slower at every table size.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int VEC>
__device__ __forceinline__ void load_words(const int* p, uint32_t (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const int4 x = __ldg(reinterpret_cast<const int4*>(p));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int VEC, int K>
__global__ void row_gather_sum_kernel(const int* __restrict__ table, int Wr,
                                      const int* __restrict__ idx, int G,
                                      int lanes_per_row,
                                      unsigned* __restrict__ out) {
  __shared__ unsigned acc[32 * VEC];  // this CTA's column chunk
  const int col0 = blockIdx.y * 32 * VEC;
  for (int c = threadIdx.x; c < 32 * VEC; c += blockDim.x) acc[c] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int sub = lane & (lanes_per_row - 1);
  const int groups_per_warp = 32 / lanes_per_row;
  const int group = (threadIdx.x >> 5) * groups_per_warp + lane / lanes_per_row;
  const int n_groups = (blockDim.x >> 5) * groups_per_warp;
  const int col = col0 + sub * VEC;
  const bool col_ok = col < Wr;
  const int* ids = idx + (size_t)blockIdx.x * G;

  uint32_t sum[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) sum[e] = 0;
  for (int j0 = group; j0 < G; j0 += n_groups * K) {
    uint32_t v[K][VEC];
#pragma unroll
    for (int u = 0; u < K; ++u) {
      const int j = j0 + u * n_groups;
      if (j < G && col_ok) {
        load_words<VEC>(table + (size_t)__ldg(ids + j) * Wr + col, v[u]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) v[u][e] = 0;
      }
    }
#pragma unroll
    for (int u = 0; u < K; ++u)
#pragma unroll
      for (int e = 0; e < VEC; ++e) sum[e] += v[u][e];
  }
  // lanes with the same `sub` hold the same columns: fold the groups
  for (int o = lanes_per_row; o < 32; o <<= 1)
#pragma unroll
    for (int e = 0; e < VEC; ++e) sum[e] += __shfl_xor_sync(0xffffffffu, sum[e], o);
  if (lane < lanes_per_row && col_ok)
#pragma unroll
    for (int e = 0; e < VEC; ++e) atomicAdd(&acc[sub * VEC + e], sum[e]);
  __syncthreads();
  for (int c = threadIdx.x; c < 32 * VEC && col0 + c < Wr; c += blockDim.x)
    atomicAdd(out + col0 + c, acc[c]);
}

template <int VEC>
cudaError_t launch(const int* table, int Wr, const int* idx, int n_blocks, int G,
                   int inflight, unsigned* out, cudaStream_t stream) {
  int lanes = (Wr + VEC - 1) / VEC;
  lanes = lanes > 32 ? 32 : lanes;
  int lanes_per_row = 1;
  while (lanes_per_row < lanes) lanes_per_row <<= 1;
  const dim3 grid(n_blocks, (Wr + 32 * VEC - 1) / (32 * VEC));
  switch (inflight) {
#define BWTPU_GATHER_CASE(K)                                                  \
  case K:                                                                     \
    row_gather_sum_kernel<VEC, K><<<grid, kThreads, 0, stream>>>(             \
        table, Wr, idx, G, lanes_per_row, out);                               \
    break;
    BWTPU_GATHER_CASE(4)
    BWTPU_GATHER_CASE(8)
    BWTPU_GATHER_CASE(16)
#undef BWTPU_GATHER_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// vec: 4 when Wr % 4 == 0 and the table is 16-byte aligned, else 1
extern "C" int bwtpu_row_gather_sum(const void* table, int Wr, int vec,
                                    const void* idx, int n_blocks, int G,
                                    int inflight, void* out, void* stream) {
  if (n_blocks <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      vec == 4 ? launch<4>((const int*)table, Wr, (const int*)idx, n_blocks, G,
                           inflight, (unsigned*)out, s)
               : launch<1>((const int*)table, Wr, (const int*)idx, n_blocks, G,
                           inflight, (unsigned*)out, s);
  return (int)err;
}

// The L2 fetch granularity hint (cudaLimitMaxL2FetchGranularity, bytes) of
// the current device: sets it to `bytes` when bytes > 0 and returns the
// value it had, or -1 on an error. scripts/torch_gather_ab.py's probe.
extern "C" int bwtpu_l2_fetch_granularity(int bytes) {
  size_t was = 0;
  if (cudaDeviceGetLimit(&was, cudaLimitMaxL2FetchGranularity) != cudaSuccess) return -1;
  if (bytes > 0 && cudaDeviceSetLimit(cudaLimitMaxL2FetchGranularity, (size_t)bytes) != cudaSuccess)
    return -1;
  return (int)was;
}

extern "C" const char* bwtpu_cuda_error_name(int err) {
  return cudaGetErrorName((cudaError_t)err);
}
