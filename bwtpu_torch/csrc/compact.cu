// Fixed-capacity stream compaction in lane order, on the device.
//
//   compact_mask   the True lanes of a bool mask: sel[p] = lane for the
//                  lane at position p < cap, and over[lane] = position
//                  >= cap (the callers' `valid & cumsum(valid) > cap`);
//   compact_slots  lane l owns slots l*H + j for j < c_l, c_l = counts[l]
//                  clamped to [0, H]: sel[cum_l + j] = l*H + j below cap,
//                  and dropped[l] = c_l > 0 && cum_l + c_l > cap.
//
// Both write count = min(total, cap) and overflow = max(total - cap, 0)
// as 0-dim int32, and leave sel 0 from count on.
//
// Replaces bwtpu/kernels/compact.py::compact (:18) and ::compact_counts
// (:39), jnp that XLA fused on the TPU: a cumsum and a scatter, and for
// compact_counts a cumsum over the lanes, a scatter-max of each live
// lane's base at its first slot and a cummax. A mask is the case H = 1 of
// the slot form (c = valid, and `dropped` is then exactly `position >=
// cap`), so both kernels share each body.
//
// What bounds it on an H100: bytes, and few of them: each lane's count (4
// B, 1 B for a mask) read once, its flag (1 B) written once, sel (4 B a
// slot, up to cap) written once: well under a microsecond at 3.35 TB/s
// at the main path's shapes (32,768 to 524,288 lanes), so a call's time
// is its launches and the chain of dependent steps from the counts to
// sel. Two forms, each the fastest in its range of lanes as timed in
// turns on the card (scripts/torch_compact_ab.py; PERF.md §6);
// kernels/compact.py's plan picks one by the call's lane count. Both run
// 256 threads a CTA, 8 consecutive lanes a thread in registers (16 B
// loads, 8 B for a mask), a block scan of the threads' sums, and each
// lane writes its own slots and its flag (8 B a thread).
//
// - The cluster form (compact_mask_kernel, compact_slots_kernel), up to
//   one cluster's 32,768 lanes: one kernel on one thread-block cluster of
//   up to 16 CTAs. The CTAs' sums meet in distributed shared memory
//   behind one cluster barrier, so each CTA knows its prefix and the
//   total, and the CTAs share the zeroing of [total, cap), 16 B a store.
//   No memset and no global scratch: a call keeps nothing between
//   launches, so graph replays and calls in flight on several threads
//   need no reset. The cluster size is the widest of 16, 8, 4, 2, 1 CTAs
//   that cudaOccupancyMaxActiveClusters places, asked once a device: 16
//   on the H100 80GB HBM3 (chip_smoke.py phase 3 prints it). A call takes
//   the fewest CTAs (a power of two) that hold its lanes. Clusters holding
//   more (up to 262,144 lanes: wider CTAs, more lanes a thread, lanes
//   striped over a warp, or prefixes in shared memory) were slower than
//   the tiles form from 65,536 lanes on: 16 SMs do the whole call, and
//   the launch and the two cluster barriers cost what the memset saves.
// - The tiles form (compact_mask_tiles_kernel, compact_slots_tiles_kernel),
//   above: the earlier one-form design. One memset zeroes the workspace
//   (sel, the scalars, the ticket, one look-back word a tile); then a CTA
//   a tile of 2,048 lanes, from a ticket, chained by the decoupled
//   look-back of scan.cuh. Tiles that held their lanes' prefixes in
//   shared memory and wrote sel coalesced (the owning lane of each
//   position by a binary search), with the memset cut to the ticket and
//   look-back words and sel's tail zeroed by CTAs drawing tickets after
//   the last tile, were slower at every main-path shape and faster only
//   at the bench's k = 2 calls (3,145,728 lanes, H 32 and 64).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "scan.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace bwtpu;

constexpr int kThreads = 256;              // the cluster and tiles forms' CTAs
constexpr int kItems = 8;                  // consecutive lanes a thread, in registers
constexpr int kTile = kThreads * kItems;   // 2,048 lanes a CTA
constexpr int kMaxCluster = 16;

template <typename In, int V>
struct alignas(sizeof(In) * V) Pack {
  In v[V];
};

__device__ __forceinline__ int clamp_count(int v, int H) { return v < 0 ? 0 : (v > H ? H : v); }

// sel[q] = 0 for q in [from, to), shared by `workers` threads (this one
// is `worker`); 16 B stores between the 16 B boundaries. sel is 16 B
// aligned.
__device__ __forceinline__ void zero_range(int* __restrict__ sel, int from, int to, int worker,
                                           int workers) {
  if (from >= to) return;
  const int a = min((from + 3) & ~3, to), b = max(to & ~3, a);
  for (int q = from + worker; q < a; q += workers) sel[q] = 0;
  int4* v = reinterpret_cast<int4*>(sel);
  for (int j = (a >> 2) + worker; j < (b >> 2); j += workers) v[j] = make_int4(0, 0, 0, 0);
  for (int q = b + worker; q < to; q += workers) sel[q] = 0;
}

// The thread's kItems consecutive lanes from `first`, clamped to [0, H]
// (16 B loads, 8 B for a mask, where `in` is 16 B aligned and the lanes
// all exist).
template <typename In>
__device__ __forceinline__ void load_items(const In* __restrict__ in, int first, int n, int H,
                                           int (&c)[kItems]) {
  constexpr int V = kItems * (int)sizeof(In) < 16 ? kItems : 16 / (int)sizeof(In);
  if (first + kItems <= n && reinterpret_cast<uintptr_t>(in) % 16 == 0) {
#pragma unroll
    for (int q = 0; q < kItems; q += V) {
      const Pack<In, V> v = *reinterpret_cast<const Pack<In, V>*>(in + first + q);
#pragma unroll
      for (int r = 0; r < V; ++r) c[q + r] = clamp_count((int)v.v[r], H);
    }
  } else {
#pragma unroll
    for (int r = 0; r < kItems; ++r)
      c[r] = first + r < n ? clamp_count((int)in[first + r], H) : 0;
  }
}

// Each of the thread's lanes writes its slots from position p on, below
// cap, and its flag (one 8 B store where the lanes all exist).
__device__ __forceinline__ void write_items(const int (&c)[kItems], int first, int n, int H,
                                            int cap, int p, int* __restrict__ sel,
                                            bool* __restrict__ flag) {
  unsigned f[kItems / 4] = {};
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    f[r >> 2] |= (unsigned)(c[r] > 0 && p + c[r] > cap) << (8 * (r & 3));
    const int base = (first + r) * H;
    for (int j = 0; j < c[r] && p + j < cap; ++j) sel[p + j] = base + j;
    p += c[r];
  }
  if (first + kItems <= n)
    *reinterpret_cast<uint2*>(flag + first) = make_uint2(f[0], f[1]);
  else
    for (int r = 0; first + r < n; ++r) flag[first + r] = (f[r >> 2] >> (8 * (r & 3))) & 1u;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The cluster form: the grid is one cluster, CTA r holds lanes [r *
// kTile, (r + 1) * kTile).
template <typename In>
__device__ __forceinline__ void cluster_body(const In* __restrict__ in, int n, int H, int cap,
                                             int* __restrict__ sel, bool* __restrict__ flag) {
  __shared__ int s_warp[kThreads / 32];
  __shared__ int s_run, s_excl, s_total;
  const int rank = blockIdx.x, nctas = gridDim.x;
  const int first = (rank * kThreads + (int)threadIdx.x) * kItems;
  int c[kItems];
  load_items(in, first, n, H, c);
  int own = 0;
#pragma unroll
  for (int r = 0; r < kItems; ++r) own += c[r];
  const int2 sc = block_exclusive_scan<kThreads / 32>(own, s_warp);
  if (threadIdx.x == 0) s_run = sc.y;
  cluster_arrive();  // release: s_run is read by the other CTAs after their wait
  cluster_wait();
  if (threadIdx.x < 32) {
    const int l = threadIdx.x;
    const int v = l < nctas ? *cg::this_cluster().map_shared_rank(&s_run, l) : 0;
    int below = l < rank ? v : 0, all = v;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      below += __shfl_xor_sync(0xFFFFFFFFu, below, o);
      all += __shfl_xor_sync(0xFFFFFFFFu, all, o);
    }
    if (l == 0) {
      s_excl = below;
      s_total = all;
    }
  }
  cluster_arrive();  // this CTA has read the others' s_run
  __syncthreads();
  const int total = s_total;
  write_items(c, first, n, H, cap, s_excl + sc.x, sel, flag);
  zero_range(sel, total, cap, rank * kThreads + threadIdx.x, nctas * kThreads);
  if (rank == 0 && threadIdx.x == 0) {
    sel[cap] = total < cap ? total : cap;
    sel[cap + 1] = total > cap ? total - cap : 0;
  }
  cluster_wait();  // no CTA leaves while another may still read its s_run
}

// The tiles form: a tile of kTile lanes a CTA, from a ticket. scalars:
// count, overflow, the ticket; lb: one look-back word a tile; sel, the
// scalars, the ticket and lb zeroed by the memset before it.
template <typename In>
__device__ __forceinline__ void tiles_body(const In* __restrict__ in, int n, int H, int cap,
                                           int nb, int* __restrict__ sel, bool* __restrict__ flag,
                                           int* __restrict__ scalars, unsigned* __restrict__ lb) {
  __shared__ int s_tile, s_prefix;
  __shared__ int s_warp[kThreads / 32];
  if (threadIdx.x == 0) s_tile = atomicAdd(scalars + 2, 1);
  __syncthreads();
  const int tile = s_tile;
  const int first = tile * kTile + (int)threadIdx.x * kItems;
  int c[kItems];
  load_items(in, first, n, H, c);
  int own = 0;
#pragma unroll
  for (int r = 0; r < kItems; ++r) own += c[r];
  const int2 sc = block_exclusive_scan<kThreads / 32>(own, s_warp);
  if (threadIdx.x < 32) {
    const int excl = tile_lookback(lb, tile, sc.y);
    if (threadIdx.x == 0) s_prefix = excl;
  }
  __syncthreads();
  write_items(c, first, n, H, cap, s_prefix + sc.x, sel, flag);
  if (threadIdx.x == 0 && tile == nb - 1) {
    const int total = s_prefix + sc.y;
    scalars[0] = total < cap ? total : cap;
    scalars[1] = total > cap ? total - cap : 0;
  }
}

// The kernels of each form. A mask is the slot form at H = 1, a constant
// there: its clamp and slot loop fold to a test.
__global__ void __launch_bounds__(kThreads)
    compact_mask_kernel(const bool* __restrict__ valid, int n, int, int cap,
                        int* __restrict__ sel, bool* __restrict__ over) {
  cluster_body(valid, n, 1, cap, sel, over);
}

__global__ void __launch_bounds__(kThreads)
    compact_slots_kernel(const int* __restrict__ counts, int n, int H, int cap,
                         int* __restrict__ sel, bool* __restrict__ dropped) {
  cluster_body(counts, n, H, cap, sel, dropped);
}

__global__ void __launch_bounds__(kThreads)
    compact_mask_tiles_kernel(const bool* __restrict__ valid, int n, int, int cap, int nb,
                              int* __restrict__ sel, bool* __restrict__ over,
                              int* __restrict__ scalars, unsigned* __restrict__ lb) {
  tiles_body(valid, n, 1, cap, nb, sel, over, scalars, lb);
}

__global__ void __launch_bounds__(kThreads)
    compact_slots_tiles_kernel(const int* __restrict__ counts, int n, int H, int cap, int nb,
                               int* __restrict__ sel, bool* __restrict__ dropped,
                               int* __restrict__ scalars, unsigned* __restrict__ lb) {
  tiles_body(counts, n, H, cap, nb, sel, dropped, scalars, lb);
}

template <typename In>
struct Kernels;
template <>
struct Kernels<bool> {
  static constexpr auto cluster_fn = compact_mask_kernel;
  static constexpr auto tiles_fn = compact_mask_tiles_kernel;
};
template <>
struct Kernels<int> {
  static constexpr auto cluster_fn = compact_slots_kernel;
  static constexpr auto tiles_fn = compact_slots_tiles_kernel;
};

int tiles(int n) { return n > 0 ? (n + kTile - 1) / kTile : 1; }

// The widest of kMaxCluster, ..., 2, 1 CTAs a cluster that the current
// device places (cudaOccupancyMaxActiveClusters, for both cluster
// kernels), after allowing the non-portable sizes above 8: the attribute
// is the device's own, so this runs on each device before its first
// cluster launch (kernels/compact.py asks once a device and keeps it).
cudaError_t ask_cluster(int* ctas) {
  *ctas = 0;
  const void* fns[] = {(const void*)compact_mask_kernel, (const void*)compact_slots_kernel};
  for (const void* f : fns) {
    const cudaError_t e =
        cudaFuncSetAttribute(f, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  for (int c = kMaxCluster; c >= 1; c >>= 1) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(c);
    cfg.blockDim = dim3(kThreads);
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = c;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    bool placed = true;
    for (const void* f : fns) {
      int num = 0;
      if (cudaOccupancyMaxActiveClusters(&num, f, &cfg) != cudaSuccess) {
        cudaGetLastError();
        num = 0;
      }
      placed &= num >= 1;
    }
    if (placed) {
      *ctas = c;
      return cudaSuccess;
    }
  }
  return cudaErrorInvalidConfiguration;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// One compaction on `s` in the form `form` picks:
//   form >= 1  the cluster form on `form` CTAs (a power of two, holding
//              n lanes, that ask_cluster found placeable: a wider one is
//              refused at launch); ws = sel[cap], count, overflow;
//   form == 0  the tiles form; ws = sel[cap], count, overflow, the ticket,
//              one look-back word a tile of kTile lanes, all zeroed first.
template <typename In>
int launch(const In* in, int n, int H, int cap, int form, int* ws, int ws_words, bool* flag,
           cudaStream_t s) {
  if (n < 0 || H < 1 || cap < 0 || form < 0 || (long long)n * H >= (long long)kScanAgg ||
      !aligned16(ws) || !aligned16(flag))
    return (int)cudaErrorInvalidValue;
  if (form > 0) {
    if (form > kMaxCluster || (form & (form - 1)) || ws_words != cap + 2 ||
        (long long)form * kTile < n)
      return (int)cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(form);
    cfg.blockDim = dim3(kThreads);
    cfg.stream = s;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = form;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, Kernels<In>::cluster_fn, in, n, H, cap, ws,
                                             flag);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
  }
  const int nb = tiles(n);
  if (ws_words != cap + 3 + nb) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaMemsetAsync(ws, 0, (size_t)ws_words * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  Kernels<In>::tiles_fn<<<nb, kThreads, 0, s>>>(in, n, H, cap, nb, ws, flag, ws + cap,
                                                reinterpret_cast<unsigned*>(ws + cap + 3));
  return (int)cudaGetLastError();
}

}  // namespace

// Lanes a CTA of either form: a cluster of c CTAs holds c times this
// many, and the tiles form has one look-back word a tile of them.
extern "C" int bwtpu_compact_tile() { return kTile; }

// The current device's cluster size for the cluster form, in *ctas (see
// ask_cluster); call it on a device before its first cluster-form launch.
extern "C" int bwtpu_compact_cluster_query(int* ctas) { return (int)ask_cluster(ctas); }

// compact(valid, cap) on `stream` in `form` (see launch): sel, count,
// overflow in `ws`, over bool[n].
extern "C" int bwtpu_compact_mask(const void* valid, int n, int cap, int form, void* ws,
                                  int ws_words, void* over, void* stream) {
  return launch((const bool*)valid, n, 1, cap, form, (int*)ws, ws_words, (bool*)over,
                (cudaStream_t)stream);
}

// compact_counts(counts, H, cap) on `stream` in `form`: sel, count,
// overflow in `ws`, dropped bool[n].
extern "C" int bwtpu_compact_slots(const void* counts, int n, int H, int cap, int form,
                                   void* ws, int ws_words, void* dropped, void* stream) {
  return launch((const int*)counts, n, H, cap, form, (int*)ws, ws_words, (bool*)dropped,
                (cudaStream_t)stream);
}

extern "C" const char* bwtpu_cuda_error_name(int err) {
  return cudaGetErrorName((cudaError_t)err);
}
