// Both strands of a block of uniform length-L packed reads, for the packed
// pipelines: rows [0, B) of rw2 and ab2 are the reads' 2-bit words and
// ambiguity bits as they are, rows [B, 2B) their packed reverse
// complement, and lens2 = L on all 2B rows. One kernel, no memset.
//
// Replaces bwtpu/kernels/prep.py::revcomp_packed (:64) with the
// concatenations of bwtpu/engine.py::device_prep_packed (:644), jnp that
// XLA fused on the TPU; in the port's plain torch each shift, mask, flip
// and concatenation is a launch of its own.
//
// Two instances. kForward = false is the engine's: the block's reads were
// uploaded into rows [0, B) of the stacked planes, so `words` and `amb`
// ARE those rows, and the kernel writes only rows [B, 2B) and lens2.
// kForward = true takes separate [B, W] rows and also copies them into
// rows [0, B). The engine calls it once a block for every shard.
//
// What bounds it on an H100: bytes. Both input planes read once, the
// reverse half written once (16 B a word), lens2 8 B a read, and with
// kForward the forward half written too (24 B a word): for the bench's
// 524,288 reads of W = 7, 62.9 MB (0.0188 ms at 3.35 TB/s) in place, 92.3
// MB (0.0275 ms) forward. At the main path's blocks (16,384-65,536 reads,
// 2-8 MB) the launch and one round trip to memory dominate instead.
//
// The design: one thread a word q of a read b, W a template parameter for
// W 1-8 (reads of up to 128 bases: the division by W is a multiply) with
// one run-time-W instance above, all index arithmetic 32-bit (the entry
// point refuses B * W >= 2^31, so a reverse row's offset fits in 32
// unsigned bits). The thread reads the read's words j = W-1-q and j - 1
// (the row's other threads read them too: L1 serves the repeats), each
// word's 16 fields reversed (__brev, then each field's two bits swapped
// back) and, for the bases, complemented (NOT: each 2-bit field XOR 0b11),
// joins them by a funnel shift right by S = 16W - L slots (0 <= S < 16),
// zero past the row's end, and stores word q of row B + b; neighbouring
// threads store neighbouring words, so a warp's stores are coalesced. The
// garbage that NOT writes into the slots >= L reverses into the slots < S
// and is shifted out. Staging a tile through shared memory (one 1-D bulk
// copy a plane on an mbarrier, or 16-byte loads, and 16-byte stores from a
// staged copy) measured slower at the main path's blocks and no faster
// beyond 2-3 % at the bench's call (PERF.md §6): each CTA's copy,
// barriers and staging add ~1 us of latency to a call that the launch and
// one round trip otherwise bound. Measured: PERF.md §6
// (scripts/torch_prep_ab.py, chip_smoke.py phase 3).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a CTA: 256 words, ~36 reads of 100 bp

// the 16 2-bit fields of x in reverse order
__device__ __forceinline__ uint32_t rev_fields(uint32_t x) {
  x = __brev(x);
  return ((x >> 1) & 0x55555555u) | ((x & 0x55555555u) << 1);
}

// kW: words a read (0: run time, `w_rt`). kForward: also write rows [0, B).
template <int kW, bool kForward>
__global__ void __launch_bounds__(kThreads) revcomp_both_kernel(
    const uint32_t* __restrict__ words, const uint32_t* __restrict__ amb, int B, int w_rt,
    int L, int bs, uint32_t* __restrict__ rw2, uint32_t* __restrict__ ab2,
    int* __restrict__ lens2) {
  const int W = kW > 0 ? kW : w_rt;
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= static_cast<unsigned>(B * W)) return;
  const int b = static_cast<int>(i) / W, q = static_cast<int>(i) - b * W;
  const uint32_t* wr = words + b * W;
  const uint32_t* ar = amb + b * W;
  const int j = W - 1 - q;
  uint32_t w = rev_fields(~__ldg(wr + j)), a = rev_fields(__ldg(ar + j));
  if (bs) {  // x << 32 is undefined: S = 0 needs no shift
    const uint32_t wn = j > 0 ? rev_fields(~__ldg(wr + j - 1)) : 0u;
    const uint32_t an = j > 0 ? rev_fields(__ldg(ar + j - 1)) : 0u;
    w = (w >> bs) | (wn << (32 - bs));
    a = (a >> bs) | (an << (32 - bs));
  }
  const uint32_t o = static_cast<uint32_t>(B) * static_cast<uint32_t>(W) + i;
  rw2[o] = w;
  ab2[o] = a;
  if constexpr (kForward) {
    rw2[i] = __ldg(wr + q);
    ab2[i] = __ldg(ar + q);
  }
  if (q == 0) {
    lens2[b] = L;
    lens2[B + b] = L;
  }
}

template <int kW, bool kForward>
cudaError_t launch(const uint32_t* words, const uint32_t* amb, int B, int W, int L,
                   uint32_t* rw2, uint32_t* ab2, int* lens2, cudaStream_t stream) {
  const long long n = (long long)B * W;
  revcomp_both_kernel<kW, kForward><<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                                      stream>>>(words, amb, B, W, L, 2 * (16 * W - L), rw2,
                                                ab2, lens2);
  return cudaGetLastError();
}

template <bool kForward>
cudaError_t dispatch(const uint32_t* words, const uint32_t* amb, int B, int W, int L,
                     uint32_t* rw2, uint32_t* ab2, int* lens2, cudaStream_t stream) {
#define BWTPU_PREP_W(w) \
  case w:               \
    return launch<w, kForward>(words, amb, B, W, L, rw2, ab2, lens2, stream);
  switch (W) {
    BWTPU_PREP_W(1)
    BWTPU_PREP_W(2)
    BWTPU_PREP_W(3)
    BWTPU_PREP_W(4)
    BWTPU_PREP_W(5)
    BWTPU_PREP_W(6)
    BWTPU_PREP_W(7)
    BWTPU_PREP_W(8)
    default:
      return launch<0, kForward>(words, amb, B, W, L, rw2, ab2, lens2, stream);
  }
#undef BWTPU_PREP_W
}

}  // namespace

// words, amb: int32[B, W]; rw2, ab2: int32[2B, W]; lens2: int32[2B]; W =
// ceil(L / 16). forward 0: words and amb are rows [0, B) of rw2 and ab2,
// and only rows [B, 2B) and lens2 are written; forward 1: they lie apart
// from the outputs, and rows [0, B) are written as copies of them. On
// `stream`.
extern "C" int bwtpu_revcomp_both(const void* words, const void* amb, int B, int W, int L,
                                  void* rw2, void* ab2, void* lens2, int forward,
                                  void* stream) {
  if (B < 0 || W < 1 || L <= 16 * (W - 1) || L > 16 * W || (long long)B * W >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const uint32_t *w = (const uint32_t*)words, *a = (const uint32_t*)amb;
  uint32_t *o = (uint32_t*)rw2, *oa = (uint32_t*)ab2;
  int* l2 = (int*)lens2;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(forward ? dispatch<true>(w, a, B, W, L, o, oa, l2, s)
                       : dispatch<false>(w, a, B, W, L, o, oa, l2, s));
}

extern "C" const char* bwtpu_cuda_error_name(int err) {
  return cudaGetErrorName((cudaError_t)err);
}
