// Both strands of a block of uniform length-L packed reads, for the packed
// pipelines: rows [0, B) of rw2 and ab2 are the reads' 2-bit words and
// ambiguity bits as they are, rows [B, 2B) their packed reverse
// complement, and lens2 = L on all 2B rows. One kernel, no memset.
//
// Replaces bwtpu/kernels/prep.py::revcomp_packed (:64) with the
// concatenations of bwtpu/engine.py::device_prep_packed (:644), jnp that
// XLA fused on the TPU; in the port's plain torch each shift, mask, flip
// and concatenation is a launch of its own. One thread per word q of a
// read b: it copies word q of both planes to row b, and writes word q of
// row B + b, whose fields come from the read's words j = W-1-q and j - 1:
// each word's 16 fields reversed (__brev, then each field's two bits
// swapped back) and, for the bases, complemented (NOT: each 2-bit field
// XOR 0b11), then the funnel shift right by S = 16W - L slots (0 <= S <
// 16) joins the two, zero past the row's end. The garbage that NOT writes
// into the slots >= L reverses into the slots < S and is shifted out.
//
// What bounds it on an H100: bytes. Each input word is read from memory
// once (a thread's two other loads are its row neighbours', served by L1
// or L2), four words are written a thread, and lens2 8 B a read: 24 B a
// word and 8 B a read, ~88 MB for the bench's 524,288 reads of W = 7 (26
// us at 3.35 TB/s). Measured: PERF.md §6 (chip_smoke.py phase 3).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// the 16 2-bit fields of x in reverse order
__device__ __forceinline__ uint32_t rev_fields(uint32_t x) {
  x = __brev(x);
  return ((x >> 1) & 0x55555555u) | ((x & 0x55555555u) << 1);
}

__global__ void __launch_bounds__(kThreads) revcomp_both_kernel(
    const uint32_t* __restrict__ words, const uint32_t* __restrict__ amb, int B, int W, int L,
    int bs, uint32_t* __restrict__ rw2, uint32_t* __restrict__ ab2, int* __restrict__ lens2) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)B * W) return;
  const int b = (int)(i / W), q = (int)(i - (long long)b * W);
  const uint32_t* wr = words + (size_t)b * W;
  const uint32_t* ar = amb + (size_t)b * W;
  rw2[i] = __ldg(wr + q);
  ab2[i] = __ldg(ar + q);
  const int j = W - 1 - q;
  uint32_t w = rev_fields(~__ldg(wr + j)), a = rev_fields(__ldg(ar + j));
  if (bs) {  // x << 32 is undefined: S = 0 needs no shift
    const uint32_t wn = j > 0 ? rev_fields(~__ldg(wr + j - 1)) : 0u;
    const uint32_t an = j > 0 ? rev_fields(__ldg(ar + j - 1)) : 0u;
    w = (w >> bs) | (wn << (32 - bs));
    a = (a >> bs) | (an << (32 - bs));
  }
  const size_t o = (size_t)B * W + (size_t)i;
  rw2[o] = w;
  ab2[o] = a;
  if (q == 0) {
    lens2[b] = L;
    lens2[B + b] = L;
  }
}

}  // namespace

// words, amb: int32[B, W]; rw2, ab2: int32[2B, W]; lens2: int32[2B]; W =
// ceil(L / 16). On `stream`.
extern "C" int bwtpu_revcomp_both(const void* words, const void* amb, int B, int W, int L,
                                  void* rw2, void* ab2, void* lens2, void* stream) {
  if (B < 0 || W < 1 || L <= 16 * (W - 1) || L > 16 * W || (long long)B * W >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const long long n = (long long)B * W;
  revcomp_both_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                        (cudaStream_t)stream>>>((const uint32_t*)words, (const uint32_t*)amb, B,
                                                W, L, 2 * (16 * W - L), (uint32_t*)rw2,
                                                (uint32_t*)ab2, (int*)lens2);
  return (int)cudaGetLastError();
}

extern "C" const char* bwtpu_cuda_error_name(int err) {
  return cudaGetErrorName((cudaError_t)err);
}
