// Single-pass lattice assembly for the bwtpu index (build-side native
// component, SURVEY.md §2.2).
//
// Given the BWT symbol string (0='$', 1..4=A..T) and the suffix array,
// emits in ONE linear pass over n rows:
//   - the 32-word search records (Occ checkpoints, 2-bit packed BWT,
//     SA-sample mark bits, mark-rank checkpoint; the caller back-fills
//     the next-block mirror words 17..28 with a cheap vector copy),
//   - the sampled-SA value array (text sampling: SA[r] % s == 0),
//   - the 2-bit packed text.
// The NumPy formulation materializes several n-sized intermediates and
// costs ~3-4 s per 11.7 Mbp shard; this pass is memory-bound at ~n
// bytes read + ~n/2 written.
//
// Layout contract must match bwtpu/index.py exactly (tests assert
// equality against the NumPy builder).

#include <cstdint>
#include <cstring>

namespace {
using i32 = int32_t;
using i64 = int64_t;
using u32 = uint32_t;
using u8 = uint8_t;

constexpr i64 BLOCK = 128;
constexpr i64 REC = 32;
constexpr i64 BWT_W0 = 4;
constexpr i64 MARK_W0 = 12;
constexpr i64 MARK_RANK_W = 16;
constexpr i64 NEXT_CK0 = 17;
constexpr i64 NEXT_BWT0 = 21;
}  // namespace

extern "C" {

// bwt_sym: n bytes (0..4, exactly one 0); sa: n int64; text_codes:
// text_len bytes (= n-1). Outputs (caller-allocated, zero-filled):
//   lattice:  (n_blocks+1) * 32 int32
//   ssa:      capacity >= number of sampled rows, int32
//   text_packed: ceil(text_len/16) int32
// Returns the number of sampled rows, or -1 on error.
i64 bwtpu_build_lattice(const u8* bwt_sym, const i64* sa, i64 n,
                        i64 sa_rate, i32* lattice, i32* ssa,
                        const u8* text_codes, i64 text_len,
                        i32* text_packed) {
  if (n <= 0 || sa_rate <= 0) return -1;
  const i64 n_blocks = (n + BLOCK - 1) / BLOCK;
  i64 counts[4] = {0, 0, 0, 0};
  i64 mark_rank = 0;
  i64 n_sampled = 0;

  for (i64 j = 0; j < n_blocks; ++j) {
    i32* rec = lattice + j * REC;
    for (int c = 0; c < 4; ++c) rec[c] = static_cast<i32>(counts[c]);
    rec[MARK_RANK_W] = static_cast<i32>(mark_rank);
    const i64 lo = j * BLOCK;
    const i64 hi = lo + BLOCK < n ? lo + BLOCK : n;
    for (i64 r = lo; r < hi; ++r) {
      const u8 sym = bwt_sym[r];
      const i64 p = r - lo;
      // '$' stored as code 0, not counted (query-time correction).
      const u32 code = sym == 0 ? 0u : static_cast<u32>(sym - 1);
      if (sym != 0) counts[sym - 1]++;
      reinterpret_cast<u32*>(rec + BWT_W0)[p >> 4] |= code << (2 * (p & 15));
      if (sa[r] % sa_rate == 0) {
        reinterpret_cast<u32*>(rec + MARK_W0)[p >> 5] |= 1u << (p & 31);
        ssa[n_sampled++] = static_cast<i32>(sa[r]);
        mark_rank++;
      }
    }
  }
  // terminator row: full-text counts + final mark rank
  i32* term = lattice + n_blocks * REC;
  for (int c = 0; c < 4; ++c) term[c] = static_cast<i32>(counts[c]);
  term[MARK_RANK_W] = static_cast<i32>(mark_rank);

  // next-block mirrors (words 17..20 = ck of j+1, 21..28 = bwt of j+1)
  for (i64 j = 0; j < n_blocks; ++j) {
    i32* rec = lattice + j * REC;
    const i32* nxt = lattice + (j + 1) * REC;
    std::memcpy(rec + NEXT_CK0, nxt, 4 * sizeof(i32));
    if (j + 1 < n_blocks)
      std::memcpy(rec + NEXT_BWT0, nxt + BWT_W0, 8 * sizeof(i32));
  }

  // packed text
  for (i64 p = 0; p < text_len; ++p) {
    reinterpret_cast<u32*>(text_packed)[p >> 4] |=
        static_cast<u32>(text_codes[p]) << (2 * (p & 15));
  }
  return n_sampled;
}

// Fused one-pass shard assembly (round 3, VERDICT r2 item 7): the
// NumPy formulation of index build spent most of its time in separate
// random-access passes over `sa` — the BWT gather, the preceding-s-mer
// gathers for the multi-step lattice, and their bincounts — each
// missing cache on the same rows. This pass reads each row's
// neighborhood of `symbols` ONCE (bwt symbol at sa[r]-1 and the s
// preceding-s-mer bytes at sa[r]-s.. share a cache line) and emits:
//   - the 32-word search records + ssa + packed text (as
//     bwtpu_build_lattice, whose layout contract it shares),
//   - the multi-step Occ lattice records: per-R-block cumulative
//     preceding-s-mer counts in words [0, A) (the caller adds Ks[t])
//     and the R code bytes in words [A, A + R/4),
//   - occk_invalid: the rows with SA[r] < step, ascending,
//   - counts5: symbol counts over the BWT ('$' included at [0]),
//   - dollar_row.
// step == 0 skips the multi-step outputs (occk_lattice may be null).
// Geometry must match bwtpu/index.py OCCK_BLOCK/OCCK_WIDTH.
namespace {
constexpr i64 kOcckR[5] = {0, 0, 0, 256, 512};   // step -> rows/record
constexpr i64 kOcckW[5] = {0, 0, 0, 128, 512};   // step -> record words
}  // namespace

extern "C" i64 bwtpu_build_shard(const u8* symbols, const i64* sa, i64 n,
                                 i64 sa_rate, i64 step, i32* lattice,
                                 i32* ssa, i32* text_packed,
                                 i32* occk_lattice, i32* occk_invalid,
                                 i64* counts5, i64* dollar_row) {
  if (n <= 0 || sa_rate <= 0) return -1;
  if (step != 0 && (step < 3 || step > 4)) return -1;
  if (step != 0 && occk_lattice == nullptr) return -1;
  const i64 n_blocks = (n + BLOCK - 1) / BLOCK;
  const i64 R = step ? kOcckR[step] : 1;
  const i64 W = step ? kOcckW[step] : 0;
  const i64 A = step ? (i64(1) << (2 * step)) : 0;
  i64 counts[4] = {0, 0, 0, 0};
  i64 countsK[256] = {0};
  i64 mark_rank = 0;
  i64 n_sampled = 0;
  i64 dollar = -1;
  int n_inv = 0;

  for (i64 r = 0; r < n; ++r) {
    if ((r & (BLOCK - 1)) == 0) {
      i32* rec = lattice + (r / BLOCK) * REC;
      for (int c = 0; c < 4; ++c) rec[c] = static_cast<i32>(counts[c]);
      rec[MARK_RANK_W] = static_cast<i32>(mark_rank);
    }
    if (step && r % R == 0) {
      i32* recK = occk_lattice + (r / R) * W;
      for (i64 t = 0; t < A; ++t) recK[t] = static_cast<i32>(countsK[t]);
    }
    const i64 sr = sa[r];
    const u8 sym = symbols[sr == 0 ? n - 1 : sr - 1];
    const i64 p = r & (BLOCK - 1);
    i32* rec = lattice + (r / BLOCK) * REC;
    const u32 code = sym == 0 ? 0u : static_cast<u32>(sym - 1);
    if (sym != 0) {
      counts[sym - 1]++;
    } else {
      dollar = r;
    }
    reinterpret_cast<u32*>(rec + BWT_W0)[p >> 4] |= code << (2 * (p & 15));
    if (sr % sa_rate == 0) {
      reinterpret_cast<u32*>(rec + MARK_W0)[p >> 5] |= 1u << (p & 31);
      ssa[n_sampled++] = static_cast<i32>(sr);
      mark_rank++;
    }
    if (step) {
      if (sr >= step) {
        u32 codeK = 0;
        for (i64 q = 0; q < step; ++q)
          codeK = codeK * 4 + static_cast<u32>(symbols[sr - step + q] - 1);
        countsK[codeK]++;
        const i64 pK = r % R;
        i32* recK = occk_lattice + (r / R) * W;
        reinterpret_cast<u32*>(recK + A)[pK >> 2] |= codeK << (8 * (pK & 3));
      } else if (n_inv < 4) {
        occk_invalid[n_inv++] = static_cast<i32>(r);
      }
    }
  }
  // terminator rows: full-text counts, zero bits/codes
  i32* term = lattice + n_blocks * REC;
  for (int c = 0; c < 4; ++c) term[c] = static_cast<i32>(counts[c]);
  term[MARK_RANK_W] = static_cast<i32>(mark_rank);
  if (step) {
    const i64 n_blocksK = (n + R - 1) / R;
    i32* termK = occk_lattice + n_blocksK * W;
    for (i64 t = 0; t < A; ++t) termK[t] = static_cast<i32>(countsK[t]);
  }

  // next-block mirrors (words 17..20 = ck of j+1, 21..28 = bwt of j+1)
  for (i64 j = 0; j < n_blocks; ++j) {
    i32* rec = lattice + j * REC;
    const i32* nxt = lattice + (j + 1) * REC;
    std::memcpy(rec + NEXT_CK0, nxt, 4 * sizeof(i32));
    if (j + 1 < n_blocks)
      std::memcpy(rec + NEXT_BWT0, nxt + BWT_W0, 8 * sizeof(i32));
  }

  // packed text (text_codes[i] = symbols[i] - 1, text_len = n - 1)
  const i64 text_len = n - 1;
  for (i64 p = 0; p < text_len; ++p) {
    reinterpret_cast<u32*>(text_packed)[p >> 4] |=
        static_cast<u32>(symbols[p] - 1) << (2 * (p & 15));
  }
  counts5[0] = 1;
  for (int c = 0; c < 4; ++c) counts5[c + 1] = counts[c];
  *dollar_row = dollar;
  return n_sampled;
}

// Histogram of the depth-dmax suffix keys in TEXT order (base-5 keys
// over `symbols`, MSB-first, zero-padded past the end — exactly the
// `tkey` of bwtpu/index.py). Because a histogram is order-independent,
// the k-mer start tables and the multi-step Ks offsets derive from its
// prefix sums WITHOUT ever gathering keys into suffix-array order or
// binary-searching them (the two passes that dominated the NumPy
// builder). Rolling evaluation: key(i) = symbols[i]*5^(dmax-1) +
// key(i+1)/5 (integer division drops the last digit).
// hist: 5^dmax uint32, zero-filled by the caller. dmax <= 12.
extern "C" int bwtpu_key_hist(const u8* symbols, i64 n, i64 dmax,
                              u32* hist) {
  if (n <= 0 || dmax < 1 || dmax > 12) return -1;
  i64 pow_hi = 1;
  for (i64 i = 0; i < dmax - 1; ++i) pow_hi *= 5;
  i64 key = 0;
  for (i64 i = n - 1; i >= 0; --i) {
    key = static_cast<i64>(symbols[i]) * pow_hi + key / 5;
    hist[key]++;
  }
  return 0;
}

}  // extern "C"
