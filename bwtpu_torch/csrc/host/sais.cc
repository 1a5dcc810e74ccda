// SA-IS suffix-array construction (linear time, induced sorting).
//
// Build-side native component (SURVEY.md §2.2): the reference builds its
// suffix array with an interpreted sort; human-scale genomes (3.1 Gbp)
// need O(n) construction with small constants, so the engine uses this
// C++17 implementation, exposed to Python via ctypes (bwtpu/sais.py),
// with a NumPy prefix-doubling fallback for environments without a
// toolchain. int64 indices throughout (n can exceed 2^31 before
// sharding); the caller receives int64 and narrows per-shard to int32.
//
// Algorithm: Nong, Zhang & Chan, "Two Efficient Algorithms for Linear
// Time Suffix Array Construction" (2009) — implemented from the paper's
// induced-sorting scheme. Input s[0..n-1] over alphabet [0, K) must end
// with a unique, smallest sentinel s[n-1] = 0.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

using i64 = int64_t;

constexpr i64 EMPTY = -1;

template <typename T>
void count_symbols(const T* s, i64 n, i64 K, i64* cnt) {
  std::memset(cnt, 0, sizeof(i64) * K);
  for (i64 i = 0; i < n; ++i) cnt[s[i]]++;
}

void bucket_ptrs(const i64* cnt, i64 K, bool ends, i64* bkt) {
  i64 sum = 0;
  for (i64 c = 0; c < K; ++c) {
    sum += cnt[c];
    bkt[c] = ends ? sum : sum - cnt[c];
  }
}

// stype[i] = true  <=> suffix i is S-type.
template <typename T>
void classify(const T* s, i64 n, std::vector<bool>& stype) {
  stype.assign(n, false);
  stype[n - 1] = true;  // sentinel is S-type by definition
  for (i64 i = n - 2; i >= 0; --i)
    stype[i] = (s[i] < s[i + 1]) || (s[i] == s[i + 1] && stype[i + 1]);
}

inline bool is_lms(const std::vector<bool>& stype, i64 i) {
  return i > 0 && stype[i] && !stype[i - 1];
}

// Induce L-type then S-type suffixes from the LMS positions already
// placed in sa (everything else EMPTY).
template <typename T>
void induce(const T* s, i64 n, i64 K, const std::vector<bool>& stype,
            const i64* cnt, std::vector<i64>& bkt, i64* sa) {
  // L-type: scan left to right, place s[i]-bucket heads.
  bucket_ptrs(cnt, K, /*ends=*/false, bkt.data());
  for (i64 i = 0; i < n; ++i) {
    i64 j = sa[i];
    if (j > 0 && !stype[j - 1]) sa[bkt[s[j - 1]]++] = j - 1;
  }
  // S-type: scan right to left, place at s[i]-bucket tails.
  bucket_ptrs(cnt, K, /*ends=*/true, bkt.data());
  for (i64 i = n - 1; i >= 0; --i) {
    i64 j = sa[i];
    if (j > 0 && stype[j - 1]) sa[--bkt[s[j - 1]]] = j - 1;
  }
}

template <typename T>
void sais_impl(const T* s, i64* sa, i64 n, i64 K) {
  if (n == 1) {
    sa[0] = 0;
    return;
  }
  std::vector<bool> stype;
  classify(s, n, stype);

  std::vector<i64> cnt(K), bkt(K);
  count_symbols(s, n, K, cnt.data());

  // Step 1: place LMS suffixes at their bucket tails (unsorted), induce.
  std::fill(sa, sa + n, EMPTY);
  bucket_ptrs(cnt.data(), K, /*ends=*/true, bkt.data());
  for (i64 i = n - 1; i >= 0; --i)
    if (is_lms(stype, i)) sa[--bkt[s[i]]] = i;
  induce(s, n, K, stype, cnt.data(), bkt, sa);

  // Step 2: compact the now-sorted LMS suffixes, name LMS substrings.
  i64 n1 = 0;
  for (i64 i = 0; i < n; ++i)
    if (is_lms(stype, sa[i])) sa[n1++] = sa[i];
  // Use the second half of sa as the name array.
  i64* names = sa + n1;
  std::fill(names, names + (n - n1), EMPTY);
  i64 name = 0, prev = EMPTY;
  for (i64 i = 0; i < n1; ++i) {
    i64 pos = sa[i];
    bool differ = false;
    if (prev == EMPTY) {
      differ = true;
    } else {
      // Compare LMS substrings at prev and pos.
      for (i64 d = 0;; ++d) {
        if (s[pos + d] != s[prev + d] || stype[pos + d] != stype[prev + d]) {
          differ = true;
          break;
        }
        if (d > 0 && (is_lms(stype, pos + d) || is_lms(stype, prev + d))) {
          differ = !(is_lms(stype, pos + d) && is_lms(stype, prev + d));
          break;
        }
      }
    }
    if (differ) {
      ++name;
      prev = pos;
    }
    names[pos / 2] = name - 1;  // LMS positions are >= 2 apart
  }
  // Compact the sparse names (stored in sa[n1..n-1], indexed by pos/2,
  // i.e. in increasing text order) to the tail of sa: s1 = sa + n - n1
  // then holds the reduced string, one name per LMS position in text
  // order.
  i64* s1 = sa + n - n1;
  {
    i64 j = n - 1;
    for (i64 i = n - 1; i >= n1; --i)
      if (sa[i] != EMPTY) sa[j--] = sa[i];
  }

  // Step 3: recurse if names are not yet unique.
  if (name < n1) {
    sais_impl<i64>(s1, sa, n1, name);
  } else {
    for (i64 i = 0; i < n1; ++i) sa[s1[i]] = i;
  }

  // Step 4: map the sorted LMS order back to text positions.
  {
    // Rebuild the LMS position list (left to right) into s1.
    i64 j = 0;
    for (i64 i = 0; i < n; ++i)
      if (is_lms(stype, i)) s1[j++] = i;
    for (i64 i = 0; i < n1; ++i) sa[i] = s1[sa[i]];
  }

  // Step 5: place sorted LMS at bucket tails, induce the full SA.
  std::fill(sa + n1, sa + n, EMPTY);
  bucket_ptrs(cnt.data(), K, /*ends=*/true, bkt.data());
  for (i64 i = n1 - 1; i >= 0; --i) {
    i64 j = sa[i];
    sa[i] = EMPTY;
    sa[--bkt[s[j]]] = j;
  }
  induce(s, n, K, stype, cnt.data(), bkt, sa);
}

}  // namespace

extern "C" {

// Suffix array of s[0..n-1] (uint8 symbols in [0, K)); s[n-1] must be
// the unique smallest sentinel. Returns 0 on success.
int bwtpu_sais_u8(const uint8_t* s, int64_t* sa, int64_t n, int64_t K) {
  if (n <= 0 || K <= 0) return 1;
  if (s[n - 1] != 0) return 2;
  for (i64 i = 0; i + 1 < n; ++i)
    if (s[i] == 0) return 2;  // sentinel must be unique
  sais_impl<uint8_t>(s, sa, n, K);
  return 0;
}

}  // extern "C"
