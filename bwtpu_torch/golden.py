# Part of bwtpu/golden.py for the port: Hit, sort_hits, suffix_array and
# select_primary, copied as they are. GoldenFMIndex and brute_force_align
# stay in bwtpu as the tests' oracles (tests/test_torch_hostcopy.py).
"""Golden reference model — THE executable behavioral spec (SURVEY.md §0.1-0.2, §4.2).

The reference implementation's sources were not available at survey time
(SURVEY.md §0), so this pure-Python/NumPy model *is* the parity oracle: it restates
the reference's FM-index semantics (backward search over half-open
[sp, ep) intervals, LF-walk locate, bounded-substitution DFS — SURVEY.md
§3.2-3.4, validated against brute force in §0.2) in the reference's own
style: interpreted per-read loops with scalar table walks (BASELINE.json:
"Python dict/list walks"). It doubles as the CPU baseline in bench.py.

Pinned conventions (normative for the whole repo; SURVEY.md §7.6 item 3):

- T' = sanitized genome + '$'; n = len(T'); '$' lexicographically smallest.
- SA is the suffix array of T'; BWT[i] = T'[SA[i]-1] (so BWT[i]='$' when
  SA[i]==0).
- C[v] = number of symbols strictly smaller than v in T', over the
  5-symbol alphabet $=0 < A=1 < C=2 < G=3 < T=4 (note: *index-internal*
  symbol values are base code + 1; read/genome code space stays 0..3).
- Occ(v, i) = count of symbol v in BWT[0:i)  (half-open prefix).
- Exact backward search: sp,ep init (0, n); per base c (right to left):
  sp = C[v] + Occ(v, sp); ep = C[v] + Occ(v, ep), v = c+1; empty when
  sp >= ep. The final [sp, ep) rows enumerate all exact occurrences.
- LF(r) = C[BWT[r]] + Occ(BWT[r], r); locate walks LF until a sampled
  row, pos = SA_sample[row] + steps. (The golden model uses the full SA
  — output-identical to any sampling scheme, SURVEY.md §3.3.)
- Inexact search (k <= 2 substitutions): every position p such that
  Hamming(P, T[p:p+L]) <= k, where an ambiguous read base (N) matches
  nothing (always a mismatch) and genome N was replaced by 'A' at load.
  Reported as the full deduped hit set (pos, strand, nm).
- Both strands are searched: the read as-is ('+') and its reverse
  complement ('-'); a '-' hit at position p means the read maps to the
  reverse strand of the window [p, p+L).
- Hit ordering: sort by (nm, strand '-' after '+', pos). Primary hit for
  SAM: first in that order. MAPQ: 37 if the best-nm hit is unique else 0.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True, order=True)
class Hit:
    """One alignment hit in concatenated-genome coordinates."""

    nm: int  # mismatch count
    strand: str  # '+' or '-'
    pos: int  # 0-based position in the concatenated genome


def sort_hits(hits) -> list[Hit]:
    """Pinned report order: (nm, '+' before '-', pos)."""
    return sorted(set(hits), key=lambda h: (h.nm, h.strand != "+", h.pos))


def suffix_array(s: np.ndarray) -> np.ndarray:
    """Suffix array by prefix doubling (Manber–Myers with np.lexsort).

    O(n log^2 n); used by the golden model and as the engine's NumPy
    fallback for SA-IS. `s` is an integer array whose last element must
    be a unique minimum (the sentinel).
    """
    s = np.asarray(s, dtype=np.int64)
    n = len(s)
    if n == 1:
        return np.zeros(1, dtype=np.int64)
    rank = np.unique(s, return_inverse=True)[1].astype(np.int64)
    k = 1
    order = None
    while True:
        key2 = np.full(n, -1, dtype=np.int64)
        key2[: n - k] = rank[k:]
        order = np.lexsort((key2, rank))
        new_rank = np.empty(n, dtype=np.int64)
        diff = (rank[order][1:] != rank[order][:-1]) | (
            key2[order][1:] != key2[order][:-1]
        )
        new_rank[order] = np.concatenate(([0], np.cumsum(diff)))
        rank = new_rank
        if rank[order[-1]] == n - 1:
            return order.astype(np.int64)
        k *= 2


def select_primary(hits: list[Hit]) -> tuple[Hit | None, int]:
    """Pinned primary-hit rule: first hit in report order; MAPQ 37 if the
    best-nm hit is unique (across both strands) else 0."""
    if not hits:
        return None, 0
    primary = hits[0]
    n_best = sum(1 for h in hits if h.nm == primary.nm)
    return primary, (37 if n_best == 1 else 0)
