# Part of bwtpu/golden.py for the port: Hit, sort_hits, suffix_array,
# GoldenFMIndex (the bench's CPU reference rate) and select_primary, copied
# as they are; only the imports differ. bwtpu's GoldenFMIndex and
# brute_force_align stay the tests' oracles (tests/test_torch_hostcopy.py).
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

from bwtpu_torch import dna


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


class GoldenFMIndex:
    """FM-index with interpreted per-read search loops (the oracle)."""

    def __init__(self, genome: str):
        genome = dna.sanitize_genome(genome)
        self.text_codes = dna.encode(genome)  # 0..3
        s = np.concatenate(
            [self.text_codes.astype(np.int64) + 1, np.zeros(1, dtype=np.int64)]
        )
        self.n = len(s)  # len(T) + 1
        self.sa = suffix_array(s)
        self.bwt = s[(self.sa - 1) % self.n]  # symbol values 0..4; 0 = '$'
        counts = np.bincount(self.bwt, minlength=5)
        self.C = np.concatenate(([0], np.cumsum(counts)[:-1]))  # C[v], v in 0..4
        # Occ prefix tables per symbol; walked with scalar indexing below
        # to mirror the reference's interpreted inner loop.
        self.occ = [
            np.concatenate(([0], np.cumsum(self.bwt == v))).astype(np.int64)
            for v in range(5)
        ]

    # ---------------- L3 search ops (SURVEY.md §3.2-3.4) ----------------

    def backward_search(self, codes, mask=None) -> tuple[int, int]:
        """Exact backward search; returns half-open [sp, ep)."""
        sp, ep = 0, self.n
        for i in range(len(codes) - 1, -1, -1):
            if mask is not None and mask[i]:
                return 0, 0  # ambiguous base matches nothing
            v = int(codes[i]) + 1
            sp = int(self.C[v]) + int(self.occ[v][sp])
            ep = int(self.C[v]) + int(self.occ[v][ep])
            if sp >= ep:
                return sp, sp
        return sp, ep

    def lf(self, r: int) -> int:
        v = int(self.bwt[r])
        return int(self.C[v]) + int(self.occ[v][r])

    def locate(self, r: int) -> int:
        """Text position of SA row r (golden: direct SA lookup)."""
        return int(self.sa[r])

    def locate_range(self, sp: int, ep: int) -> list[int]:
        return sorted(int(self.sa[r]) for r in range(sp, ep))

    def inexact_search(self, codes, k: int, mask=None) -> list[tuple[int, int]]:
        """Bounded-substitution DFS (reference shape, SURVEY.md §3.4).

        Returns the deduped list of (pos, nm) for every position with
        Hamming distance <= k. Distinct DFS leaves correspond to
        distinct matched strings, hence disjoint SA intervals, so no
        position repeats; dedupe is kept for safety.
        """
        L = len(codes)
        results: list[tuple[int, int, int]] = []  # (sp, ep, nm)

        def rec(i: int, sp: int, ep: int, m: int):
            if sp >= ep:
                return
            if i < 0:
                results.append((sp, ep, m))
                return
            ambiguous = mask is not None and mask[i]
            want = -1 if ambiguous else int(codes[i])
            for c in range(4):
                mm = m + (1 if c != want else 0)
                if mm > k:
                    continue
                v = c + 1
                rec(
                    i - 1,
                    int(self.C[v]) + int(self.occ[v][sp]),
                    int(self.C[v]) + int(self.occ[v][ep]),
                    mm,
                )

        rec(L - 1, 0, self.n, 0)
        best: dict[int, int] = {}
        for sp, ep, m in results:
            for r in range(sp, ep):
                p = int(self.sa[r])
                if p not in best or m < best[p]:
                    best[p] = m
        return sorted(best.items())

    # ---------------- L5 driver (SURVEY.md §3.2/§3.5) ----------------

    def align_read(self, seq: str, k: int = 0) -> list[Hit]:
        """Align one read on both strands; full deduped sorted hit list."""
        codes, mask = dna.encode_with_mask(seq)
        hits: list[Hit] = []
        for strand in ("+", "-"):
            pc, pm = (codes, mask) if strand == "+" else dna.revcomp_codes(codes, mask)
            if k == 0:
                sp, ep = self.backward_search(pc, pm)
                hits.extend(Hit(nm=0, strand=strand, pos=p) for p in self.locate_range(sp, ep))
            else:
                hits.extend(
                    Hit(nm=m, strand=strand, pos=p)
                    for p, m in self.inexact_search(pc, k, pm)
                )
        return sort_hits(hits)


def select_primary(hits: list[Hit]) -> tuple[Hit | None, int]:
    """Pinned primary-hit rule: first hit in report order; MAPQ 37 if the
    best-nm hit is unique (across both strands) else 0."""
    if not hits:
        return None, 0
    primary = hits[0]
    n_best = sum(1 for h in hits if h.nm == primary.nm)
    return primary, (37 if n_best == 1 else 0)
