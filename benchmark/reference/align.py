"""The plain reference aligner, in NumPy, from the genome and the reads
alone.

What it answers is what the configuration's file states ("guarantees"):
every position p with at most k substitutions between the read (or its
reverse complement, the - strand) and genome[p:p+L], an N in the read
matching nothing; each (position, strand) once at its least nm, in the
order (read, nm, + before -, position). A read is "heavy" where, on a
strand, one of its k + 1 seeds (k = 0: the whole read) has more exact
occurrences in the genome than the capacity the configuration states:
the program must mark such a read truncated, and only such a read.

How: pigeonhole. A hit within k substitutions leaves at least one of the
k + 1 disjoint seeds exact, so every hit starts at an exact occurrence of
a seed minus the seed's offset. Exact occurrences are found by 32-base
keys: the keys of every genome position, a bitmap of the query keys'
hashes to pass few of them, then a sorted search; the seed's bases past
32 are compared after. Candidates are verified at full length.
"""

from __future__ import annotations

import dataclasses

import numpy as np

KEY = 32  # bases a key: 2 bits each fill a uint64
_MULT = np.uint64(0x9E3779B97F4A7C15)
_HASH_BITS = 26
CHUNK = 1 << 20  # rows compared at once (bounds the temporaries)


def seed_layout(L: int, n_seeds: int) -> list[tuple[int, int]]:
    """(offset, length) of n_seeds near-equal seeds, the remainder to the
    leftmost ones (the configuration's "seeds")."""
    q, r = divmod(L, n_seeds)
    out, off = [], 0
    for s in range(n_seeds):
        out.append((off, q + (1 if s < r else 0)))
        off += out[-1][1]
    return out


def genome_keys(codes: np.ndarray) -> np.ndarray:
    """uint64[n - KEY + 1]: the KEY bases from each position, the first
    base in the highest bits."""
    k = codes.astype(np.uint64)
    w = 1
    while w < KEY:
        k = (k[:-w] << np.uint64(2 * w)) | k[w:]
        w *= 2
    return k


def row_keys(codes: np.ndarray) -> np.ndarray:
    """uint64[m] keys of rows uint8[m, KEY]."""
    shifts = np.uint64(2) * np.arange(KEY - 1, -1, -1, dtype=np.uint64)
    return np.bitwise_or.reduce(codes.astype(np.uint64) << shifts, axis=1)


def _hash(keys: np.ndarray) -> np.ndarray:
    return (keys * _MULT) >> np.uint64(64 - _HASH_BITS)


class Genome:
    """The genome's codes and the key of every position."""

    def __init__(self, codes: np.ndarray):
        self.codes = np.ascontiguousarray(codes, dtype=np.uint8)
        self.n = len(self.codes)
        self.keys = genome_keys(self.codes)
        self._hashes = None

    def matches(self, qkeys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Every (query index, genome position) whose KEY bases equal the
        query's key."""
        if len(qkeys) == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        if self._hashes is None:
            with np.errstate(over="ignore"):
                self._hashes = _hash(self.keys)
        uq, inv = np.unique(qkeys, return_inverse=True)
        bitmap = np.zeros(1 << _HASH_BITS, dtype=bool)
        with np.errstate(over="ignore"):
            bitmap[_hash(uq)] = True
        cand = np.flatnonzero(bitmap[self._hashes])
        gk = self.keys[cand]
        j = np.minimum(np.searchsorted(uq, gk), len(uq) - 1)
        ok = uq[j] == gk
        gpos, u = cand[ok], j[ok]
        # expand each matched key to every query that has it
        order = np.argsort(inv, kind="stable")
        cnt = np.bincount(inv, minlength=len(uq))
        first = np.cumsum(cnt) - cnt
        rep = cnt[u]
        within = np.arange(rep.sum()) - np.repeat(np.cumsum(rep) - rep, rep)
        return order[np.repeat(first[u], rep) + within], np.repeat(gpos, rep)

    def nm(self, ocodes: np.ndarray, oamb: np.ndarray, rows: np.ndarray,
           pos: np.ndarray) -> np.ndarray:
        """int64 mismatches of oriented rows[i] at pos[i] (an N counts);
        -1 where the window leaves the genome."""
        L = ocodes.shape[1]
        out = np.full(len(pos), -1, dtype=np.int64)
        inside = np.flatnonzero((pos >= 0) & (pos <= self.n - L))
        win = np.lib.stride_tricks.sliding_window_view(self.codes, L)
        for lo in range(0, len(inside), CHUNK):
            i = inside[lo:lo + CHUNK]
            diff = (win[pos[i]] != ocodes[rows[i]]) | oamb[rows[i]]
            out[i] = diff.sum(1)
        return out


@dataclasses.dataclass
class Answer:
    """The reference's answer for m reads."""

    heavy: np.ndarray  # bool[m]
    # hits of the reads that are not heavy, in report order
    read: np.ndarray  # int64[h]
    pos: np.ndarray  # int64[h]
    rev: np.ndarray  # bool[h]
    nm: np.ndarray  # int64[h]


def codes_of(seq: np.ndarray):
    """(codes uint8, N mask bool) of ASCII reads uint8[m, L]; anything but
    ACGT is an N."""
    lut = np.zeros(256, dtype=np.uint8)
    for i, b in enumerate(b"ACGT"):
        lut[b] = i
    return lut[seq], ~np.isin(seq, np.frombuffer(b"ACGT", np.uint8))


def oriented(codes: np.ndarray, amb: np.ndarray):
    """Rows [0, m) the reads, [m, 2m) their reverse complements."""
    return (np.concatenate([codes, 3 - codes[:, ::-1]]),
            np.concatenate([amb, amb[:, ::-1]]))


def align(genome: Genome, codes: np.ndarray, amb: np.ndarray, k: int,
          capacity: int) -> Answer:
    """The reference answer for reads codes uint8[m, L] (A=0 .. T=3) with
    N at amb bool[m, L]; capacity: the most exact occurrences a seed may
    have before its read is heavy."""
    m, L = codes.shape
    oc, oa = oriented(codes, amb)
    seeds = [(0, L)] if k == 0 else seed_layout(L, k + 1)
    if min(s for _, s in seeds) < KEY:
        raise ValueError(f"seeds {seeds} shorter than the {KEY}-base key")
    # queries: (oriented row, seed) with no N in the seed
    q_row, q_off, q_len = [], [], []
    for off, slen in seeds:
        ok = ~oa[:, off:off + slen].any(1)
        rows = np.flatnonzero(ok)
        q_row.append(rows)
        q_off.append(np.full(len(rows), off))
        q_len.append(np.full(len(rows), slen))
    q_row, q_off, q_len = (np.concatenate(x) for x in (q_row, q_off, q_len))
    keys = row_keys(oc[q_row[:, None], q_off[:, None] + np.arange(KEY)])
    qi, gpos = genome.matches(keys)
    # the seed's bases past the key, where it has any
    full = gpos + q_len[qi] <= genome.n
    ext = int(q_len.max()) - KEY
    if ext > 0:
        win = np.lib.stride_tricks.sliding_window_view(
            np.concatenate([genome.codes, np.zeros(ext, np.uint8)]), ext)
        for lo in range(0, len(qi), CHUNK):
            s = slice(lo, lo + CHUNK)
            q, g = qi[s], gpos[s]
            cols = q_off[q, None] + KEY + np.arange(ext)
            want = oc[q_row[q, None], np.minimum(cols, L - 1)]
            eq = (win[g + KEY] == want) | (cols >= (q_off[q] + q_len[q])[:, None])
            full[s] &= eq.all(1)
    qi, gpos = qi[full], gpos[full]
    count = np.bincount(qi, minlength=len(q_row))
    heavy = np.zeros(m, dtype=bool)
    heavy[q_row[count > capacity] % m] = True
    # candidates of the other reads, verified at full length
    keep = ~heavy[q_row[qi] % m]
    row, start = q_row[qi[keep]], gpos[keep] - q_off[qi[keep]]
    pair = np.unique(np.stack([row, start], 1), axis=0) if len(row) else np.zeros((0, 2), np.int64)
    row, start = pair[:, 0], pair[:, 1]
    nm = genome.nm(oc, oa, row, start)
    hit = (nm >= 0) & (nm <= k)
    row, start, nm = row[hit], start[hit], nm[hit]
    read, rev = row % m, row >= m
    order = np.lexsort((start, rev, nm, read))
    return Answer(heavy, read[order], start[order], rev[order], nm[order])
