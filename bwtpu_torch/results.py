# Port of bwtpu/results.py: its imports differ, and flatten_hits differs in method (one packed
# int64 key, two value sorts) while its FlatHits are held field- and dtype-equal to
# bwtpu.results.flatten_hits by tests (test_torch_hostcopy.py, test_torch_assemble.py).
"""Vectorized hit assembly and primary-hit selection (host side).

Round-2 measurement (VERDICT r2 "what's missing" #1): the per-hit Python
dict loop in the old assembler cost 1.30 s per 262 K-read batch — a
~0.20 M reads/s host ceiling 20x below the device rate. This module is
the array re-design: the whole batch's hits live in flat NumPy columns
(read index, global position, strand, mismatch count) and every step —
shard/bounds filtering, (read, pos, strand) dedupe with min-nm, pinned
report ordering, primary selection, MAPQ uniqueness, contig resolution
— is one vectorized pass. Semantics are pinned by bwtpu.golden
(sort_hits / select_primary) and bwtpu.io.resolve_position; parity is
asserted in tests/test_fastpath.py.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from bwtpu_torch import trace
from bwtpu_torch.golden import Hit, sort_hits
from bwtpu_torch.io import Contig


class FlatHits(NamedTuple):
    """Deduped hits in the pinned report order: sorted by read index,
    then (nm, '+' before '-', pos) within a read (golden.sort_hits)."""

    read_idx: np.ndarray  # int32[n_hits], non-decreasing
    pos: np.ndarray  # int64[n_hits] concatenated-genome position
    strand_rev: np.ndarray  # bool[n_hits]
    nm: np.ndarray  # int32[n_hits]
    n_reads: int
    # bool[n_reads] reads whose results are still capacity-truncated
    # after the engine's bounded self-healing retries (engine.finish_
    # block); None = no truncation. SAM emitters tag these xo:i:1.
    truncated: np.ndarray | None = None


class Primary(NamedTuple):
    """Per-read primary-hit arrays (golden.select_primary semantics)."""

    mapped: np.ndarray  # bool[n]
    pos: np.ndarray  # int64[n] (valid where mapped)
    strand_rev: np.ndarray  # bool[n]
    nm: np.ndarray  # int32[n]
    mapq: np.ndarray  # int32[n] 37 if the best-nm hit is unique else 0


def _key_widths(n_reads: int, text_lens, offsets, max_nm: int) -> tuple[int, int]:
    """(wg, wm): the bits of a global position and of an nm in the packed
    key, from the genome's extent and the largest nm. The read takes the
    bits of n_reads - 1 and the strand one; ValueError past 63 in all."""
    ends = np.asarray(offsets, dtype=np.int64) + np.asarray(text_lens, dtype=np.int64)
    end = int(ends.max(initial=0))
    wr = max(n_reads - 1, 0).bit_length()
    wg = end.bit_length()
    wm = max(int(max_nm), 1).bit_length()
    if wr + 1 + wg + wm > 63:
        raise ValueError(
            f"hit key needs {wr} + 1 + {wg} + {wm} bits (read, strand, genome position up to "
            f"{end}, nm up to {int(max_nm)}): more than the 63 of an int64")
    return wg, wm


def _pack(b, sr, gpos, m, wg: int, wm: int) -> np.ndarray:
    """int64 dedupe keys read | strand | gpos | nm (fields that fit their widths)."""
    key = b.astype(np.int64) << (1 + wg + wm)
    key |= sr.astype(np.int64) << (wg + wm)
    key |= gpos << wm
    key |= m
    return key


def _flat_from_keys(key: np.ndarray, n_reads: int, wg: int, wm: int) -> FlatHits:
    """Packed dedupe keys (any order) -> deduped, report-ordered FlatHits.

    One value sort groups each (read, strand, pos) with its smallest nm
    first; the first of each run of equal key >> wm is kept. The survivors
    are unique, so a value sort of the repacked key read | nm | strand |
    gpos is exactly golden.sort_hits' order, with no argsort or gather.
    Counters assemble_keys (keys sorted) and assemble_dupes (removed)."""
    n_in = len(key)
    key.sort()
    if n_in > 1:
        loc = key >> wm
        first = np.empty(n_in, dtype=bool)
        first[0] = True
        np.not_equal(loc[1:], loc[:-1], out=first[1:])
        key = key[first]
    trace.count("assemble_keys", n_in)
    trace.count("assemble_dupes", n_in - len(key))
    lo = 1 + wg  # strand | gpos
    top = key >> (lo + wm)
    key = (top << (lo + wm)) | ((key & ((1 << wm) - 1)) << lo) | ((key >> wm) & ((1 << lo) - 1))
    key.sort()
    return FlatHits(
        read_idx=(key >> (lo + wm)).astype(np.int32),
        pos=key & ((1 << wg) - 1),
        strand_rev=(key & (1 << wg)) != 0,
        nm=((key >> lo) & ((1 << wm) - 1)).astype(np.int32),
        n_reads=n_reads,
    )


def flatten_hits(
    n_reads: int,
    read_lens,  # int array [n_reads] or scalar (uniform length)
    B: int,
    s_idx: np.ndarray,
    row_idx: np.ndarray,
    p: np.ndarray,
    m: np.ndarray,
    text_lens,
    offsets,
) -> FlatHits:
    """Raw per-shard device outputs -> deduped, report-ordered FlatHits.

    row_idx: read-strand row (rows [0, B) forward, [B, 2B) reverse);
    p: shard-local candidate position; m: mismatch count. Rows >= the
    live read count and out-of-bounds positions are dropped; duplicates
    on (read, pos, strand) keep the minimum nm (duplicates arise from
    different seed slots hitting the same locus). Sorted as one packed
    int64 key (_flat_from_keys); ValueError where the fields exceed 63
    bits or an nm is negative."""
    p = np.asarray(p, dtype=np.int64)
    row_idx, m = np.asarray(row_idx), np.asarray(m)
    b = row_idx % B
    keep = b < n_reads
    rl = np.asarray(read_lens, dtype=np.int64)
    if rl.ndim:
        rl = rl[np.where(keep, b, 0)] if rl.size else 0  # no read: keep is all False
    keep &= (p >= 0) & (p + rl <= np.asarray(text_lens, dtype=np.int64)[s_idx])
    b, sr, m = b[keep], row_idx[keep] >= B, m[keep]
    gpos = np.asarray(offsets, dtype=np.int64)[s_idx[keep]] + p[keep]
    if m.min(initial=0) < 0:
        raise ValueError(f"negative nm {int(m.min())} in the hits")
    wg, wm = _key_widths(n_reads, text_lens, offsets, m.max(initial=0))
    return _flat_from_keys(_pack(b, sr, gpos, m, wg, wm), n_reads, wg, wm)


def flatten_hit_buffers(n_reads: int, read_len: int, B: int, Ct: int, k: int,
                        shard_hits, text_lens, offsets) -> FlatHits:
    """Each shard's fetched hit buffer (cand, hm, count) -> FlatHits, as
    flatten_hits would give from its columns, with no columns built.

    cand: shard-local candidate position; hm = lane * 4 + nm, the lane's
    read-strand row lane // Ct ([0, B) forward, [B, 2B) reverse); lanes
    from count on are not hits. The same filters as flatten_hits, and nm
    <= k; every read read_len long."""
    wg, wm = _key_widths(n_reads, text_lens, offsets, k)
    keys = []
    for off, tl, (cand, hm, count) in zip(offsets, text_lens, shard_hits):
        cand, hm = cand[:count], hm[:count]
        nm = hm & 3
        row = (hm >> 2) // Ct
        sr = row >= B
        b = row - sr * B
        p = cand.astype(np.int64)
        keep = (nm <= k) & (b < n_reads) & (p >= 0) & (p + read_len <= tl)
        # packed first and cut once: a dropped lane's fields may not fit, but only its own key
        keys.append(_pack(b, sr, p + off, nm, wg, wm)[keep])
    key = np.concatenate(keys) if keys else np.zeros(0, np.int64)
    return _flat_from_keys(key, n_reads, wg, wm)


def hit_lists(flat: FlatHits) -> list[list[Hit]]:
    """FlatHits -> per-read Hit lists (already deduped + sorted)."""
    out: list[list[Hit]] = [[] for _ in range(flat.n_reads)]
    for b, gp, sr, mm in zip(
        flat.read_idx.tolist(), flat.pos.tolist(),
        flat.strand_rev.tolist(), flat.nm.tolist(),
    ):
        out[b].append(Hit(nm=mm, strand="-" if sr else "+", pos=gp))
    return out


def flat_from_hit_lists(hits_per_read: list[list[Hit]]) -> FlatHits:
    """Inverse of hit_lists (testing / adapters for Hit-list producers)."""
    n = len(hits_per_read)
    b = np.array(
        [i for i, hs in enumerate(hits_per_read) for _ in hs], dtype=np.int32
    )
    flat_hits = [h for hs in hits_per_read for h in sort_hits(hs)]
    return FlatHits(
        read_idx=b,
        pos=np.array([h.pos for h in flat_hits], dtype=np.int64),
        strand_rev=np.array([h.strand == "-" for h in flat_hits], dtype=bool),
        nm=np.array([h.nm for h in flat_hits], dtype=np.int32),
        n_reads=n,
    )


def select_primary_flat(flat: FlatHits) -> Primary:
    """Vectorized golden.select_primary over every read at once.

    flat is in report order, so each read's first hit is its primary;
    MAPQ is 37 iff exactly one hit carries the read's best nm."""
    n = flat.n_reads
    b, m = flat.read_idx, flat.nm
    nh = len(b)
    mapped = np.zeros(n, dtype=bool)
    pos = np.zeros(n, dtype=np.int64)
    sr = np.zeros(n, dtype=bool)
    nm = np.zeros(n, dtype=np.int32)
    mapq = np.zeros(n, dtype=np.int32)
    if nh == 0:
        return Primary(mapped, pos, sr, nm, mapq)

    read_first = np.ones(nh, dtype=bool)
    read_first[1:] = b[1:] != b[:-1]
    fi = np.flatnonzero(read_first)  # first-hit index per mapped read
    rb = b[fi]
    mapped[rb] = True
    pos[rb] = flat.pos[fi]
    sr[rb] = flat.strand_rev[fi]
    nm[rb] = m[fi]

    # best-nm multiplicity: runs of equal (read, nm); each read's first
    # run is its best-nm group
    assert m.max(initial=0) < 8, "nm exceeds packed key width"
    kb = b.astype(np.int64) * 8 + m
    run_start = np.ones(nh, dtype=bool)
    run_start[1:] = kb[1:] != kb[:-1]
    starts = np.flatnonzero(run_start)
    lengths = np.diff(np.append(starts, nh))
    # fi values are all run starts; find each in `starts`
    n_best = lengths[np.searchsorted(starts, fi)]
    mapq[rb] = np.where(n_best == 1, 37, 0)
    return Primary(mapped, pos, sr, nm, mapq)


def split_flat(flat: FlatHits, n1: int) -> tuple[FlatHits, FlatHits]:
    """Split a stacked-batch FlatHits (reads [0, n1) = mate 1, rest =
    mate 2) into per-mate FlatHits; read_idx is non-decreasing, so the
    split is one searchsorted."""
    cut = int(np.searchsorted(flat.read_idx, n1))
    t1 = t2 = None
    if flat.truncated is not None:
        t1, t2 = flat.truncated[:n1], flat.truncated[n1:]
    f1 = FlatHits(flat.read_idx[:cut], flat.pos[:cut],
                  flat.strand_rev[:cut], flat.nm[:cut], n1, t1)
    f2 = FlatHits((flat.read_idx[cut:] - n1).astype(np.int32),
                  flat.pos[cut:], flat.strand_rev[cut:], flat.nm[cut:],
                  flat.n_reads - n1, t2)
    return f1, f2


class PairChoice(NamedTuple):
    """Per-pair proper-pair selection (golden pair_and_emit_sam rule)."""

    i1: np.ndarray  # int64[n] index into flat1 arrays; -1 = no proper pair
    i2: np.ndarray  # int64[n] index into flat2 arrays
    tlen1: np.ndarray  # int64[n] signed insert for mate 1 (valid i1 >= 0)


def select_pairs(
    flat1: FlatHits, flat2: FlatHits, L1: int, L2: int,
    min_insert: int, max_insert: int,
) -> PairChoice:
    """Vectorized twin of bwtpu.sam.pair_and_emit_sam's pairing loop.

    Pinned rule: proper pair = mates on opposite strands, FR
    orientation (the '-' mate's end past the '+' mate's start), outer
    insert in [min_insert, max_insert]; minimize (nm1+nm2, fwd pos,
    min mate pos), remaining ties broken by hit-list iteration order
    (mate-1-major) — reproduced here as a final (i1, i2) lexsort key so
    output is byte-identical to the per-pair Python loop
    (tests/test_fastpath.py)."""
    n = flat1.n_reads
    out_i1 = np.full(n, -1, dtype=np.int64)
    out_i2 = np.full(n, -1, dtype=np.int64)
    out_tlen = np.zeros(n, dtype=np.int64)
    c1 = np.bincount(flat1.read_idx, minlength=n).astype(np.int64)
    c2 = np.bincount(flat2.read_idx, minlength=n).astype(np.int64)
    o1 = np.zeros(n, dtype=np.int64)
    o1[1:] = np.cumsum(c1)[:-1]
    o2 = np.zeros(n, dtype=np.int64)
    o2[1:] = np.cumsum(c2)[:-1]
    m = c1 * c2
    total = int(m.sum())
    if total == 0:
        return PairChoice(out_i1, out_i2, out_tlen)
    seg = np.repeat(np.arange(n, dtype=np.int64), m)
    mo = np.zeros(n, dtype=np.int64)
    mo[1:] = np.cumsum(m)[:-1]
    t = np.arange(total, dtype=np.int64) - mo[seg]
    i1 = o1[seg] + t // c2[seg]
    i2 = o2[seg] + t % c2[seg]
    s1 = flat1.strand_rev[i1]
    s2 = flat2.strand_rev[i2]
    p1 = flat1.pos[i1]
    p2 = flat2.pos[i2]
    fwd_pos = np.where(~s1, p1, p2)
    rev_end = np.where(~s1, p2 + L2, p1 + L1)
    insert = rev_end - fwd_pos
    ok = (
        (s1 != s2) & (rev_end > fwd_pos)
        & (insert >= min_insert) & (insert <= max_insert)
    )
    if not ok.any():
        return PairChoice(out_i1, out_i2, out_tlen)
    seg, i1, i2 = seg[ok], i1[ok], i2[ok]
    insert, fwd_pos, s1 = insert[ok], fwd_pos[ok], s1[ok]
    nmsum = flat1.nm[i1] + flat2.nm[i2]
    minp = np.minimum(flat1.pos[i1], flat2.pos[i2])
    order = np.lexsort((i2, i1, minp, fwd_pos, nmsum, seg))
    seg_o = seg[order]
    first = np.ones(len(seg_o), dtype=bool)
    first[1:] = seg_o[1:] != seg_o[:-1]
    sel = order[first]
    ssel = seg[sel]
    out_i1[ssel] = i1[sel]
    out_i2[ssel] = i2[sel]
    out_tlen[ssel] = np.where(~s1[sel], insert[sel], -insert[sel])
    return PairChoice(out_i1, out_i2, out_tlen)


class ContigTable(NamedTuple):
    """Vectorized twin of bwtpu.io.resolve_position."""

    starts: np.ndarray  # int64[n_contigs]
    ends: np.ndarray  # int64[n_contigs]
    name_blob: bytes
    name_off: np.ndarray  # int64[n_contigs + 1]

    @classmethod
    def build(cls, contigs: list[Contig]) -> "ContigTable":
        starts = np.array([c.offset for c in contigs], dtype=np.int64)
        ends = np.array([c.offset + c.length for c in contigs], dtype=np.int64)
        names = [c.name.encode() for c in contigs]
        off = np.zeros(len(names) + 1, dtype=np.int64)
        off[1:] = np.cumsum([len(nm_) for nm_ in names])
        return cls(starts, ends, b"".join(names), off)

    def resolve(self, gpos: np.ndarray, lens) -> tuple[np.ndarray, np.ndarray]:
        """(contig id int32 or -1 if boundary-crossing/out of range,
        contig-local 0-based position int64). Matches resolve_position:
        a window crossing a contig boundary resolves to nothing."""
        cidx = np.searchsorted(self.starts, gpos, side="right") - 1
        cidx = np.clip(cidx, 0, len(self.starts) - 1)
        ok = (gpos >= self.starts[cidx]) & (gpos + lens <= self.ends[cidx])
        return (
            np.where(ok, cidx, -1).astype(np.int32),
            (gpos - self.starts[cidx]).astype(np.int64),
        )
