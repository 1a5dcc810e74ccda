"""The comparison that decides `correct`: what the timed path produced,
against the plain reference (reference/), once the window has closed.

During the window the check only keeps things: for every align block done,
the results of the sampled reads (gen.reads.sample_reads: the same reads
of each pool block in every pass); for sam, the records of a seeded
reservoir of the chunks done. After the window the reference answers the
sampled reads once, and every kept result is held against it:

  wrong_reads          sampled reads, counted once per block or chunk done,
                       whose answer breaks a guarantee: an unmarked read whose
                       hits (or SAM record) differ from the reference's in any
                       way, or that the reference finds heavy; a read marked
                       truncated (xo:i:1) with a hit (or primary) that is not
                       where it says at the nm it says
  extra_marked_permille  marked reads that the reference does not find heavy,
                       per 1,000 sampled reads: the block-level capacities
                       (the compaction cap, the finisher's cap) may mark them
                       too, as the configuration allows, but heals left
                       undone raise it
  checked_reads        sampled reads compared (at least one)

The limits are the cell's, in benchmark/limits/<cell>.json: wrong_reads
exact (0: every stage on the path is integer), extra_marked_permille set
between what sound runs and the controls read, checked_reads at least 1
(a run that checks nothing is not correct).
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import align as ref_align
from benchmark.reference import sam as ref_sam


def capacity(cfg: dict, k: int) -> int:
    """The most exact occurrences a seed (k = 0: the read) may have before
    its read is heavy: the configuration's max_cand (max_hits) doubled at
    each of its max_heals heals."""
    b = cfg["build_index"]
    return (b["max_cand"] if k else b["max_hits"]) << cfg["guarantees"]["max_heals"]


def _ranges(lo: np.ndarray, cnt: np.ndarray) -> np.ndarray:
    """Concatenated arange(lo[i], lo[i] + cnt[i])."""
    return np.repeat(lo, cnt) + (np.arange(cnt.sum()) - np.repeat(np.cumsum(cnt) - cnt, cnt))


class Reference:
    """The reference's answer for the sampled reads of every pool block."""

    def __init__(self, genome: ref_align.Genome, pool, sample: np.ndarray, k: int, cap: int):
        P, S = sample.shape
        self.B, self.S, self.k = pool.block_reads, S, k
        self.idx = (np.arange(P)[:, None] * pool.block_reads + sample).reshape(-1)
        self.seq, self.qual = pool.seq[self.idx], pool.qual[self.idx]
        codes, amb = ref_align.codes_of(self.seq)
        self.genome = genome
        self.ans = ref_align.align(self.genome, codes, amb, k, cap)
        self.oc, self.oa = ref_align.oriented(codes, amb)
        m = len(self.idx)
        self.cnt = np.bincount(self.ans.read, minlength=m)
        self.first = np.cumsum(self.cnt) - self.cnt

    def block(self, b: int):
        """(heavy, per-read counts, hit rows) of pool block b's sample."""
        s = slice(b * self.S, (b + 1) * self.S)
        return self.ans.heavy[s], self.cnt[s], _ranges(self.first[s], self.cnt[s])

    def sound(self, reads: np.ndarray, pos: np.ndarray, rev: np.ndarray,
              nm: np.ndarray) -> np.ndarray:
        """bool: hit (pos, rev) of sample read `reads` is at nm <= k."""
        m = len(self.idx)
        got = self.genome.nm(self.oc, self.oa, reads + m * rev.astype(np.int64), pos)
        return (got == nm) & (nm <= self.k)


class AlignCheck:
    """Keeps the sampled reads' FlatHits columns of every block done."""

    def __init__(self, sample: np.ndarray):
        self.sample = sample
        self.got = []

    def on_done(self, b: int, flat) -> None:
        s = self.sample[b]
        lo = np.searchsorted(flat.read_idx, s, "left")
        cnt = np.searchsorted(flat.read_idx, s, "right") - lo
        i = _ranges(lo, cnt)
        mark = (flat.truncated[s] if flat.truncated is not None
                else np.zeros(len(s), dtype=bool))
        self.got.append((b, cnt, flat.pos[i], flat.strand_rev[i], flat.nm[i], mark))

    def judge(self, ref: Reference) -> dict:
        wrong = checked = extra = 0
        for b, cnt, pos, rev, nm, mark in self.got:
            heavy, rcnt, rows = ref.block(b)
            bad = ~mark & heavy
            clear = ~mark & ~heavy
            bad |= clear & (cnt != rcnt)
            # unmarked reads whose counts agree: their hits line up in report order
            same = clear & (cnt == rcnt)
            read_of = np.repeat(np.arange(len(cnt)), cnt)
            take = same[read_of]
            rtake = same[np.repeat(np.arange(len(rcnt)), rcnt)]
            r = rows[rtake]
            diff = ((pos[take] != ref.ans.pos[r]) | (rev[take] != ref.ans.rev[r])
                    | (nm[take] != ref.ans.nm[r]))
            bad[read_of[take][diff]] = True
            # marked reads: every hit sound
            hit_of = mark[read_of]
            ok = ref.sound(b * ref.S + read_of[hit_of], pos[hit_of], rev[hit_of],
                           nm[hit_of].astype(np.int64))
            bad[read_of[hit_of][~ok]] = True
            wrong += int(bad.sum())
            extra += int((mark & ~heavy).sum())
            checked += len(cnt)
        return _numbers(wrong, extra, checked)


class SamCheck:
    """Keeps a seeded reservoir of `keep` SAM chunks."""

    def __init__(self, sample: np.ndarray, keep: int, seed: int):
        self.sample, self.keep = sample, keep
        self.rng = np.random.default_rng(np.random.SeedSequence([seed % 2**64, 2]))
        self.kept: list = []
        self.seen = 0

    def on_done(self, j: int, blob: bytes) -> None:
        self.seen += 1
        if len(self.kept) < self.keep:
            self.kept.append((j, blob))
        else:
            r = int(self.rng.integers(0, self.seen))
            if r < self.keep:
                self.kept[r] = (j, blob)

    def judge(self, ref: Reference, contig: bytes) -> dict:
        wrong = checked = extra = 0
        for j, blob in self.kept:
            lines = blob.split(b"\n")
            heavy, rcnt, rows = ref.block(j)
            starts = np.cumsum(rcnt) - rcnt
            for i, s in enumerate(self.sample[j]):
                checked += 1
                r = j * ref.S + i
                qname = b"r%09d" % ref.idx[r]
                seq, qual = ref.seq[r].tobytes(), ref.qual[r].tobytes()
                line = lines[s] if s < len(lines) - 1 else b""
                if line.endswith(b"\txo:i:1"):
                    extra += not heavy[i]
                    got = ref_sam.parse_truncated(line, qname, seq, qual, contig)
                    wrong += got is None or (got != () and not ref.sound(
                        np.array([r]), np.array([got[0]]), np.array([got[1]]),
                        np.array([got[2]]))[0])
                    continue
                h = rows[starts[i]:starts[i] + rcnt[i]]
                hits = list(zip(ref.ans.pos[h].tolist(), ref.ans.rev[h].tolist(),
                                ref.ans.nm[h].tolist()))
                wrong += heavy[i] or line != ref_sam.record(qname, seq, qual, contig, hits,
                                                            False)
        return _numbers(int(wrong), int(extra), checked)


def _numbers(wrong: int, extra: int, checked: int) -> dict:
    return {"wrong_reads": wrong,
            "extra_marked_permille": 1000.0 * extra / checked if checked else 0.0,
            "checked_reads": checked}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "max" or "min"}}) for the numbers the
    cell's limits name: {name: {"max": x} or {"min": x}}."""
    out, ok = {}, True
    for name, lim in limits.items():
        (side, limit), v = next(iter(lim.items())), numbers[name]
        ok &= v <= limit if side == "max" else v >= limit
        out[name] = {"value": v, side: limit}
    return bool(ok), out
