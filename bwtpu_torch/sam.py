# Copy of bwtpu/sam.py for the port; only its imports differ (tests/test_torch_hostcopy.py).
"""SAM-equivalent emission (layer L0, component C14 — SURVEY.md §2.1, §3.3).

Shared by the golden model and the TPU engine so formatting can never
drift; the parity surface is the (read-id, position, strand, nm) tuples
plus this formatter. Output follows SURVEY.md §3.3:
QNAME FLAG(16 if rev) RNAME POS(1-based) MAPQ CIGAR=<L>M RNEXT PNEXT
TLEN SEQ QUAL NM:i:<nm>.
"""

from __future__ import annotations

from typing import Iterable, TextIO

from bwtpu_torch import dna
from bwtpu_torch.golden import Hit, select_primary
from bwtpu_torch.io import Contig, Read, resolve_position

FLAG_PAIRED = 0x1
FLAG_PROPER = 0x2
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_REVERSE = 0x10
FLAG_MATE_REVERSE = 0x20
FLAG_READ1 = 0x40
FLAG_READ2 = 0x80


def sam_header(contigs: list[Contig], extra: Iterable[str] = ()) -> str:
    lines = ["@HD\tVN:1.6\tSO:unsorted"]
    lines += [f"@SQ\tSN:{c.name}\tLN:{c.length}" for c in contigs]
    lines += ["@PG\tID:bwtpu\tPN:bwtpu\tVN:0.1.0"]
    lines += list(extra)
    return "\n".join(lines) + "\n"


def _record(
    read: Read,
    hit: Hit | None,
    mapq: int,
    contigs: list[Contig],
    flag_extra: int = 0,
    rnext: str = "*",
    pnext: int = 0,
    tlen: int = 0,
    tag: str | None = None,
) -> str:
    qual = read.qual if read.qual else "*"
    if hit is None:
        flag = FLAG_UNMAPPED | flag_extra
        return "\t".join(
            [read.rid, str(flag), "*", "0", "0", "*", rnext, str(pnext), "0",
             read.seq, qual]
        )
    resolved = resolve_position(contigs, hit.pos, len(read.seq))
    if resolved is None:
        # hit spans a contig boundary (concatenation artifact) — unmapped
        flag = FLAG_UNMAPPED | flag_extra
        return "\t".join(
            [read.rid, str(flag), "*", "0", "0", "*", rnext, str(pnext), "0",
             read.seq, qual]
        )
    rname, pos0 = resolved
    flag = flag_extra
    seq, q = read.seq, qual
    if hit.strand == "-":
        flag |= FLAG_REVERSE
        seq = dna.revcomp_str(read.seq)
        q = qual[::-1] if qual != "*" else "*"
    cigar = f"{len(read.seq)}M"
    fields = [read.rid, str(flag), rname, str(pos0 + 1), str(mapq), cigar,
              rnext, str(pnext), str(tlen), seq, q, f"NM:i:{hit.nm}"]
    if tag:
        fields.append(tag)
    return "\t".join(fields)


def emit_sam(
    reads: list[Read],
    hits_per_read: list[list[Hit]],
    contigs: list[Contig],
    out: TextIO,
    header: bool = True,
    tags_per_read: list[str | None] | None = None,
):
    """Single-end emission: one primary record per read (pinned rule).

    tags_per_read: optional extra SAM tag (e.g. "AS:i:40") appended to
    each read's record when mapped (cli align --rescore)."""
    if header:
        out.write(sam_header(contigs))
    for i, (read, hits) in enumerate(zip(reads, hits_per_read)):
        primary, mapq = select_primary(hits)
        tag = tags_per_read[i] if tags_per_read else None
        out.write(_record(read, primary, mapq, contigs, tag=tag) + "\n")


def pair_and_emit_sam(
    pairs: list[tuple[Read, Read]],
    hits1: list[list[Hit]],
    hits2: list[list[Hit]],
    contigs: list[Contig],
    out: TextIO,
    min_insert: int = 0,
    max_insert: int = 1000,
    header: bool = True,
    tags1: list[str | None] | None = None,
    tags2: list[str | None] | None = None,
):
    """Paired-end pairing + emission (config 5, SURVEY.md §3.5).

    Pinned pairing rule: a proper pair has mates on opposite strands in
    FR orientation (the '+' mate starts before the '-' mate ends) with
    insert size (outer distance) in [min_insert, max_insert]; among
    proper pairs pick the one minimizing nm1 + nm2, ties broken by
    (leftmost '+' position, then leftmost mate position). If no proper
    pair exists, each mate falls back to its independent primary hit.

    tags1/tags2: optional extra SAM tag per pair for mate 1 / mate 2
    (e.g. "xo:i:1" truncation marks from the distributed engine).
    """
    if header:
        out.write(sam_header(contigs))
    for pi, ((r1, r2), h1s, h2s) in enumerate(zip(pairs, hits1, hits2)):
        t1 = tags1[pi] if tags1 else None
        t2 = tags2[pi] if tags2 else None
        best = None  # (score_tuple, hit1, hit2, tlen)
        for h1 in h1s:
            for h2 in h2s:
                if h1.strand == h2.strand:
                    continue
                fwd, rev = (h1, h2) if h1.strand == "+" else (h2, h1)
                fwd_len = len(r1.seq) if fwd is h1 else len(r2.seq)
                rev_len = len(r2.seq) if rev is h2 else len(r1.seq)
                if rev.pos + rev_len <= fwd.pos:
                    continue  # not FR orientation
                insert = rev.pos + rev_len - fwd.pos
                if not (min_insert <= insert <= max_insert):
                    continue
                key = (h1.nm + h2.nm, fwd.pos, min(h1.pos, h2.pos))
                if best is None or key < best[0]:
                    best = (key, h1, h2, insert)
        base1 = FLAG_PAIRED | FLAG_READ1
        base2 = FLAG_PAIRED | FLAG_READ2
        if best is not None:
            _, h1, h2, insert = best
            tlen1 = insert if h1.strand == "+" else -insert
            p1 = resolve_position(contigs, h1.pos, len(r1.seq))
            p2 = resolve_position(contigs, h2.pos, len(r2.seq))
            proper = FLAG_PROPER if (p1 and p2 and p1[0] == p2[0]) else 0
            f1 = base1 | proper | (FLAG_MATE_REVERSE if h2.strand == "-" else 0)
            f2 = base2 | proper | (FLAG_MATE_REVERSE if h1.strand == "-" else 0)
            rn1, pn1 = ("=", p2[1] + 1) if (p1 and p2 and p1[0] == p2[0]) else (
                (p2[0], p2[1] + 1) if p2 else ("*", 0)
            )
            rn2, pn2 = ("=", p1[1] + 1) if (p1 and p2 and p1[0] == p2[0]) else (
                (p1[0], p1[1] + 1) if p1 else ("*", 0)
            )
            out.write(_record(r1, h1, 37, contigs, f1, rn1, pn1, tlen1,
                              tag=t1) + "\n")
            out.write(_record(r2, h2, 37, contigs, f2, rn2, pn2, -tlen1,
                              tag=t2) + "\n")
        else:
            prim1, mq1 = select_primary(h1s)
            prim2, mq2 = select_primary(h2s)
            f1 = base1 | (FLAG_MATE_UNMAPPED if prim2 is None else 0)
            f2 = base2 | (FLAG_MATE_UNMAPPED if prim1 is None else 0)
            if prim2 is not None and prim2.strand == "-":
                f1 |= FLAG_MATE_REVERSE
            if prim1 is not None and prim1.strand == "-":
                f2 |= FLAG_MATE_REVERSE
            out.write(_record(r1, prim1, mq1, contigs, f1, tag=t1) + "\n")
            out.write(_record(r2, prim2, mq2, contigs, f2, tag=t2) + "\n")
