"""The plain reference of a read's SAM record (the configuration's "sam"
guarantee), from the reference's hits and the read as generated.

One record a read, tab-separated: QNAME FLAG RNAME POS MAPQ CIGAR RNEXT
PNEXT TLEN SEQ QUAL, then NM:i:<nm> when mapped, then xo:i:1 when the
read is marked truncated. The primary is the first hit in report order;
MAPQ is 37 if no other hit has its nm, else 0; on the - strand FLAG is 16
and SEQ and QUAL are the reverse complement and the reverse. A read with
no hit is unmapped: FLAG 4, "*" for RNAME and CIGAR, 0 for POS and MAPQ.
The genome is one contig, so a hit's POS is its position plus one.
"""

from __future__ import annotations

_COMP = bytes.maketrans(b"ACGTN", b"TGCAN")


def record(qname: bytes, seq: bytes, qual: bytes, contig: bytes, hits,
           truncated: bool) -> bytes:
    """hits: (pos, rev, nm) tuples of one read in report order."""
    xo = b"\txo:i:1" if truncated else b""
    if not hits:
        return b"\t".join([qname, b"4", b"*", b"0", b"0", b"*", b"*", b"0", b"0",
                           seq, qual]) + xo
    pos, rev, nm = hits[0]
    mapq = 37 if sum(1 for h in hits if h[2] == nm) == 1 else 0
    if rev:
        seq, qual = seq[::-1].translate(_COMP), qual[::-1]
    return b"\t".join([qname, b"16" if rev else b"0", contig, b"%d" % (pos + 1),
                       b"%d" % mapq, b"%dM" % len(seq), b"*", b"0", b"0", seq, qual,
                       b"NM:i:%d" % nm]) + xo


def parse_truncated(line: bytes, qname: bytes, seq: bytes, qual: bytes,
                    contig: bytes):
    """A truncated read's record: its primary may come from part of its hits,
    so only its form is fixed. Returns None if the form is wrong, else the
    (pos, rev, nm) it reports, or () when unmapped."""
    f = line.split(b"\t")
    if len(f) < 12 or f[0] != qname or f[-1] != b"xo:i:1":
        return None
    if f[1] == b"4":
        ok = f[2:11] == [b"*", b"0", b"0", b"*", b"*", b"0", b"0", seq, qual] and len(f) == 12
        return () if ok else None
    rev = f[1] == b"16"
    if f[1] not in (b"0", b"16") or len(f) != 13 or f[2] != contig:
        return None
    s, q = (seq[::-1].translate(_COMP), qual[::-1]) if rev else (seq, qual)
    if f[5] != b"%dM" % len(seq) or f[6:11] != [b"*", b"0", b"0", s, q]:
        return None
    if f[4] not in (b"0", b"37") or not f[11].startswith(b"NM:i:"):
        return None
    return int(f[3]) - 1, rev, int(f[11][5:])
