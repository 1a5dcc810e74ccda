# Copy of bwtpu/io.py for the port; only its imports differ (tests/test_torch_hostcopy.py).
"""FASTA / FASTQ parsing and contig bookkeeping (layer L0, SURVEY.md §1).

Reference capability C1/C2 (SURVEY.md §2.1): parse the reference genome
(concatenating contigs and recording a contig name -> offset map needed
for RNAME/POS in SAM) and parse reads with paired-end support.
"""

from __future__ import annotations

import dataclasses
import gzip
from typing import Iterable, Iterator

from bwtpu_torch import dna


@dataclasses.dataclass(frozen=True)
class Contig:
    name: str
    offset: int  # start offset in the concatenated genome
    length: int


@dataclasses.dataclass
class Read:
    rid: str
    seq: str
    qual: str | None = None


def _open(path: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def read_fasta(path: str) -> tuple[str, list[Contig]]:
    """Parse FASTA; return (concatenated sanitized genome, contig table).

    Contigs are concatenated in file order with no separator; the contig
    table records offsets for SAM RNAME/POS resolution. Non-ACGT genome
    characters are replaced by 'A' (pinned convention, bwtpu.dna).
    """
    contigs: list[Contig] = []
    parts: list[str] = []
    name = None
    cur: list[str] = []
    offset = 0

    def flush():
        nonlocal offset
        if name is None:
            return
        seq = dna.sanitize_genome("".join(cur))
        contigs.append(Contig(name=name, offset=offset, length=len(seq)))
        parts.append(seq)
        offset += len(seq)

    with _open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                flush()
                name = line[1:].split()[0]
                cur = []
            else:
                cur.append(line)
        flush()
    if not contigs:
        raise ValueError(f"no sequences in FASTA {path}")
    return "".join(parts), contigs


def read_fastq(path: str) -> list[Read]:
    """Parse FASTQ (4-line records) into Read objects."""
    reads: list[Read] = []
    with _open(path) as f:
        while True:
            h = f.readline()
            if not h:
                break
            h = h.strip()
            if not h:
                continue
            if not h.startswith("@"):
                raise ValueError(f"bad FASTQ header line: {h!r}")
            seq = f.readline().strip()
            plus = f.readline()
            qual = f.readline().strip()
            if not plus.startswith("+"):
                raise ValueError("bad FASTQ record (missing '+')")
            reads.append(Read(rid=h[1:].split()[0], seq=seq.upper(), qual=qual))
    return reads


def read_reads(path: str) -> list[Read]:
    """Read either FASTQ or FASTA reads by sniffing the first character."""
    with _open(path) as f:
        first = f.read(1)
    if first == "@":
        return read_fastq(path)
    return _read_fasta_reads(path)


def _read_fasta_reads(path: str) -> list[Read]:
    reads: list[Read] = []
    name = None
    cur: list[str] = []
    with _open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    reads.append(Read(rid=name, seq="".join(cur).upper()))
                name = line[1:].split()[0]
                cur = []
            else:
                cur.append(line)
    if name is not None:
        reads.append(Read(rid=name, seq="".join(cur).upper()))
    return reads


def pair_reads(r1: Iterable[Read], r2: Iterable[Read]) -> list[tuple[Read, Read]]:
    """Pair mate files positionally (standard _1/_2 FASTQ convention)."""
    pairs = list(zip(r1, r2))
    return pairs


def write_fasta(path: str, records: Iterable[tuple[str, str]], width: int = 70):
    with open(path, "w") as f:
        for name, seq in records:
            f.write(f">{name}\n")
            for i in range(0, len(seq), width):
                f.write(seq[i : i + width] + "\n")


def write_fastq(path: str, reads: Iterable[Read]):
    with open(path, "w") as f:
        for r in reads:
            q = r.qual if r.qual else "I" * len(r.seq)
            f.write(f"@{r.rid}\n{r.seq}\n+\n{q}\n")


def resolve_position(
    contigs: list[Contig], pos: int, length: int
) -> tuple[str, int] | None:
    """Map a concatenated-genome position to (contig name, 0-based pos).

    Returns None if the [pos, pos+length) window crosses a contig
    boundary (pinned convention: such hits are dropped at emission —
    they are artifacts of concatenation).
    """
    for c in contigs:
        if c.offset <= pos < c.offset + c.length:
            if pos + length > c.offset + c.length:
                return None
            return c.name, pos - c.offset
    return None
