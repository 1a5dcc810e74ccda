# Copy of bwtpu/simulate.py for the port; only its imports differ (tests/test_torch_hostcopy.py).
"""Deterministic test-data simulation (component C20, SURVEY.md §2.1).

No network egress is available, so the test tiers of BASELINE config 1-5
(phiX174-scale, E. coli-scale, chr21-scale) are exercised with seeded
random genomes and read sets with known true positions. Real FASTA files
can be dropped into data/ and used via cli.py unchanged.
"""

from __future__ import annotations

import numpy as np

from bwtpu_torch import dna
from bwtpu_torch.io import Read

# Scale presets (genome length in bp) mirroring the BASELINE tiers.
PHIX_SCALE = 5_386
ECOLI_SCALE = 4_641_652
CHR21_SCALE = 46_709_983


def random_genome(n: int, seed: int = 0) -> str:
    rng = np.random.default_rng(seed)
    return dna.decode(rng.integers(0, 4, size=n, dtype=np.uint8))


def adversarial_genome(n: int, kind: str, seed: int = 0) -> str:
    """Structured worst-case genomes (VERDICT r1 item 8; data/README.md).

    kind:
      "tandem"       long tandem arrays of a short motif — backward-
                     search intervals over the array never narrow below
                     the copy number (straggler/early-stop-fixup stress)
      "homopolymer"  homopolymer runs longer than any read interleaved
                     with random spacers — maximal interval widths and
                     locate fan-out
      "palindrome"   blocks followed by their reverse complements —
                     every read hits on both strands
    """
    rng = np.random.default_rng(seed)
    if kind == "tandem":
        parts = []
        total = 0
        while total < n:
            motif = dna.decode(rng.integers(0, 4, size=int(rng.integers(3, 12)),
                                            dtype=np.uint8))
            copies = int(rng.integers(20, 200))
            spacer = dna.decode(rng.integers(0, 4, size=int(rng.integers(50, 300)),
                                             dtype=np.uint8))
            block = motif * copies + spacer
            parts.append(block)
            total += len(block)
        return "".join(parts)[:n]
    if kind == "homopolymer":
        parts = []
        total = 0
        while total < n:
            base = "ACGT"[int(rng.integers(0, 4))]
            run = int(rng.integers(150, 400))  # > any test read length
            spacer = dna.decode(rng.integers(0, 4, size=int(rng.integers(80, 200)),
                                             dtype=np.uint8))
            parts.append(base * run + spacer)
            total += run + len(spacer)
        return "".join(parts)[:n]
    if kind == "palindrome":
        parts = []
        total = 0
        while total < n:
            block = dna.decode(rng.integers(0, 4, size=int(rng.integers(100, 400)),
                                            dtype=np.uint8))
            parts.append(block + dna.revcomp_str(block))
            total += 2 * len(block)
        return "".join(parts)[:n]
    raise ValueError(f"unknown adversarial kind: {kind}")


def simulate_reads(
    genome: str,
    n_reads: int,
    read_len: int = 100,
    max_mismatches: int = 0,
    revcomp_frac: float = 0.5,
    n_frac: float = 0.0,
    seed: int = 1,
    error_rate: float | None = None,
) -> tuple[list[Read], list[dict]]:
    """Sample reads from the genome with known truth.

    Returns (reads, truth) where truth[i] = dict(pos, strand, nm) for
    the sampled origin of read i. Mismatches are substitutions at
    distinct positions; with n_frac > 0, some read bases become 'N'
    (each N also counts toward nm since N matches nothing).

    error_rate: when set, the per-read mismatch count is drawn
    Binomial(read_len, error_rate) truncated at max_mismatches — a
    realistic sequencing-error profile (e.g. 0.5%/base: ~61% of 100 bp
    reads are error-free) instead of the adversarial uniform
    {0..max_mismatches} default (VERDICT r4 item 5: the uniform set
    escalates ~2/3 of reads in the tiered pipeline, which no production
    read set does).
    """
    rng = np.random.default_rng(seed)
    g = dna.encode(genome)
    n = len(g)
    assert n >= read_len
    reads: list[Read] = []
    truth: list[dict] = []
    for i in range(n_reads):
        pos = int(rng.integers(0, n - read_len + 1))
        window = g[pos : pos + read_len].copy()
        if error_rate is not None:
            nm = min(int(rng.binomial(read_len, error_rate)), max_mismatches)
        else:
            nm = (int(rng.integers(0, max_mismatches + 1))
                  if max_mismatches else 0)
        mm_pos = rng.choice(read_len, size=nm, replace=False) if nm else []
        for p in mm_pos:
            window[p] = (window[p] + int(rng.integers(1, 4))) % 4
        seq = dna.decode(window)
        strand = "-" if rng.random() < revcomp_frac else "+"
        if strand == "-":
            seq = dna.revcomp_str(seq)
        if n_frac > 0:
            chars = list(seq)
            for p in range(read_len):
                if rng.random() < n_frac:
                    chars[p] = "N"
            seq = "".join(chars)
            # recompute nm including N positions vs the true window
            w = g[pos : pos + read_len]
            codes, mask = dna.encode_with_mask(seq)
            if strand == "-":
                codes, mask = dna.revcomp_codes(codes, mask)
            nm = int(np.sum((w != codes) | mask))
        reads.append(Read(rid=f"r{i}", seq=seq, qual="I" * read_len))
        truth.append({"pos": pos, "strand": strand, "nm": nm})
    return reads, truth


def simulate_pairs(
    genome: str,
    n_pairs: int,
    read_len: int = 100,
    insert_mean: int = 300,
    insert_sd: int = 30,
    max_mismatches: int = 0,
    seed: int = 2,
) -> tuple[list[tuple[Read, Read]], list[dict]]:
    """FR-orientation paired reads with known insert size."""
    rng = np.random.default_rng(seed)
    g = dna.encode(genome)
    n = len(g)
    pairs = []
    truth = []
    for i in range(n_pairs):
        insert = int(
            np.clip(rng.normal(insert_mean, insert_sd), 2 * read_len, n)
        )
        pos = int(rng.integers(0, n - insert + 1))
        w1 = g[pos : pos + read_len].copy()
        w2 = g[pos + insert - read_len : pos + insert].copy()
        for w in (w1, w2):
            nm = int(rng.integers(0, max_mismatches + 1)) if max_mismatches else 0
            for p in rng.choice(read_len, size=nm, replace=False) if nm else []:
                w[p] = (w[p] + int(rng.integers(1, 4))) % 4
        r1 = Read(rid=f"p{i}", seq=dna.decode(w1), qual="I" * read_len)
        r2 = Read(
            rid=f"p{i}", seq=dna.revcomp_str(dna.decode(w2)), qual="I" * read_len
        )
        pairs.append((r1, r2))
        truth.append({"pos1": pos, "pos2": pos + insert - read_len, "insert": insert})
    return pairs, truth
