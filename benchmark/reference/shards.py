"""The plain reference's capacity rule for an index cut into interval
shards, from the genome and the configuration alone.

The configuration's "capacity" guarantee caps a seed's exact occurrences
in the index the program searches. Where the index is S interval shards,
each shard is an index of its own, and each caps its own occurrences; a
read is heavy where, on a strand, one of its seeds has more exact
occurrences than the capacity within one shard's interval (an occurrence
in an overlap counts in both shards). Hits are those of the whole
genome: reference.align with no cap.

The intervals are the configuration's build rule (build-index --shards S
--overlap V over n bases): with c = ceil(n / S), shard s covers
[s * c, min(n, (s + 1) * c + V)).
"""

from __future__ import annotations

import numpy as np

from . import align as ref_align


def intervals(n: int, shards: int, overlap: int) -> list[tuple[int, int]]:
    """[start, end) of each shard's interval."""
    c = -(-n // shards)
    return [(min(s * c, max(0, n - 1)), min(n, (s + 1) * c + overlap)) for s in range(shards)]


def shard_genomes(codes: np.ndarray, shards: int, overlap: int) -> list[ref_align.Genome]:
    """One reference Genome a shard interval."""
    return [ref_align.Genome(codes[a:b]) for a, b in intervals(len(codes), shards, overlap)]


def heavy(parts: list[ref_align.Genome], codes: np.ndarray, amb: np.ndarray, k: int,
          capacity: int) -> np.ndarray:
    """bool[m]: reads uint8[m, L] (N at amb) that are heavy in some shard."""
    out = np.zeros(len(codes), dtype=bool)
    for g in parts:
        out |= ref_align.align(g, codes, amb, k, capacity).heavy
    return out
