"""The check's reference for any index the program loads, one shard or
several: the judge that run.py's Session.judge and ring.py's judge are to
share.

The configuration's "capacity" guarantee caps a seed's exact occurrences
in the index the program searches. An index of one shard is capped in the
whole genome: check.Reference with check.capacity, as run.py judges
today. An index of S interval shards caps each shard's occurrences
separately (reference/shards.py): the hits are those of the whole genome
with no cap, and a read is heavy where a seed is over the capacity within
one shard. Judged by the whole genome's capacity instead, a read whose
seed is over it in the genome and under it in every shard would count as
wrong though the program completes it, as the configuration says.

A configuration of several shards states its build_index "shards" and
"overlap", and the index built has to match both (Judge raises where it
does not, before any run).

Reached by benchmark/tests/test_bm_shards.py; run.py and ring.py keep their
own judges until a benchmark change that edits them calls this one.
"""

from __future__ import annotations

import numpy as np

from benchmark import check as chk
from benchmark.reference import align as ref_align
from benchmark.reference import shards as ref_shards

NO_CAP = (1 << 63) - 1


def sharded(cfg: dict, shards: int, overlap: int) -> bool:
    """True for an index of several interval shards that the configuration
    states; False for one shard. Raises where the index built disagrees
    with the configuration's build_index "shards" and "overlap"."""
    b = cfg["build_index"]
    if shards == 1 and b["shards"] in (0, 1):
        return False
    if shards == 1 or b["shards"] != shards or b.get("overlap") != overlap:
        raise RuntimeError(f"an index of {shards} shards, overlap {overlap}: the configuration "
                           f"states shards {b['shards']}, overlap {b.get('overlap')}")
    return True


class Judge:
    """The reference side of the check for one configuration's genome and
    index; the keys of every position are built once a process."""

    def __init__(self, cfg: dict, codes: np.ndarray, shards: int, overlap: int):
        self.cfg, self.codes = cfg, codes
        self.shards, self.overlap = shards, overlap
        self.sharded = sharded(cfg, shards, overlap)
        self.genome = self.parts = None

    def reference(self, pool, sample: np.ndarray, k: int) -> chk.Reference:
        """The reference's answer for the sampled reads of every pool block."""
        cap = chk.capacity(self.cfg, k)
        if self.genome is None:
            self.genome = ref_align.Genome(self.codes)
            if self.sharded:
                self.parts = ref_shards.shard_genomes(self.codes, self.shards, self.overlap)
        if not self.sharded:
            return chk.Reference(self.genome, pool, sample, k, cap)
        ref = chk.Reference(self.genome, pool, sample, k, NO_CAP)
        codes, amb = ref_align.codes_of(ref.seq)
        heavy = ref_shards.heavy(self.parts, codes, amb, k, cap)
        a = ref.ans
        keep = ~heavy[a.read]
        ref.ans = ref_align.Answer(heavy, a.read[keep], a.pos[keep], a.rev[keep], a.nm[keep])
        ref.cnt = np.bincount(ref.ans.read, minlength=len(ref.idx))
        ref.first = np.cumsum(ref.cnt) - ref.cnt
        return ref
