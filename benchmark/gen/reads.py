"""A run's read pool from --seed: the semantics of the program's
`simulate.simulate_reads` (a window at a uniform start, substitutions at
distinct positions, to a different base, then the reverse complement on
the - strand, then N), vectorised over whole blocks with no per-read loop.

Parameters come from the traffic file:

  read_len           bases a read
  substitution_rate  each base substituted with this probability, so a
                     read's count is Binomial(read_len, rate), not cut at k
  n_rate             each base of the read made N with this probability
  reverse_share      the share of reads taken from the - strand
  block_reads, pool_blocks   the pool: pool_blocks distinct blocks

Reads are named r<index in the pool, 9 digits>; qualities are drawn from
'#' to 'I'. Every seed gives the same sizes; only the draws differ.
"""

from __future__ import annotations

import dataclasses

import numpy as np

ASCII = np.frombuffer(b"ACGT", dtype=np.uint8)
N_CHAR = ord("N")
ID_DIGITS = 9


@dataclasses.dataclass
class Pool:
    seq: np.ndarray  # uint8[n, L] ASCII as sent (ACGTN)
    qual: np.ndarray  # uint8[n, L] ASCII
    start: np.ndarray  # int64[n] the window each read came from
    reverse: np.ndarray  # bool[n] taken from the - strand
    block_reads: int

    @property
    def n(self) -> int:
        return len(self.seq)

    def ids(self, lo: int, hi: int) -> np.ndarray:
        """uint8[hi - lo, 1 + ID_DIGITS]: the names r<9 digits>."""
        idx = np.arange(lo, hi, dtype=np.int64)
        digits = (idx[:, None] // 10 ** np.arange(ID_DIGITS - 1, -1, -1)) % 10
        out = np.empty((hi - lo, 1 + ID_DIGITS), dtype=np.uint8)
        out[:, 0] = ord("r")
        out[:, 1:] = digits + ord("0")
        return out

    def fastq(self, lo: int, hi: int) -> bytes:
        """The reads [lo, hi) as 4-line FASTQ records."""
        n, L = hi - lo, self.seq.shape[1]
        col = lambda c: np.full((n, 1), ord(c), np.uint8)  # noqa: E731
        rec = np.concatenate([col("@"), self.ids(lo, hi), col("\n"), self.seq[lo:hi],
                              col("\n"), col("+"), col("\n"), self.qual[lo:hi], col("\n")],
                             axis=1)
        return rec.tobytes()


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed % 2**64, stream]))


def _block(genome: np.ndarray, traffic: dict, rng: np.random.Generator, B: int):
    L = int(traffic["read_len"])
    windows = np.lib.stride_tricks.sliding_window_view(genome, L)
    start = rng.integers(0, len(genome) - L + 1, B)
    codes = windows[start]  # a copy
    sub = rng.random((B, L), dtype=np.float32) < traffic["substitution_rate"]
    codes[sub] = (codes[sub] + rng.integers(1, 4, int(sub.sum()), dtype=np.uint8)) % 4
    rev = rng.random(B) < traffic["reverse_share"]
    codes[rev] = 3 - codes[rev, ::-1]
    seq = ASCII[codes]
    seq[rng.random((B, L), dtype=np.float32) < traffic["n_rate"]] = N_CHAR
    qual = rng.integers(ord("#"), ord("I") + 1, (B, L), dtype=np.uint8)
    return seq, qual, start, rev


def make_pool(genome: np.ndarray, traffic: dict, seed: int) -> Pool:
    """pool_blocks blocks of block_reads reads; block b draws from its own
    stream of the seed, so a block does not depend on the others."""
    B = int(traffic["block_reads"])
    parts = [_block(genome, traffic, _rng(seed, b), B) for b in range(traffic["pool_blocks"])]
    seq, qual, start, rev = (np.concatenate(x) for x in zip(*parts))
    return Pool(seq, qual, start, rev, B)


def sample_reads(traffic: dict, seed: int) -> np.ndarray:
    """int64[pool_blocks, sample_reads]: the block-local reads of each pool
    block that the check compares, sorted, drawn from the seed."""
    rng = _rng(seed, 1 << 20)
    B, S = int(traffic["block_reads"]), int(traffic["sample_reads"])
    return np.stack([np.sort(rng.choice(B, size=min(S, B), replace=False))
                     for _ in range(traffic["pool_blocks"])])
