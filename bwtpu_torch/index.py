# Copy of bwtpu/index.py for the port; only its imports and load_index's trace span differ
# (tests/test_torch_hostcopy.py).
"""Host-side FM-index construction and the HBM lattice layout.

Layers L1/L2 (SURVEY.md §1, §3.1): suffix array -> BWT -> C table ->
checkpointed Occ -> text-sampled SA, laid out for the device as int32
lattices (SURVEY.md §7.2 "memory layout — the load-bearing decisions").

Lattice layout (normative; the jnp twin and Pallas kernels both consume
exactly this):

  search_lattice : int32[n_blocks + 1, 32] — one 128 B record per
      128-base BWT block j. Width is free on the gather path (cost is
      per row — docs/DESIGN.md), so the record carries everything any
      step could need, making BOTH a backward-search step (both bounds,
      while ep - sp <= 128) and a locate step ONE gather:
        words  0..3   OccCk[j][c]: count of base c in BWT[0 : 128*j)
                      (true counts; the '$' row is NOT counted as any
                      base),
        words  4..11  the block's 128 BWT bases, 2-bit packed LSB-first
                      (base at block-local p -> word 4 + p//16, bits
                      2*(p%16); the '$' row stores code 0 and is
                      corrected at query time via dollar_row),
        words 12..15  SA-sample mark bits (bit p of word 12 + p//32 set
                      iff row 128*j + p is sampled, i.e. SA[row] %
                      sa_rate == 0 — text sampling, SURVEY.md §3.3),
        word  16      mark_rank_ck[j]: number of sampled rows < 128*j,
        words 17..20  OccCk[j+1][c]  (next block's checkpoints),
        words 21..28  block j+1's BWT bases,
        words 29..31  pad.
      Row n_blocks is a terminator: full-text Occ counts, zero bits.

  ssa : int32[n_sampled] — SA values of sampled rows, in row order;
      ssa[mark_rank(r)] == SA[r] for sampled r.

  text_packed : int32[ceil(text_len/16)] — the 2-bit packed reference
      text (no sentinel), for seed-and-extend verify (SURVEY.md §7.4).

  C : int32[8] — C[v] = count of symbols < v over the 5-symbol alphabet
      $=0 < A=1 < .. < T=4 (padded to 8).

Shard length must stay < 2^31 so all device arithmetic is int32
(SURVEY.md §7.2); global positions are resolved on host as
shard_offset + local_pos in int64.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from bwtpu_torch import dna, sais, trace
from bwtpu_torch.config import EngineConfig
from bwtpu_torch.io import Contig

BLOCK = 128  # bases per Occ checkpoint block (fixed by the layout)
REC_WORDS = 32  # int32 words per search-lattice record
BWT_WORD0 = 4  # first packed-BWT word in a record
MARK_WORD0 = 12  # first mark word in a record
MARK_RANK_WORD = 16  # in-record mark-rank checkpoint
NEXT_CK0 = 17  # next block's Occ checkpoints
NEXT_BWT0 = 21  # next block's packed BWT words

# Multi-step (s-mer alphabet) Occ lattice: one record per R BWT rows
# advances backward search by s bases (s = 3 or 4) for both interval
# bounds in a single gather (docs/DESIGN.md "multi-step Occ lattice").
# Record layout for step s, alphabet A = 4^s, R rows per block,
# power-of-2 width W (smallest record that fits measures fastest on
# v5e; see docs/DESIGN.md):
#   words 0..A-1     fold[j][t] = Ks[t] + OccS(t, R*j): Ks[t] is the
#                    SA interval start of s-mer t (first row whose
#                    suffix begins with t); OccS(t, i) counts rows
#                    r < i whose suffix is preceded by exactly the s
#                    text chars t,
#   words A..A+R/4-1 R bytes, byte p = preceding-s-mer code (0..A-1)
#                    of row R*j + p, LSB-first. The s rows with
#                    SA[r] < s have no preceding s-mer: they store code
#                    0 and are EXCLUDED from fold counts; queries with
#                    t == 0 subtract them via occk_invalid (the same
#                    correction scheme as the 1-step '$' row). Padding
#                    rows past n also store 0 but sit at block-local
#                    positions no prefix count ever reaches.
#   remaining words  pad to W.
# Row n_blocksK is a terminator (full-text folds, codes 0).
OCCK_BLOCK = {3: 256, 4: 512}  # step -> rows per record R
OCCK_WIDTH = {3: 128, 4: 512}  # step -> record words W (power of 2)
# The engine recovers the (static) step from the record width at trace
# time; widths must therefore stay distinct and this reverse map is the
# ONE place that decoding lives (engine._shard_occ_step imports it).
OCCK_STEP_FROM_WIDTH = {w: s for s, w in OCCK_WIDTH.items()}
assert len(OCCK_STEP_FROM_WIDTH) == len(OCCK_WIDTH), "OCCK_WIDTH must be injective"
assert 1 not in OCCK_STEP_FROM_WIDTH, "width 1 is reserved for the dummy lattice"

FORMAT_VERSION = 6


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """Pack base codes (0..3) into int32 words, 16 codes/word, LSB-first."""
    n = len(codes)
    n_words = (n + 15) // 16
    padded = np.zeros(n_words * 16, dtype=np.uint32)
    padded[:n] = codes.astype(np.uint32)
    lanes = padded.reshape(n_words, 16)
    shifts = (2 * np.arange(16, dtype=np.uint32))[None, :]
    words = np.bitwise_or.reduce(lanes << shifts, axis=1)
    return words.astype(np.int64).astype(np.uint32).view(np.int32)


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """Pack a bool array into int32 words, 32 bits/word, LSB-first."""
    n = len(bits)
    n_words = (n + 31) // 32
    padded = np.zeros(n_words * 32, dtype=np.uint32)
    padded[:n] = bits.astype(np.uint32)
    lanes = padded.reshape(n_words, 32)
    shifts = np.arange(32, dtype=np.uint32)[None, :]
    words = np.bitwise_or.reduce(lanes << shifts, axis=1)
    return words.astype(np.int64).astype(np.uint32).view(np.int32)


@dataclasses.dataclass
class FMIndex:
    """One shard's FM-index, host-resident (NumPy); uploaded by the engine."""

    config: EngineConfig
    text_len: int  # bases in this shard's text
    n: int  # text_len + 1 (BWT rows incl. '$')
    dollar_row: int
    C: np.ndarray  # int32[8]
    search_lattice: np.ndarray  # int32[n_blocks+1, 16]
    mark_rank_ck: np.ndarray  # int32[n_blocks+1]
    ssa: np.ndarray  # int32[n_sampled]
    text_packed: np.ndarray  # int32[ceil(text_len/16)]
    kmer_d: int  # max depth of the k-mer start tables (0 = none)
    kmer_tables: dict  # {depth: int32[4^depth, 2]} SA interval per d-mer
    contigs: list[Contig]
    shard_offset: int = 0  # global position of this shard's base 0
    occk_lattice: np.ndarray | None = None  # int32[n_blocksK+1, W]
    occk_invalid: np.ndarray | None = None  # int32[4]: rows with SA[r] < s (-1 pad)

    @property
    def n_blocks(self) -> int:
        return (self.n + BLOCK - 1) // BLOCK


def build_fm_index(
    genome: str | None = None,
    config: EngineConfig | None = None,
    contigs: list[Contig] | None = None,
    shard_offset: int = 0,
    sa: np.ndarray | None = None,
    force_numpy: bool = False,
    text_codes: np.ndarray | None = None,
) -> FMIndex:
    """Build one shard's FM-index from a genome string OR pre-encoded
    uint8 base codes (`text_codes`, already sanitized — the streaming
    sharded build passes memmap slices this way so the parent never
    pickles genome strings to workers).

    Call stack per SURVEY.md §3.1: read_fasta -> build_sa -> bwt_from_sa
    -> build_c -> build_occ_checkpoints -> sample_sa -> lattice pack.
    """
    config = config or EngineConfig()
    if text_codes is None:
        genome = dna.sanitize_genome(genome)
        text_codes = dna.encode(genome)
    text_codes = np.ascontiguousarray(text_codes, dtype=np.uint8)
    text_len = len(text_codes)
    if text_len >= 2**31 - 1:
        raise ValueError(
            f"shard too long for int32 rows ({text_len}); shard the genome "
            "(build_sharded_index) so each interval stays < 2^31"
        )
    if contigs is None:
        contigs = [Contig(name="ref", offset=0, length=text_len)]

    # L1: suffix array over symbols (code+1) with 0 sentinel, then BWT.
    symbols = np.empty(text_len + 1, dtype=np.uint8)
    symbols[:text_len] = text_codes + 1
    symbols[text_len] = 0
    n = text_len + 1
    if sa is None:
        sa = sais.suffix_array(symbols)

    # k-mer depth ladder is decided up front: the fused native pass
    # needs to know whether the multi-step lattice will be built.
    d = config.kmer_d
    if d is None:
        d = min(12, max(0, int(np.log(max(n, 2)) / np.log(4))))
    depths = sorted({dd for dd in (4, 8, d) if 0 < dd <= d})
    s = config.occ_step
    want_occk = bool(s and depths and text_len >= s and depths[-1] >= s)

    # L1+L2 fused fast path (csrc/pack.cc bwtpu_build_shard): BWT,
    # C counts, search lattice, ssa, packed text AND the raw multi-step
    # lattice in ONE pass over `sa` — the separate NumPy passes (BWT
    # gather, preceding-s-mer gathers, bincounts) each missed cache on
    # the same rows and dominated the build (docs/DESIGN.md "index
    # build pass, round 3"). The NumPy path below is the reference
    # implementation (tests assert equality).
    occk_lattice = None
    occk_invalid = None
    fused = None if force_numpy else sais.build_shard_native(
        symbols, sa, config.sa_rate, s if want_occk else 0
    )
    n_blocks = (n + BLOCK - 1) // BLOCK
    if fused is not None:
        (lattice, ssa, text_packed, occk_lattice, occk_invalid,
         counts5, dollar_row) = fused
        mark_rank_ck = lattice[:, MARK_RANK_WORD].astype(np.int64)
        C = np.zeros(8, dtype=np.int64)
        C[1:5] = np.cumsum(counts5)[:4]
        C = C.astype(np.int32)
    else:
        bwt_sym = symbols[(sa - 1) % n]  # 0..4, exactly one 0 ('$')
        dollar_row = int(np.nonzero(bwt_sym == 0)[0][0])

        # L2: C table over the 5-symbol alphabet.
        counts5 = np.bincount(bwt_sym, minlength=5)
        C = np.zeros(8, dtype=np.int64)
        C[1:5] = np.cumsum(counts5)[:4]
        C = C.astype(np.int32)
        bwt_codes = bwt_sym.astype(np.int64) - 1
        bwt_codes[dollar_row] = 0  # '$' stored as code 0, corrected at query
        padded = np.zeros(n_blocks * BLOCK, dtype=np.int64)
        padded[:n] = bwt_codes

        # Per-block per-base counts ('$' excluded from counts).
        valid = np.ones(n_blocks * BLOCK, dtype=bool)
        valid[n:] = False
        valid[dollar_row] = False
        block_idx = np.arange(n_blocks * BLOCK) // BLOCK
        flat = (block_idx * 4 + padded)[valid]
        per_block = np.bincount(flat, minlength=n_blocks * 4).reshape(n_blocks, 4)
        occ_ck = np.zeros((n_blocks + 1, 4), dtype=np.int64)
        occ_ck[1:] = np.cumsum(per_block, axis=0)

        # L2: text-sampled SA (rows r with SA[r] % sa_rate == 0 are marked).
        marked = (sa % config.sa_rate) == 0
        ssa = sa[marked].astype(np.int32)
        mark_rank_ck = np.zeros(n_blocks + 1, dtype=np.int64)
        marked_padded = np.zeros(n_blocks * BLOCK, dtype=bool)
        marked_padded[:n] = marked
        mark_rank_ck[1:] = np.cumsum(
            marked_padded.reshape(n_blocks, BLOCK).sum(axis=1)
        )

        # Assemble the 32-word records (self + next-block interleaved).
        lattice = np.zeros((n_blocks + 1, REC_WORDS), dtype=np.int32)
        lattice[:, 0:4] = occ_ck.astype(np.int32)
        bwt_words = pack_2bit(padded.astype(np.uint8)).reshape(n_blocks, 8)
        lattice[:n_blocks, BWT_WORD0 : BWT_WORD0 + 8] = bwt_words
        mark_words = pack_bits(marked_padded).reshape(n_blocks, 4)
        lattice[:n_blocks, MARK_WORD0 : MARK_WORD0 + 4] = mark_words
        lattice[:, MARK_RANK_WORD] = mark_rank_ck.astype(np.int32)
        lattice[:n_blocks, NEXT_CK0 : NEXT_CK0 + 4] = occ_ck[1:].astype(np.int32)
        lattice[: n_blocks - 1, NEXT_BWT0 : NEXT_BWT0 + 8] = bwt_words[1:]
        text_packed = pack_2bit(text_codes)

    # k-mer start table (docs/DESIGN.md): for every d-mer c, the SA
    # interval of suffixes starting with c — built as a LADDER of
    # depths so short patterns (seeds, short reads) also start from a
    # table lookup (each depth gets its own exact table; sizes 256 B ..
    # 4^d * 8 B). One device gather then replaces d chained steps.
    #
    # Construction: give each suffix a base-5 key of its first d
    # symbols ($=0 < A=1 < ... — shorter suffixes pad with 0); keys are
    # non-decreasing in SA order, so interval bounds are counts of keys
    # below a query value. Fast path: those counts come from prefix
    # sums of a TEXT-ORDER key histogram (csrc/pack.cc bwtpu_key_hist —
    # a histogram is order-independent), so no key is ever gathered
    # into SA order and nothing is binary-searched; the two passes
    # dominated the NumPy builder (docs/DESIGN.md "index build pass,
    # round 3"). NumPy fallback: explicit SA-ordered keys +
    # searchsorted (the reference formulation; tests assert equality).
    kmer_tables = {}
    kS = None  # Ks[t] for the multi-step lattice, from the same keys
    if depths:
        dmax = depths[-1]

        def qkeys(depth: int) -> np.ndarray:
            """Base-5 keys of all 4^depth ACGT-only d-mers, ascending."""
            digits = np.arange(4**depth, dtype=np.int64)
            qk = np.zeros(4**depth, dtype=np.int64)
            for i in range(depth):
                qk = qk * 5 + ((digits >> (2 * (depth - 1 - i))) & 3) + 1
            return qk

        hist = None if force_numpy else sais.key_hist_native(symbols, dmax)
        if hist is not None:
            # in-place exclusive-of-nothing cumsum: cum[v] = number of
            # suffix keys <= v (counts total n < 2^31, fits int32)
            cum = hist.view(np.int32)
            np.cumsum(cum, out=cum)

            def count_below(v: np.ndarray) -> np.ndarray:
                """Number of suffix keys < v (v in [0, 5^dmax])."""
                v = np.asarray(v, dtype=np.int64)
                return np.where(v > 0, cum[np.maximum(v, 1) - 1], 0)

            for depth in depths:
                scale = 5 ** (dmax - depth)
                qk = qkeys(depth)
                lo = count_below(qk * scale)
                hi = count_below((qk + 1) * scale)
                kmer_tables[depth] = np.stack([lo, hi], axis=1).astype(np.int32)
            if want_occk:
                kS = count_below(qkeys(s) * (5 ** (dmax - s)))
            del hist, cum
        else:
            sym_padded = np.zeros(n + dmax, dtype=np.int64)
            sym_padded[:n] = symbols
            # text-ordered keys via SEQUENTIAL shifted slices (the naive
            # per-digit formulation does dmax random gathers), then ONE
            # gather into suffix-array order.
            tkey = np.zeros(n, dtype=np.int64)
            for i in range(dmax):
                tkey += sym_padded[i : i + n] * 5 ** (dmax - 1 - i)
            key = tkey[sa]
            for depth in depths:
                kd = key // (5 ** (dmax - depth)) if depth != dmax else key
                qk = qkeys(depth)
                lo = np.searchsorted(kd, qk, side="left")
                hi = np.searchsorted(kd, qk, side="right")
                kmer_tables[depth] = np.stack([lo, hi], axis=1).astype(np.int32)
            if want_occk:
                keyS = key // (5 ** (dmax - s))
                kS = np.searchsorted(keyS, qkeys(s), side="left")

    # Multi-step Occ lattice (layout documented at OCCK_BLOCK above). Only
    # built when a k-mer start table exists: the multi-step search path
    # requires a table start (a [0, n) initial interval would straggle
    # immediately). The fused native pass already emitted the raw
    # per-block counts and code bytes; only Ks[t] remains to fold in.
    if want_occk and occk_lattice is not None:
        A = 4**s
        occk_lattice[:, :A] += kS.astype(np.int32)[None, :]
    elif want_occk:
        A = 4**s
        W = OCCK_WIDTH[s]
        R = OCCK_BLOCK[s]
        tc = text_codes.astype(np.int64)
        pre_code = np.zeros(n, dtype=np.int64)
        v = sa >= s
        kpos = sa[v].astype(np.int64)
        acc = np.zeros(len(kpos), dtype=np.int64)
        for i in range(s):
            acc = acc * 4 + tc[kpos - s + i]
        pre_code[v] = acc
        occk_invalid = np.full(4, -1, dtype=np.int32)
        inv_rows = np.nonzero(~v)[0]
        occk_invalid[: len(inv_rows)] = inv_rows
        n_blocksK = (n + R - 1) // R
        paddedK = np.zeros(n_blocksK * R, dtype=np.int64)
        paddedK[:n] = pre_code
        ok = np.zeros(n_blocksK * R, dtype=bool)
        ok[:n] = v
        blk = np.arange(n_blocksK * R) // R
        per_block = np.bincount(
            (blk * A + paddedK)[ok], minlength=n_blocksK * A
        ).reshape(n_blocksK, A)
        ckK = np.zeros((n_blocksK + 1, A), dtype=np.int64)
        ckK[1:] = np.cumsum(per_block, axis=0)
        occk_lattice = np.zeros((n_blocksK + 1, W), dtype=np.int32)
        occk_lattice[:, :A] = (kS[None, :] + ckK).astype(np.int32)
        bytesK = paddedK.reshape(n_blocksK, R // 4, 4).astype(np.uint32)
        shifts = (8 * np.arange(4, dtype=np.uint32))[None, None, :]
        wordsK = np.bitwise_or.reduce(bytesK << shifts, axis=2)
        occk_lattice[:n_blocksK, A : A + R // 4] = wordsK.view(
            np.int32
        ).reshape(n_blocksK, R // 4)

    return FMIndex(
        config=config,
        text_len=text_len,
        n=n,
        dollar_row=dollar_row,
        C=C,
        search_lattice=lattice,
        mark_rank_ck=mark_rank_ck.astype(np.int32),
        ssa=ssa,
        text_packed=text_packed,
        kmer_d=d,
        kmer_tables=kmer_tables,
        contigs=contigs,
        shard_offset=shard_offset,
        occk_lattice=occk_lattice,
        occk_invalid=occk_invalid,
    )


# ---------------------------------------------------------------------------
# Host-side reference queries against the lattice (used by tests to pin the
# layout independently of the device code).
# ---------------------------------------------------------------------------


def host_occ(idx: FMIndex, c: int, i: int) -> int:
    """Occ(base c, i) computed from the packed lattice (layout oracle)."""
    j, m = divmod(i, BLOCK)
    rec = idx.search_lattice[j]
    count = int(rec[c])
    words = rec[BWT_WORD0 : BWT_WORD0 + 8].view(np.uint32)
    for p in range(m):
        base = (int(words[p // 16]) >> (2 * (p % 16))) & 3
        if base == c:
            count += 1
    if c == 0 and (idx.dollar_row // BLOCK) == j and idx.dollar_row < i:
        count -= 1
    return count


def host_occk(idx: FMIndex, t: int, i: int) -> int:
    """Ks[t] + OccS(t, i) from the packed multi-step lattice (layout
    oracle), including the invalid-row (SA[r] < s) correction."""
    s = idx.config.occ_step
    A = 4**s
    R = OCCK_BLOCK[s]
    j, m = divmod(i, R)
    rec = idx.occk_lattice[j]
    count = int(rec[t])
    words = rec[A : A + R // 4].view(np.uint32)
    for p in range(m):
        code = (int(words[p // 4]) >> (8 * (p % 4))) & 0xFF
        if code == t:
            count += 1
    if t == 0:
        for r in idx.occk_invalid:
            if r >= 0 and j * R <= r < i:
                count -= 1
    return count


def host_sa_lookup(idx: FMIndex, r: int) -> tuple[bool, int]:
    """(is r sampled, ssa index if sampled) from mark bits + rank ck."""
    j, m = divmod(r, BLOCK)
    rec = idx.search_lattice[j]
    words = rec[MARK_WORD0 : MARK_WORD0 + 4].view(np.uint32)
    bit = (int(words[m // 32]) >> (m % 32)) & 1
    rank = int(idx.mark_rank_ck[j])
    for p in range(m):
        rank += (int(words[p // 32]) >> (p % 32)) & 1
    return bool(bit), rank


# ---------------------------------------------------------------------------
# Sharding (SURVEY.md §2.3 "index sharding", §7.5)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShardManifest:
    """Describes how the concatenated genome is split into intervals.

    Shards overlap by `overlap` bases so a read (len <= overlap) lying
    across an interval boundary is fully contained in at least one
    shard; duplicate hits in overlaps are deduped at merge time on
    global position.
    """

    total_len: int
    overlap: int
    starts: list[int]  # global start of each shard's text
    lengths: list[int]
    contigs: list[Contig]

    @property
    def n_shards(self) -> int:
        return len(self.starts)


def plan_shards(total_len: int, n_shards: int, overlap: int) -> ShardManifest:
    if n_shards < 1:
        raise ValueError("n_shards must be >= 1")
    base = -(-total_len // n_shards)  # ceil
    starts, lengths = [], []
    for s in range(n_shards):
        start = s * base
        end = min(total_len, (s + 1) * base + overlap)
        start = min(start, max(0, total_len - 1))
        lengths.append(max(0, end - start))
        starts.append(start)
    return ShardManifest(
        total_len=total_len, overlap=overlap, starts=starts, lengths=lengths,
        contigs=[],
    )


def _build_shard_job(args):
    codes_path, start, length, config, contigs = args
    # workers slice the shared on-disk code stream; nothing genome-sized
    # is ever pickled across the process boundary
    codes = np.memmap(codes_path, dtype=np.uint8, mode="r",
                      offset=start, shape=(length,))
    return build_fm_index(
        text_codes=codes, config=config, contigs=contigs, shard_offset=start
    )


def build_sharded_index(
    genome: str | np.ndarray,
    n_shards: int,
    config: EngineConfig | None = None,
    contigs: list[Contig] | None = None,
    overlap: int = 256,
    jobs: int = 1,
) -> tuple[list[FMIndex], ShardManifest]:
    """Split the genome into overlapping intervals, one FM-index each.

    genome: string or pre-encoded uint8 base codes. The encoded stream
    is written ONCE to a temp file; workers memmap their slice, so the
    parent never holds per-shard genome copies (the round-2 builder
    materialized every slice up front — ~2x genome RSS — and pickled
    250 MB strings to workers; VERDICT r2 item 7).

    jobs > 1 builds shards in parallel processes (each shard build is
    single-threaded NumPy/SA-IS; human-scale builds are embarrassingly
    parallel across interval shards).
    """
    import tempfile

    config = config or EngineConfig()
    if isinstance(genome, np.ndarray):
        codes = np.ascontiguousarray(genome, dtype=np.uint8)
    else:
        codes = dna.encode(dna.sanitize_genome(genome))
    total_len = len(codes)
    if contigs is None:
        contigs = [Contig(name="ref", offset=0, length=total_len)]
    manifest = plan_shards(total_len, n_shards, overlap)
    manifest.contigs = contigs
    if config.kmer_d is None:
        # pin one depth across shards (auto-depth would differ with
        # shard length and the engine needs a common table ladder)
        min_n = max(2, min(manifest.lengths) + 1)
        config = config.replace(
            kmer_d=min(12, max(0, int(np.log(min_n) / np.log(4))))
        )
    with tempfile.NamedTemporaryFile(prefix="bwtpu_codes_", delete=False) as f:
        codes_path = f.name
    try:
        codes.tofile(codes_path)
        del codes
        work = [
            (codes_path, start, length, config, contigs)
            for start, length in zip(manifest.starts, manifest.lengths)
        ]
        if jobs > 1 and len(work) > 1:
            import concurrent.futures as cf
            import multiprocessing as mp

            # spawn, not fork: the parent often has JAX (multithreaded)
            # already imported, and fork() under threads can deadlock
            with cf.ProcessPoolExecutor(
                max_workers=min(jobs, len(work)),
                mp_context=mp.get_context("spawn"),
            ) as ex:
                shards = list(ex.map(_build_shard_job, work))
        else:
            shards = [_build_shard_job(w) for w in work]
    finally:
        os.unlink(codes_path)
    return shards, manifest


# ---------------------------------------------------------------------------
# On-disk artifact (SURVEY.md §5.4 checkpoint/resume: the index IS the
# checkpoint; versioned so engine and index cannot disagree).
# ---------------------------------------------------------------------------


def save_index(path: str, shards: list[FMIndex], manifest: ShardManifest):
    os.makedirs(path, exist_ok=True)
    meta = {
        "format_version": FORMAT_VERSION,
        "config": shards[0].config.to_json(),
        "n_shards": len(shards),
        "manifest": {
            "total_len": manifest.total_len,
            "overlap": manifest.overlap,
            "starts": manifest.starts,
            "lengths": manifest.lengths,
        },
        "contigs": [
            {"name": c.name, "offset": c.offset, "length": c.length}
            for c in manifest.contigs
        ],
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    for i, sh in enumerate(shards):
        extra = {}
        if sh.occk_lattice is not None:
            extra["occk_lattice"] = sh.occk_lattice
            extra["occk_invalid"] = sh.occk_invalid
        np.savez(
            os.path.join(path, f"shard{i}.npz"),
            text_len=sh.text_len,
            n=sh.n,
            dollar_row=sh.dollar_row,
            C=sh.C,
            search_lattice=sh.search_lattice,
            mark_rank_ck=sh.mark_rank_ck,
            ssa=sh.ssa,
            text_packed=sh.text_packed,
            kmer_d=sh.kmer_d,
            kmer_depths=np.array(sorted(sh.kmer_tables), dtype=np.int32),
            shard_offset=sh.shard_offset,
            **{f"kmer_table_{dd}": t for dd, t in sh.kmer_tables.items()},
            **extra,
        )


def load_index(path: str) -> tuple[list[FMIndex], ShardManifest]:
    with trace.span("load_index"):
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        if meta["format_version"] != FORMAT_VERSION:
            raise ValueError(
                f"index format v{meta['format_version']} != engine v{FORMAT_VERSION}; rebuild"
            )
        config = EngineConfig.from_json(meta["config"])
        contigs = [Contig(**c) for c in meta["contigs"]]
        m = meta["manifest"]
        manifest = ShardManifest(
            total_len=m["total_len"], overlap=m["overlap"], starts=m["starts"],
            lengths=m["lengths"], contigs=contigs,
        )
        shards = []
        for i in range(meta["n_shards"]):
            z = np.load(os.path.join(path, f"shard{i}.npz"))
            shards.append(
                FMIndex(
                    config=config,
                    text_len=int(z["text_len"]),
                    n=int(z["n"]),
                    dollar_row=int(z["dollar_row"]),
                    C=z["C"],
                    search_lattice=z["search_lattice"],
                    mark_rank_ck=z["mark_rank_ck"],
                    ssa=z["ssa"],
                    text_packed=z["text_packed"],
                    kmer_d=int(z["kmer_d"]),
                    kmer_tables={
                        int(dd): z[f"kmer_table_{int(dd)}"]
                        for dd in z["kmer_depths"]
                    },
                    contigs=contigs,
                    shard_offset=int(z["shard_offset"]),
                    occk_lattice=z["occk_lattice"] if "occk_lattice" in z else None,
                    occk_invalid=z["occk_invalid"] if "occk_invalid" in z else None,
                )
            )
        return shards, manifest
