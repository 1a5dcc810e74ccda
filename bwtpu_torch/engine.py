"""Alignment engine on torch tensors (counterpart of bwtpu/engine.py).

One or more index shards on one torch device, dispatched in turn
(bwtpu's list form) or, with fuse_shards=True, as one program for all
shards (bwtpu's fused list form: on the card one CUDA graph replay a
block). bwtpu's stacked-vmap form is not ported: it exists for XLA's
vmap and costs relayout copies of the tables. Two entry points, as in
bwtpu:

  dispatch_block / finish_block   columnar ReadBlocks of one read length
                                  (tiered=True: exact first, then the
                                  seed expansion of the reads with no
                                  exact hit)
  dispatch_batch / finish_batch   Read lists (align_batch, align_all)

Uniform-length input with the multi-step lattice and d >= 1 runs the
packed pipelines (both strands stacked, rows [0, B) forward and
[B, 2B) reverse; the engine uploads the reads into rows [0, B) and preps
the rest once a batch for every shard):

  device_prep_packed -> search_early_stop_packed (one per seed slot at
  k > 0) -> ONE compaction of all candidate rows -> locate + verify

with compacted outputs ("hits", "compact" or "tiered"). Locate + verify
is locate_walk then verify_nm (CUDA kernels) at sa_rate > 1, and
verify_locv (CUDA kernel: one fused locate+verify row per candidate) at
sa_rate == 1 with the locv table. Mixed-length Read lists, indexes
without the multi-step lattice and patterns shorter than every k-mer
table (d = 0) run the 1-step pipelines with dense outputs:

  encode_batch (host) or device_prep_uniform -> backward_search_ra
  (search_chain1 kernel, then search_chain2 on the stragglers) ->
  compaction -> locate [+ verify at k > 0] -> scatter back

In the "tiered" mode, and in "hits" with the fused form, every shard's
fixed-shape outputs come to the host in ONE device-to-host copy a block
(the grouped fetch); the loop form's "hits" fetches every shard's
scalars in one copy, then each shard's hits up to its count. The host
assembles every shard's hits with results.py (global positions in int64
from each shard's offset, overlap hits deduplicated). Outputs equal
bwtpu's: the same hit sets, truncation marks, heals and SAM bytes. Torch
runs eagerly; the fused form's graph cache takes the place of the
reference's jit program cache.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import logging
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from bwtpu_torch import dna, trace
from bwtpu_torch.config import EngineConfig
from bwtpu_torch.golden import Hit
from bwtpu_torch.index import OCCK_STEP_FROM_WIDTH, FMIndex
from bwtpu_torch.io import Read
from bwtpu_torch.results import FlatHits, flatten_hits
from bwtpu_torch.kernels import _build
from bwtpu_torch.kernels.common import i32, popcount32
from bwtpu_torch.kernels.compact import compact, compact_counts, scatter_back
from bwtpu_torch.kernels.locate import locate_walk
from bwtpu_torch.kernels.prep import revcomp_both
from bwtpu_torch.kernels.search import interval_rows
from bwtpu_torch.kernels.search2 import backward_search_ra, right_align
from bwtpu_torch.kernels.searchk import search_early_stop_packed
from bwtpu_torch.kernels.verify import seed_layout
from bwtpu_torch.kernels.verify2 import (NM_INVALID, build_locv_rows,
                                         build_text_rows, locv_row_width,
                                         pack_reads, verify_locv, verify_nm)

log = logging.getLogger(__name__)

# "hits" mode packs (sel, nm) into one int32 as sel * 4 + nm: it needs
# 2 * batch * candidate slots * 4 below this bound, else "compact" mode
HIT_PAYLOAD_MAX = 2**31
LOCV_MAX_BYTES = 4 << 30  # fused locate+verify table budget on the device


class Shard(NamedTuple):
    """One shard's device-resident index."""

    lattice: torch.Tensor  # int32[n_blocks+1, 32]
    latk: torch.Tensor  # int32[n_blocksK+1, W] multi-step records; (1, 1)
    #                     dummy = no multi-step lattice (1-step path)
    latk_inv: torch.Tensor  # int32[4] rows with SA[r] < step (-1 pad)
    ssa: torch.Tensor  # int32[n_sampled]
    C: torch.Tensor  # int32[8]
    dollar_row: int
    n: int
    text_len: int
    text_rows: torch.Tensor  # int32[n_rows, R] stride-8 text windows
    locv: torch.Tensor  # int32[n, 1+2W+1] fused locate+verify rows
    #                     (sa_rate == 1 only); (1, 1) dummy = absent
    kmer_tables: dict  # {depth: int32[4^depth, 2]}


def upload_index(shards: list[FMIndex], device, locv: bool | None = None) -> list[Shard]:
    """Put each FMIndex's arrays on `device`: one Shard per index shard
    (bwtpu's list form, upload_index(stacked=False), without its padding
    to common shapes: the port runs eagerly, so no compiled program is
    shared between shards).

    As in bwtpu, the multi-step lattice is used only when every shard has
    one of the same width (else every shard gets the (1, 1) dummy), and
    the k-mer tables are the depths every shard has. locv: build the
    fused locate+verify table (one row = SA value + verify window,
    verify2.build_locv_rows). None = auto, as in bwtpu: on when sa_rate
    == 1, the multi-step lattice is present and the tables of all shards
    fit LOCV_MAX_BYTES together (~300 MB at E. coli scale, L 100)."""
    have_latk = all(s.occk_lattice is not None for s in shards) and len(
        {s.occk_lattice.shape[1] for s in shards}) == 1
    sa_rate, read_len = shards[0].config.sa_rate, shards[0].config.read_len
    if locv is None:
        locv = (sa_rate == 1 and have_latk
                and sum(s.n for s in shards) * locv_row_width(read_len) * 4 <= LOCV_MAX_BYTES)
    if locv and sa_rate != 1:
        raise ValueError("locv table requires sa_rate == 1 (ssa must "
                         "be the full row-ordered suffix array)")
    depths = sorted(set.intersection(*[set(s.kmer_tables) for s in shards]))

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)

    with trace.span("upload_index"):
        return [Shard(
            lattice=put(s.search_lattice),
            latk=put(s.occk_lattice if have_latk else np.zeros((1, 1), np.int32)),
            latk_inv=put(s.occk_invalid if have_latk else np.full(4, -1, np.int32)),
            ssa=put(s.ssa),
            C=put(s.C),
            dollar_row=int(s.dollar_row),
            n=int(s.n),
            text_len=int(s.text_len),
            text_rows=put(build_text_rows(s.text_packed, read_len)),
            locv=put(build_locv_rows(s.text_packed, s.ssa, read_len) if locv
                     else np.zeros((1, 1), np.int32)),
            kmer_tables={dd: put(s.kmer_tables[dd]) for dd in depths},
        ) for s in shards]


def pick_kmer_depth(available: list[int], min_len: int) -> int:
    """Largest available table depth <= min pattern length (0 if none)."""
    for dd in sorted(available, reverse=True):
        if dd <= min_len:
            return dd
    return 0


def compact_cap(n_lanes: int, loc_factor, scale: int = 1) -> int:
    """Compacted-stage capacity for a batch of n_lanes read-strand rows;
    scale (= 2**heal_level) also raises the 4096 floor."""
    return max(int(n_lanes * loc_factor), 4096 * scale)


def shard_occ_step(shard: Shard) -> int:
    """Multi-step size from the lattice record width (index.OCCK_WIDTH);
    0 = dummy lattice, stay on the 1-step path."""
    return OCCK_STEP_FROM_WIDTH.get(shard.latk.shape[-1], 0)


# ---------------------------------------------------------------------------
# Host-side batch encoding (numpy copy of bwtpu.engine.encode_batch)
# ---------------------------------------------------------------------------


class EncodedBatch(NamedTuple):
    # search inputs (both strands stacked: rows [0,B) fwd, [B,2B) rev)
    ra_codes: np.ndarray  # int32[2B, L] right-aligned
    ra_amb: np.ndarray  # int32[2B, L]
    lens: np.ndarray  # int32[2B]
    # verify inputs
    read_words: np.ndarray  # int32[2B, W]
    amb_bits: np.ndarray  # int32[2B, W]
    len_mask: np.ndarray  # int32[2B, W]
    # seed inputs (built on demand for inexact)
    seed_ra: np.ndarray | None  # int32[2B*S, cap]
    seed_amb: np.ndarray | None
    seed_lens: np.ndarray | None  # int32[2B*S]
    seed_off: np.ndarray | None  # int32[2B*S]
    min_len: int
    min_seed_len: int


def encode_batch(
    config: EngineConfig, reads: list[Read], k: int, pad_to: int | None = None
) -> tuple[EncodedBatch, int]:
    B = len(reads)
    Bp = pad_to or B
    L = max(config.read_len, max((len(r.seq) for r in reads), default=1))
    codes = np.zeros((Bp, L), dtype=np.int32)
    amb = np.zeros((Bp, L), dtype=np.int32)
    lens = np.zeros(Bp, dtype=np.int32)
    if reads and all(len(r.seq) == L for r in reads) and Bp == B:
        c, m = dna.encode_with_mask("".join(r.seq for r in reads))
        codes[:B] = c.reshape(B, L)
        amb[:B] = m.reshape(B, L)
        lens[:B] = L
    else:
        for i, r in enumerate(reads):
            c, m = dna.encode_with_mask(r.seq)
            codes[i, : len(c)] = c
            amb[i, : len(c)] = m
            lens[i] = len(c)

    # both strands, left-aligned
    rc = np.where(
        np.arange(L)[None, :] < lens[:, None],
        3 - np.take_along_axis(
            codes, np.clip(lens[:, None] - 1 - np.arange(L)[None, :], 0, L - 1),
            axis=1,
        ),
        0,
    )
    ra_m = np.take_along_axis(
        amb, np.clip(lens[:, None] - 1 - np.arange(L)[None, :], 0, L - 1), axis=1
    )
    rc_amb = np.where(np.arange(L)[None, :] < lens[:, None], ra_m, 0)
    codes2 = np.concatenate([codes, rc]).astype(np.int32)
    amb2 = np.concatenate([amb, rc_amb]).astype(np.int32)
    lens2 = np.concatenate([lens, lens])

    ra_c, ra_a = right_align(codes2, amb2, lens2)
    rw, ab, lm = pack_reads(codes2, amb2, lens2)
    valid_lens = lens[:B][lens[:B] > 0]
    min_len = int(valid_lens.min()) if len(valid_lens) else 0

    seed_ra = seed_amb = seed_lens = seed_off = None
    min_seed_len = 0
    if k > 0:
        S = k + 1
        cap = -(-L // S)
        B2 = 2 * Bp
        q, r = lens2 // S, lens2 % S
        s_idx = np.arange(S)[None, :]
        off = (s_idx * q[:, None] + np.minimum(s_idx, r[:, None])).astype(np.int32)
        slen = (q[:, None] + (s_idx < r[:, None])).astype(np.int32)
        # extract + right-align in one gather per element (host numpy)
        i_idx = np.arange(cap)[None, None, :]
        src = off[:, :, None] + i_idx - (cap - slen[:, :, None])
        ok = src >= off[:, :, None]
        src_safe = np.clip(src, 0, L - 1)
        sc = np.take_along_axis(
            np.repeat(codes2[:, None, :], S, axis=1), src_safe, axis=2
        )
        sa_ = np.take_along_axis(
            np.repeat(amb2[:, None, :], S, axis=1), src_safe, axis=2
        )
        seed_ra = np.where(ok, sc, 0).reshape(B2 * S, cap).astype(np.int32)
        seed_amb = np.where(ok, sa_, 0).reshape(B2 * S, cap).astype(np.int32)
        seed_lens = slen.reshape(B2 * S)
        seed_off = off.reshape(B2 * S)
        pos_seeds = seed_lens[seed_lens > 0]
        min_seed_len = int(pos_seeds.min()) if len(pos_seeds) else 0

    return (
        EncodedBatch(
            ra_codes=ra_c, ra_amb=ra_a, lens=lens2,
            read_words=rw, amb_bits=ab, len_mask=lm,
            seed_ra=seed_ra, seed_amb=seed_amb, seed_lens=seed_lens,
            seed_off=seed_off, min_len=min_len, min_seed_len=min_seed_len,
        ),
        Bp,
    )


# ---------------------------------------------------------------------------
# Device-side batch prep for uniform-length packed reads
# ---------------------------------------------------------------------------


def _len_mask_words(L: int) -> np.ndarray:
    """int32[W] length mask of one length-L read (pack_reads layout)."""
    return pack_reads(np.zeros((1, L), np.int32), np.zeros((1, L), np.int32),
                      np.array([L]))[2][0]


@functools.lru_cache(maxsize=None)
def _len_mask(L: int, device: torch.device) -> torch.Tensor:
    """_len_mask_words(L) on `device`, made once per (L, device): a copy
    from the host syncs, and a CUDA graph cannot capture it."""
    return torch.from_numpy(_len_mask_words(L)).to(device)


def _unpack_words(words, L: int, step: int):
    """(B, W) packed words -> (B, L) fields of `step` bits at even slots
    (the shift may be arithmetic: only the masked low bits are kept)."""
    rep = words.repeat_interleave(16, dim=1)[:, :L]
    shifts = torch.from_numpy((2 * (np.arange(L) % 16)).astype(np.int32))
    return (rep >> shifts.to(words.device)) & ((1 << step) - 1)


def _pack_words(vals, W: int):
    """(B, L) 2-bit values -> (B, W) packed int32 words."""
    B, L = vals.shape
    v = torch.cat([vals.to(torch.int64),
                   vals.new_zeros((B, W * 16 - L), dtype=torch.int64)], dim=1)
    shifts = 2 * torch.arange(16, dtype=torch.int64, device=vals.device)
    return i32((v.reshape(B, W, 16) << shifts).sum(2))


def device_prep_uniform(read_words, amb_bits, L: int, k: int):
    """Both-strand code planes of uniform-length packed reads, laid out as
    encode_batch lays them out: (ra_codes2, ra_amb2, lens2, read_words2,
    amb_bits2, len_mask2, seeds), seeds = (seed_ra, seed_amb, seed_lens,
    seed_off) for k > 0, else None. The 1-step fallback runs on these."""
    B, W = read_words.shape
    dev = read_words.device
    codes = _unpack_words(read_words, L, 2)
    amb = _unpack_words(amb_bits, L, 1)
    rc = 3 - codes.flip(1)
    rca = amb.flip(1)
    codes2 = torch.cat([codes, rc])
    amb2 = torch.cat([amb, rca])
    lens2 = torch.full((2 * B,), L, dtype=torch.int32, device=dev)
    rw2 = torch.cat([read_words, _pack_words(rc, W)])
    ab2 = torch.cat([amb_bits, _pack_words(rca, W)])
    lm2 = _len_mask(L, dev).unsqueeze(0).expand(2 * B, W)

    seeds = None
    if k > 0:
        nS = k + 1
        cap = -(-L // nS)
        layout = seed_layout(L, nS)
        pad = torch.zeros((2 * B, cap), dtype=torch.int32, device=dev)

        def right_aligned(plane):
            parts = [torch.cat([pad[:, : cap - slen], plane[:, off : off + slen]], 1)
                     for off, slen in layout]
            return torch.stack(parts, dim=1).reshape(2 * B * nS, cap)

        offs, slens = (torch.tensor(x, dtype=torch.int32, device=dev).repeat(2 * B)
                       for x in zip(*layout))
        seeds = (right_aligned(codes2), right_aligned(amb2), slens, offs)
    return codes2, amb2, lens2, rw2, ab2, lm2, seeds


def device_prep_packed(read_words, amb_bits, L: int, out=None):
    """Both-strand packed rows: (rw2, ab2, lens2, lm2), forward rows first
    (revcomp_both: one kernel on the card). out = (rw2, ab2), int32[2B, W]
    planes to write into: where read_words and amb_bits are their rows
    [0, B), as Engine uploads a block, only the reverse half is written."""
    B, W = read_words.shape
    rw2, ab2, lens2 = revcomp_both(read_words, amb_bits, L, out)
    return rw2, ab2, lens2, _len_mask(L, read_words.device).unsqueeze(0).expand(2 * B, W)


def pack_reads_for_bench(reads):
    """Pack a uniform-length read list to (read_words, amb_bits)."""
    B = len(reads)
    L = len(reads[0].seq)
    c, m = dna.encode_with_mask("".join(r.seq for r in reads))
    codes = c.reshape(B, L).astype(np.int32)
    amb = m.reshape(B, L).astype(np.int32)
    rw, ab, _ = pack_reads(codes, amb, np.full(B, L, np.int32))
    return rw, ab


# ---------------------------------------------------------------------------
# Device pipelines (plain functions of one shard + one batch)
# ---------------------------------------------------------------------------


def _locate_compacted(shard: Shard, rows, counts, *, sa_rate, cap):
    """Compact the rows of per-lane counts (rows[l, :counts[l]]), locate
    them, scatter positions back (-1 fill). Returns (pos, loc_over,
    dropped bool[lanes]): lanes whose rows did not all fit the cap."""
    sel, count, loc_over, dropped = compact_counts(counts, rows.shape[-1], cap)
    # sel indexes a live lane's own slots, so locate's row gather is in range
    pos_c = locate_walk(shard.lattice, shard.ssa, shard.C, shard.dollar_row,
                        rows.reshape(-1), sel, count, sa_rate)
    pos = scatter_back(pos_c, sel, count, rows.numel(), fill=-1)
    return pos.reshape(rows.shape), loc_over, dropped


def _exact_finish(shard: Shard, sp, ep, fix_over, *, max_hits, sa_rate,
                  loc_factor, cap_scale=1):
    """Interval expand -> compacted locate. Returns (pos int32[B2, H],
    valid, overflow int32[B2], loc_over): compaction drops and fixup
    losses join the interval overflow, one incompleteness count per row."""
    rows, valid, overflow = interval_rows(sp, ep, max_hits)
    pos, loc_over, dropped = _locate_compacted(
        shard, rows, ep - sp, sa_rate=sa_rate,
        cap=compact_cap(sp.shape[0], loc_factor, cap_scale))
    overflow = overflow + dropped.to(torch.int32) + fix_over
    return pos, valid & (pos >= 0), overflow, loc_over


def exact_pipeline(shard: Shard, ra_codes, ra_amb, lens, *, d: int, max_hits: int,
                   sa_rate: int, loc_factor=2, cap_scale: int = 1):
    """1-step exact path: k-mer start -> backward_search_ra -> locate.
    Returns (pos int32[B2, H], valid bool[B2, H], overflow int32[B2],
    loc_over)."""
    sp, ep, fix_over = backward_search_ra(
        shard.lattice, shard.C, shard.dollar_row, shard.n,
        shard.kmer_tables[d] if d > 0 else None, ra_codes, ra_amb, lens, d,
        cap_scale=cap_scale)
    return _exact_finish(shard, sp, ep, fix_over, max_hits=max_hits,
                         sa_rate=sa_rate, loc_factor=loc_factor, cap_scale=cap_scale)


def inexact_pipeline(shard: Shard, seed_ra, seed_amb, seed_lens, seed_off,
                     read_words, amb_bits, len_mask, lens, *, k: int, d: int,
                     max_loc: int, sa_rate: int, loc_factor=4, cap_scale: int = 1):
    """1-step pigeonhole seed-and-extend over right-aligned seed lanes
    (lane = read_row * (k+1) + slot). Returns the dense (cand int32[B2,
    Ct], nm, valid, overflow int32[B2], comp_over)."""
    sp, ep, fix_over = backward_search_ra(
        shard.lattice, shard.C, shard.dollar_row, shard.n,
        shard.kmer_tables[d] if d > 0 else None, seed_ra, seed_amb, seed_lens, d,
        cap_scale=cap_scale)
    empty = seed_lens == 0
    sp = torch.where(empty, 0, sp)
    ep = torch.where(empty, 0, ep)
    return _inexact_from_intervals(
        shard, sp, ep, seed_off, read_words, amb_bits, len_mask, lens, k=k,
        max_loc=max_loc, sa_rate=sa_rate, loc_factor=loc_factor,
        fix_over=fix_over, cap_scale=cap_scale, compact_output=False)


def _inexact_from_intervals(shard: Shard, sp, ep, seed_off, read_words,
                            amb_bits, len_mask, lens, *, k, max_loc, sa_rate,
                            loc_factor, fix_over, cap_scale=1, compact_output=True):
    """Seed-lane intervals -> ONE compaction -> locate -> packed verify.

    Lane l = read_row * (k+1) + seed_slot; a candidate's read start is
    locate(row) - seed_off[l]; at sa_rate > 1 (or without the locv
    table) verify_nm finds each candidate's read row, seed offset and
    validity itself, so nothing runs between locate_walk and verify_nm.
    Returns the compacted candidate list
    (cand_c, nm_c, sel, count) plus the per-row incompleteness count
    (interval overflow, compaction drop or finisher loss) and the
    compaction overflow; with compact_output=False the candidates are
    scattered back to dense (B2, (k+1) * max_loc) planes instead (fill -1
    / NM_INVALID): (cand, nm, nm <= k, overflow, comp_over). Duplicates
    across seed slots are left for the host assembler (results.py
    dedupes on (read, pos, strand)).
    """
    B2 = read_words.shape[0]
    nS = k + 1
    rows, _, overflow_s = interval_rows(sp, ep, max_loc)
    cap = compact_cap(B2, loc_factor, cap_scale)
    sel, count, comp_over, dropped = compact_counts(ep - sp, max_loc, cap)
    overflow = (overflow_s + dropped.to(torch.int32) + fix_over).reshape(
        B2, nS).sum(1, dtype=torch.int32)
    if sa_rate == 1 and shard.locv.shape[-1] > 1:
        sel_valid = torch.arange(cap, dtype=torch.int32, device=sp.device) < count
        # sel indexes a live lane's own slots, so every gather below is in range
        lane = sel // max_loc
        b_idx = lane // nS
        off_l = seed_off.index_select(0, lane)
        reads_c = (read_words.index_select(0, b_idx), amb_bits.index_select(0, b_idx),
                   len_mask.index_select(0, b_idx), lens.index_select(0, b_idx))
        # fused locate+verify: ONE row per candidate yields the SA value
        # and the text window (verify2.build_locv_rows)
        spos_c, nm_c = verify_locv(shard.locv, shard.text_len,
                                   rows.reshape(-1).index_select(0, sel), sel_valid,
                                   off_l, *reads_c)
        cand_c = spos_c - off_l
    else:
        # the candidates' read rows, seed offsets and validity are found in
        # verify_nm's kernel, from sel and the read-level rows
        spos_c = locate_walk(shard.lattice, shard.ssa, shard.C, shard.dollar_row,
                             rows.reshape(-1), sel, count, sa_rate)
        cand_c, nm_c = verify_nm(shard.text_rows, shard.text_len, spos_c, sel, count,
                                 seed_off, read_words, amb_bits, len_mask, lens, max_loc,
                                 nS)
    if compact_output:
        return cand_c, nm_c, sel, count, overflow, comp_over
    total = B2 * nS * max_loc
    cand = scatter_back(cand_c, sel, count, total, fill=-1).reshape(B2, -1)
    nm = scatter_back(nm_c, sel, count, total, fill=NM_INVALID).reshape(B2, -1)
    return cand, nm, nm <= k, overflow, comp_over


def _has_multistep(shard: Shard, d: int) -> bool:
    """The packed (multi-step, compacted) pipelines need the multi-step
    lattice and a k-mer start table (d >= 1); else the 1-step ones run."""
    return bool(shard_occ_step(shard) and d >= 1)


def exact_pipeline_packed(shard: Shard, read_words, amb_bits, *, L, d, max_hits,
                          sa_rate, loc_factor=2, min_trips=0, cap_scale=1,
                          wide_steps=0):
    """Exact search as the k = 0 case of the candidate path: early-stop
    search -> locate -> full-length verify (hit iff nm == 0); compacted
    outputs. Without the multi-step lattice or at d = 0: the 1-step
    exact_pipeline on device-derived code planes, dense outputs."""
    if not _has_multistep(shard, d):
        ra2, raa2, lens2, *_ = device_prep_uniform(read_words, amb_bits, L, 0)
        return exact_pipeline(shard, ra2, raa2, lens2, d=d, max_hits=max_hits,
                              sa_rate=sa_rate, loc_factor=loc_factor,
                              cap_scale=cap_scale)
    return _exact_packed(shard, device_prep_packed(read_words, amb_bits, L), L=L, d=d,
                         max_hits=max_hits, sa_rate=sa_rate, loc_factor=loc_factor,
                         min_trips=min_trips, cap_scale=cap_scale, wide_steps=wide_steps)


def _exact_packed(shard: Shard, prep, *, L, d, max_hits, sa_rate, loc_factor, min_trips,
                  cap_scale, wide_steps):
    """exact_pipeline_packed's multi-step path on reads already prepped:
    prep = device_prep_packed's (rw2, ab2, lens2, lm2)."""
    rw2, ab2, lens2, lm2 = prep
    sp, ep, rem, fix_over = search_early_stop_packed(
        shard.lattice, shard.latk, shard.latk_inv, shard.C, shard.dollar_row,
        shard.kmer_tables[d], rw2, ab2, 0, L, d, shard_occ_step(shard),
        max_hits, min_trips, cap_scale=cap_scale,
        wide_steps=min(wide_steps, max(L - d, 0)),
    )
    return _inexact_from_intervals(
        shard, sp, ep, rem, rw2, ab2, lm2, lens2, k=0, max_loc=max_hits,
        sa_rate=sa_rate, loc_factor=loc_factor, fix_over=fix_over,
        cap_scale=cap_scale,
    )


def inexact_pipeline_packed(shard: Shard, read_words, amb_bits, *, L, k, d,
                            max_loc, sa_rate, loc_factor=4, min_trips=0,
                            cap_scale=1, wide_steps=0):
    """Pigeonhole seed-and-extend: k+1 static seed slots searched as
    (off, slen) subfields of the packed rows, all candidates verified at
    full length; compacted outputs. Without the multi-step lattice or at
    d = 0: the 1-step inexact_pipeline, dense outputs."""
    if not _has_multistep(shard, d):
        _, _, lens2, rw2, ab2, lm2, seeds = device_prep_uniform(
            read_words, amb_bits, L, k)
        return inexact_pipeline(shard, *seeds, rw2, ab2, lm2, lens2, k=k, d=d,
                                max_loc=max_loc, sa_rate=sa_rate,
                                loc_factor=loc_factor, cap_scale=cap_scale)
    return _seed_expand_packed(shard, device_prep_packed(read_words, amb_bits, L), L=L,
                               k=k, d=d, max_loc=max_loc, sa_rate=sa_rate,
                               loc_factor=loc_factor, min_trips=min_trips,
                               cap_scale=cap_scale, wide_steps=wide_steps)


def _seed_expand_packed(shard: Shard, prep, *, L, k, d, max_loc, sa_rate, loc_factor,
                        min_trips, cap_scale, wide_steps=0):
    """Pigeonhole seed expansion on already-prepped both-strand packed
    rows, prep = device_prep_packed's (rw2, ab2, lens2, lm2): the
    multi-step path of inexact_pipeline_packed, and the tiered path's
    tier 2 on a compacted escalated subset; compacted outputs."""
    rw2, ab2, lens2, lm2 = prep
    B2 = rw2.shape[0]
    nS = k + 1
    sps, eps, offs, fovs = [], [], [], []
    for off, slen in seed_layout(L, nS):
        sp_s, ep_s, rem_s, over = search_early_stop_packed(
            shard.lattice, shard.latk, shard.latk_inv, shard.C,
            shard.dollar_row, shard.kmer_tables[d], rw2, ab2, off, slen, d,
            shard_occ_step(shard), max_loc, min_trips, cap_scale=cap_scale,
            wide_steps=min(wide_steps, max(slen - d, 0)),
        )
        sps.append(sp_s)
        eps.append(ep_s)
        offs.append(off + rem_s)
        fovs.append(over)
    lane_major = lambda xs: torch.stack(xs, dim=1).reshape(B2 * nS)  # noqa: E731
    return _inexact_from_intervals(
        shard, lane_major(sps), lane_major(eps), lane_major(offs), rw2, ab2,
        lm2, lens2, k=k, max_loc=max_loc, sa_rate=sa_rate,
        loc_factor=loc_factor, fix_over=lane_major(fovs), cap_scale=cap_scale,
    )


def tiered_pipeline_packed(shard: Shard, read_words, amb_bits, *, L, k, d, d_seed,
                           max_hits, max_cand, sa_rate, loc_factor,
                           k2_loc_factor, esc_factor=1.0, min_trips=0,
                           cap_scale=1, wide_steps=0):
    """Tiered inexact search: every read runs the full-read exact pass
    (the k = 0 candidate path); only the reads with no nm == 0 hit on
    either strand are compacted (esc_factor caps their share) and run
    the (k+1)-seed expansion.

    Stratum contract, as in bwtpu: reads with no exact hit get their full
    <= k hit set; reads with one get their complete nm == 0 set plus any
    nm <= k hits the exact pass verified. Tier 2 gets `wide_steps` as
    given (the engine passes the full-read depth's count; reference
    fault C.3, kept for parity).

    Returns (cand1, nm1, sel1, cnt1, cand2, nm2, sel2, cnt2, esc_sel,
    esc_cnt, ov_rows, comp_over): list 1 in the exact tier's slot space
    (row = sel1 // max_hits), list 2 in escalated lane space (row2 =
    sel2 // ((k+1) * max_cand), real row esc_sel[row2 % esc_cap], +B for
    the reverse half); ov_rows int32[2B] the combined per-row
    incompleteness count."""
    return _tiered_packed(
        shard, device_prep_packed(read_words, amb_bits, L), L=L, k=k, d=d, d_seed=d_seed,
        max_hits=max_hits, max_cand=max_cand, sa_rate=sa_rate, loc_factor=loc_factor,
        k2_loc_factor=k2_loc_factor, esc_factor=esc_factor, min_trips=min_trips,
        cap_scale=cap_scale, wide_steps=wide_steps)


def _tiered_packed(shard: Shard, prep, *, L, k, d, d_seed, max_hits, max_cand, sa_rate,
                   loc_factor, k2_loc_factor, esc_factor, min_trips, cap_scale, wide_steps):
    """tiered_pipeline_packed on reads already prepped: prep =
    device_prep_packed's (rw2, ab2, lens2, lm2)."""
    step = shard_occ_step(shard)
    assert step and d >= 1 and d_seed >= 1, (step, d, d_seed)
    rw2, ab2, lens2, lm2 = prep
    B2, W = rw2.shape
    B = B2 // 2
    dev = rw2.device

    # tier 1: full-read exact candidate pass
    sp, ep, rem, fov = search_early_stop_packed(
        shard.lattice, shard.latk, shard.latk_inv, shard.C, shard.dollar_row,
        shard.kmer_tables[d], rw2, ab2, 0, L, d, step, max_hits, min_trips,
        cap_scale=cap_scale, wide_steps=min(wide_steps, max(L - d, 0)),
    )
    cand1, nm1, sel1, cnt1, ov1, co1 = _inexact_from_intervals(
        shard, sp, ep, rem, rw2, ab2, lm2, lens2, k=0, max_loc=max_hits,
        sa_rate=sa_rate, loc_factor=loc_factor, fix_over=fov, cap_scale=cap_scale,
    )
    live1 = torch.arange(cand1.shape[0], dtype=torch.int32, device=dev) < cnt1
    is0 = (live1 & (nm1 == 0)).to(torch.int32)
    # sel1 < B2 * max_hits on every lane, so row1 is in range
    has0 = torch.zeros(B2, dtype=torch.int32, device=dev).scatter_reduce(
        0, (sel1 // max_hits).to(torch.int64), is0, reduce="amax")
    read_has0 = (has0[:B] + has0[B:]) > 0

    # escalate live reads (not all-ambiguous padding) without one
    n_amb = popcount32(ab2[:B] & lm2[:B]).sum(1, dtype=torch.int32)
    escalate = ~read_has0 & (n_amb < torch.clamp(lens2[:B], max=L))
    esc_cap = min(compact_cap(B, esc_factor, cap_scale), B)
    # reads escalated past capacity lose their inexact tier (esc_dropped)
    esc_sel, esc_cnt, esc_over, esc_dropped = compact(escalate, esc_cap)

    # tier 2: seed expansion on the escalated subset
    live_e = torch.arange(esc_cap, dtype=torch.int32, device=dev) < esc_cnt
    live_pair = torch.cat([live_e, live_e])
    both = torch.cat([esc_sel, B + esc_sel])
    rw2e = rw2.index_select(0, both)
    # kill the slack lanes beyond esc_cnt (compact pads sel with lane 0):
    # all-ambiguous rows die in the first search step
    ab2e = torch.where(live_pair.unsqueeze(1), ab2.index_select(0, both), lm2[:1])
    lm2e = lm2[:1].expand(2 * esc_cap, W)
    lens2e = torch.full((2 * esc_cap,), L, dtype=torch.int32, device=dev)
    cand2, nm2, sel2, cnt2, ov2, co2 = _seed_expand_packed(
        shard, (rw2e, ab2e, lens2e, lm2e), L=L, k=k, d=d_seed, max_loc=max_cand,
        sa_rate=sa_rate, loc_factor=k2_loc_factor, min_trips=min_trips,
        cap_scale=cap_scale, wide_steps=wide_steps,
    )

    # combined per-row incompleteness: tier-1 rows + escalation drops +
    # tier-2 rows added back to their real rows (dead lanes to the spill
    # slot B2)
    ov_rows = torch.cat([ov1 + torch.cat([esc_dropped, esc_dropped]).to(torch.int32),
                         ov1.new_zeros(1)])
    spill = torch.full_like(esc_sel, B2)
    ov_rows = ov_rows.index_add(0, torch.where(live_e, esc_sel, spill), ov2[:esc_cap])
    ov_rows = ov_rows.index_add(0, torch.where(live_e, B + esc_sel, spill),
                                ov2[esc_cap:])[:B2]
    comp_over = co1 + co2 + esc_over
    return (cand1, nm1, sel1, cnt1, cand2, nm2, sel2, cnt2, esc_sel, esc_cnt,
            ov_rows, comp_over)


def hits_output(out, *, k: int, Ct: int, hit_cap: int):
    """Keep the verified hits (nm <= k) of a compacted candidate list,
    compacted again to hit_cap. Hit-compaction drops join the per-row
    overflow. Returns (cand, sel*4 + nm, count, n_over_rows, comp_over,
    hit_over, overflow_rows bool[B2], candidate-stage count); the last
    feeds the occupancy channel of Engine.autotune_caps."""
    cand_c, nm_c, sel, count, overflow, comp_over = out
    live = torch.arange(sel.shape[0], dtype=torch.int32, device=sel.device) < count
    keep = (nm_c <= k) & live
    sel2, cnt2, hover, drop = compact(keep, hit_cap)
    overflow = overflow.index_add(0, sel // Ct, drop.to(torch.int32))
    payload = torch.stack([cand_c, sel * 4 + nm_c], dim=1).index_select(0, sel2)
    ov_rows = overflow > 0
    return (payload[:, 0], payload[:, 1], cnt2, ov_rows.sum(), comp_over,
            hover, ov_rows, count)


# ---------------------------------------------------------------------------
# Host assembly (numpy copies of bwtpu.engine's)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BatchStats:
    reads: int = 0
    hits: int = 0
    overflow_reads: int = 0
    compact_overflows: int = 0
    heals: int = 0  # self-healing re-dispatches (doubled-cap retries)
    truncated_reads: int = 0  # reads still capacity-cut after max_heals
    escalated: int = 0  # tiered dispatch: reads sent to the seed tier
    device_s: float = 0.0  # spans "wait" + "fetch": the host blocked on, and copying from, the card
    host_s: float = 0.0  # spans "assemble": host assembly of the last level


def _assemble_flat(reads, B, s_idx, row_idx, p, m, text_lens, offsets):
    """Flat (shard, read-strand row, local pos, nm) vectors -> per-read
    deduped sorted Hit lists (results.py)."""
    from bwtpu_torch.results import hit_lists

    read_lens = np.array([len(r.seq) for r in reads], dtype=np.int64)
    flat = flatten_hits(
        len(reads), read_lens, B, s_idx, row_idx, p, m, text_lens, offsets
    )
    return hit_lists(flat)


def dense_to_columns(pos, nm, valid):
    """(S, 2B, H) dense device outputs -> flat (s_idx, row_idx, p, m)."""
    s_idx, row_idx, h_idx = np.nonzero(valid)
    p = pos[s_idx, row_idx, h_idx]
    m = nm[s_idx, row_idx, h_idx] if nm is not None else np.zeros(len(p), int)
    return s_idx, row_idx, p, m


def compact_to_columns(shard_comp, k, Ct):
    """Per-shard compacted outputs (cand_c, nm_c, sel, count) -> flat
    (s_idx, row_idx, p, m) columns; read-strand row = sel // Ct."""
    s_l, row_l, p_l, m_l = [], [], [], []
    for s, (cand_c, nm_c, sel, count) in enumerate(shard_comp):
        cnt = int(count)
        cand_c, nm_c, sel = cand_c[:cnt], nm_c[:cnt], sel[:cnt]
        keep = nm_c <= k
        cand_c, nm_c, sel = cand_c[keep], nm_c[keep], sel[keep]
        s_l.append(np.full(len(sel), s, dtype=np.int64))
        row_l.append(sel // Ct)
        p_l.append(cand_c)
        m_l.append(nm_c)
    return (
        np.concatenate(s_l), np.concatenate(row_l),
        np.concatenate(p_l), np.concatenate(m_l),
    )


def tiered_to_columns(out, max_hits, max_cand, k, B):
    """Host decode of tiered_pipeline_packed's outputs (numpy) -> flat
    (row_idx, p, m) columns, the per-row overflow count and comp_over.
    Tier-2 rows map from escalated lane space back to real read-strand
    rows via esc_sel. Dedups on (row, pos) keeping the min nm, so a hit
    found by both tiers is reported once (numpy copy of bwtpu's)."""
    (cand1, nm1, sel1, cnt1, cand2, nm2, sel2, cnt2,
     esc_sel, esc_cnt, ov_rows, comp_over) = [np.asarray(o) for o in out]
    c1 = int(cnt1)
    keep1 = nm1[:c1] <= k
    rows1 = (sel1[:c1] // max_hits)[keep1]
    p1, m1 = cand1[:c1][keep1], nm1[:c1][keep1]
    esc_cap = len(esc_sel)
    Ct2 = (k + 1) * max_cand
    c2 = int(cnt2)
    keep2 = nm2[:c2] <= k
    r2e = (sel2[:c2] // Ct2)[keep2]
    fwd = r2e < esc_cap
    real2 = np.where(fwd, esc_sel[r2e % esc_cap],
                     B + esc_sel[(r2e - esc_cap) % esc_cap])
    p2, m2 = cand2[:c2][keep2], nm2[:c2][keep2]
    rows = np.concatenate([rows1, real2])
    p = np.concatenate([p1, p2])
    m = np.concatenate([m1, m2])
    order = np.lexsort((m, p, rows))
    rows, p, m = rows[order], p[order], m[order]
    first = np.ones(len(rows), dtype=bool)
    first[1:] = (rows[1:] != rows[:-1]) | (p[1:] != p[:-1])
    return (rows[first], p[first], m[first], int((ov_rows > 0).sum()),
            int(comp_over))


def assemble_hits(reads, B, pos, nm, valid, text_lens, offsets):
    """(S, 2B, H) dense device outputs -> per-read Hit lists."""
    s_idx, row_idx, p, m = dense_to_columns(pos, nm, valid)
    return _assemble_flat(reads, B, s_idx, row_idx, p, m, text_lens, offsets)


def assemble_hits_compact(reads, B, shard_comp, k, Ct, text_lens, offsets):
    """Compacted device outputs -> per-read Hit lists."""
    s_idx, row_idx, p, m = compact_to_columns(shard_comp, k, Ct)
    return _assemble_flat(reads, B, s_idx, row_idx, p, m, text_lens, offsets)


def _np(t: torch.Tensor) -> np.ndarray:
    """A tensor on the host (counter d2h_bytes)."""
    a = t.cpu().numpy()
    trace.count("d2h_bytes", a.nbytes)
    return a


def _tolist(t: torch.Tensor) -> list:
    """A tensor's values on the host (counter d2h_bytes)."""
    trace.count("d2h_bytes", t.numel() * t.element_size())
    return t.tolist()


def _bitmap(flags: torch.Tensor) -> torch.Tensor:
    """bool[n] -> int32[ceil(n / 32)]: flag r at bit r % 32 of word r // 32."""
    n = flags.shape[0]
    v = torch.cat([flags.to(torch.int64), flags.new_zeros(-n % 32, dtype=torch.int64)])
    shifts = torch.arange(32, dtype=torch.int64, device=flags.device)
    return i32((v.view(-1, 32) << shifts).sum(1))


def _unbits(words: np.ndarray, n: int) -> np.ndarray:
    """Inverse of _bitmap on the host: bool[n]."""
    return np.unpackbits(np.ascontiguousarray(words, "<i4").view(np.uint8),
                         bitorder="little")[:n].astype(bool)


def _fixed_outputs(mode: str, out) -> list:
    """One shard's outputs of mode "hits" (hits_output) or "tiered"
    (tiered_pipeline_packed) as the fixed-shape tensors the grouped fetch
    packs: the scalars of "hits" in one int32[5], the per-row overflow as
    a bitmap."""
    if mode == "hits":
        cand, hm, cnt, n_over, comp_over, hit_over, ov_rows, count = out
        scal = torch.stack([x.to(torch.int32) for x in (cnt, n_over, comp_over, hit_over,
                                                        count)])
        return [cand, hm, scal, _bitmap(ov_rows)]
    return [*out[:10], _bitmap(out[10] > 0), out[11]]


def _pack(mode: str, outs) -> tuple[torch.Tensor, list]:
    """Every shard's outputs of `mode` as _fixed_outputs in ONE int32
    buffer, and their shapes (per shard) to split it by."""
    per_shard = [_fixed_outputs(mode, o) for o in outs]
    shapes = [[tuple(t.shape) for t in ts] for ts in per_shard]
    return torch.cat([t.reshape(-1).to(torch.int32) for ts in per_shard for t in ts]), shapes


def _fetch_grouped(buf: torch.Tensor, shapes: list) -> list[list[np.ndarray]]:
    """ONE device-to-host copy of a _pack buffer: per-shard numpy lists."""
    flat = _np(buf)
    per_shard, at = [], 0
    for shard in shapes:
        arrs = []
        for shape in shard:
            n = int(np.prod(shape))
            arrs.append(flat[at:at + n].reshape(shape))
            at += n
        per_shard.append(arrs)
    return per_shard


class FusedGraph(NamedTuple):
    """One captured fused program: its static inputs and packed output."""

    graph: torch.cuda.CUDAGraph
    rw: torch.Tensor  # int32[2Bp, W] static stacked planes: packed reads, then the prep's
    ab: torch.Tensor  # int32[2Bp, W] the same of the ambiguity bits
    out: torch.Tensor  # int32 packed outputs of every shard
    shapes: list  # per shard, the shapes to split `out` by
    launches: dict  # {kernel name: launches the capture recorded}


# ---------------------------------------------------------------------------
# Engine (host orchestration)
# ---------------------------------------------------------------------------


class Engine:
    """Alignment engine over one or more index shards on one torch device.

    Every shard is dispatched in turn (bwtpu's list form with
    vmap_shards=False, fuse_shards=False) on the same device-resident
    reads, and the host assembles all shards' hits with their text
    lengths and global offsets. device="cuda" runs the CUDA kernels and
    raises when CUDA is absent; device="cpu" runs their plain-torch
    versions (the tests).

    fuse_shards=True (bwtpu's fused list form, off by default as there):
    with more than one shard, the "hits" and "tiered" block modes run
    every shard's pipeline as ONE program (_dispatch_fused) whose outputs
    land in one int32 buffer. On the card the program is captured once
    per capacity key into a CUDA graph and each block is one replay; a
    capture or replay that fails raises. "compact", "dense" and Read
    lists stay per shard, as in bwtpu."""

    def __init__(self, shards: list[FMIndex], device="cuda", fuse_shards: bool = False):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Engine(device='cuda'): no CUDA device is available")
        self.shards = shards
        self.config = shards[0].config
        self.dev_shards = upload_index(shards, self.device)
        self.fuse_shards = fuse_shards
        # the fused form's CUDA graphs by key, the seconds each took to
        # warm up and capture, and each key's replays so far; one lock orders
        # capture, input copy, replay and output copy across threads (the
        # CLI finishes blocks, and heals, on a worker thread)
        self._graphs: dict = {}
        self.captures: dict = {}
        self.graph_replays = collections.Counter()
        self._graph_lock = threading.Lock()
        self.kmer_depths = sorted(shards[0].kmer_tables)
        self.stats = BatchStats()
        # occupancy channel: max observed candidate-stage and hit live
        # fractions (live rows / lane count) per k, fed by finish_block;
        # autotune_caps reads them and sets per-k loc_factor / hit_factor
        # overrides (the config values stay the ceilings)
        self._cand_live_frac: dict = {}
        self._hit_live_frac: dict = {}
        self._lf_override: dict = {}
        self._hf_override: dict = {}

    def _text_lens(self) -> list[int]:
        return [sh.text_len for sh in self.shards]

    def _offsets(self) -> list[int]:
        return [sh.shard_offset for sh in self.shards]

    def _multistep(self, d: int) -> bool:
        """Every shard has the same lattice form (upload_index)."""
        return _has_multistep(self.dev_shards[0], d)

    def _wide_steps(self, d: int) -> int:
        """Two-gather 1-step narrowings before the multi-step loop, sized
        so E[width] = n / 4^d of the largest shard falls to <= 8 (0 at
        bacterial scale)."""
        if d <= 0:
            return 0
        lam = max(sh.n for sh in self.shards) / 4.0**d
        w = 0
        while lam > 8 and w < 8:
            lam /= 4
            w += 1
        return w

    # quantized loc_factor ladder: autotune_caps picks from here
    LF_LADDER = (0.25, 0.35, 0.45, 0.5, 0.6, 0.75, 1.0, 1.25, 1.5,
                 2.0, 3.0, 4.0, 6.0)

    def autotune_caps(self, block, k: int | None = None,
                      margin: float = 1.12, pad_to: int | None = None):
        """Occupancy-adaptive capacities, as in bwtpu: dispatch `block`
        once at the current caps (every shard), observe the largest
        shard's candidate-stage live fraction, and point this k's
        loc_factor at the smallest ladder value covering live * margin,
        never above the configured ceiling (healing absorbs batches that
        beat the margin); the hit buffer likewise from the live hit
        fraction. Returns the chosen loc_factor. A probe that overflowed
        even after healing keeps the ceilings."""
        k = self.config.k if k is None else k
        self._cand_live_frac.pop(k, None)
        self._hit_live_frac.pop(k, None)
        ov0 = self.stats.overflow_reads + self.stats.compact_overflows
        self.finish_block(self.dispatch_block(block, k, pad_to=pad_to))
        if self.stats.overflow_reads + self.stats.compact_overflows > ov0:
            log.warning("autotune_caps: probe batch overflowed; keeping "
                        "configured ceilings for k=%d", k)
            return self._lf(k)
        live = self._cand_live_frac.get(k)
        if live is None:  # dense fallback path: no occupancy channel
            return self._lf(k)
        lf = next((v for v in self.LF_LADDER if v >= live * margin),
                  self.config.loc_factor)
        lf = min(lf, self.config.loc_factor)
        if lf != self._lf(k):
            log.info("autotune_caps: k=%d live frac %.3f -> loc_factor %s "
                     "(was %s)", k, live, lf, self._lf(k))
        self._lf_override[k] = lf
        hlive = self._hit_live_frac.get(k)
        if hlive is not None:
            hf = next((v for v in self.LF_LADDER if v >= hlive * margin),
                      self.config.hit_factor)
            self._hf_override[k] = min(hf, self.config.hit_factor)
        return lf

    def _lf(self, k: int) -> float:
        """Effective base loc_factor for this k (autotune override or the
        configured ceiling)."""
        return self._lf_override.get(k, self.config.loc_factor)

    def _hf(self, k: int) -> float:
        """Effective base hit_factor for this k."""
        return self._hf_override.get(k, self.config.hit_factor)

    def _caps(self, k: int, level: int):
        """(max_hits, max_cand, loc_factor, hit_factor) at heal level
        `level`: every capacity doubles per level; from level 1 the hit
        buffer is as wide as the compaction cap."""
        f = 1 << level
        cfg = self.config
        mh = cfg.max_hits * f
        mc = cfg.max_cand * f
        max_loc = mc if k else mh
        lf = min(self._lf(k) * f, (k + 1) * max_loc)
        hf = self._hf(k) if level == 0 else lf
        return mh, mc, lf, hf

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _upload(self, rw: np.ndarray, ab: np.ndarray, Bp: int):
        """Packed forward reads into rows [0, Bp) of new int32[2Bp, W]
        stacked planes on the device (one host-to-device copy a plane),
        rows past the reads padded with zero words and all-ambiguous bits.
        Rows [Bp, 2Bp) are left to the prep (_prepped). Span "upload",
        counter h2d_bytes."""
        n, W = rw.shape
        planes = []
        with trace.span("upload"):
            for a, pad in ((rw, 0), (ab, 0x55555555)):
                if Bp > n:
                    a = np.concatenate([a, np.full((Bp - n, W), pad, np.int32)])
                a = np.ascontiguousarray(a)
                t = torch.empty((2 * Bp, W), dtype=torch.int32, device=self.device)
                t[:Bp].copy_(torch.from_numpy(a))
                planes.append(t)
                trace.count("h2d_bytes", a.nbytes)
        return planes

    def _prepped(self, rw2, ab2, L: int, d: int):
        """What every shard's packed pipeline takes of a batch's stacked
        planes (_upload): on the multi-step path both strands, prepped here
        once for all shards (device_prep_packed in place: only rows [Bp,
        2Bp) are written); on the 1-step fallback the forward rows, which
        it preps per shard (device_prep_uniform)."""
        Bp = rw2.shape[0] // 2
        if self._multistep(d):
            return device_prep_packed(rw2[:Bp], ab2[:Bp], L, (rw2, ab2))
        return rw2[:Bp], ab2[:Bp]

    def _run_packed(self, shard: Shard, prepped, L: int, k: int, d: int, level: int):
        """A batch's _prepped reads -> one shard's packed pipeline outputs:
        compacted when the multi-step path runs, else the 1-step
        fallback's dense outputs."""
        mh, mc, lf, _ = self._caps(k, level)
        opts = dict(sa_rate=self.config.sa_rate, loc_factor=lf,
                    min_trips=self.config.min_trips, cap_scale=1 << level,
                    wide_steps=self._wide_steps(d))
        multistep = self._multistep(d)
        if k == 0:
            if multistep:
                return _exact_packed(shard, prepped, L=L, d=d, max_hits=mh, **opts)
            return exact_pipeline_packed(shard, *prepped, L=L, d=d, max_hits=mh, **opts)
        if multistep:
            return _seed_expand_packed(shard, prepped, L=L, k=k, d=d, max_loc=mc, **opts)
        return inexact_pipeline_packed(shard, *prepped, L=L, k=k, d=d, max_loc=mc, **opts)

    def _run_tiered(self, shard: Shard, prepped, L: int, k: int, level: int):
        """A block's _prepped reads -> one shard's tiered_pipeline_packed
        outputs: tier 1 at the k = 0 caps, tier 2 at this k's caps."""
        mh0, _, lf0, _ = self._caps(0, level)
        _, mc, lf, _ = self._caps(k, level)
        d_full = pick_kmer_depth(self.kmer_depths, L)
        return _tiered_packed(
            shard, prepped, L=L, k=k, d=d_full,
            d_seed=pick_kmer_depth(self.kmer_depths, L // (k + 1)),
            max_hits=mh0, max_cand=mc, sa_rate=self.config.sa_rate,
            loc_factor=lf0, k2_loc_factor=lf, esc_factor=self.config.esc_factor,
            min_trips=self.config.min_trips, cap_scale=1 << level,
            # the full-read depth's count for both tiers (C.3)
            wide_steps=self._wide_steps(d_full))

    # ---- Read lists (align_batch, align_all) ----

    def dispatch_batch(self, reads: list[Read], k: int, _level: int = 0):
        """Encode + launch device work for one batch on every shard;
        returns a handle for finish_batch. Uniform-length batches no
        longer than read_len run the packed pipelines on 2-bit packed
        forward reads; mixed lengths go through encode_batch and the 1-step
        pipelines (dense). The reads go to the device once for all shards.

        _level: self-healing escalation level — all capacities run at
        2**_level x their configured values."""
        L = len(reads[0].seq) if reads else 0
        if reads and 0 < L <= self.config.read_len and all(
            len(r.seq) == L for r in reads
        ):
            B = len(reads)
            c, m = dna.encode_with_mask("".join(r.seq for r in reads))
            rw, ab, _ = pack_reads(c.reshape(B, L).astype(np.int32),
                                   m.reshape(B, L).astype(np.int32),
                                   np.full(B, L, np.int32))
            d = pick_kmer_depth(self.kmer_depths, L if k == 0 else L // (k + 1))
            prepped = self._prepped(*self._upload(rw, ab, B), L, d)
            outs = [self._run_packed(sh, prepped, L, k, d, _level) for sh in self.dev_shards]
            mode = "compact" if self._multistep(d) else "dense"
            return (reads, B, k, outs, mode, _level)

        enc, B = encode_batch(self.config, reads, k)
        mh, mc, lf, _ = self._caps(k, _level)
        opts = dict(sa_rate=self.config.sa_rate, loc_factor=lf,
                    cap_scale=1 << _level)
        if k == 0:
            d = pick_kmer_depth(self.kmer_depths, enc.min_len)
            args = tuple(map(self._put, (enc.ra_codes, enc.ra_amb, enc.lens)))
            outs = [exact_pipeline(sh, *args, d=d, max_hits=mh, **opts)
                    for sh in self.dev_shards]
        else:
            d = pick_kmer_depth(self.kmer_depths, enc.min_seed_len)
            args = tuple(map(self._put, (
                enc.seed_ra, enc.seed_amb, enc.seed_lens, enc.seed_off,
                enc.read_words, enc.amb_bits, enc.len_mask, enc.lens)))
            outs = [inexact_pipeline(sh, *args, k=k, d=d, max_loc=mc, **opts)
                    for sh in self.dev_shards]
        return (reads, B, k, outs, "dense", _level)

    def _maybe_heal_batch(self, reads, k, overflow, compact_over, level):
        """Self-healing re-dispatch: when any row overflowed a capacity
        (interval / compaction / fixup) on any shard and heal levels
        remain, re-run the whole batch with every cap doubled. Returns the
        healed hits or None."""
        n_over = int((overflow.sum(axis=0) > 0).sum())
        cfg = self.config
        if (n_over or compact_over) and cfg.heal_overflow and (
            level < cfg.max_heals
        ):
            self.stats.heals += 1
            log.info(
                "align_batch: %d overflowed rows / %d compaction drops — "
                "healing with 2^%d x caps", n_over, compact_over, level + 1,
            )
            return self.finish_batch(
                self.dispatch_batch(reads, k, _level=level + 1)
            )
        return None

    def finish_batch(self, handle) -> list[list[Hit]]:
        """Materialize a dispatch_batch handle -> per-read Hit lists (spans
        "fetch" and "assemble", which stats.device_s and host_s add, as in
        finish_block)."""
        reads, B, k, outs, mode, level = handle
        mh, mc, lf, hf = self._caps(k, level)
        Ct = (k + 1) * mc if k else mh
        with trace.span("fetch") as fetch:
            if mode == "compact":
                # (cand_c, nm_c, sel, count, overflow, comp_over) per shard
                counts = _tolist(torch.stack([o[3] for o in outs]))
                shard_comp = [(_np(o[0][:c]), _np(o[1][:c]), _np(o[2][:c]), c)
                              for o, c in zip(outs, counts)]
                overflow = np.stack([_np(o[4]) for o in outs])  # (shards, 2B)
                compact_over = int(sum(_np(o[5]) for o in outs))
            else:  # dense: (pos, valid, overflow, co) or (pos, nm, valid, overflow, co)
                outs = [o if k else (o[0], None, *o[1:]) for o in outs]
                pos, valid, overflow = (np.stack([_np(o[i]) for o in outs]) for i in (0, 2, 3))
                nm = np.stack([_np(o[1]) for o in outs]) if k else None
                compact_over = int(sum(_np(o[4]) for o in outs))
        self.stats.device_s += fetch.wall
        healed = self._maybe_heal_batch(reads, k, overflow, compact_over, level)
        if healed is not None:
            return healed
        if mode == "compact":
            if compact_over:
                log.warning(
                    "align_batch: compaction capacity overflowed by %d rows "
                    "after %d heals; results may be incomplete — raise "
                    "loc_factor or max_heals", compact_over, level,
                )
            with trace.span("assemble") as asm:
                hits = assemble_hits_compact(reads, B, shard_comp, k, Ct,
                                             self._text_lens(), self._offsets())
            return self._finish_stats(reads, hits, overflow, compact_over, asm.wall)
        return self._assemble(reads, B, pos, nm, valid, overflow, compact_over)

    def align_batch(self, reads: list[Read], k: int | None = None) -> list[list[Hit]]:
        if not reads:
            return []
        k = self.config.k if k is None else k
        return self.finish_batch(self.dispatch_batch(reads, k))

    def _assemble(self, reads, B, pos, nm, valid, overflow, compact_over):
        if compact_over:
            log.warning(
                "align_batch: compaction capacity overflowed by %d rows; "
                "results may be incomplete — raise loc_factor/max_cand",
                compact_over,
            )
        with trace.span("assemble") as asm:
            out = assemble_hits(reads, B, pos, nm, valid, self._text_lens(), self._offsets())
        return self._finish_stats(reads, out, overflow, compact_over, asm.wall)

    def _finish_stats(self, reads, out, overflow, compact_over, host_s):
        n_over = int((overflow.sum(axis=0) > 0).sum())
        if n_over:
            log.warning(
                "align_batch: %d read-strand rows overflowed interval "
                "capacity (max_hits=%d, max_cand=%d); raise the caps",
                n_over, self.config.max_hits, self.config.max_cand,
            )
        self.stats.reads += len(reads)
        self.stats.hits += sum(len(h) for h in out)
        self.stats.overflow_reads += n_over
        self.stats.compact_overflows += compact_over
        self.stats.host_s += host_s
        return out

    def align_all(self, reads: list[Read], k: int | None = None,
                  batch_size: int | None = None,
                  pipeline_depth: int = 3) -> list[list[Hit]]:
        """Streamed alignment with `pipeline_depth` batches in flight."""
        k = self.config.k if k is None else k
        bs = batch_size or self.config.batch_size
        out: list[list[Hit]] = []
        inflight: list = []
        for i in range(0, len(reads), bs):
            inflight.append(self.dispatch_batch(reads[i : i + bs], k))
            if len(inflight) > pipeline_depth:
                out.extend(self.finish_batch(inflight.pop(0)))
        while inflight:
            out.extend(self.finish_batch(inflight.pop(0)))
        return out

    # ---- columnar ReadBlocks (the CLI's FASTQ paths) ----

    def dispatch_block(self, block, k: int | None = None,
                       pad_to: int | None = None, _level: int = 0,
                       tiered: bool = False):
        """Run a uniform-length columnar ReadBlock (readblock.py)
        through the packed pipelines of every shard. pad_to keeps batch
        shapes fixed across a stream; pad rows are all-ambiguous and die at
        the start table. Output modes, as in bwtpu: "hits" (one compacted
        hit list per shard), "compact" when the hit payload sel*4 + nm
        would overflow int32, "dense" on the 1-step fallback, "tiered" for
        tiered=True at k > 0 (tiered_pipeline_packed; without the
        multi-step lattice the full inexact pipeline runs instead, whose
        results are a superset of the tiered contract). The packed reads
        go to the device once for all shards (_upload_block), and the
        multi-step path preps both strands once for all of them; "hits" and
        "tiered" take the fused form with fuse_shards and more than one
        shard. Returns a handle for finish_block.

        Span "dispatch" (pack, upload, issue inside), with a new block
        number at level 0; a heal's dispatch keeps its block's."""
        k = self.config.k if k is None else k
        with trace.span("dispatch", block=-1 if _level else trace.new_block()):
            return self._dispatch_packed(block, *self._upload_block(block, pad_to), k,
                                         _level, tiered)

    def _upload_block(self, block, pad_to: int | None):
        """The block's packed forward reads on the device, padded to pad_to
        rows, in rows [0, Bp) of its stacked planes (_upload): (rw2, ab2,
        Bp). The one host sync of a dispatch."""
        from bwtpu_torch.readblock import pack_block

        if not (0 < block.L <= self.config.read_len):
            raise ValueError(f"block read length {block.L} not in (0, {self.config.read_len}]")
        with trace.span("pack"):
            rw, ab = pack_block(block)
        Bp = pad_to or block.n
        return (*self._upload(rw, ab, Bp), Bp)

    def _dispatch_packed(self, block, rw2, ab2, Bp: int, k: int, level: int, tiered: bool):
        """dispatch_block once the reads are in rows [0, Bp) of the stacked
        planes on the device (span "issue"). The handle carries the block
        number and an event recorded after the block's work (None on the
        CPU), which finish_block waits on."""
        with trace.span("issue"):
            L = block.L
            d = pick_kmer_depth(self.kmer_depths, L if k == 0 else L // (k + 1))
            compact_out = self._multistep(d)
            if tiered and k > 0 and not compact_out:
                log.debug("tiered dispatch unavailable without the multi-step "
                          "lattice; running the full inexact pipeline")
            tiered = tiered and k > 0 and compact_out
            mh, mc, _, _ = self._caps(k, level)
            Ct = (k + 1) * mc if k else mh
            if tiered or (compact_out and 2 * Bp * Ct * 4 < HIT_PAYLOAD_MAX):
                mode = "tiered" if tiered else "hits"
                run = functools.partial(self._shard_outputs, L=L, k=k, d=d, level=level,
                                        mode=mode)
                if self.fuse_shards and len(self.dev_shards) > 1:
                    # bwtpu's _packed_fn key (mode, k, d, L, both tiers' caps)
                    # plus the heal level, the rows and the wide steps
                    key = (mode, k, d, L, level, self._caps(k, level),
                           self._caps(0, level) if tiered else None, Bp, self._wide_steps(d))
                    outs = self._dispatch_fused(lambda rw2, ab2: _pack(mode, run(rw2, ab2)),
                                                rw2, ab2, key)
                else:
                    outs = run(rw2, ab2)
            else:
                prepped = self._prepped(rw2, ab2, L, d)
                outs = [self._run_packed(sh, prepped, L, k, d, level) for sh in self.dev_shards]
                mode = "compact" if compact_out else "dense"
        return ("block", block, Bp, k, outs, (trace.current_block(), self._done_event()),
                mode, level)

    def _done_event(self):
        """An event on the current stream after a dispatch's work (None on
        the CPU): what finish_block's "wait" blocks on."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _shard_outputs(self, rw2, ab2, *, L: int, k: int, d: int, level: int,
                       mode: str) -> list:
        """Every shard's "hits" (_run_packed + hits_output) or "tiered"
        (_run_tiered) outputs on a block's stacked planes, the reads in rows
        [0, Bp), prepped here once for every shard. The loop form runs this
        eagerly, the fused form inside one CUDA graph: nothing here syncs
        with the host."""
        prepped = self._prepped(rw2, ab2, L, d)
        if mode == "tiered":
            return [self._run_tiered(sh, prepped, L, k, level) for sh in self.dev_shards]
        mh, mc, _, hf = self._caps(k, level)
        Ct = (k + 1) * mc if k else mh
        per_shard = []
        for sh in self.dev_shards:
            out = self._run_packed(sh, prepped, L, k, d, level)
            hit_cap = min(out[2].shape[0], compact_cap(rw2.shape[0], hf, 1 << level))
            per_shard.append(hits_output(out, k=k, Ct=Ct, hit_cap=hit_cap))
        return per_shard

    def _dispatch_fused(self, run, rw2, ab2, key: tuple):
        """The fused form: `run` (every shard's pipeline on a block's
        stacked planes, its outputs packed into one int32 buffer: (buffer,
        shapes)) as ONE program; returns ("fused", buffer, shapes). On the
        CPU it runs eagerly. On the card the first block of a key runs once
        eagerly on a side stream (kernel builds, library and allocator
        set-up), is captured into a CUDA graph, and every block is then one
        replay, whose static planes get the block's reads in rows [0, Bp)
        (the graph's prep writes the rest). The buffer is copied out of the
        graph's pool, so a later replay never overwrites a handle still in
        flight."""
        if self.device.type != "cuda":
            return ("fused", *run(rw2, ab2))
        Bp = rw2.shape[0] // 2
        with self._graph_lock:
            g = self._graphs.get(key) or self._capture(key, run, rw2, ab2)
            g.rw[:Bp].copy_(rw2[:Bp])
            g.ab[:Bp].copy_(ab2[:Bp])
            g.graph.replay()
            # the replay's kernels run without their wrappers: no launch
            # counter moves (g.launches is what the capture recorded)
            self.graph_replays[key] += 1
            return ("fused", g.out.clone(), g.shapes)

    def _capture(self, key: tuple, run, rw2, ab2) -> FusedGraph:
        """Warm `run` up on a side stream, then capture it into a CUDA
        graph on static copies of the stacked planes (cached under key)."""
        t0 = time.perf_counter()
        srw, sab = rw2.clone(), ab2.clone()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            run(srw, sab)
        torch.cuda.current_stream(self.device).wait_stream(side)
        t1 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with _build.recording() as launches, torch.cuda.graph(
                graph, capture_error_mode="thread_local"):
            out, shapes = run(srw, sab)
        self.captures[key] = {"warmup_s": t1 - t0, "capture_s": time.perf_counter() - t1}
        self._graphs[key] = FusedGraph(graph, srw, sab, out, shapes, launches)
        return self._graphs[key]

    def finish_block(self, handle) -> FlatHits:
        """Materialize a dispatch_block handle -> results.FlatHits.

        Any capacity overflow on any shard re-dispatches the block with
        doubled caps on every shard (bounded by config.max_heals); reads
        still overflowed at the last level are flagged in
        FlatHits.truncated (SAM tag xo:i:1). Counts follow bwtpu's list
        form: in "hits" and "compact" modes the overflowed rows of each
        shard add up, in "tiered" and "dense" modes a row counts once.

        Span "finish", and inside it "wait" (the host blocked on the card
        until the dispatch's event; both with thread CPU time), "fetch" (the
        copies to the host), then "heal" or, at the last level, "assemble"
        (the columns, flatten_hits and the truncation flags). Counters overflow_rows.l<level>,
        compact_drops.l<level> and hit_drops.l<level>: what overflowed at
        each heal level. stats.device_s adds wait and fetch, stats.host_s
        assemble."""
        tag, block, Bp, k, outs, (seq, done), mode, level = handle
        assert tag == "block"
        mh, mc, lf, hf = self._caps(k, level)
        Ct = (k + 1) * mc if k else mh
        cfg = self.config
        can_heal = cfg.heal_overflow and level < cfg.max_heals
        n_over = compact_over = hit_over = 0
        with trace.span("finish", block=seq, cpu=True):
            with trace.span("wait", cpu=True) as wait:
                if done is not None:
                    done.synchronize()
            with trace.span("fetch") as fetch:
                per_shard = None
                if isinstance(outs, tuple):  # the fused form's buffer
                    per_shard = _fetch_grouped(*outs[1:])
                elif mode == "tiered":  # every shard's 12 outputs in one copy
                    per_shard = _fetch_grouped(*_pack(mode, outs))
                if mode == "hits" and per_shard is not None:
                    # each shard's hits at hit_cap, its scalars, its overflow bitmap
                    scal = [s[2].tolist() for s in per_shard]
                    hits = [(s[0][:r[0]], s[1][:r[0]]) for s, r in zip(per_shard, scal)]
                    ov_rows = _unbits(np.bitwise_or.reduce([s[3] for s in per_shard]), 2 * Bp)
                elif mode == "hits":
                    # every shard's scalars in one transfer, then its hits up to
                    # its count (fewer bytes than every shard's full hit buffer)
                    scal = _tolist(torch.stack([x.to(torch.int64) for o in outs for x in
                                                (o[2], o[3], o[4], o[5], o[7])]).view(-1, 5))
                    hits = [(_np(o[0][:r[0]]), _np(o[1][:r[0]])) for o, r in zip(outs, scal)]
                    ov_rows = torch.stack([o[6] for o in outs]).any(0)
                elif mode == "compact":
                    scal = _tolist(torch.stack([x.to(torch.int64) for o in outs for x in
                                                (o[3], (o[4] > 0).sum(), o[5])]).view(-1, 3))
                    shard_comp = [(_np(o[0][:r[0]]), _np(o[1][:r[0]]), _np(o[2][:r[0]]), r[0])
                                  for o, r in zip(outs, scal)]
                    ov_rows = torch.stack([o[4] > 0 for o in outs]).any(0)
                elif mode == "dense":  # (pos, valid, overflow, loc_over) or (cand, nm, ...)
                    outs = [o if k else (o[0], None, *o[1:]) for o in outs]
                    ov_rows = torch.stack([o[3] for o in outs]).sum(0) > 0
                    vals = _tolist(torch.stack([ov_rows.sum()]
                                               + [o[4].to(torch.int64) for o in outs]))
            self.stats.device_s += wait.wall + fetch.wall
            if mode == "hits":
                for cnt, _, _, _, cand_live in scal:
                    self._observe(self._cand_live_frac, k, cand_live, Bp)
                    self._observe(self._hit_live_frac, k, cnt, Bp)
                n_over, compact_over, hit_over = (sum(r[i] for r in scal) for i in (1, 2, 3))
            elif mode == "compact":
                for cnt, _, _ in scal:
                    self._observe(self._cand_live_frac, k, cnt, Bp)
                n_over, compact_over = (sum(r[i] for r in scal) for i in (1, 2))
            elif mode == "tiered":
                ov_rows = False
                for out_np in per_shard:
                    out_np[10] = _unbits(out_np[10], 2 * Bp)
                    ov_rows = ov_rows | out_np[10]
                    compact_over += int(out_np[11])
                    # per shard and at every heal level, as bwtpu counts it
                    # (reference fault C.2)
                    self.stats.escalated += int(out_np[9])
                n_over = int(ov_rows.sum())
            else:
                n_over, compact_over = vals[0], sum(vals[1:])
            for name, v in (("overflow_rows", n_over), ("compact_drops", compact_over),
                            ("hit_drops", hit_over)):
                if v:
                    trace.count(f"{name}.l{level}", v)
            if (n_over or compact_over or hit_over) and can_heal:
                return self._heal_block(block, k, Bp, level, n_over,
                                        compact_over + hit_over, tiered=mode == "tiered")
            if mode == "dense" or (n_over and torch.is_tensor(ov_rows)):
                with trace.span("fetch") as fetch:  # what only the last level takes
                    if n_over and torch.is_tensor(ov_rows):
                        ov_rows = _np(ov_rows)
                    if mode == "dense":
                        dense = (np.stack([_np(o[0]) for o in outs]),
                                 None if k == 0 else np.stack([_np(o[1]) for o in outs]),
                                 np.stack([_np(o[2]) for o in outs]))
                self.stats.device_s += fetch.wall
            if hit_over:
                log.warning(
                    "align block: hit buffer overflowed by %d hits after %d heals "
                    "— results incomplete; raise config.hit_factor", hit_over, level,
                )
                self.stats.compact_overflows += hit_over
            if compact_over:
                log.warning(
                    "align block: compaction capacity overflowed by %d rows after "
                    "%d heals; affected reads are marked truncated — raise "
                    "loc_factor/max_cand or max_heals", compact_over, level,
                )
            if n_over:
                log.warning(
                    "align block: %d read-strand rows overflowed interval capacity "
                    "after %d heals (max_hits=%d, max_cand=%d); affected reads are "
                    "marked truncated", n_over, level, mh, mc,
                )
            with trace.span("assemble") as asm:
                if mode == "dense":
                    s_idx, row_idx, p, m = dense_to_columns(*dense)
                elif mode == "tiered":
                    mh0 = self._caps(0, level)[0]
                    cols = []
                    for s, out_np in enumerate(per_shard):
                        rows_t, p_t, m_t, _, _ = tiered_to_columns(out_np, mh0, mc, k, Bp)
                        cols.append((np.full(len(rows_t), s, np.int64), rows_t, p_t, m_t))
                    s_idx, row_idx, p, m = (np.concatenate(c) for c in zip(*cols))
                else:
                    if mode == "hits":
                        shard_comp = [(cand, hm % 4, hm // 4, r[0])
                                      for (cand, hm), r in zip(hits, scal)]
                    s_idx, row_idx, p, m = compact_to_columns(shard_comp, k, Ct)
                flat = flatten_hits(block.n, block.L, Bp, s_idx, row_idx, p, m,
                                    self._text_lens(), self._offsets())
                if n_over:
                    # read-strand rows -> per-read flags ([0,Bp) fwd, [Bp,2Bp) rev)
                    tr = np.zeros(block.n, dtype=bool)
                    rows = np.flatnonzero(ov_rows) % Bp
                    tr[rows[rows < block.n]] = True
                    flat = flat._replace(truncated=tr)
            self.stats.host_s += asm.wall
            if n_over:
                self.stats.truncated_reads += int(tr.sum())
            self.stats.reads += block.n
            self.stats.hits += len(flat.read_idx)
            self.stats.overflow_reads += n_over
            self.stats.compact_overflows += compact_over
            return flat

    def _observe(self, fracs: dict, k: int, live: int, Bp: int) -> None:
        """Raise fracs[k] to live rows / lanes (2 * Bp read-strand rows)."""
        fracs[k] = max(fracs.get(k, 0.0), live / (2 * Bp))

    def _heal_block(self, block, k, Bp, level, n_over, compact_over, tiered=False):
        """Re-dispatch a block with doubled caps on every shard
        (self-healing), in span "heal"."""
        self.stats.heals += 1
        log.info(
            "align block: %d overflowed rows / %d compaction drops — healing "
            "with 2^%d x caps", n_over, compact_over, level + 1,
        )
        with trace.span("heal"):
            return self.finish_block(
                self.dispatch_block(block, k, pad_to=Bp, _level=level + 1,
                                    tiered=tiered))
