"""Alignment engine on torch tensors (counterpart of bwtpu/engine.py).

This slice covers the CLI's default configuration: one index shard,
uniform-length reads through the columnar block path, sa_rate >= 2, the
multi-step Occ lattice with the k-mer start table, and the "hits"
output with self-healing. Per batch (both strands stacked, rows [0, B)
forward and [B, 2B) reverse):

  device_prep_packed -> search_early_stop_packed (one per seed slot at
  k > 0) -> ONE compaction of all candidate rows -> locate_walk (CUDA
  kernel) -> verify_nm (CUDA kernel) -> hit compaction

then finish_block assembles FlatHits on the host with bwtpu.results.
Outputs equal bwtpu's: the same hit sets, truncation marks and SAM
bytes. Everything else raises NotImplementedError naming the ROADMAP
slice that brings it. Torch runs eagerly, so the reference's jit program
cache has no counterpart, and the packed overflow bitmap stays a bool
row vector.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import NamedTuple

import numpy as np
import torch

from bwtpu.index import OCCK_STEP_FROM_WIDTH, FMIndex
from bwtpu.results import FlatHits, flatten_hits
from bwtpu_torch.kernels.compact import compact, compact_counts
from bwtpu_torch.kernels.locate import locate_walk
from bwtpu_torch.kernels.prep import revcomp_packed
from bwtpu_torch.kernels.search import interval_rows
from bwtpu_torch.kernels.searchk import search_early_stop_packed
from bwtpu_torch.kernels.verify import seed_layout
from bwtpu_torch.kernels.verify2 import build_text_rows, pack_reads, verify_nm

log = logging.getLogger(__name__)


class Shard(NamedTuple):
    """One shard's device-resident index."""

    lattice: torch.Tensor  # int32[n_blocks+1, 32]
    latk: torch.Tensor  # int32[n_blocksK+1, W] multi-step records
    latk_inv: torch.Tensor  # int32[4] rows with SA[r] < step (-1 pad)
    ssa: torch.Tensor  # int32[n_sampled]
    C: torch.Tensor  # int32[8]
    dollar_row: int
    n: int
    text_len: int
    text_rows: torch.Tensor  # int32[n_rows, R] stride-8 text windows
    kmer_tables: dict  # {depth: int32[4^depth, 2]}


def upload_index(shards: list[FMIndex], device) -> Shard:
    """Put one FMIndex's arrays on `device` as a Shard."""
    if len(shards) != 1:
        raise NotImplementedError(
            f"{len(shards)} index shards: several shards on one GPU are "
            "ROADMAP slice 5 of the port")
    s = shards[0]
    if s.config.sa_rate == 1:
        raise NotImplementedError(
            "sa_rate == 1 (fused locate+verify rows) is ROADMAP slice 2 of the port")
    if s.occk_lattice is None:
        raise NotImplementedError(
            "index without the multi-step lattice: the 1-step path is "
            "ROADMAP slice 6 of the port")

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)

    return Shard(
        lattice=put(s.search_lattice),
        latk=put(s.occk_lattice),
        latk_inv=put(s.occk_invalid),
        ssa=put(s.ssa),
        C=put(s.C),
        dollar_row=int(s.dollar_row),
        n=int(s.n),
        text_len=int(s.text_len),
        text_rows=put(build_text_rows(s.text_packed, s.config.read_len)),
        kmer_tables={dd: put(t) for dd, t in s.kmer_tables.items()},
    )


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
    """Multi-step size from the lattice record width (index.OCCK_WIDTH)."""
    return OCCK_STEP_FROM_WIDTH[shard.latk.shape[-1]]


# ---------------------------------------------------------------------------
# Device pipelines (plain functions of one shard + one batch)
# ---------------------------------------------------------------------------


def _len_mask_words(L: int) -> np.ndarray:
    """int32[W] length mask of one length-L read (pack_reads layout)."""
    return pack_reads(np.zeros((1, L), np.int32), np.zeros((1, L), np.int32),
                      np.array([L]))[2][0]


def device_prep_packed(read_words, amb_bits, L: int):
    """Both-strand packed rows: (rw2, ab2, lens2, lm2), forward rows first."""
    B, W = read_words.shape
    rc_w, rc_a = revcomp_packed(read_words, amb_bits, L)
    rw2 = torch.cat([read_words, rc_w])
    ab2 = torch.cat([amb_bits, rc_a])
    lens2 = torch.full((2 * B,), L, dtype=torch.int32, device=read_words.device)
    lm = torch.from_numpy(_len_mask_words(L)).to(read_words.device)
    return rw2, ab2, lens2, lm.unsqueeze(0).expand(2 * B, W)


def _inexact_from_intervals(shard: Shard, sp, ep, seed_off, read_words,
                            amb_bits, len_mask, lens, *, k, max_loc, sa_rate,
                            loc_factor, fix_over, cap_scale=1):
    """Seed-lane intervals -> ONE compaction -> locate -> packed verify.

    Lane l = read_row * (k+1) + seed_slot; a candidate's read start is
    locate(row) - seed_off[l]. Returns the compacted candidate list
    (cand_c, nm_c, sel, count) plus the per-row incompleteness count
    (interval overflow, compaction drop or finisher loss) and the
    compaction overflow. Duplicates across seed slots are left for the
    host assembler (bwtpu.results dedupes on (read, pos, strand)).
    """
    B2 = read_words.shape[0]
    nS = k + 1
    rows, _, overflow_s = interval_rows(sp, ep, max_loc)
    cap = compact_cap(B2, loc_factor, cap_scale)
    sel, count, comp_over, dropped = compact_counts(ep - sp, max_loc, cap)
    overflow = (overflow_s + dropped.to(torch.int32) + fix_over).reshape(
        B2, nS).sum(1, dtype=torch.int32)
    sel_valid = torch.arange(cap, dtype=torch.int32, device=sp.device) < count
    # sel indexes a live lane's own slots, so every gather below is in range
    rows_c = rows.reshape(-1).index_select(0, sel)
    lane = sel // max_loc
    b_idx = lane // nS
    spos_c = locate_walk(shard.lattice, shard.ssa, shard.C, shard.dollar_row,
                         rows_c, sel_valid, sa_rate)
    cand_c = spos_c - seed_off.index_select(0, lane)
    nm_c = verify_nm(
        shard.text_rows, shard.text_len, cand_c, sel_valid & (spos_c >= 0),
        read_words.index_select(0, b_idx), amb_bits.index_select(0, b_idx),
        len_mask.index_select(0, b_idx), lens.index_select(0, b_idx),
    )
    return cand_c, nm_c, sel, count, overflow, comp_over


def exact_pipeline_packed(shard: Shard, read_words, amb_bits, *, L, d, max_hits,
                          sa_rate, loc_factor=2, min_trips=0, cap_scale=1,
                          wide_steps=0):
    """Exact search as the k = 0 case of the candidate path: early-stop
    search -> locate -> full-length verify (hit iff nm == 0)."""
    rw2, ab2, lens2, lm2 = device_prep_packed(read_words, amb_bits, L)
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
    full length."""
    rw2, ab2, lens2, lm2 = device_prep_packed(read_words, amb_bits, L)
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


def hits_output(out, *, k: int, Ct: int, hit_cap: int):
    """Keep the verified hits (nm <= k) of a compacted candidate list,
    compacted again to hit_cap. Hit-compaction drops join the per-row
    overflow. Returns (cand, sel*4 + nm, count, n_over_rows, comp_over,
    hit_over, overflow_rows bool[B2])."""
    cand_c, nm_c, sel, count, overflow, comp_over = out
    live = torch.arange(sel.shape[0], dtype=torch.int32, device=sel.device) < count
    keep = (nm_c <= k) & live
    sel2, cnt2, hover = compact(keep, hit_cap)
    drop = keep & (torch.cumsum(keep.to(torch.int32), 0) > hit_cap)
    overflow = overflow.index_add(0, sel // Ct, drop.to(torch.int32))
    payload = torch.stack([cand_c, sel * 4 + nm_c], dim=1).index_select(0, sel2)
    ov_rows = overflow > 0
    return (payload[:, 0], payload[:, 1], cnt2, ov_rows.sum(), comp_over,
            hover, ov_rows)


# ---------------------------------------------------------------------------
# Engine (host orchestration)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BatchStats:
    reads: int = 0
    hits: int = 0
    overflow_reads: int = 0
    compact_overflows: int = 0
    heals: int = 0  # self-healing re-dispatches (doubled-cap retries)
    truncated_reads: int = 0  # reads still capacity-cut after max_heals
    device_s: float = 0.0
    host_s: float = 0.0


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


class Engine:
    """Single-shard alignment engine on one torch device.

    device="cuda" runs the CUDA kernels and raises when CUDA is absent;
    device="cpu" runs their plain-torch versions (the tests)."""

    def __init__(self, shards: list[FMIndex], device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Engine(device='cuda'): no CUDA device is available")
        self.shards = shards
        self.config = shards[0].config
        self.shard = upload_index(shards, self.device)
        self.kmer_depths = sorted(shards[0].kmer_tables)
        self.stats = BatchStats()

    def _wide_steps(self, d: int) -> int:
        """Two-gather 1-step narrowings before the multi-step loop, sized
        so E[width] = n / 4^d falls to <= 8 (0 at bacterial scale)."""
        if d <= 0:
            return 0
        lam = max(sh.n for sh in self.shards) / 4.0**d
        w = 0
        while lam > 8 and w < 8:
            lam /= 4
            w += 1
        return w

    def _caps(self, k: int, level: int):
        """(max_hits, max_cand, loc_factor, hit_factor) at heal level
        `level`: every capacity doubles per level; from level 1 the hit
        buffer is as wide as the compaction cap."""
        f = 1 << level
        cfg = self.config
        mh = cfg.max_hits * f
        mc = cfg.max_cand * f
        max_loc = mc if k else mh
        lf = min(cfg.loc_factor * f, (k + 1) * max_loc)
        hf = cfg.hit_factor if level == 0 else lf
        return mh, mc, lf, hf

    def dispatch_block(self, block, k: int | None = None,
                       pad_to: int | None = None, _level: int = 0):
        """Run a uniform-length columnar ReadBlock (bwtpu.readblock)
        through the packed pipelines. pad_to keeps batch shapes fixed
        across a stream; pad rows are all-ambiguous and die at the start
        table. Returns a handle for finish_block."""
        from bwtpu.readblock import pack_block

        k = self.config.k if k is None else k
        L = block.L
        if not (0 < L <= self.config.read_len):
            raise ValueError(f"block read length {L} not in (0, {self.config.read_len}]")
        rw, ab = pack_block(block)
        Bp = pad_to or block.n
        if Bp > block.n:
            W = rw.shape[1]
            rw = np.concatenate([rw, np.zeros((Bp - block.n, W), np.int32)])
            ab = np.concatenate([ab, np.full((Bp - block.n, W), 0x55555555, np.int32)])
        d = pick_kmer_depth(self.kmer_depths, L if k == 0 else L // (k + 1))
        if d < 1:
            raise NotImplementedError(
                f"patterns shorter than every k-mer table (d = 0): the 1-step "
                "path is ROADMAP slice 6 of the port")
        mh, mc, lf, hf = self._caps(k, _level)
        Ct = (k + 1) * mc if k else mh
        if 2 * Bp * Ct * 4 >= 2**31:
            raise NotImplementedError(
                f"batch {Bp} x {Ct} candidate slots overflows the int32 hit "
                "payload: lower --batch-size")
        cfg = self.config
        rw = torch.from_numpy(np.ascontiguousarray(rw)).to(self.device)
        ab = torch.from_numpy(np.ascontiguousarray(ab)).to(self.device)
        opts = dict(sa_rate=cfg.sa_rate, loc_factor=lf, min_trips=cfg.min_trips,
                    cap_scale=1 << _level, wide_steps=self._wide_steps(d))
        if k == 0:
            out = exact_pipeline_packed(self.shard, rw, ab, L=L, d=d,
                                        max_hits=mh, **opts)
        else:
            out = inexact_pipeline_packed(self.shard, rw, ab, L=L, k=k, d=d,
                                          max_loc=mc, **opts)
        hit_cap = min(out[2].shape[0], compact_cap(2 * Bp, hf, 1 << _level))
        out = hits_output(out, k=k, Ct=Ct, hit_cap=hit_cap)
        return ("block", block, Bp, k, out, time.perf_counter(), "hits", _level)

    def finish_block(self, handle) -> FlatHits:
        """Materialize a dispatch_block handle -> bwtpu.results.FlatHits.

        Any capacity overflow re-dispatches the block with doubled caps
        (bounded by config.max_heals); reads still overflowed at the last
        level are flagged in FlatHits.truncated (SAM tag xo:i:1)."""
        tag, block, Bp, k, out, t_disp, mode, level = handle
        assert tag == "block" and mode == "hits"
        mh, mc, lf, hf = self._caps(k, level)
        Ct = (k + 1) * mc if k else mh
        cfg = self.config
        can_heal = cfg.heal_overflow and level < cfg.max_heals
        hc, hm, cnt2, n_ov, co, hover, ov_rows = out
        cnt, n_over, compact_over, hit_over = torch.stack(
            [x.to(torch.int64) for x in (cnt2, n_ov, co, hover)]).tolist()
        hc = hc[:cnt].cpu().numpy()
        hm = hm[:cnt].cpu().numpy()
        self.stats.device_s += time.perf_counter() - t_disp
        if (n_over or compact_over or hit_over) and can_heal:
            return self._heal_block(block, k, Bp, level, n_over,
                                    compact_over + hit_over)
        trunc_rows = ov_rows.cpu().numpy() if n_over else None
        if hit_over:
            log.warning(
                "align block: hit buffer overflowed by %d hits after %d heals "
                "— results incomplete; raise config.hit_factor", hit_over, level,
            )
            self.stats.compact_overflows += hit_over
        t1 = time.perf_counter()
        s_idx, row_idx, p, m = compact_to_columns([(hc, hm % 4, hm // 4, cnt)], k, Ct)
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
        sh = self.shards[0]
        flat = flatten_hits(block.n, block.L, Bp, s_idx, row_idx, p, m,
                            [sh.text_len], [sh.shard_offset])
        if trunc_rows is not None:
            # read-strand rows -> per-read flags ([0,Bp) fwd, [Bp,2Bp) rev)
            tr = np.zeros(block.n, dtype=bool)
            rows = np.flatnonzero(trunc_rows) % Bp
            tr[rows[rows < block.n]] = True
            flat = flat._replace(truncated=tr)
            self.stats.truncated_reads += int(tr.sum())
        self.stats.reads += block.n
        self.stats.hits += len(flat.read_idx)
        self.stats.overflow_reads += n_over
        self.stats.compact_overflows += compact_over
        self.stats.host_s += time.perf_counter() - t1
        return flat

    def _heal_block(self, block, k, Bp, level, n_over, compact_over):
        """Re-dispatch a block with doubled caps (self-healing)."""
        self.stats.heals += 1
        log.info(
            "align block: %d overflowed rows / %d compaction drops — healing "
            "with 2^%d x caps", n_over, compact_over, level + 1,
        )
        return self.finish_block(
            self.dispatch_block(block, k, pad_to=Bp, _level=level + 1))
