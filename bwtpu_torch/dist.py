"""Distributed alignment on torch.distributed (counterpart of bwtpu/dist.py).

bwtpu runs one program over a ('shard', 'data') device mesh: shard_map
splits a global batch over the mesh and lax.ppermute / lax.all_to_all
move data inside the compiled program. torch.distributed is SPMD: one
process per device (a "rank"), local tensors only, and every exchange is
issued by hand, in the same order on every rank. The port keeps bwtpu's
layout with ranks in place of devices:

- The FM-index is interval-sharded. Rank r = d * S + s of an engine's
  ranks holds shard s only (replicated over the data groups) and owns
  batch block r: bwtpu's P(('data', 'shard')) order, data major and
  shard minor. The ring of data group d is ranks d*S ... d*S + S - 1.
- Each rank aligns its own reads. They ride the ring of its data group
  (one batch_isend_irecv a hop: send to the next rank, receive from the
  previous one) and meet every shard. Each hop's outputs stay home,
  indexed by hop; after the last hop one all_to_all over the ring sends
  every block to the rank whose reads it holds (bwtpu/dist.py:413-428),
  so every hit crosses the ring once. The reads make S - 1 hops: bwtpu's
  last rotation, which brings them home unused, is left out.
- The host resolves global int64 positions as shard_offset[s] +
  local_pos from every shard's text_len / shard_offset (results.py).

Transport: NCCL between cards, gloo between CPU ranks (the tests), and
gloo between ranks that share a card when asked for (backend "gloo" with
a CUDA device, the counterpart of `bwtpu.multihost --platform cpu
--host-devices N`): its exchanges go through host memory in
Layout._exchange. Host-side agreements (batch shape, ring mode, heal or
not) go over a gloo group in every case, so they never wait for the
card. NCCL is never replaced by gloo quietly: a rank takes the backend
its process group was created with.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch
import torch.distributed as dist

from bwtpu_torch import dna
from bwtpu_torch.engine import (Engine, _has_multistep, assemble_hits, assemble_hits_compact,
                                encode_batch, exact_pipeline, exact_pipeline_packed,
                                inexact_pipeline, inexact_pipeline_packed, pick_kmer_depth,
                                upload_index)
from bwtpu_torch.golden import Hit
from bwtpu_torch.index import FMIndex, ShardManifest
from bwtpu_torch.io import Read
from bwtpu_torch.kernels.verify2 import pack_reads

log = logging.getLogger(__name__)

_NO_READ = 1 << 30  # a rank without reads in the min-length agreement


class Layout:
    """This rank's place among an engine's ranks, and its exchanges.

    S shards, len(ranks) // S data groups; rank (its index in `ranks`) =
    data group * S + shard. `ring` is the data group's process group
    (None at S = 1: no exchange), `ring_ranks` its global ranks, `control`
    a gloo group over all the engine's ranks for host-side agreements."""

    def __init__(self, S: int, ranks: list[int], ring, ring_ranks: list[int], control):
        self.S = S
        self.ranks = ranks
        self.rank = ranks.index(dist.get_rank())
        self.shard = self.rank % S
        self.ring, self.ring_ranks, self.control = ring, ring_ranks, control
        self.backend = dist.get_backend(ring) if ring is not None else dist.get_backend()

    def transport(self, device: torch.device) -> str:
        """What the ring's hops go through, for summaries."""
        if self.backend == "gloo" and device.type == "cuda":
            return "gloo via host memory"
        return self.backend

    # ---- host-side agreements (gloo, CPU tensors) ----

    def agree(self, vals) -> np.ndarray:
        """Every rank's `vals` (integers, the same count on every rank):
        int64[n_ranks, len(vals)], in rank order."""
        t = torch.from_numpy(np.asarray(vals, dtype=np.int64))
        out = [torch.empty_like(t) for _ in self.ranks]
        dist.all_gather(out, t, group=self.control)
        return torch.stack(out).numpy()

    def total(self, x: int) -> int:
        """Sum of x over the engine's ranks."""
        t = torch.tensor([x], dtype=torch.int64)
        dist.all_reduce(t, group=self.control)
        return int(t)

    # ---- the ring's exchanges ----

    def _exchange(self, t: torch.Tensor) -> tuple[torch.Tensor, bool]:
        """The tensor a collective takes for t: t itself, or its host copy
        when gloo serves ranks on a card (staged=True)."""
        staged = self.backend == "gloo" and t.device.type == "cuda"
        return (t.cpu() if staged else t), staged

    def rotate(self, send: torch.Tensor, recv: torch.Tensor):
        """Start one hop: send -> the next rank of the ring, the previous
        rank's -> recv (same shape). Returns a function that waits for
        both; recv holds the visiting batch after it returns."""
        s, staged = self._exchange(send)
        r = torch.empty_like(s) if staged else recv
        nxt = self.ring_ranks[(self.shard + 1) % self.S]
        prv = self.ring_ranks[(self.shard - 1) % self.S]
        reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, s, nxt, self.ring),
                                       dist.P2POp(dist.irecv, r, prv, self.ring)])

        def wait():
            for q in reqs:
                q.wait()
            if staged:
                recv.copy_(r)
        return wait

    def home(self, rows: torch.Tensor) -> torch.Tensor:
        """One all_to_all over the ring: row o of `rows` goes to ring rank o;
        row j of the result comes from ring rank j."""
        if self.S == 1:
            return rows
        x, staged = self._exchange(rows)
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x, group=self.ring)
        return y.to(rows.device) if staged else y


def make_layout(n_shard: int, ranks: list[int] | None = None) -> Layout | None:
    """The layout of an engine over `ranks` (default: every rank), which
    replaces bwtpu's make_mesh and make_multihost_mesh. Every process of
    the default group calls this, in the same order, since each creates
    the same process groups; ranks outside `ranks` get None.

    As make_multihost_mesh keeps the shard ring within a host, the ring
    stays within a node: torchrun numbers ranks node by node, so the
    ranks per node (LOCAL_WORLD_SIZE) must be a multiple of n_shard."""
    ranks = list(range(dist.get_world_size())) if ranks is None else list(ranks)
    if len(ranks) % n_shard:
        raise ValueError(f"{len(ranks)} ranks not divisible by {n_shard} shards")
    local = os.environ.get("LOCAL_WORLD_SIZE")
    if local is not None and int(local) % n_shard:
        raise ValueError(f"{local} ranks per node (LOCAL_WORLD_SIZE) not divisible by "
                         f"{n_shard} shards: the shard ring must stay within a node")
    backend = dist.get_backend()
    whole = ranks == list(range(dist.get_world_size()))
    control = (dist.group.WORLD if backend == "gloo" and whole
               else dist.new_group(ranks, backend="gloo"))
    groups = [ranks[i:i + n_shard] for i in range(0, len(ranks), n_shard)]
    rings = [dist.new_group(g) for g in groups] if n_shard > 1 else [None] * len(groups)
    me = dist.get_rank()
    if me not in ranks:
        return None
    d = ranks.index(me) // n_shard
    lay = Layout(n_shard, ranks, rings[d], groups[d], control)
    if lay.ring is not None:
        # open the ring: NCCL wants a group's first point-to-point exchange
        # to involve all of its ranks, hence a collective first; then one
        # exchange of each kind the ring runs, so that NCCL connects the
        # peers here and not inside the first batch
        dev = torch.device("cuda", torch.cuda.current_device()) if backend == "nccl" else "cpu"
        t = torch.zeros((n_shard, 1), dtype=torch.int32, device=dev)
        dist.all_reduce(t, group=lay.ring)
        lay.rotate(t, torch.empty_like(t))()
        lay.home(t)
    return lay


# ---------------------------------------------------------------------------
# The rings (plain functions of one layout, one shard and one batch)
# ---------------------------------------------------------------------------


def _flat(ts) -> torch.Tensor:
    """Tensors of any shapes and integer or bool types -> one int32 row."""
    return torch.cat([t.reshape(-1).to(torch.int32) for t in ts])


def _split(flat, like) -> list:
    """A row of _flat (tensor or numpy) -> views shaped like `like`'s
    tensors (int32; a bool plane stays 0/1)."""
    out, at = [], 0
    for t in like:
        out.append(flat[at:at + t.numel()].reshape(tuple(t.shape)))
        at += t.numel()
    return out


def _ring(lay: Layout, batch: list[torch.Tensor], run, debug_checks: bool = False):
    """Run `run` on the visiting batch at each of the ring's S hops, and
    bring each hop's outputs home.

    The batch's tensors travel as one int32 row; hop h + 1's exchange is
    started before hop h's pipeline runs (both only read the row), into
    the second of two buffers. Returns (rows int32[S, F], like): row s
    holds this rank's reads' outputs against shard s, flattened; `like`
    the outputs of one hop (their shapes, for _split)."""
    cur = _flat(batch)
    if debug_checks:
        # divergence detector (bwtpu's psum checksum): every rank must
        # exchange batches of one shape, or the ring deadlocks
        csum = cur.numel() * 1000003 + len(batch)
        if lay.total(csum) != csum * len(lay.ranks):
            raise RuntimeError(f"rank {lay.rank}: ring batch shapes differ between ranks")
    nxt = torch.empty_like(cur) if lay.S > 1 else None
    rows, like = [], None
    for h in range(lay.S):
        wait = lay.rotate(cur, nxt) if h < lay.S - 1 else None
        outs = run(*_split(cur, batch))
        like = outs
        rows.append(_flat(outs))
        if wait is not None:
            wait()
            cur, nxt = nxt, cur
    # hop h held the reads of ring rank (s - h) mod S; row o goes home to o
    order = [(lay.shard - o) % lay.S for o in range(lay.S)]
    return lay.home(torch.stack([rows[h] for h in order])), like


def ring_align(lay: Layout, shard, batch: list[torch.Tensor], *, k: int, d: int,
               max_hits: int, max_cand: int, sa_rate: int, loc_factor=2, cap_scale: int = 1,
               debug_checks: bool = False):
    """The ragged ring (build_ring_align): both strands stacked by
    encode_batch on this rank's reads. batch = (ra_codes, ra_amb, lens)
    at k = 0, else (seed_ra, seed_amb, seed_lens, seed_off, read_words,
    amb_bits, len_mask, lens); the 1-step pipelines' dense outputs per
    shard (see _ring)."""
    if k == 0:
        def run(*b):
            return exact_pipeline(shard, *b, d=d, max_hits=max_hits, sa_rate=sa_rate,
                                  loc_factor=loc_factor, cap_scale=cap_scale)
    else:
        def run(*b):
            return inexact_pipeline(shard, *b, k=k, d=d, max_loc=max_cand, sa_rate=sa_rate,
                                    loc_factor=loc_factor, cap_scale=cap_scale)
    return _ring(lay, batch, run, debug_checks)


def ring_align_packed(lay: Layout, shard, read_words, amb_bits, *, k: int, d: int, L: int,
                      max_hits: int, max_cand: int, sa_rate: int, loc_factor=2,
                      min_trips: int = 0, cap_scale: int = 1, wide_steps: int = 0,
                      debug_checks: bool = False):
    """The packed rings (build_ring_align_packed and _compact): 2-bit
    packed forward reads ride the ring, each hop derives the strands and
    seeds on the device. With the multi-step lattice and d >= 1 the
    packed pipelines give compacted outputs (cand, nm, sel, count,
    overflow, comp_over: bwtpu's compact ring), else the 1-step
    fallback's dense ones (bwtpu's packed ring); the port's pipelines
    choose, so one function serves both."""
    opts = dict(L=L, d=d, sa_rate=sa_rate, loc_factor=loc_factor, min_trips=min_trips,
                cap_scale=cap_scale, wide_steps=wide_steps)

    def run(rw, ab):
        if k == 0:
            return exact_pipeline_packed(shard, rw, ab, max_hits=max_hits, **opts)
        return inexact_pipeline_packed(shard, rw, ab, k=k, max_loc=max_cand, **opts)
    return _ring(lay, [read_words, amb_bits], run, debug_checks)


# ---------------------------------------------------------------------------
# DistEngine
# ---------------------------------------------------------------------------


def default_device() -> torch.device:
    """cuda:LOCAL_RANK (torchrun's local rank; 0 without one)."""
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


class DistEngine:
    """Alignment engine over the ranks of a Layout, SPMD: every rank calls
    the same methods in the same order with its own reads (bwtpu's
    multi-process semantics, the only one torch.distributed has).

    device: cuda:LOCAL_RANK by default (the CUDA kernels; raises without
    a card), "cpu" for the plain-torch versions (the tests). The process
    group must exist (bwtpu_torch.multihost.initialize sets the device
    and creates it)."""

    # the single-device engine's rules, not copies: every cap doubles per
    # heal level; wide start intervals are narrowed before the multi-step
    # loop (no autotune here, so no override is ever set)
    _caps = Engine._caps
    _lf = Engine._lf
    _hf = Engine._hf
    _wide_steps = Engine._wide_steps

    def __init__(self, shards: list[FMIndex], manifest: ShardManifest,
                 layout: Layout | None = None, device=None, debug_checks: bool = False):
        if not dist.is_initialized():
            raise RuntimeError("DistEngine: no process group (bwtpu_torch.multihost.initialize)")
        self.shards = shards
        self.manifest = manifest
        self.config = shards[0].config
        self.layout = layout if layout is not None else make_layout(len(shards))
        if self.layout is None or self.layout.S != len(shards):
            raise ValueError("DistEngine: this rank is not in a layout of "
                             f"{len(shards)} shards")
        self.device = torch.device(device) if device is not None else default_device()
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("DistEngine(device='cuda'): no CUDA device is available")
        if self.layout.backend == "nccl" and self.device.type != "cuda":
            raise ValueError(f"DistEngine: NCCL needs a CUDA device, not {self.device}")
        self.transport = self.layout.transport(self.device)
        # this rank's shard only; the host keeps every shard's text_len
        # and shard_offset for the assembly
        self.dev = upload_index([shards[self.layout.shard]], self.device)[0]
        self.kmer_depths = sorted(shards[0].kmer_tables)
        self.debug_checks = debug_checks
        self._lf_override: dict = {}
        self._hf_override: dict = {}
        # per-read truncation flags of this rank's reads from the most
        # recent finish_batch, set only when the final heal level still
        # overflowed (bwtpu_torch.multihost reads it right after)
        self.last_truncated: np.ndarray | None = None
        self.heals = 0  # self-healing ring re-dispatches (doubled caps)

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def dispatch_batch(self, reads: list[Read], k: int | None = None,
                       packed: bool | None = None, _level: int = 0):
        """Encode this rank's reads and run the ring; returns a handle for
        finish_batch. Several handles can be kept in flight: every rank
        dispatches the same rings in the same order.

        The ranks first agree (one all_gather of a few integers) on the
        rows per rank (the most reads any rank has; shorter batches are
        padded with all-ambiguous rows), on the packed/ragged choice and
        on the k-mer depth, since each picks the exchange sequence.
        packed: None = packed when every rank's reads have one length in
        (0, read_len]; True requires that (every rank must pass the same
        value)."""
        k = self.config.k if k is None else k
        lens = [len(r.seq) for r in reads]
        L = lens[0] if reads else 0
        uniform = bool(reads and 0 < L <= self.config.read_len and min(lens) == max(lens))
        v = self.layout.agree([k, -1 if packed is None else int(packed), len(reads),
                               int(uniform), L, max(lens, default=0),
                               min((x for x in lens if x > 0), default=_NO_READ)])
        if len(set(v[:, 0])) > 1 or len(set(v[:, 1])) > 1:
            raise ValueError(f"ranks disagree on k or packed: {v[:, :2].tolist()}")
        b = max(1, int(v[:, 2].max()))
        live = v[:, 2] > 0
        same_len = bool(live.any() and v[live, 3].all() and len(set(v[live, 4])) == 1)
        if packed is None:
            packed = same_len
        elif packed and not same_len:
            raise ValueError("packed=True requires uniform-length reads, one length on every rank")
        mh, mc, lf, _ = self._caps(k, _level)
        opts = dict(k=k, max_hits=mh, max_cand=mc, sa_rate=self.config.sa_rate,
                    loc_factor=lf, cap_scale=1 << _level, debug_checks=self.debug_checks)
        if packed:
            L = int(v[live, 4][0])
            codes = np.zeros((b, L), dtype=np.int32)
            amb = np.ones((b, L), dtype=np.int32)  # pad rows all-ambiguous
            if reads:
                c, m = dna.encode_with_mask("".join(r.seq for r in reads))
                codes[:len(reads)] = c.reshape(len(reads), L)
                amb[:len(reads)] = m.reshape(len(reads), L)
            rw, ab, _ = pack_reads(codes, amb, np.full(b, L, np.int32))
            d = pick_kmer_depth(self.kmer_depths, L if k == 0 else L // (k + 1))
            out = ring_align_packed(self.layout, self.dev, self._put(rw), self._put(ab), d=d,
                                    L=L, min_trips=self.config.min_trips,
                                    wide_steps=self._wide_steps(d), **opts)
            tag = "packed_compact" if _has_multistep(self.dev, d) else "packed"
            return (tag, reads, b, k, out, _level)
        # ragged: strands stacked on this rank's reads at the ranks' common
        # width; the depth from the shortest read (seed) of any rank
        min_len = int(v[:, 6].min())
        min_len = 0 if min_len == _NO_READ else min_len
        d = pick_kmer_depth(self.kmer_depths, min_len if k == 0 or not min_len
                            else max(min_len // (k + 1), 1))
        cfg = self.config.replace(read_len=max(self.config.read_len, int(v[:, 5].max())))
        enc, _ = encode_batch(cfg, reads, k, pad_to=b)
        batch = ((enc.ra_codes, enc.ra_amb, enc.lens) if k == 0 else
                 (enc.seed_ra, enc.seed_amb, enc.seed_lens, enc.seed_off, enc.read_words,
                  enc.amb_bits, enc.len_mask, enc.lens))
        out = ring_align(self.layout, self.dev, [self._put(x) for x in batch], d=d, **opts)
        return ("ragged", reads, b, k, out, _level)

    def _finish(self, handle):
        """The homed ring outputs -> (hits, overflowed rows, compaction
        overflow, per-read truncation) of this rank's reads."""
        tag, reads, B, k, (rows, like), level = handle
        per_shard = [_split(r, like) for r in rows.cpu().numpy()]
        text_lens = [sh.text_len for sh in self.shards]
        offsets = [sh.shard_offset for sh in self.shards]
        if tag == "packed_compact":
            # (cand, nm, sel, count, overflow, comp_over) per shard
            mh, mc, _, _ = self._caps(k, level)
            shard_comp = [(o[0][:int(o[3])], o[1][:int(o[3])], o[2][:int(o[3])], int(o[3]))
                          for o in per_shard]
            ov = np.stack([o[4] for o in per_shard])
            hits = assemble_hits_compact(reads, B, shard_comp, k, (k + 1) * mc if k else mh,
                                         text_lens, offsets)
        else:  # dense: (pos, valid, overflow, co) or (cand, nm, valid, overflow, co)
            per_shard = [o if k else (o[0], None, *o[1:]) for o in per_shard]
            pos, valid, ov = (np.stack([o[i] for o in per_shard]) for i in (0, 2, 3))
            nm = np.stack([o[1] for o in per_shard]) if k else None
            hits = assemble_hits(reads, B, pos, nm, valid, text_lens, offsets)
        co = sum(int(o[-1]) for o in per_shard)
        ovs = ov.sum(axis=0)  # per read-strand row (2B), over every shard
        trunc = ((ovs[:B] + ovs[B:]) > 0)[:len(reads)]
        return hits, int((ovs > 0).sum()), co, trunc

    def finish_batch(self, handle) -> list[list[Hit]]:
        tag, reads, k, level = handle[0], handle[1], handle[3], handle[5]
        hits, n_over, co, trunc = self._finish(handle)
        cfg = self.config
        # every rank takes the same heal-or-not branch (the healed ring is
        # another exchange sequence): the overflow is summed over the ranks
        bad = self.layout.total(n_over + co)
        if bad and cfg.heal_overflow and level < cfg.max_heals:
            # self-healing: same batch, doubled caps; the results are a
            # superset, so they replace the originals
            self.heals += 1
            log.info("dist align: %d overflowed rows / %d compaction drops — "
                     "healing with 2^%d x caps", n_over, co, level + 1)
            return self.finish_batch(
                self.dispatch_batch(reads, k, tag != "ragged", _level=level + 1))
        # final level: per-read truncation for the emit path (the
        # innermost call of the heal recursion is the final level's run)
        self.last_truncated = trunc if n_over else None
        if co:
            log.warning("dist align: compaction overflow by %d rows after %d heals — "
                        "results may be incomplete", co, level)
        if n_over:
            log.warning("dist align: %d read-strand rows overflowed interval capacity "
                        "after %d heals", n_over, level)
        return hits

    def align_batch(self, reads: list[Read], k: int | None = None,
                    packed: bool | None = None) -> list[list[Hit]]:
        return self.finish_batch(self.dispatch_batch(reads, k, packed))

    def align_all(self, reads: list[Read], k: int | None = None, batch_size: int | None = None,
                  pipeline_depth: int = 3, packed: bool | None = None) -> list[list[Hit]]:
        """Streamed alignment of this rank's reads with `pipeline_depth`
        batches in flight. Every rank dispatches as many batches as the rank
        with the most reads (empty ones past the end of its reads)."""
        bs = batch_size or self.config.batch_size
        n_batches = int(self.layout.agree([-(-len(reads) // bs)]).max())
        out: list[list[Hit]] = []
        inflight: list = []
        for i in range(0, n_batches * bs, bs):
            inflight.append(self.dispatch_batch(reads[i:i + bs], k, packed))
            if len(inflight) > pipeline_depth:
                out.extend(self.finish_batch(inflight.pop(0)))
        while inflight:
            out.extend(self.finish_batch(inflight.pop(0)))
        return out
