"""Stage walls, launch count and device busy share of the bwtpu_torch
main path on one CUDA card: the CLI's default index (sa_rate 8,
read_len 100, max_hits 16, max_cand 32) over a random E. coli-scale
genome, 100 bp reads with <= 2 mismatches, k = 0 and k = 2.

For each k, after one warm-up block, three passes over the same BLOCKS
blocks of BATCH reads (the CLI's default batch), each through
Engine.dispatch_block + finish_block:
  wall     synchronized only at both ends: the pass's own wall;
  stages   a torch.cuda.synchronize() around every stage (prep, search,
           finisher: the two-record chain of the lanes the search's exit
           kernel compacted, compaction, locate_walk, verify_nm, hit
           compaction, finish), so each stage's wall is its own, and one
           more row,
           "candidate stage": from the end of the candidate compaction to
           the end of verify_nm (locate_walk, verify_nm and every op
           around them that forms each candidate's start and mismatch
           count; the sa_rate > 1 branch only). Heals re-run the
           pipeline inside finish, so at k = 2 the stage rows add up to
           more than the total;
  profile  under torch.profiler (CUDA activity only): device kernels and
           copies, their merged busy time, and the wall of that same
           window. Busy share = busy time / that window. The profiler
           adds host time per launch, so its window can be longer than
           the plain wall; both are printed.
One JSON line per k on stdout.

Then the Read-list path (Engine.align_batch on BLOCKS batches of BATCH
reads of 50-100 bp, the CLI's FASTA route) at k = 0 and k = 2, after one
warm-up batch: a plain pass and a stage-synced pass (host encoding,
upload, 1-step search incl. its fixup, compaction, locate_walk,
verify_nm, the candidate stage, scatter back, fetch, host assembly), then
the SAM text of the same batches
timed alone. One JSON line per k, "path": "read_list".

Then bench.py's single-end configuration: `build-index --sa-rate 1`
(otherwise the CLI defaults), the block passes above after
Engine.autotune_caps on the warm-up block, at k = 0, k = 2 and tiered
k = 2, each with the fused locate+verify table on (verify_locv) and off
(ssa gather + verify_nm, upload_index(locv=False)). One JSON line per
run, "path": "sa_rate1".

Needs a CUDA card; there is no fallback.

Run:  python scripts/torch_stage_profile.py [--paths block read_list sa_rate1]
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BLOCKS = 2
BATCH = 16384
SEED = 20261016


def _timer(totals, counts):
    """timed(name, fn): fn wrapped in synchronized timers that add to
    totals[name] and counts[name]."""
    import torch

    def timed(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            totals[name] += time.perf_counter() - t0
            counts[name] += 1
            return out
        return run
    return timed


def _patch(patches, timed):
    """Replace each (owner, attr, stage name) with its timed version;
    returns the (owner, attr, original) triples to restore."""
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in patches]
    for owner, attr, name in patches:
        setattr(owner, attr, timed(name, getattr(owner, attr)))
    return saved


def _candidate_window(totals, counts):
    """Patches that time the candidate stage: from the return of the
    last compact_counts (synchronized) to the return of verify_nm
    (synchronized), whatever runs between them."""
    import torch

    from bwtpu_torch import engine

    start = [None]
    compact_counts, verify_nm = engine.compact_counts, engine.verify_nm

    def compact_then_mark(*a, **kw):
        out = compact_counts(*a, **kw)
        torch.cuda.synchronize()
        start[0] = time.perf_counter()
        return out

    def verify_then_read(*a, **kw):
        out = verify_nm(*a, **kw)
        torch.cuda.synchronize()
        if start[0] is not None:
            totals["candidate stage"] += time.perf_counter() - start[0]
            counts["candidate stage"] += 1
        start[0] = None
        return out

    saved = [(engine, "compact_counts", compact_counts), (engine, "verify_nm", verify_nm)]
    engine.compact_counts, engine.verify_nm = compact_then_mark, verify_then_read
    return saved


def _stage_hooks(totals, counts):
    """Synchronized timers around the block path's stages."""
    from bwtpu_torch import engine
    from bwtpu_torch.kernels import searchk

    timed = _timer(totals, counts)
    depth = [0]
    finish = engine.Engine.finish_block

    def finish_outer(self, handle):  # heals recurse: time the outer call
        depth[0] += 1
        try:
            if depth[0] > 1:
                return finish(self, handle)
            return timed("finish", finish)(self, handle)
        finally:
            depth[0] -= 1

    saved = _patch([(engine, "device_prep_packed", "prep"),
                    (engine, "search_early_stop_packed", "search"),
                    (searchk, "_finisher", "finisher"),
                    (engine, "compact_counts", "compaction"),
                    (engine, "locate_walk", "locate_walk"),
                    (engine, "verify_nm", "verify_nm"),
                    (engine, "verify_locv", "verify_locv"),
                    (engine, "compact", "hit compaction")], timed)
    saved = _candidate_window(totals, counts) + saved
    saved.append((engine.Engine, "finish_block", finish))
    engine.Engine.finish_block = finish_outer
    return saved


def _read_list_hooks(totals, counts):
    """Synchronized timers around the Read-list path's stages."""
    from bwtpu_torch import engine

    saved = _patch([(engine, "encode_batch", "encode (host)"),
                    (engine, "backward_search_ra", "1-step search + fixup"),
                    (engine, "compact_counts", "compaction"),
                    (engine, "locate_walk", "locate_walk"),
                    (engine, "verify_nm", "verify_nm"),
                    (engine, "scatter_back", "scatter back"),
                    (engine, "assemble_hits", "host assembly"),
                    (engine, "_np", "fetch (D2H)"),
                    (engine.Engine, "_put", "upload (H2D)")], _timer(totals, counts))
    return _candidate_window(totals, counts) + saved


def _read_list(genome, shards, contigs, smi):
    """The Read-list path's passes; prints one JSON line per k."""
    import numpy as np
    import torch

    from bwtpu_torch.io import Read
    from bwtpu_torch.sam import emit_sam
    from bwtpu_torch.simulate import simulate_reads
    from bwtpu_torch.engine import Engine

    B = BATCH
    rng = np.random.default_rng(SEED + 7)
    lens = rng.integers(50, 101, size=(BLOCKS + 1) * B)
    reads = []
    for L in range(50, 101):
        n = int((lens == L).sum())
        reads += simulate_reads(genome, n, read_len=L, max_mismatches=2,
                                seed=SEED + L)[0]
    reads = [Read(f"q{i}", reads[j].seq) for i, j in enumerate(rng.permutation(len(reads)))]
    batches = [reads[i:i + B] for i in range(0, len(reads), B)]
    for k in (0, 2):
        eng = Engine(shards, device="cuda")
        eng.align_batch(batches[0], k)  # warm-up

        def run_pass():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hits = [eng.align_batch(b, k) for b in batches[1:]]
            torch.cuda.synchronize()
            return time.perf_counter() - t0, hits

        wall_s, hits = run_pass()
        totals, counts = collections.defaultdict(float), collections.Counter()
        saved = _read_list_hooks(totals, counts)
        try:
            stage_wall_s, _ = run_pass()
        finally:
            for mod, attr, fn in saved:
                setattr(mod, attr, fn)
        t0 = time.perf_counter()
        for b, h in zip(batches[1:], hits):
            emit_sam(b, h, contigs, io.StringIO(), header=False)
        sam_s = time.perf_counter() - t0
        print(json.dumps({
            "path": "read_list", "k": k, "blocks": BLOCKS, "batch": B, "card": smi,
            "wall_ms": wall_s * 1e3, "heals": eng.stats.heals,
            "reads_per_s": BLOCKS * B / wall_s,
            "stage_pass_ms": stage_wall_s * 1e3,
            "stages_ms": {n: totals[n] * 1e3 for n in sorted(totals, key=totals.get,
                                                             reverse=True)},
            "stage_calls": dict(counts),
            "emit_sam_ms": sam_s * 1e3,
        }), flush=True)


def _busy_us(events) -> float:
    """Merged length of device intervals (µs), overlaps counted once."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def _block_passes(eng, blocks, k, smi, tiered=False, **tags):
    """The block path's three passes over blocks[1:] (blocks[0] has
    warmed up eng); prints one JSON line."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    B = BATCH

    def run_pass():
        heals, esc = eng.stats.heals, eng.stats.escalated
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for blk in blocks[1:]:
            eng.finish_block(eng.dispatch_block(blk, k, pad_to=B, tiered=tiered))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0, eng.stats.heals - heals,
                eng.stats.escalated - esc)

    wall_s, heals, escalated = run_pass()

    totals, counts = collections.defaultdict(float), collections.Counter()
    saved = _stage_hooks(totals, counts)
    try:
        stage_wall_s, *_ = run_pass()
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        window_s, *_ = run_pass()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
    busy_us = _busy_us(dev)
    print(json.dumps({
        **tags, "k": k, "tiered": tiered, "blocks": BLOCKS, "batch": B, "card": smi,
        "wall_ms": wall_s * 1e3, "heals": heals, "escalated": escalated,
        "reads_per_s": BLOCKS * B / wall_s,
        "stage_pass_ms": stage_wall_s * 1e3,
        "stages_ms": {n: totals[n] * 1e3 for n in sorted(totals, key=totals.get,
                                                         reverse=True)},
        "stage_calls": dict(counts),
        "profiled_window_ms": window_s * 1e3,
        "device_events": len(dev), "kernels": len(kernels),
        "kernel_ms": sum(e.time_range.elapsed_us() for e in kernels) / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "busy_share_of_window": busy_us / 1e6 / window_s,
    }), flush=True)


def _build_index(fa, idx, *flags):
    """`python -m bwtpu_torch.cli build-index` with its output swallowed;
    returns (shards, manifest)."""
    from bwtpu_torch.index import load_index
    from bwtpu_torch import cli as tcli

    with contextlib.redirect_stdout(io.StringIO()):
        tcli.main(["build-index", fa, idx, *flags])
    return load_index(idx)


def _sa_rate1(shards, blocks, smi):
    """bench.py's configuration: autotuned caps, k = 0, k = 2 and tiered
    k = 2, the locv table on and off."""
    from bwtpu_torch.engine import Engine, upload_index

    for k, tiered in ((0, False), (2, False), (2, True)):
        for locv in (True, False):
            eng = Engine(shards, device="cuda")
            if not locv:
                eng.dev_shards = upload_index(shards, eng.device, locv=False)
            lf = eng.autotune_caps(blocks[0], k, pad_to=BATCH)  # also the warm-up
            _block_passes(eng, blocks, k, smi, tiered=tiered, path="sa_rate1",
                          locv=locv, loc_factor=lf, hit_factor=eng._hf(k))


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--paths", nargs="*", default=["block", "read_list", "sa_rate1"],
                    choices=["block", "read_list", "sa_rate1"])
    paths = ap.parse_args(argv).paths
    if not torch.cuda.is_available():
        print("torch_stage_profile: no CUDA device", file=sys.stderr)
        return 2

    from bwtpu_torch.io import write_fasta
    from bwtpu_torch.readblock import ReadBlock
    from bwtpu_torch.simulate import ECOLI_SCALE, random_genome, simulate_reads
    from bwtpu_torch.engine import Engine

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    genome = random_genome(ECOLI_SCALE, seed=SEED)
    B = BATCH
    reads, _ = simulate_reads(genome, (BLOCKS + 1) * B, read_len=100,
                              max_mismatches=2, seed=SEED + 1)
    blocks = [ReadBlock.from_reads(reads[i:i + B]) for i in range(0, len(reads), B)]
    with tempfile.TemporaryDirectory(prefix="bwtpu_torch_prof_") as tmp:
        fa = os.path.join(tmp, "g.fa")
        write_fasta(fa, [("ecoli_sim", genome)])
        if "block" in paths or "read_list" in paths:
            shards, manifest = _build_index(fa, os.path.join(tmp, "idx"))  # CLI defaults
        if "sa_rate1" in paths:
            shards1, _ = _build_index(fa, os.path.join(tmp, "idx1"), "--sa-rate", "1")

    if "block" in paths:
        for k in (0, 2):
            eng = Engine(shards, device="cuda")
            eng.finish_block(eng.dispatch_block(blocks[0], k, pad_to=B))  # warm-up
            _block_passes(eng, blocks, k, smi)
    if "read_list" in paths:
        _read_list(genome, shards, manifest.contigs, smi)
    if "sa_rate1" in paths:
        _sa_rate1(shards1, blocks, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
