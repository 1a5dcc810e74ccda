"""Stage walls, launch count and device busy share of the bwtpu_torch
main path on one CUDA card: the CLI's default index (sa_rate 8,
read_len 100, max_hits 16, max_cand 32) over a random E. coli-scale
genome, 100 bp reads with <= 2 mismatches, k = 0 and k = 2.

For each k, after one warm-up block, three passes over the same BLOCKS
blocks of BATCH reads (the CLI's default batch), each through
Engine.dispatch_block + finish_block:
  wall     synchronized only at both ends: the pass's own wall;
  stages   a torch.cuda.synchronize() around every stage (prep, search,
           finisher, compaction, locate_walk, verify_nm, hit compaction,
           finish), so each stage's wall is its own. Heals re-run the
           pipeline inside finish, so at k = 2 the stage rows add up to
           more than the total;
  profile  under torch.profiler (CUDA activity only): device kernels and
           copies, their merged busy time, and the wall of that same
           window. Busy share = busy time / that window. The profiler
           adds host time per launch, so its window can be longer than
           the plain wall; both are printed.
One JSON line per k on stdout. Needs a CUDA card; there is no fallback.

Run:  python scripts/torch_stage_profile.py
"""

from __future__ import annotations

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


def _stage_hooks(totals, counts):
    """Wrap the engine's stage functions with synchronized timers."""
    import torch

    from bwtpu_torch import engine
    from bwtpu_torch.kernels import searchk

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

    patches = [(engine, "device_prep_packed", "prep"),
               (engine, "search_early_stop_packed", "search"),
               (searchk, "_fixup_stragglers_packed", "finisher"),
               (engine, "compact_counts", "compaction"),
               (engine, "locate_walk", "locate_walk"),
               (engine, "verify_nm", "verify_nm"),
               (engine, "compact", "hit compaction")]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
    saved.append((engine.Engine, "finish_block", finish))
    for mod, attr, name in patches:
        setattr(mod, attr, timed(name, getattr(mod, attr)))
    engine.Engine.finish_block = finish_outer
    return saved


def _busy_us(events) -> float:
    """Merged length of device intervals (µs), overlaps counted once."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_stage_profile: no CUDA device", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bwtpu.index import load_index
    from bwtpu.io import write_fasta
    from bwtpu.readblock import ReadBlock
    from bwtpu.simulate import ECOLI_SCALE, random_genome, simulate_reads
    from bwtpu_torch import cli as tcli
    from bwtpu_torch.engine import Engine

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    genome = random_genome(ECOLI_SCALE, seed=SEED)
    with tempfile.TemporaryDirectory(prefix="bwtpu_torch_prof_") as tmp:
        fa, idx = os.path.join(tmp, "g.fa"), os.path.join(tmp, "idx")
        write_fasta(fa, [("ecoli_sim", genome)])
        with contextlib.redirect_stdout(io.StringIO()):
            tcli.main(["build-index", fa, idx])  # CLI defaults
        shards, _ = load_index(idx)
    B = BATCH
    reads, _ = simulate_reads(genome, (BLOCKS + 1) * B, read_len=100,
                              max_mismatches=2, seed=SEED + 1)
    blocks = [ReadBlock.from_reads(reads[i:i + B]) for i in range(0, len(reads), B)]

    for k in (0, 2):
        eng = Engine(shards, device="cuda")
        eng.finish_block(eng.dispatch_block(blocks[0], k, pad_to=B))  # warm-up

        def run_pass():
            heals = eng.stats.heals
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for blk in blocks[1:]:
                eng.finish_block(eng.dispatch_block(blk, k, pad_to=B))
            torch.cuda.synchronize()
            return time.perf_counter() - t0, eng.stats.heals - heals

        wall_s, heals = run_pass()

        totals, counts = collections.defaultdict(float), collections.Counter()
        saved = _stage_hooks(totals, counts)
        try:
            stage_wall_s, _ = run_pass()
        finally:
            for mod, attr, fn in saved:
                setattr(mod, attr, fn)

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            window_s, _ = run_pass()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        kernels = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
        busy_us = _busy_us(dev)
        print(json.dumps({
            "k": k, "blocks": BLOCKS, "batch": B, "card": smi,
            "wall_ms": wall_s * 1e3, "heals": heals,
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
