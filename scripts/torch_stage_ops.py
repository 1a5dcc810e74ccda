"""Read prep and the stream compactions of the packed main path, call by
call, on one CUDA card: the host issue, device time and operations of
every call of engine.device_prep_packed, engine.compact_counts and
engine.compact in one block, and the operations of the whole block.

Three configurations (chip_smoke.py's):
  ecoli  phase 5: the CLI's default index (sa_rate 8, read_len 100,
         max_hits 16, max_cand 32, kmer_d 11) of the random E. coli-size
         genome with its repeat family; one block of 16,384 reads of
         100 bp (<= 2 mismatches);
  chr21  phase 10: `build-index --shards 2 --jobs 2` at the CLI defaults
         of the random genome of chr21's length; one block of 16,384
         reads, through the loop form and the fused one
         (Engine(fuse_shards=True): one CUDA graph replay a block, whose
         launches only the trace sees);
  int32  phase 14a: one shard of 2^28 + 4,096 bp (test_scale_int32's
         genome, seed 77; sa_rate 8, max_hits 4, max_cand 8, kmer_d 11,
         so two wide steps), built in a child process while `ecoli` runs
         (into --int32-dir and kept there, or loaded from it when it
         holds one); one block of 65,536 reads (scale_human_chip.py's
         --batch).
The blocks carry their packed words, as the CLI's FASTQ reader makes
them, so a dispatch_block's wall is the upload and the host issue.

At k = 0 and k = 2, after a warm-up block: one dispatch_block +
finish_block with every call of the three stages recorded (the heal's
re-run included), then each recorded call replayed alone:
  issue_us    the host wall of one call queued behind a device sleep,
              so that it never waits on the card (median of REPS);
  device_us   the summed duration of the call's device operations
              (torch.profiler, CUDA activity, REPS calls / REPS);
  device_ops  device operations (kernels, memsets, copies) a call;
  eager_ops   aten operations dispatched a call (TorchDispatchMode);
and for the whole block: the wall of its dispatch_block (three runs),
and in one more dispatch_block + finish_block its device operations
and their summed time, each kernel's launches and summed device µs
counted by kernel name (`_build.launches_in_trace`: the one count that
sees a graph replay's launches), the aten operations of its
dispatch_block and of its finish_block (the heal runs there), and the
aten operations and kernel names that contain "cummax" or "scatter"
(torch.profiler with CPU and CUDA activity; the block is the second of
the window, the first warms the profiler). One JSON line per
configuration, form and k, after the card's name and power limit.

--package DIR imports bwtpu_torch from DIR instead (an earlier tree,
unpacked with `git archive`).

Needs a CUDA card; there is no fallback.

Run:  python scripts/torch_stage_ops.py [--configs ecoli chr21 int32] [--int32-dir DIR]
                                        [--package _ab/parent]
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _chip_smoke():
    """This tree's chip_smoke.py (whatever package --package puts first)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT,
                                                                           "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod
    spec.loader.exec_module(mod)
    return mod

STAGES = ("device_prep_packed", "compact_counts", "compact")
REPS = 20  # calls a replay's timing and profile window


def recording(calls: dict):
    """Patch the engine's three stage names so that every call's
    arguments are recorded (cloned) in calls[name]; returns the restore
    list."""
    from bwtpu_torch import engine

    clone_args = sys.modules["chip_smoke"].clone_args
    saved = []
    for name in STAGES:
        orig = getattr(engine, name)
        saved.append((name, orig))

        def rec(*args, _orig=orig, _name=name):
            calls[_name].append(clone_args(args))
            return _orig(*args)

        setattr(engine, name, rec)
    return saved


def eager_ops(fn) -> collections.Counter:
    """{aten operation: times} dispatched by one fn() call."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = collections.Counter()

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen[str(func.overloadpacket.__name__)] += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return seen


def device_window(fn, reps: int):
    """Device events of `reps` fn() calls under torch.profiler (CUDA
    activity); a window with no device event delivered is retried
    (twice), then [] is returned (the profiler sometimes delivers none)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
        if dev:
            return dev
    return []


def issue_us(fn, reps: int) -> float:
    """Host wall of one fn() call queued behind a device sleep (~10 ms),
    so that it neither waits on the card nor fills the launch queue: the
    median of `reps` such calls."""
    import torch

    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return sorted(walls)[reps // 2] * 1e6


def counted_window(run):
    """(device events, profile) of one run() under torch.profiler with CPU
    and CUDA activity, after one run() in the same window that is not
    counted (a trace can miss the first device events of its first
    replay); a window with none delivered is retried (twice)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
            with record_function("torch_stage_ops.counted"):
                run()
                torch.cuda.synchronize()
        events = prof.events()
        span = next(e.time_range for e in events if e.name == "torch_stage_ops.counted"
                    and e.device_type == DeviceType.CPU)
        dev = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.time_range.start >= span.start]
        if dev:
            return dev, prof
    raise RuntimeError("torch.profiler delivered no device activity in three windows")


def kernels_in(dev) -> dict:
    """{kernel: {"launches": n, "us": summed device µs}} of device events,
    by kernel name, for the kernels that ran."""
    from bwtpu_torch.kernels import _build

    out = {}
    for e in dev:
        hit = {n: c for n, c in _build.launches_in_trace([e.name]).items() if c}
        for n in hit:
            r = out.setdefault(n, {"launches": 0, "us": 0.0})
            r["launches"] += 1
            r["us"] += e.time_range.elapsed_us()
    return out


def replay(name: str, args) -> dict:
    """One recorded stage call, replayed alone."""
    from bwtpu_torch import engine

    fn = getattr(engine, name)
    call = lambda: fn(*args)  # noqa: E731
    call()  # warm
    dev = device_window(call, REPS)
    if not dev:
        say(f"  {name}: torch.profiler delivered no device activity for a replayed call "
            f"in three windows; its device_us and device_ops read null")
    return {"issue_us": issue_us(call, REPS),
            "device_us": sum(e.time_range.elapsed_us() for e in dev) / REPS if dev else None,
            "device_ops": len(dev) / REPS if dev else None,
            "eager_ops": sum(eager_ops(call).values())}


def block_run(eng, blk, k: int, tag: str, smi: str) -> dict:
    """The stage calls of one block at k, replayed, and the whole block's
    operations; prints and returns one JSON record."""
    from bwtpu_torch import engine

    run = lambda: eng.finish_block(eng.dispatch_block(blk, k, pad_to=blk.n))  # noqa: E731
    run()  # warm-up block
    calls = {n: [] for n in STAGES}
    saved = recording(calls)
    try:
        run()
    finally:
        for name, orig in saved:
            setattr(engine, name, orig)
    stages = {}
    for name in STAGES:
        per = [replay(name, a) for a in calls[name]]
        stages[name] = {"calls": len(per), "per_call": per,
                        **{f"block_{m}": (None if any(p[m] is None for p in per)
                                          else sum(p[m] for p in per))
                           for m in ("issue_us", "device_us", "device_ops", "eager_ops")}}
    dev, prof = counted_window(run)
    names = sorted({e.name for e in prof.events()
                    if "cummax" in e.name or "scatter" in e.name})
    kernels = kernels_in(dev)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        h = eng.dispatch_block(blk, k, pad_to=blk.n)
        walls.append((time.perf_counter() - t0) * 1e3)
        eng.finish_block(h)
    handle = []
    ops = eager_ops(lambda: handle.append(eng.dispatch_block(blk, k, pad_to=blk.n)))
    fops = eager_ops(lambda: eng.finish_block(handle[0]))
    rec = {"config": tag, "k": k, "card": smi, "reads": blk.n, "heals": eng.stats.heals,
           "stages": stages,
           "block": {"dispatch_ms": sorted(walls), "device_ops": len(dev),
                     "device_us": sum(e.time_range.elapsed_us() for e in dev),
                     "kernels": kernels,
                     "eager_ops_dispatch": sum(ops.values()),
                     "eager_ops_finish": sum(fops.values()),
                     "cummax_or_scatter_names": names}}
    say(f"{tag} k={k}: " + "; ".join(
        f"{n} x{s['calls']}: issue {s['block_issue_us']:.1f} us, device "
        f"{s['block_device_us']} us, {s['block_device_ops']} device ops, "
        f"{s['block_eager_ops']} eager ops" for n, s in stages.items())
        + f"; block: dispatch {sorted(walls)[1]:.2f} ms, {len(dev)} device ops, "
          f"{rec['block']['device_us']:.1f} us, "
          f"{rec['block']['eager_ops_dispatch']} + {rec['block']['eager_ops_finish']} eager ops "
          f"(dispatch + finish); cummax/scatter: {names}; kernels (launches, µs): "
          + ", ".join(f"{n} {r['launches']} {r['us']:.1f}" for n, r in kernels.items()))
    print(json.dumps(rec), flush=True)
    return rec


def packed_block(reads):
    """A ReadBlock of the reads with its packed words filled in."""
    from bwtpu_torch.readblock import ReadBlock, pack_block

    blk = ReadBlock.from_reads(reads)
    blk.words, blk.amb = pack_block(blk)
    return blk


def say(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def ecoli(tmp: str, smi: str) -> None:
    """chip_smoke.py phase 5's index and one block of its reads."""
    chip_smoke = sys.modules["chip_smoke"]
    from bwtpu_torch.engine import Engine
    from bwtpu_torch.index import load_index
    from bwtpu_torch.io import write_fasta
    from bwtpu_torch.simulate import simulate_reads

    genome = chip_smoke.smoke_genome()
    fa = os.path.join(tmp, "ecoli.fa")
    write_fasta(fa, [("ecoli_sim", genome)])
    with contextlib.redirect_stdout(io.StringIO()):
        chip_smoke.run_cli(["build-index", fa, os.path.join(tmp, "ecoli_idx")])
    shards, _ = load_index(os.path.join(tmp, "ecoli_idx"))
    reads, _ = simulate_reads(genome, chip_smoke.BATCH, read_len=100, max_mismatches=2,
                              seed=chip_smoke.SEED + 1)
    for k in (0, 2):
        block_run(Engine(shards, device="cuda"), packed_block(reads), k, "ecoli", smi)


def chr21(tmp: str, smi: str) -> None:
    """chip_smoke.py phase 10's 2-shard index and one block of 16,384
    reads, in the loop form and the fused one."""
    chip_smoke = sys.modules["chip_smoke"]
    from bwtpu_torch.engine import Engine
    from bwtpu_torch.index import load_index
    from bwtpu_torch.io import write_fasta
    from bwtpu_torch.simulate import simulate_reads

    genome = chip_smoke.paired_genome()
    fa, idx = os.path.join(tmp, "chr21.fa"), os.path.join(tmp, "chr21_idx")
    write_fasta(fa, [("chr21_sim", genome)])
    with contextlib.redirect_stdout(io.StringIO()):
        chip_smoke.run_cli(["build-index", fa, idx, "--shards", "2", "--jobs", "2"])
    shards, _ = load_index(idx)
    reads, _ = simulate_reads(genome, chip_smoke.BATCH, read_len=100, max_mismatches=2,
                              seed=chip_smoke.SEED + 10)
    for k in (0, 2):
        for fuse in (False, True):
            block_run(Engine(shards, device="cuda", fuse_shards=fuse), packed_block(reads), k,
                      "chr21-fused" if fuse else "chr21", smi)


def int32(proc, path: str, smi: str) -> None:
    """chip_smoke.py phase 14a's shard (built by `proc`, or already in
    `path` when proc is None) and one block of 65,536 reads."""
    chip_smoke = sys.modules["chip_smoke"]
    from bwtpu_torch.engine import Engine
    from bwtpu_torch.index import load_index
    from bwtpu_torch.simulate import random_genome, simulate_reads

    if proc is not None:
        out, _ = proc.communicate(timeout=1200)
        if proc.returncode != 0:
            raise RuntimeError(f"the int32 index build failed: {out[-2000:]}")
    shards, _ = load_index(path)
    genome = random_genome(chip_smoke.INT32_N, seed=77)
    reads, _ = simulate_reads(genome, chip_smoke.HUMAN_BATCH, read_len=100,
                              max_mismatches=2, seed=chip_smoke.SEED + 17)
    for k in (0, 2):
        block_run(Engine(shards, device="cuda"), packed_block(reads), k, "int32", smi)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", nargs="*", default=["ecoli", "int32"],
                    choices=["ecoli", "chr21", "int32"])
    ap.add_argument("--int32-dir", help="the int32 index's directory: built there when "
                                        "it holds none, else loaded (default: a temporary one)")
    ap.add_argument("--package", help="import bwtpu_torch from this directory")
    args = ap.parse_args(argv)
    configs = args.configs
    if args.package:
        sys.path.insert(0, os.path.abspath(args.package))
    _chip_smoke()

    import torch

    if not torch.cuda.is_available():
        print("torch_stage_ops: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    with tempfile.TemporaryDirectory(prefix="bwtpu_torch_ops_") as tmp:
        proc, path = None, os.path.abspath(args.int32_dir or os.path.join(tmp, "int32_idx"))
        if "int32" in configs and not os.path.exists(os.path.join(path, "meta.json")):
            # builds while `ecoli` runs
            code = f"import chip_smoke; chip_smoke.int32_index({path!r})"
            proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, text=True,
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        try:
            if "ecoli" in configs:
                ecoli(tmp, smi)
            if "chr21" in configs:
                chr21(tmp, smi)
            if "int32" in configs:
                int32(proc, path, smi)
        finally:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
    return 0


if __name__ == "__main__":
    sys.exit(main())
