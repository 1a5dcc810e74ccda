"""A/B on one CUDA card: the stream compactions compact_slots and
compact_mask (bwtpu_torch/kernels/compact.py) built from several kernel
sources, timed in turns on the main path's own calls.

The calls are captured from Engine.dispatch_block (every call of
engine.compact_counts and engine.compact in one block, the heal's re-run
included) at three configurations:
  ecoli  chip_smoke.py phase 5: the CLI-default index of its E. coli-size
         genome, one block of 16,384 reads at k = 0 and k = 2 (32,768 /
         98,304 candidate lanes, 65,536 hit lanes);
  int32  chip_smoke.py phase 14a: one 268,439,552 bp shard (kmer_d 11),
         built in a child process while `ecoli` runs (kept in --int32-dir
         when given), one block of 65,536 reads at k = 0 and 2 (131,072 /
         393,216 candidate lanes), the human-scale blocks' shapes;
  bench  the ecoli index, one block of 524,288 reads (phase 5's reads
         tiled 4x) at k = 0 and 2, as bench.py's device calls have.
To place the edges between the forms, `--sweep N ...` adds calls of N
lanes made by tiling phase 5's k = 2 candidate counts (their density)
with the capacity scaled alike.

Each source is a .cu file with csrc/compact.cu's C entry points. One with
a cluster form (exporting `bwtpu_compact_cluster_query`) runs as two
variants, "<name>:cluster" (where one cluster holds the lanes) and
"<name>:tiles" (its look-back form), whatever form the plan would pick;
kernels/compact.py's plan sizes both. PR 14's one-form design (one
memset and one look-back kernel, the tiles form's workspace) runs as
one. The csrc/*.cuh headers are copied beside a source that lacks them.

For every call and variant: every output against the plain version; then
in turns (forward, then backward) the whole call's device ms (50
back-to-back calls between one CUDA event pair behind a device sleep,
divided by 50); per variant the device µs of each device operation of a
call (torch.profiler, CUDA activity, 20 calls) and the empty call (every
count 0 / every lane false at the same shape and capacity); for the mask,
torch.nonzero_static(valid, size=cap) beside it; and the package's own
wrapper (the form its plan picks): its ms and device operations. Each
call's bound is counted from its inputs (kernels/bounds.py).

Prints the card's name and power limit, a line per call, then one JSON
line with everything.

Run (one card): python scripts/torch_compact_ab.py
           or:  python scripts/torch_compact_ab.py --configs ecoli \\
                    --sources bwtpu_torch/csrc/compact.cu _ab/pr14/compact.cu
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CONFIGS = ("ecoli", "int32", "bench")
REPS = 50


def source_name(path: str) -> str:
    """The build's name of a .cu file: its path relative to bwtpu_torch/csrc,
    without `.cu`; the csrc/*.cuh headers are copied beside it if missing."""
    from bwtpu_torch.kernels import _build

    path = os.path.abspath(path)
    for h in glob.glob(os.path.join(_build.CSRC, "*.cuh")):
        dst = os.path.join(os.path.dirname(path), os.path.basename(h))
        if not os.path.exists(dst):
            shutil.copy(h, dst)
    return os.path.relpath(os.path.splitext(path)[0], _build.CSRC)


class Variant:
    """One form of one built source, called through its C entry point:
    form None (a one-form source), "cluster" or "tiles"."""

    def __init__(self, name: str, lib, form: str | None):
        self.name = name if form is None else f"{name}:{form}"
        self.lib, self.form = lib, form

    def words(self, n: int, cap: int):
        """(form argument, workspace words) of a call from the package's
        plan, or None where this variant does not take n lanes (the
        cluster form above one cluster's capacity)."""
        from bwtpu_torch.kernels import compact as tc

        form, words = tc.plan(n, cap, self.lib.ctas if self.form == "cluster" else 0,
                              self.lib.tile)
        if self.form == "cluster" and form == 0:
            return None
        return (None if self.form is None else form), words

    def __call__(self, kind: str, x, H: int, cap: int):
        """(sel, count, overflow, flag) of one call."""
        import torch

        from bwtpu_torch.kernels import _build

        n = x.shape[0]
        form, words = self.words(n, cap)
        ws = torch.empty(words, dtype=torch.int32, device=x.device)
        flag = torch.empty(n, dtype=torch.bool, device=x.device)
        arg = () if form is None else (form,)
        if kind == "compact_mask":
            _build.launch(self.lib, self.lib.bwtpu_compact_mask, self.name, x, x.data_ptr(), n,
                          cap, *arg, ws.data_ptr(), words, flag.data_ptr())
        else:
            _build.launch(self.lib, self.lib.bwtpu_compact_slots, self.name, x, x.data_ptr(),
                          n, H, cap, *arg, ws.data_ptr(), words, flag.data_ptr())
        return ws[:cap], ws[cap], ws[cap + 1], flag


def variants(path: str) -> list:
    """The variants of the source at `path`: a one-form source's one; a source
    with a cluster form (`bwtpu_compact_cluster_query`) as its cluster
    form and its tiles form."""
    import torch

    from bwtpu_torch.kernels import _build
    from bwtpu_torch.kernels import compact as tc

    name = source_name(path)
    lib = _build.library(name)
    label = os.path.relpath(os.path.splitext(os.path.abspath(path))[0], ROOT)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bwtpu_compact_tile.restype = i
    lib.tile = lib.bwtpu_compact_tile()
    cluster = hasattr(lib, "bwtpu_compact_cluster_query")
    lib.bwtpu_compact_mask.restype = lib.bwtpu_compact_slots.restype = i
    lib.bwtpu_compact_mask.argtypes = [p, i, i] + ([i] if cluster else []) + [p, i, p, p]
    lib.bwtpu_compact_slots.argtypes = [p, i, i, i] + ([i] if cluster else []) + [p, i, p, p]
    if not cluster:
        return [Variant(label, lib, None)]
    lib.bwtpu_compact_cluster_query.restype = i
    lib.bwtpu_compact_cluster_query.argtypes = [p]
    if not hasattr(lib, "cluster_ctas"):  # kernels/compact.py's per-device cache
        lib.cluster_ctas = {}
    lib.ctas = tc._cluster_ctas(lib, torch.device("cuda", 0))
    print(f"{label}: cluster of {lib.ctas} CTAs of {lib.tile} lanes", flush=True)
    return [Variant(label, lib, "cluster"), Variant(label, lib, "tiles")]


def device_ops(fn, reps: int = 20) -> dict:
    """{device operation name: µs a call} of fn under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a window with no device activity delivered is retried
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = collections.defaultdict(float)
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
                m = re.search(r"\w*kernel\w*", e.name)
                name = "memset" if "Memset" in e.name else m.group(0) if m else e.name[:40]
                us[name] += e.time_range.elapsed_us() / reps
        if us:
            return dict(us)
    return {}


def capture(eng, blk, k: int) -> list:
    """[(kind, args)] of every compaction call of one dispatch_block +
    finish_block of blk at k."""
    import chip_smoke as cs
    from bwtpu_torch import engine

    slots, masks = [], []
    with cs.capturing(engine, "compact_counts", slots), cs.capturing(engine, "compact", masks):
        eng.finish_block(eng.dispatch_block(blk, k, pad_to=blk.n))
    return [("compact_slots", a) for a in slots] + [("compact_mask", a) for a in masks]


def config_calls(configs, sweep, int32_dir: str | None, tmp: str) -> list:
    """[(label, kind, args)] of the requested configurations' calls."""
    import chip_smoke as cs
    import torch

    from bwtpu_torch.config import EngineConfig
    from bwtpu_torch.engine import Engine
    from bwtpu_torch.index import build_fm_index, load_index
    from bwtpu_torch.readblock import ReadBlock
    from bwtpu_torch.simulate import random_genome, simulate_reads

    proc, path = None, os.path.abspath(int32_dir or os.path.join(tmp, "int32_idx"))
    if "int32" in configs and not os.path.exists(os.path.join(path, "meta.json")):
        code = f"import chip_smoke; chip_smoke.int32_index({path!r})"
        proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, text=True,
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    out = []
    try:
        if configs & {"ecoli", "bench"} or sweep:
            genome = cs.smoke_genome()
            eng = Engine([build_fm_index(genome, EngineConfig(sa_rate=8))], device="cuda")
            reads, _ = simulate_reads(genome, cs.N_READS, read_len=100, max_mismatches=2,
                                      seed=cs.SEED + 1)
            blk = ReadBlock.from_reads(reads[:cs.BATCH])
            for k in (0, 2):
                calls = capture(eng, blk, k)
                if "ecoli" in configs:
                    out += [(f"ecoli k={k} #{i}", kind, a) for i, (kind, a) in enumerate(calls)]
                if k == 2:
                    counts, H, cap = next(a for kind, a in calls if kind == "compact_slots")
                    for n in sweep:
                        reps = -(-n // counts.shape[0])
                        big = counts.repeat(reps)[:n].contiguous()
                        out.append((f"sweep {n}", "compact_slots",
                                    (big, H, cap * n // counts.shape[0])))
            if "bench" in configs:
                big = ReadBlock.from_reads(reads * 4)
                for k in (0, 2):
                    out += [(f"bench k={k} #{i}", kind, a)
                            for i, (kind, a) in enumerate(capture(eng, big, k))]
            del eng
            torch.cuda.empty_cache()
        if "int32" in configs:
            if proc is not None:
                log, _ = proc.communicate(timeout=1200)
                if proc.returncode != 0:
                    raise RuntimeError(f"the int32 index build failed: {log[-2000:]}")
            shards, _ = load_index(path)
            genome = random_genome(cs.INT32_N, seed=77)
            reads, _ = simulate_reads(genome, cs.HUMAN_BATCH, read_len=100, max_mismatches=2,
                                      seed=cs.SEED + 17)
            eng = Engine(shards, device="cuda")
            blk = ReadBlock.from_reads(reads)
            for k in (0, 2):
                out += [(f"int32 k={k} #{i}", kind, a)
                        for i, (kind, a) in enumerate(capture(eng, blk, k))]
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
    return out


def main(argv=None) -> int:
    """Run the A/B; returns 0, 1 if a variant's result differed from the
    plain one, 2 without a CUDA device."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sources", nargs="+", default=["bwtpu_torch/csrc/compact.cu"],
                    help=".cu files with csrc/compact.cu's C entry points")
    ap.add_argument("--configs", nargs="*", default=list(CONFIGS), choices=CONFIGS)
    ap.add_argument("--sweep", nargs="*", type=int, default=[],
                    help="lane counts of calls tiled from phase 5's k = 2 candidate counts")
    ap.add_argument("--int32-dir", help="the int32 index's directory: built there when it "
                                        "holds none, else loaded (default: a temporary one)")
    opts = ap.parse_args(argv)

    import torch

    from bwtpu_torch import engine
    from bwtpu_torch.kernels import _build
    from bwtpu_torch.kernels import compact as tc
    from bwtpu_torch.kernels.bounds import bound, compact_mask_work, compact_slots_work, cuda_ms

    if not torch.cuda.is_available():
        print("torch_compact_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(smi, flush=True)
    names = [source_name(p) for p in opts.sources]
    _build.build_all(names)
    for name in names:
        lines = [ln.strip() for ln in _build.build_info[name]["ptxas"].splitlines()
                 if "Used" in ln or "stack frame" in ln]
        print(f"{name}: built in {_build.build_info[name]['seconds']:.1f} s; ptxas "
              f"{' | '.join(lines)}", flush=True)
    vs = [v for p in opts.sources for v in variants(p)]
    plains = {"compact_slots": tc.compact_counts_plain, "compact_mask": tc.compact_plain}
    wrappers = {"compact_slots": engine.compact_counts, "compact_mask": engine.compact}
    works = {"compact_slots": compact_slots_work, "compact_mask": compact_mask_work}
    with tempfile.TemporaryDirectory(prefix="bwtpu_torch_compact_ab_") as tmp:
        calls = config_calls(set(opts.configs), opts.sweep, opts.int32_dir, tmp)
    report = {"card": smi, "calls": []}
    ok = True
    for label, kind, args in calls:
        x, cap = args[0], args[-1]
        H = args[1] if kind == "compact_slots" else 1
        nbytes, ops, what = works[kind](args)
        rec = {"call": label, "kernel": kind, "what": what, **bound(nbytes, ops),
               "variants": {}}
        want = plains[kind](*args)
        empty = torch.zeros_like(x)
        run = [v for v in vs if v.words(x.shape[0], cap) is not None]
        for v in run:
            got = v(kind, x, H, cap)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, want, strict=True))
            ok &= same
            rec["variants"][v.name] = {"equal": same}
        rec["turns"] = [[v.name, cuda_ms(lambda v=v: v(kind, x, H, cap), REPS)]
                        for v in run + run[::-1]]
        for v in run:
            r = rec["variants"][v.name]
            r["ops_us"] = device_ops(lambda v=v: v(kind, x, H, cap))
            r["empty_ms"] = cuda_ms(lambda v=v: v(kind, empty, H, cap), REPS)
        lib = tc._lib()
        plan = tc.plan(x.shape[0], cap, tc._cluster_ctas(lib, x.device), lib.tile)
        pkg = {"plan_form": plan[0], "ms": cuda_ms(lambda: wrappers[kind](*args), REPS),
               "ops_us": device_ops(lambda: wrappers[kind](*args))}
        if kind == "compact_mask":
            got = torch.nonzero_static(x, size=cap, fill_value=0)
            torch.cuda.synchronize()
            assert torch.equal(got[:, 0], want[0].long()), "nonzero_static != sel"
            pkg["nonzero_static_ms"] = cuda_ms(
                lambda: torch.nonzero_static(x, size=cap, fill_value=0), REPS)
        rec["package"] = pkg
        report["calls"].append(rec)
        print(f"{label} {kind} ({what}): bound {rec['bound_ms']:.5f} ms ({rec['bound_by']}, "
              f"{rec['bound_bytes']} B)", flush=True)
        print("  turns " + ", ".join(f"{n} {ms:.4f}" for n, ms in rec["turns"]), flush=True)
        for n, r in rec["variants"].items():
            print(f"  {n}: equal {r['equal']}; empty {r['empty_ms']:.4f} ms; ops µs "
                  + ", ".join(f"{k} {u:.2f}" for k, u in r["ops_us"].items()), flush=True)
        print(f"  package (plan form {plan[0]}): {pkg['ms']:.4f} ms; ops µs "
              + ", ".join(f"{k} {u:.2f}" for k, u in pkg["ops_us"].items())
              + (f"; nonzero_static {pkg['nonzero_static_ms']:.4f} ms"
                 if "nonzero_static_ms" in pkg else ""), flush=True)
    print(json.dumps(report), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
