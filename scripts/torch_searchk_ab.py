"""A/B on one CUDA card: search_multistep (bwtpu_torch/kernels/searchk.py)
built from several kernel sources, timed in turns on the main path's own
calls.

The calls are captured from Engine.dispatch_block, as chip_smoke.py's
phase 3 captures them, at four shapes:
  block  one block of 16,384 reads of 100 bp on chip_smoke.py's E. coli-size
         genome at the CLI-default index: the k = 0 call (32,768 lanes) and
         the first k = 2 seed call; the s-mer lattice (9.3 MB) sits in L2;
  bench  the same 131,072 reads tiled 4x in one block: 524,288 reads, the
         k = 0 call of 1,048,576 lanes, as bench.py's device calls have
         (the same index: the search's inputs do not depend on sa_rate);
  wide   one block of 16,384 reads of 100 bp on a single-shard
         `build-index --kmer-d 11` (otherwise the CLI defaults) of
         chip_smoke.py's 46,709,983 bp genome: the k = 0 call and the first
         k = 2 seed call, whose wide_steps is 1 (E[width] = n / 4^11 = 11.1 >
         8; the default depth, 12, leaves 2.8 and no wide phase) and whose
         s-mer lattice (~93 MB) is larger than L2;
  step4  the block's reads on a step-4 index (occ_step 4, 2 KB records) of
         the same E. coli-size genome: the k = 0 call.

Each source is a .cu file with csrc/searchk.cu's C entry points:
bwtpu_torch/csrc/searchk.cu itself (the default), or another design kept
outside the package, for example the parent's in the gitignored _ab/.
A source that exports `bwtpu_searchk_exit_tile` compacts the unfinished
lanes in its exit kernel (the workspace form of searchk.py); one without
it is the form whose exit kernel only flags them (hist zeroed by a
torch.zeros, the compaction left to torch). The csrc/*.cuh headers are
copied beside a source that lacks them. `--groups G3:G4 ...` adds, for
each pair, a copy of the first source built with that many threads a
lane at step 3 and at step 4 (it must read the SEARCHK_G3/SEARCHK_G4
macros).

For every call and source: the outputs against search_multistep_plain
(every output; the sp and ep of unfinished lanes only where the source
compacts, since the other form leaves them as its trips left them), then
in turns (forward, then backward: A, B, B, A) the whole call's device ms
(50 back-to-back calls between one CUDA event pair behind a device sleep,
divided by 50), and per source: the device time of each kernel of the call
(torch.profiler, CUDA activity, 20 calls), an empty call (stop width 2^30,
min_trips 0: every lane stops at its start interval), and the one lane
with the largest exit trip alone. The leave histogram of each call, and,
for the package's own search_early_stop_packed (the finisher included),
its host issue (the call's wall without a sync), its synced wall, and its
kernels and device time a call.

Prints the card's name and power limit, a line per measurement, then one
JSON line with everything.

Run (one card): python scripts/torch_searchk_ab.py
           or:  python scripts/torch_searchk_ab.py --shapes block \\
                    --sources _ab/parent/bwtpu_torch/csrc/searchk.cu \\
                    bwtpu_torch/csrc/searchk.cu --groups 8:16 16:32
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import glob
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPES = ("block", "bench", "wide", "step4")
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


def group_variant(path: str, g3: int, g4: int) -> str:
    """A copy of the source at `path` built with g3 / g4 threads a lane
    (under _ab/groups/); returns its path."""
    out_dir = os.path.join(ROOT, "_ab", "groups")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"searchk_g{g3}_{g4}.cu")
    with open(path) as f:
        body = f.read()
    with open(out, "w") as f:
        f.write(f"#define SEARCHK_G3 {g3}\n#define SEARCHK_G4 {g4}\n{body}")
    return out


class Source:
    """One built source and a direct call of its C entry point."""

    def __init__(self, name: str):
        from bwtpu_torch.kernels import _build

        self.name = name
        self.lib = _build.library(name)
        self.compacts = hasattr(self.lib, "bwtpu_searchk_exit_tile")
        f = self.lib.bwtpu_search_multistep
        p, i = ctypes.c_void_p, ctypes.c_int
        f.restype = i
        f.argtypes = ([p, p, p, p, i, p, p, p] + [i] * 11
                      + ([p] * 9 + [i, p] if self.compacts else [p] * 10))
        self.f = f
        if self.compacts:
            self.lib.bwtpu_searchk_exit_tile.restype = i
            self.tile = self.lib.bwtpu_searchk_exit_tile()

    def __call__(self, args):
        """The call's outputs: (sp0, ep0, sp, ep, rem, unfinished, trips,
        leave) and, where the source compacts, (sel, count, over_lane, n_unf)."""
        import torch

        from bwtpu_torch.kernels import _build, searchk

        lat, latk, inv, C, dr, kt, words, amb, off, L, d, step, stop, mt, cs, wide = args
        B, W = words.shape
        T, _, cap = searchk._shape(L, d, step, wide, B, cs)
        dev = words.device
        out = [torch.empty(B, dtype=torch.int32, device=dev) for _ in range(6)]
        unf = torch.empty(B, dtype=torch.bool, device=dev)
        head = (lat.data_ptr(), latk.data_ptr(), inv.data_ptr(), C.data_ptr(), int(dr),
                kt.data_ptr(), words.data_ptr(), amb.data_ptr(), B, W, off, L, d, step, stop,
                mt, wide, T, cap)
        if self.compacts:
            nb = max(1, -(-B // self.tile))
            ws = torch.empty(T + 5 + nb + cap, dtype=torch.int32, device=dev)
            over = torch.empty(B, dtype=torch.int32, device=dev)
            _build.launch(self.lib, self.f, self.name, words, *head,
                          *(t.data_ptr() for t in out), unf.data_ptr(), over.data_ptr(),
                          ws.data_ptr(), ws.numel())
            extra = (ws[T + 5 + nb:], ws[T + 2], over, ws[T + 3])
            trips = ws[T + 1]
        else:
            hist = torch.zeros(T + 1, dtype=torch.int32, device=dev)
            trips = torch.empty((), dtype=torch.int32, device=dev)
            _build.launch(self.lib, self.f, self.name, words, *head,
                          *(t.data_ptr() for t in out), unf.data_ptr(), hist.data_ptr(),
                          trips.data_ptr())
            extra = ()
        sp0, ep0, sp, ep, rem, leave = out
        return (sp0, ep0, sp, ep, rem, unf, trips, leave) + extra


def cuda_ms(fn, reps: int = REPS) -> float:
    """Device ms of one fn() call: `reps` back-to-back calls between one
    CUDA event pair, queued behind a device sleep, divided by `reps`."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def kernel_split(fn, reps: int = 20) -> dict:
    """{kind: (device ms a call, events a call)} of fn's device work under
    torch.profiler: kinds "search", "exit", "chain2", "memset" and "other"."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us, n = collections.defaultdict(float), collections.Counter()
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        kind = ("search" if "multistep_kernel" in e.name else "exit" if "exit_kernel" in e.name
                else "chain2" if "chain2" in e.name else "memset" if "Memset" in e.name
                else "other")
        us[kind] += e.time_range.elapsed_us()
        n[kind] += 1
    return {k: (us[k] / reps / 1e3, n[k] / reps) for k in sorted(us)}


def check(src: Source, args, want) -> bool:
    """The source's outputs against the plain version's."""
    import torch

    got = src(args)
    torch.cuda.synchronize()
    unf = want[5]
    names = ("sp0", "ep0", "sp", "ep", "rem", "unfinished", "trips")
    ok = True
    for i, name in enumerate(names):
        a, b = got[i], want[i]
        if name in ("sp", "ep") and not (src.compacts and len(want) > 7):
            a, b = a[~unf], b[~unf]
        ok &= bool(torch.equal(a, b))
    if src.compacts and len(want) > 7:
        ok &= all(bool(torch.equal(a, b)) for a, b in zip(got[8:], want[7:11]))
    return ok


def capture_calls(eng, blk, k: int) -> list:
    """The search_multistep arguments of one dispatch_block of blk at k."""
    import chip_smoke as cs
    from bwtpu_torch.kernels import searchk

    calls: list = []
    with cs.capturing(searchk, "search_multistep", calls):
        eng.dispatch_block(blk, k, pad_to=blk.n)
    return calls


def shape_calls(shapes, tmp: str) -> list:
    """[(label, args)] of the requested shapes' calls."""
    import chip_smoke as cs
    from bwtpu_torch.config import EngineConfig
    from bwtpu_torch.engine import Engine
    from bwtpu_torch.index import build_fm_index, load_index
    from bwtpu_torch.io import write_fasta
    from bwtpu_torch.readblock import ReadBlock
    from bwtpu_torch.simulate import simulate_reads

    out = []
    if shapes & {"block", "bench", "step4"}:
        genome = cs.smoke_genome()
        idx = build_fm_index(genome, EngineConfig(sa_rate=8))
        reads, _ = simulate_reads(genome, cs.N_READS, read_len=100, max_mismatches=2,
                                  seed=cs.SEED + 1)
        eng = Engine([idx], device="cuda")
        if "block" in shapes:
            blk = ReadBlock.from_reads(reads[:cs.BATCH])
            out.append(("block k=0", capture_calls(eng, blk, 0)[0]))
            out.append(("block k=2 seed 0", capture_calls(eng, blk, 2)[0]))
        if "bench" in shapes:
            out.append(("bench k=0", capture_calls(eng, ReadBlock.from_reads(reads * 4), 0)[0]))
        if "step4" in shapes:
            eng = Engine([build_fm_index(genome, EngineConfig(sa_rate=8, occ_step=4))],
                         device="cuda")
            blk = ReadBlock.from_reads(reads[:cs.BATCH])
            out.append(("step4 k=0", capture_calls(eng, blk, 0)[0]))
        del eng
    if "wide" in shapes:
        genome = cs.paired_genome()
        fa, idx_dir = os.path.join(tmp, "chr21.fa"), os.path.join(tmp, "chr21_idx1")
        write_fasta(fa, [("chr21_sim", genome)])
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            cs.run_cli(["build-index", fa, idx_dir, "--kmer-d", "11"])
        print(f"single-shard build-index --kmer-d 11 of {len(genome)} bp: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        shards, _ = load_index(idx_dir)
        reads, _ = simulate_reads(genome, cs.BATCH, read_len=100, max_mismatches=2,
                                  seed=cs.SEED + 10)
        eng = Engine(shards, device="cuda")
        blk = ReadBlock.from_reads(reads)
        for k, label in ((0, "wide k=0"), (2, "wide k=2 seed 0")):
            args = capture_calls(eng, blk, k)[0]
            if args[15] != 1:
                raise RuntimeError(f"{label}: wide_steps {args[15]}, expected 1")
            out.append((label, args))
    return out


def package_call(args) -> dict:
    """The package's whole search_early_stop_packed on args: host issue
    (wall of the call without a sync, and of its finisher where the
    finisher is a function of its own), synced wall, kernels and device ms
    a call."""
    import torch

    from bwtpu_torch.kernels import searchk

    # the finisher's function: `_finisher` (search_chain2 alone), or in a
    # checkout whose exit kernel does not compact, `_fixup_stragglers_packed`
    fin_name = next(n for n in ("_finisher", "_fixup_stragglers_packed")
                    if hasattr(searchk, n))
    fin = getattr(searchk, fin_name)
    fin_s = [0.0]

    def timed_fin(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fin(*a, **kw)
        finally:
            fin_s[0] += time.perf_counter() - t0

    searchk.search_early_stop_packed(*args)
    torch.cuda.synchronize()
    issue, finisher_issue, synced = [], [], []
    setattr(searchk, fin_name, timed_fin)
    try:
        for _ in range(5):
            torch.cuda.synchronize()
            fin_s[0] = 0.0
            t0 = time.perf_counter()
            searchk.search_early_stop_packed(*args)
            issue.append(time.perf_counter() - t0)
            finisher_issue.append(fin_s[0])
            torch.cuda.synchronize()
            synced.append(time.perf_counter() - t0)
    finally:
        setattr(searchk, fin_name, fin)
    split = kernel_split(lambda: searchk.search_early_stop_packed(*args))
    return {"issue_ms": min(issue) * 1e3, "finisher_issue_ms": min(finisher_issue) * 1e3,
            "synced_ms": min(synced) * 1e3,
            "device_events": sum(n for _, n in split.values()),
            "device_ms": sum(ms for ms, _ in split.values()),
            "split": {k: ms for k, (ms, _) in split.items()}}


def main(argv=None) -> int:
    """Run the A/B; returns 0, 1 if a source's result differed from the
    plain one, 2 without a CUDA device."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sources", nargs="+", default=["bwtpu_torch/csrc/searchk.cu"],
                    help=".cu files with csrc/searchk.cu's C entry points")
    ap.add_argument("--groups", nargs="*", default=[],
                    help="G3:G4 pairs: copies of the first source at those group sizes")
    ap.add_argument("--shapes", nargs="+", default=list(SHAPES), choices=SHAPES)
    opts = ap.parse_args(argv)

    import torch

    from bwtpu_torch.kernels import _build, searchk
    from bwtpu_torch.kernels.bounds import bound, multistep_work

    if not torch.cuda.is_available():
        print("torch_searchk_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(smi, flush=True)
    paths = list(opts.sources)
    for pair in opts.groups:
        g3, g4 = (int(x) for x in pair.split(":"))
        paths.append(group_variant(opts.sources[0], g3, g4))
    names = [source_name(p) for p in paths]
    _build.build_all(names)
    for name in names:
        lines = [ln.strip() for ln in _build.build_info[name]["ptxas"].splitlines()
                 if "Used" in ln or "stack frame" in ln]
        print(f"{name}: ptxas {' | '.join(lines)}", flush=True)
    sources = [Source(n) for n in names]
    report = {"card": smi, "calls": []}
    ok = True
    with tempfile.TemporaryDirectory(prefix="bwtpu_torch_searchk_ab_") as tmp:
        calls = shape_calls(set(opts.shapes), tmp)
    for label, args in calls:
        B = args[6].shape[0]
        T = searchk._shape(*args[9:12], args[15], B, args[14])[0]
        want = searchk.search_multistep_plain(*args)
        nbytes, ops, what = multistep_work(args)
        rec = {"call": label, "what": what, "T": T, "wide_steps": args[15],
               "trips": int(want[6]), "n_unf": int(want[5].sum()),
               **bound(nbytes, ops), "sources": {}}
        leave = None
        for src in sources:
            same = check(src, args, want)
            ok &= same
            leave = src(args)[7] if leave is None else leave
            rec["sources"][src.name] = {"equal": same}
        hist = torch.bincount(leave.long(), minlength=T + 1).tolist()
        rec["leave_hist"] = hist
        one = int(torch.argmax(leave))
        one_args = (*args[:6], args[6][one:one + 1].contiguous(),
                    args[7][one:one + 1].contiguous(), *args[8:])
        empty_args = (*args[:12], 1 << 30, 0, *args[14:])
        turns = []
        for src in sources + sources[::-1]:
            turns.append([src.name, cuda_ms(lambda: src(args))])
        rec["turns"] = turns
        for src in sources:
            r = rec["sources"][src.name]
            r["split"] = {k: v[0] for k, v in kernel_split(lambda: src(args)).items()}
            r["empty_ms"] = cuda_ms(lambda: src(empty_args))
            r["one_lane_ms"] = cuda_ms(lambda: src(one_args))
            r["one_lane_split"] = {k: v[0] for k, v in
                                   kernel_split(lambda: src(one_args)).items()}
        rec["one_lane_leave"] = int(leave[one])
        rec["package"] = package_call(args)
        report["calls"].append(rec)
        print(f"{label} ({what}; wide_steps {args[15]}): trips {rec['trips']}, n_unf "
              f"{rec['n_unf']}; bound {rec['bound_ms']:.5f} ms ({rec['bound_by']}, "
              f"{rec['bound_bytes']} B); leave histogram {hist}", flush=True)
        for name, ms in turns:
            print(f"  turn {name}: {ms:.4f} ms", flush=True)
        for name, r in rec["sources"].items():
            print(f"  {name}: equal {r['equal']}; kernels {r['split']}; empty call "
                  f"{r['empty_ms']:.4f} ms; one lane (leave {rec['one_lane_leave']}) "
                  f"{r['one_lane_ms']:.4f} ms, kernels {r['one_lane_split']}", flush=True)
        print(f"  package search_early_stop_packed: {rec['package']}", flush=True)
    print(json.dumps(report), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
