"""Cells on several cards: the program's shard ring (bwtpu_torch.dist.
DistEngine), one rank process a card. main() runs one such cell once and
prints run.py's result line; run.py hands it a cell whose "chips" is above
1 by a branch that comes with the first such cell in BENCHMARK.json
(`if cell.chips > 1: return ring.main(bench, args, T_START)`, after the
device-count check).

  launcher  (the calling process) the configuration's genome and index
            (cells.prepare, built on the first run in a checkout), then
            one rank process a card (this file, --rank r), all waited for
            with one deadline. A rank that fails or outlives the deadline
            ends every rank, and no result is printed.
  rank r    cuda:r and its process group by the program's
            multihost.initialize (tcp on localhost), the whole index's
            shards and manifest, DistEngine for shard r, its own pool from
            (seed, r), a warm-up of `warmup_blocks` blocks, the window,
            and then its window sent to rank 0, which judges every rank's
            sampled reads against one plain reference and writes the
            result.

The window is the loop of `bwtpu_torch.multihost` (its rounds copied:
the program has no function that takes a block iterator): the pool's
blocks cycled, `in_flight` of them dispatched ahead, each finished on the
dispatching thread, as DistEngine's heals issue collectives from the
finish. The program's entry is the one multihost runs,
DistEngine.dispatch_batch / finish_batch on Read lists (packed=True); a
block path of the program would be an entry of its own, named by a cell's
traffic. Whether to dispatch another block is rank 0's decision by its
clock, broadcast over a gloo group of the harness's own, so every rank
dispatches the same blocks. perf_counter is CLOCK_MONOTONIC, one clock
for every process of the host: setup_s runs from the launcher's start to
rank 0's window opening, and every rank uses rank 0's window. The ranks
start as torchrun starts them: one OpenMP thread each unless set, no
pinning.

The joint window holds every rank's blocks and spans: a rate counts the
reads of all ranks, a per-block mean is over all ranks' blocks. It also
keeps each rank's own readings, for readers that need them: the
program's spans up to the window's close (`rank_spans`, from its
recorder; None where the recorder dropped one), the counters added from
the window's opening to the last block's finish (`rank_counters`) and,
with --trace 1, each card's trace summary (`rank_traces`). With --trace 1
each rank traces its own card; busy_s, window_s, kernel_s and the NCCL
kernels' seconds (nccl_s) are the cards' means (a reader that divides by
the reads of all ranks multiplies them by `ranks`), the breakdown is rank
0's.

Controls and faults (the benchmark's own runs use "sound"):

  python3 benchmark/ring.py --workload <cell> --seeds <n> ... \\
      [--variants sound noheal] [--seconds 20]

one launch, one JSON line a (variant, seed) on stdout. noheal (control):
heal_overflow off. The faults, for the tests: stale (the block before's
results), half (the second half of each block's reads left without
hits), altered (every 16th read's nm changed), exchange (the ring's hops
and its homing all_to_all left out); slow and lost make rank 1 slow in
each dispatch, or end it in the window.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import itertools
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from time import perf_counter

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0]) == HERE:
    sys.path.pop(0)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.drive import Spans, Window  # noqa: E402

VARIANTS = ("sound", "noheal", "stale", "half", "altered", "exchange", "slow", "lost")
DEADLINE_S = 240.0  # a run's ranks, past its window: set-up, warm-up, check
NO_CAP = (1 << 63) - 1


@dataclasses.dataclass
class RingWindow(Window):
    ranks: int = 1
    per_rank: list = dataclasses.field(default_factory=list)  # each rank's dispatches
    rank_spans: list = dataclasses.field(default_factory=list)  # program Records, or None
    rank_counters: list = dataclasses.field(default_factory=list)  # {counter: added}
    rank_traces: list = dataclasses.field(default_factory=list)  # devtrace summaries


def rank_seed(seed: int, rank: int) -> int:
    """Rank r's pool seed: its own stream of --seed."""
    import numpy as np

    s = np.random.SeedSequence([seed % 2**64, 0x52494E47, rank]).generate_state(2, np.uint32)
    return int(s[0]) << 32 | int(s[1])


# ---------------------------------------------------------------------------
# Launcher
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(bench, name: str, seeds, variants, seconds: float, trace: bool, *,
           t_start: float, device: str = "cuda", deadline_s: float | None = None,
           record: str = "result"):
    """Start the cell's ranks and wait for them: rank 0's records, one a
    (seed, variant), or None where a rank failed or the deadline passed.
    record: "result" ({"result", "info"}: a benchmark run's line) or
    "control" (the numbers compared, blocks done, reads/s)."""
    from benchmark.cells import prepare
    from benchmark.run import set_caches

    cell = bench.cell(name)
    set_caches(bench)
    prepare(bench, cell.config)
    fd, out = tempfile.mkstemp(suffix=".jsonl")
    os.close(fd)
    port = _free_port()
    argv = ["--root", bench.root, "--workload", name, "--seeds", *map(str, seeds),
            "--variants", *variants, "--seconds", repr(float(seconds)),
            "--trace", str(int(trace)), "--t-start", repr(t_start), "--device", device,
            "--port", str(port), "--world", str(cell.chips), "--out", out,
            "--out-record", record]
    # as torchrun starts ranks: one OpenMP thread each unless set
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.setdefault("OMP_NUM_THREADS", "1")
    n_runs = len(seeds) * len(variants)
    deadline = time.monotonic() + (deadline_s or n_runs * (DEADLINE_S + seconds))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r),
                               *argv], cwd=ROOT, env=env, stdout=2)
             for r in range(cell.chips)]
    failed = None
    try:
        while failed is None:
            codes = [p.poll() for p in procs]
            if all(c == 0 for c in codes):
                break
            bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = f"rank {bad[0][0]} exited with {bad[0][1]}"
            elif time.monotonic() > deadline:
                failed = f"ranks still running at the deadline ({deadline_s or 'default'} s)"
            else:
                time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    try:
        with open(out) as f:
            records = [json.loads(line) for line in f if line.strip()]
    finally:
        os.unlink(out)
    if failed is not None:
        print(f"no result: {failed}", file=sys.stderr)
        return None
    return records


def main(bench, args, t_start: float, device: str = "cuda") -> int:
    """One run of a cell on several cards, printed as run.main prints a
    one-card run: what run.py's branch for such a cell calls."""
    from benchmark.run import forbidden_modules, power_limit

    recs = launch(bench, args.workload, [args.seed], ["sound"], args.seconds,
                  bool(args.trace), t_start=t_start, device=device)
    if not recs:
        return 4
    result, info = recs[0]["result"], recs[0]["info"]
    bad = sorted(set(forbidden_modules()) | set(info.pop("forbidden")))
    if bad:
        print(f"no result: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    print(f"# {power_limit()}; {json.dumps(info)}", file=sys.stderr)
    for n, c in result["check"].items():
        side = "max" if "max" in c else "min"
        print(f"check {n} {c['value']} {'<=' if side == 'max' else '>='} {c[side]}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


# ---------------------------------------------------------------------------
# A rank
# ---------------------------------------------------------------------------


class Feed:
    """The rank's pool as multihost's rounds take it, Read lists for
    DistEngine.dispatch_batch, and its results as the check reads them."""

    def __init__(self, engine, pool, k: int):
        from bwtpu_torch.io import Read

        B = pool.block_reads
        self.engine, self.k, self.B = engine, k, B
        self.n_blocks = pool.n // B
        # the FASTQ records as io.read_fastq takes them apart, from memory:
        # a file of the pool would be 60 MB a rank and run
        lines = pool.fastq(0, pool.n).decode().split("\n")
        reads = [Read(lines[i][1:], lines[i + 1], lines[i + 3]) for i in range(0, 4 * pool.n, 4)]
        self.blocks = [reads[lo:lo + B] for lo in range(0, pool.n, B)]

    def dispatch(self, b: int):
        return self.engine.dispatch_batch(self.blocks[b], k=self.k, packed=True)

    def finish(self, handle):
        """(each read's list of hits, its truncation flags)."""
        return self.engine.finish_batch(handle), self.engine.last_truncated

    def heals(self) -> int:
        return self.engine.heals

    def sampled(self, res, s):
        """FlatHits of the sampled reads s (sorted) of one block's results,
        read_idx in the block's numbering."""
        import numpy as np

        from bwtpu_torch.results import FlatHits

        hits, trunc = res
        per = [hits[i] for i in s]
        cnt = np.array([len(h) for h in per], dtype=np.int64)
        flat = [h for hs in per for h in hs]
        mark = np.zeros(self.B, dtype=bool)
        if trunc is not None:
            mark[:len(trunc)] = trunc
        return FlatHits(np.repeat(np.asarray(s, np.int32), cnt),
                        np.array([h.pos for h in flat], np.int64),
                        np.array([h.strand == "-" for h in flat], bool),
                        np.array([h.nm for h in flat], np.int32), self.B, mark)


def _half(res):
    hits, trunc = res
    n = len(hits) // 2
    return hits[:n] + [[] for _ in hits[n:]], trunc


def _altered(res):
    from bwtpu_torch.golden import Hit

    hits, trunc = res
    return [[Hit((h.nm + 1) % 3, h.strand, h.pos) for h in hs] if i % 16 == 0 else hs
            for i, hs in enumerate(hits)], trunc


@contextlib.contextmanager
def variant(engine, feed, name: str):
    """The engine (or the feed over it) with `name` applied, restored on exit."""
    config, lay = engine.config, engine.layout
    finish = feed.finish
    if name == "noheal":
        engine.config = config.replace(heal_overflow=False)
    elif name in ("stale", "half", "altered"):
        state = {}

        def wrapped(handle):
            res = finish(handle)
            if name == "stale":
                out, state["last"] = state.get("last", res), res
                return out
            return (_half if name == "half" else _altered)(res)
        feed.finish = wrapped
    elif name == "exchange":
        def rotate(send, recv):
            recv.copy_(send)
            return lambda: None
        lay.rotate, lay.home = rotate, (lambda rows: rows)
    elif name not in VARIANTS:
        raise ValueError(f"unknown variant {name!r}")
    try:
        yield
    finally:
        engine.config = config
        feed.__dict__.pop("finish", None)
        feed.__dict__.pop("dispatch", None)
        lay.__dict__.pop("rotate", None)
        lay.__dict__.pop("home", None)


def _rank_fault(feed, name: str, rank: int) -> None:
    """slow / lost, in the window only: rank 1 sleeps 50 ms in each
    dispatch, or ends at its third."""
    if rank != 1 or name not in ("slow", "lost"):
        return
    dispatch, calls = feed.dispatch, itertools.count(1)

    def wrapped(b):
        if name == "lost" and next(calls) == 3:
            os._exit(17)
        if name == "slow":
            time.sleep(0.05)
        return dispatch(b)
    feed.dispatch = wrapped


def run_ring(feed, *, depth: int, group, seconds: float | None, warm: int = 0,
             on_done=None, spans: Spans | None = None, t_open: float = 0.0) -> Window:
    """The rounds: `depth` blocks in flight, each finished on this thread.
    seconds None: the feed's first `warm` blocks (the warm-up, the same
    count on every rank). Else a window from t_open, rank 0's clock
    deciding each dispatch."""
    import torch
    import torch.distributed as dist

    spans = spans or Spans()
    inflight, done = collections.deque(), []
    dispatched = 0
    t_close = t_open + seconds if seconds is not None else float("inf")
    me = dist.get_rank(group)

    def go(i: int) -> bool:
        if seconds is None:
            return i < warm
        flag = torch.tensor([int(perf_counter() < t_close) if me == 0 else 0])
        dist.broadcast(flag, 0, group=group)
        return bool(flag)

    def drain():
        b, t0, handle = inflight.popleft()
        h0 = feed.heals()
        tf = perf_counter()
        res = feed.finish(handle)
        t1 = perf_counter()
        spans.add("finish_block", tf, t1)
        done.append((b, t0, t1, feed.B, feed.heals() - h0))
        if on_done is not None:
            on_done(b, res)
            spans.add("check", t1, perf_counter())

    for i in itertools.count():
        if not go(i):
            break
        b = i % feed.n_blocks
        t0 = perf_counter()
        handle = feed.dispatch(b)
        spans.add("dispatch_block", t0, perf_counter())
        inflight.append((b, t0, handle))
        dispatched += feed.B
        if len(inflight) >= depth:
            drain()
    while inflight:
        drain()
    if seconds is None:
        t_open, t_close = 0.0, perf_counter()
    return Window("align", t_open, t_close, done, dispatched, spans)


def _nccl_s(events, anchors, t_open, t_close) -> float:
    """Seconds of NCCL kernels in the window (device trace)."""
    from benchmark import devtrace

    ev = [e for e in events if e.get("name") == devtrace.ANCHOR
          or (e.get("cat") == "kernel" and e.get("name", "").startswith("nccl"))]
    return devtrace.summarize(ev, anchors, t_open, t_close, [])["kernel_s"]


class Rank:
    """One rank's program, kept across the (seed, variant) runs of a launch."""

    def __init__(self, a):
        import torch.distributed as dist

        from benchmark.cells import Bench, prepare
        from benchmark.run import set_caches
        from bwtpu_torch.dist import DistEngine
        from bwtpu_torch.hosttune import tune_malloc
        from bwtpu_torch.index import load_index
        from bwtpu_torch.multihost import initialize

        self.a, self.rank = a, a.rank
        self.bench = Bench(a.root)
        self.cell = self.bench.cell(a.workload)
        self.cuda = a.device == "cuda"
        set_caches(self.bench)
        tune_malloc()  # as multihost does at entry
        self.dev, _ = initialize(f"localhost:{a.port}", a.world, a.rank,
                                 device=f"cuda:{a.rank}" if self.cuda else "cpu")
        self.genome, index_dir = prepare(self.bench, self.cell.config)
        shards, manifest = load_index(index_dir)
        b = self.cell.config["build_index"]
        if len(shards) != b["shards"] or manifest.overlap != b["overlap"]:
            raise RuntimeError(f"index of {len(shards)} shards, overlap {manifest.overlap}: "
                               f"the configuration states {b['shards']}, {b['overlap']}")
        self.engine = DistEngine(shards, manifest, device=self.dev)
        self.group = dist.new_group(backend="gloo")  # the harness's agreements
        self.ref = None

    def sync(self):
        import torch

        if self.cuda:
            torch.cuda.synchronize(self.dev)

    def one(self, seed: int, name: str) -> dict | None:
        """One run; rank 0 returns its record."""
        import torch
        import torch.distributed as dist

        from benchmark import check as chk
        from benchmark import devtrace
        from benchmark.gen.reads import make_pool, sample_reads
        from benchmark.run import forbidden_modules
        from bwtpu_torch import trace as program

        tr = self.cell.traffic
        k, depth = int(tr["k"]), int(tr["in_flight"])
        pseed = rank_seed(seed, self.rank)
        pool = make_pool(self.genome, tr, pseed)
        sample = sample_reads(tr, pseed)
        feed = Feed(self.engine, pool, k)
        checker = chk.AlignCheck(sample)
        on_done = lambda b, res: checker.on_done(b, feed.sampled(res, sample[b]))  # noqa: E731
        with variant(self.engine, feed, name):
            run_ring(feed, depth=depth, group=self.group, seconds=None,
                     warm=int(tr["warmup_blocks"]))
            self.sync()
            if self.cuda:
                torch.cuda.reset_peak_memory_stats(self.dev)
            _rank_fault(feed, name, self.rank)
            spans, trace = Spans(), None
            c0 = program.totals()[1]
            with contextlib.ExitStack() as stack:
                dt = stack.enter_context(devtrace.DeviceTrace()) if self.a.trace else None
                a0 = dt.anchor() if dt else self.sync()
                t = torch.tensor([perf_counter()], dtype=torch.float64)
                dist.broadcast(t, 0, group=self.group)  # rank 0's window, every rank's
                w = run_ring(feed, depth=depth, group=self.group, seconds=self.a.seconds,
                             on_done=on_done, spans=spans, t_open=float(t))
                a1 = dt.anchor() if dt else None
            c1 = program.totals()[1]
            if dt:
                ev = dt.events()
                trace = devtrace.summarize(ev, (a0, a1), w.t_open, w.t_close, spans.items)
                trace["nccl_s"] = _nccl_s(ev, (a0, a1), w.t_open, w.t_close)
        self.sync()
        peak = torch.cuda.max_memory_allocated(self.dev) if self.cuda else 0
        mine = {"done": w.done, "spans": spans.items, "got": checker.got, "pseed": pseed,
                "dispatched": w.dispatched, "peak": int(peak), "trace": trace,
                "program": program.between(float("-inf"), w.t_close),
                "counters": {c: n - c0.get(c, 0) for c, n in c1.items() if n != c0.get(c, 0)},
                "forbidden": forbidden_modules()}
        every = [None] * self.a.world if self.rank == 0 else None
        dist.gather_object(mine, every, dst=0, group=self.group)
        if self.rank != 0:
            return None
        return self.judge(seed, name, w, every)

    def judge(self, seed: int, name: str, w, every: list) -> dict:
        import numpy as np

        from benchmark import check as chk
        from benchmark.gen.reads import make_pool, sample_reads
        from benchmark.reference import align as ref_align
        from benchmark.reference.shards import heavy, shard_genomes

        cfg, tr = self.cell.config, self.cell.traffic
        k, b = int(tr["k"]), cfg["build_index"]
        cap = chk.capacity(cfg, k)
        if self.ref is None:  # the keys of every position, once a process
            self.ref = (ref_align.Genome(self.genome),
                        shard_genomes(self.genome, b["shards"], b["overlap"]))
        genome, parts = self.ref
        wrong = extra = checked = 0
        for r in every:
            pool = make_pool(self.genome, tr, r["pseed"])
            sample = sample_reads(tr, r["pseed"])
            ref = chk.Reference(genome, pool, sample, k, NO_CAP)
            codes, amb = ref_align.codes_of(ref.seq)
            hv = heavy(parts, codes, amb, k, cap)
            a = ref.ans
            keep = ~hv[a.read]
            ref.ans = ref_align.Answer(hv, a.read[keep], a.pos[keep], a.rev[keep],
                                           a.nm[keep])
            ref.cnt = np.bincount(ref.ans.read, minlength=len(ref.idx))
            ref.first = np.cumsum(ref.cnt) - ref.cnt
            checker = chk.AlignCheck(sample)
            checker.got = r["got"]
            n = checker.judge(ref)
            wrong += n["wrong_reads"]
            checked += n["checked_reads"]
            extra += round(n["extra_marked_permille"] * n["checked_reads"] / 1000)
        numbers = chk._numbers(wrong, extra, checked)
        correct, compared = chk.verdict(numbers, self.bench.limits(self.cell.name))

        win = RingWindow("align", w.t_open, w.t_close,
                         sorted((d for r in every for d in r["done"]), key=lambda d: d[2]),
                         sum(r["dispatched"] for r in every), Spans(), ranks=len(every),
                         per_rank=[r["dispatched"] for r in every],
                         rank_spans=[r["program"] for r in every],
                         rank_counters=[r["counters"] for r in every],
                         rank_traces=[r["trace"] for r in every])
        win.spans.items = [s for r in every for s in r["spans"]]
        win.setup_s = w.t_open - self.a.t_start
        traces = win.rank_traces
        if traces[0] is not None:
            mean = lambda key: sum(t[key] for t in traces) / len(traces)  # noqa: E731
            win.trace = dict(traces[0], **{key: mean(key) for key in
                                           ("busy_s", "window_s", "kernel_s", "nccl_s")},
                             anchored=all(t["anchored"] for t in traces))
        if self.a.out_record == "control":
            return {"variant": name, "seed": seed, "correct": correct, **numbers,
                    "blocks_done": len(win.in_window()), "heals": win.heals,
                    "reads_per_s": win.reads / win.seconds}
        return self.result(win, correct, compared, numbers, every)

    def result(self, w, correct, compared, numbers, every) -> dict:
        import torch

        cell = self.cell
        metrics = {}
        for m in (cell.per_layer if self.a.trace else cell.end_to_end):
            v = self.bench.reader(m["name"])(w)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        dev = {"platform": "gpu" if self.cuda else "cpu",
               "kind": torch.cuda.get_device_name(self.dev) if self.cuda else "cpu",
               "count": cell.chips, "memory_peak_bytes": max(r["peak"] for r in every)}
        result = {"correct": correct, "attempted": w.dispatched, "failed": 0,
                  "metrics": metrics, "device": dev}
        if w.trace is not None:
            dev["busy_s"], dev["window_s"] = w.trace["busy_s"], w.trace["window_s"]
            result["breakdown"] = {"device_ops": w.trace["device_ops"],
                                   "idle_gaps": w.trace["idle_gaps"]}
        result["check"] = compared  # last: the numbers compared, with their limits
        quarter = [0] * 4
        for d in w.in_window():
            quarter[min(3, int(4 * (d[2] - w.t_open) / w.seconds))] += 1
        info = {"blocks_done": len(w.in_window()), "blocks_by_quarter": quarter,
                "heals": w.heals,
                "dispatched_per_rank": w.per_rank,
                "memory_peak_per_rank": [r["peak"] for r in every],
                "forbidden": sorted({m for r in every for m in r["forbidden"]}),
                **{k_: v for k_, v in numbers.items() if k_ not in compared}}
        if w.trace is not None:
            info.update(trace_anchored=w.trace["anchored"], kernel_s=w.trace["kernel_s"],
                        nccl_s=w.trace["nccl_s"])
        return {"result": result, "info": info}


def rank_main(a) -> int:
    import torch.distributed as dist

    rank = Rank(a)
    try:
        for seed in a.seeds:
            for name in a.variants:
                rec = rank.one(seed, name)
                if rec is not None:
                    with open(a.out, "a") as f:
                        f.write(json.dumps(rec) + "\n")
    finally:
        rank.engine = None
        dist.destroy_process_group()
    return 0


def cli(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--variants", nargs="+", default=["sound", "noheal"], choices=VARIANTS)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    # a rank's own arguments, given by the launcher
    p.add_argument("--rank", type=int)
    p.add_argument("--root", default=ROOT)
    p.add_argument("--world", type=int)
    p.add_argument("--port", type=int)
    p.add_argument("--t-start", type=float, default=0.0)
    p.add_argument("--out")
    p.add_argument("--out-record", default="result", choices=("result", "control"))
    a = p.parse_args(argv)
    if a.rank is not None:
        return rank_main(a)

    from benchmark.cells import Bench

    recs = launch(Bench(a.root), a.workload, a.seeds, a.variants, a.seconds, bool(a.trace),
                  t_start=perf_counter(), device=a.device, record="control")
    for rec in recs or []:
        print(json.dumps(rec), flush=True)
    return 0 if recs else 4


if __name__ == "__main__":
    sys.exit(cli())
