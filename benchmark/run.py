"""One run of one benchmark cell of bwtpu_torch, from the repository root:

  python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (timed as setup_s, from the start of this process): the
configuration's genome and index (benchmark/.cache, built on the first run
in a checkout), the Engine on the card, the read pool from --seed (align:
parsed once by the program's FASTQ reader; sam: a FASTQ file in TMPDIR),
and one warm-up pass over the pool. Then the window of --seconds (with
--trace 1 under torch.profiler), then the check against the plain
reference (check.py). The last line of stdout is the result:

  {"correct", "attempted", "failed", "metrics", "device"[, "breakdown"], "check"}

with the cell's end-to-end metrics (--trace 0) or per-layer metrics
(--trace 1). The numbers compared, each with its limit, are also the last
lines of stderr. Without a CUDA card (or fewer cards than the cell asks
for), or with jax, jaxlib, flax or the JAX package bwtpu loaded once the
window has closed, it prints no result and exits non-zero.
"""

from time import perf_counter

T_START = perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0]) == HERE:
    sys.path.pop(0)  # the harness's modules are reached as benchmark.*
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "bwtpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is a forbidden one, whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def set_caches(bench) -> None:
    """Build and kernel caches inside the checkout, at fixed paths (the
    program's own kernels cache in bwtpu_torch/_build/)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = bench.path(".cache", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = bench.path(".cache", "triton")


class Session:
    """One cell's program on its device: the configuration's genome and
    index (benchmark/.cache), and the Engine. control.py keeps one across
    seeds; a benchmark run makes one."""

    def __init__(self, bench, name: str, device: str = "cuda"):
        from benchmark.cells import prepare
        from bwtpu_torch.engine import Engine
        from bwtpu_torch.hosttune import tune_malloc
        from bwtpu_torch.index import load_index

        self.bench, self.name, self.cell = bench, name, bench.cell(name)
        self.cuda = device.startswith("cuda")
        set_caches(bench)
        tune_malloc()  # as the CLI does at entry
        self.genome, index_dir = prepare(bench, self.cell.config)
        shards, self.manifest = load_index(index_dir)
        self.engine = Engine(shards, device=device)
        self.ref_genome = None

    def window(self, seed: int, seconds: float, trace: bool, t_start: float):
        """The pool from the seed, the warm-up pass, then the window.
        Returns (window, checker, pool, sample); window.setup_s counts from
        t_start to the window's opening."""
        import numpy as np
        import torch

        from benchmark import check as chk
        from benchmark.drive import CountingSink, Spans, run_align, run_sam
        from benchmark.gen.reads import make_pool, sample_reads

        tr, engine = self.cell.traffic, self.engine
        k, depth, B = int(tr["k"]), int(tr["in_flight"]), int(tr["block_reads"])
        pool = make_pool(self.genome, tr, seed)
        sample = sample_reads(tr, seed)
        fastq = None
        if tr["entry"] == "align":
            from bwtpu_torch.readblock import _native_parse

            blocks = []
            for lo in range(0, pool.n, B):
                blk = _native_parse(np.frombuffer(pool.fastq(lo, lo + B), dtype=np.uint8))
                if blk is None:
                    raise RuntimeError("the program's native FASTQ parser is unavailable")
                blocks.append(blk)
            checker = chk.AlignCheck(sample)
            drive = lambda secs, on_done=None, spans=None: run_align(  # noqa: E731
                engine, blocks, k=k, depth=depth, seconds=secs, on_done=on_done, spans=spans)
        else:
            fd, fastq = tempfile.mkstemp(suffix=".fq")
            with os.fdopen(fd, "wb") as f:
                for lo in range(0, pool.n, B):
                    f.write(pool.fastq(lo, lo + B))
            checker = chk.SamCheck(sample, int(tr["kept_chunks"]), seed)
            drive = lambda secs, on_done=None, spans=None: run_sam(  # noqa: E731
                engine, fastq, self.manifest, k=k, block=B, depth=depth, seconds=secs,
                sink=CountingSink(), on_done=on_done, spans=spans)
        try:
            drive(None)  # warm-up: every shape and heal level the pool takes
            if self.cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            spans = Spans()
            if trace:
                from benchmark.devtrace import DeviceTrace, summarize

                with DeviceTrace() as dt:
                    a0 = dt.anchor()
                    setup_s = perf_counter() - t_start
                    w = drive(seconds, checker.on_done, spans)
                    a1 = dt.anchor()
                w.trace = summarize(dt.events(), (a0, a1), w.t_open, w.t_close, spans.items)
            else:
                if self.cuda:
                    torch.cuda.synchronize()
                setup_s = perf_counter() - t_start
                w = drive(seconds, checker.on_done, spans)
            w.setup_s = setup_s
        finally:
            if fastq is not None:
                os.unlink(fastq)
        return w, checker, pool, sample

    def judge(self, checker, pool, sample) -> dict:
        """The numbers check.py compares, from the plain reference."""
        from benchmark import check as chk

        from benchmark.reference.align import Genome

        cfg, k = self.cell.config, int(self.cell.traffic["k"])
        if self.ref_genome is None:  # the keys of every position, once a process
            self.ref_genome = Genome(self.genome)
        ref = chk.Reference(self.ref_genome, pool, sample, k, chk.capacity(cfg, k))
        if self.cell.traffic["entry"] == "align":
            return checker.judge(ref)
        return checker.judge(ref, cfg["contig"].encode())


def run(bench, name: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
        t_start: float | None = None) -> tuple[dict, dict]:
    """One run of cell `name`: (the result, its "check" key last; what else
    the run saw, for stderr)."""
    import torch

    from benchmark import check as chk

    t_start = T_START if t_start is None else t_start
    sess = Session(bench, name, device)
    w, checker, pool, sample = sess.window(seed, seconds, trace, t_start)
    peak = torch.cuda.max_memory_allocated() if sess.cuda else 0
    kind = torch.cuda.get_device_name(0) if sess.cuda else "cpu"
    stats = sess.engine.stats
    sess.engine = None  # the program's state goes before the reference runs
    if sess.cuda:
        torch.cuda.empty_cache()
    numbers = sess.judge(checker, pool, sample)
    correct, compared = chk.verdict(numbers, bench.limits(name))

    cell = sess.cell
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = bench.reader(m["name"])(w)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if sess.cuda else "cpu", "kind": kind, "count": cell.chips,
           "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": w.dispatched, "failed": 0, "metrics": metrics,
              "device": dev}
    if w.trace is not None:
        dev["busy_s"], dev["window_s"] = w.trace["busy_s"], w.trace["window_s"]
        result["breakdown"] = {"device_ops": w.trace["device_ops"],
                               "idle_gaps": w.trace["idle_gaps"]}
    result["check"] = compared  # last: the numbers compared, with their limits
    info = {"blocks_done": len(w.in_window()), "heals": w.heals, "sam_bytes": w.sam_bytes,
            "compact_overflows": stats.compact_overflows,
            "truncated_reads": stats.truncated_reads,
            **{k_: v for k_, v in numbers.items() if k_ not in compared}}
    if w.trace is not None:
        info.update(trace_anchored=w.trace["anchored"], anchor_drift_s=w.trace["anchor_drift_s"],
                    kernel_s=w.trace["kernel_s"])
    return result, info


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark.cells import Bench

    bench = Bench(ROOT)
    cell = bench.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"no result: {cell.name} needs {cell.chips} CUDA card(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, info = run(bench, args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
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


if __name__ == "__main__":
    sys.exit(main())
