"""How steady a cell is, read as the benchmark's check reads it, and where
its runs differ.

  python3 benchmark/steady.py --workload <cell> --seeds <n> ... \\
      [--sets 2] [--seconds s] [--roots DIR ...] [--readings [--probe]] [--out FILE]

For each set, each seed in turn, and each root in turn (a checkout of the
repository; the default is this one, and a second root is read in turns
against the first, as `parent change change parent`), one process runs

  python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace 0

from that root, as a check runs it. Then, per root and end-to-end metric,
each set's median and spread: (Q3 - Q1) / median by
statistics.quantiles(n=4), and the same with the run farthest from the
median left out where that narrows it. The check holds a cell too noisy
where the mean of the two sets' narrowed spreads is over half the bound,
and a bound too loose where it is over eight times the wider spread of all
the runs; both verdicts are printed beside BENCHMARK.json's bound. Each
run's record (its result line and stderr's last lines) goes to --out.

With --readings each run is `steady.py --one` instead: the same run in
the same process (run.run), with readings of its own process and host
taken every --every seconds by a thread of this script: each thread's CPU
seconds, its wait on a run queue (/proc/self/task/*/schedstat), its
voluntary and involuntary context switches and minor page faults, named
by thread (main, worker: the finish worker, parse: read_fastq_stream's
parse-ahead thread, else the thread's own name); the garbage collector's
collections and seconds by generation (gc.callbacks); Dirty and Writeback
(/proc/meminfo); the host's busy and steal shares (/proc/stat), its load
(/proc/loadavg) and CPU MHz (/proc/cpuinfo); and the rate of each interval
of the window. It reads only /proc and changes no setting. With --probe
as well, a second process beside each run sorts one fixed array again and
again on a core the run leaves free: its sorts a second, per interval,
follow the host's speed and not the run's.
"""

from time import perf_counter

T_START = perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0]) == HERE:
    sys.path.pop(0)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TICK = os.sysconf("SC_CLK_TCK")


def spread(values: list) -> float:
    """(Q3 - Q1) / median, the quartiles of statistics.quantiles(n=4)."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def narrowed(values: list) -> float:
    """spread(), or that of the runs less the one farthest from the median
    where that is narrower."""
    s = spread(values)
    if len(values) < 4:
        return s
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return min(s, spread(values[:far] + values[far + 1:]))


def verdicts(sets: list[list], bound: float) -> dict:
    """The check's readings of one metric from two or more sets of runs."""
    n = [narrowed(v) for v in sets]
    wide = max(spread(v) for v in sets)
    meds = [statistics.median(v) for v in sets]
    return {"medians": meds, "spreads": [spread(v) for v in sets], "narrowed": n,
            "mean_narrowed": sum(n) / len(n), "bound": bound,
            "too_noisy": sum(n) / len(n) > bound / 2,
            "too_loose": bound > 8 * wide and bound > 0.01,
            "five_times_widest": 5 * wide,
            "medians_apart": abs(meds[-1] - meds[0]) / meds[0]}


# ---- readings of this process and its host (--one) -------------------------

def _read(path: str) -> str:
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return ""


def _threads() -> dict:
    """{tid: name}: the harness's names for its Python threads."""
    import threading

    out = {}
    for t in threading.enumerate():
        if t.native_id is None:
            continue
        if t is threading.main_thread():
            out[t.native_id] = "main"
        elif t.name.startswith("ThreadPoolExecutor"):
            out[t.native_id] = "executor"  # named below by what it ran
        elif t.name == "steady-readings":
            out[t.native_id] = "readings"
        else:
            out[t.native_id] = "py:" + t.name
    return out


def _task(tid: str) -> dict | None:
    stat = _read(f"/proc/self/task/{tid}/stat")
    if not stat:
        return None
    comm = stat[stat.index("(") + 1:stat.rindex(")")]
    f = stat[stat.rindex(")") + 2:].split()
    status = dict(line.split(":\t", 1) for line in _read(
        f"/proc/self/task/{tid}/status").splitlines() if ":\t" in line)
    sched = _read(f"/proc/self/task/{tid}/schedstat").split()
    return {"comm": comm, "cpu_s": (int(f[11]) + int(f[12])) / TICK, "minflt": int(f[7]),
            "run_s": int(sched[0]) / 1e9 if sched else None,
            "wait_s": int(sched[1]) / 1e9 if sched else None,
            "vcs": int(status.get("voluntary_ctxt_switches", "0").strip()),
            "ivcs": int(status.get("nonvoluntary_ctxt_switches", "0").strip())}


def _host() -> dict:
    cpu = [int(x) for x in _read("/proc/stat").splitlines()[0].split()[1:]]
    idle = cpu[3] + cpu[4]
    mem = {k: int(v.split()[0]) for k, v in (line.split(":", 1) for line in _read(
        "/proc/meminfo").splitlines()) if k in ("Dirty", "Writeback")}
    mhz = [float(line.split(":")[1]) for line in _read("/proc/cpuinfo").splitlines()
           if line.startswith("cpu MHz")]
    proc = _read("/proc/self/stat")
    f = proc[proc.rindex(")") + 2:].split()
    return {"total": sum(cpu[:8]), "idle": idle, "steal": cpu[7] if len(cpu) > 7 else 0,
            "process_cpu_s": (int(f[11]) + int(f[12])) / TICK,
            "dirty_kb": mem.get("Dirty"), "writeback_kb": mem.get("Writeback"),
            "load1": float(_read("/proc/loadavg").split()[0]),
            "mhz": sum(mhz) / len(mhz) if mhz else None}


class Readings:
    """A thread that samples every `every` seconds until stopped."""

    def __init__(self, every: float):
        import gc
        import threading

        self.every, self.samples, self.gc_s = every, [], [0.0, 0.0, 0.0]
        self.gc_n, self._t0 = [0, 0, 0], None
        self._stop = threading.Event()
        gc.callbacks.append(self._gc)
        self.thread = threading.Thread(target=self._loop, name="steady-readings", daemon=True)

    def _gc(self, phase, info):
        if phase == "start":
            self._t0 = perf_counter()
        elif self._t0 is not None:
            g = info["generation"]
            self.gc_s[g] += perf_counter() - self._t0
            self.gc_n[g] += 1
            self._t0 = None

    def sample(self) -> dict:
        py = _threads()
        tasks = {}
        for tid in os.listdir("/proc/self/task"):
            r = _task(tid)
            if r is not None:
                r["py"] = py.get(int(tid))
                tasks[tid] = r
        return {"t": perf_counter(), "tasks": tasks, "host": _host(),
                "gc_s": list(self.gc_s), "gc_n": list(self.gc_n)}

    def _loop(self):
        while True:
            self.samples.append(self.sample())
            if self._stop.wait(self.every):
                break

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self.thread.join()
        self.samples.append(self.sample())


def _role(r: dict, roles: dict, tid: str) -> str:
    if r["py"] == "executor":
        return roles.get(tid, "executor")
    return r["py"] or "os:" + r["comm"]


def summarize(samples: list, t_open: float, t_close: float, done: list,
              executor_roles: dict) -> dict:
    """The readings over the window: per role of thread, per interval."""
    ins = [s for s in samples if t_open - 1e-3 <= s["t"] <= t_close + 1e-3]
    if len(ins) < 2:
        return {"error": "fewer than two readings in the window"}
    a, b = ins[0], ins[-1]
    dt = b["t"] - a["t"]
    roles: dict = {}
    for tid, rb in b["tasks"].items():
        ra = a["tasks"].get(tid, {"cpu_s": 0.0, "run_s": 0.0, "wait_s": 0.0, "vcs": 0,
                                  "ivcs": 0, "minflt": 0})
        role = _role(rb, executor_roles, tid)
        acc = roles.setdefault(role, {"threads": 0, "cpu_s": 0.0, "wait_s": 0.0, "vcs": 0,
                                      "ivcs": 0, "minflt": 0})
        acc["threads"] += 1
        acc["cpu_s"] += rb["cpu_s"] - ra["cpu_s"]
        if rb["wait_s"] is not None:
            acc["wait_s"] += rb["wait_s"] - (ra["wait_s"] or 0.0)
        for k in ("vcs", "ivcs", "minflt"):
            acc[k] += rb[k] - ra[k]
    intervals = []
    for x, y in zip(ins, ins[1:]):
        hx, hy = x["host"], y["host"]
        tot = max(1, hy["total"] - hx["total"])
        reads = sum(d[3] for d in done if x["t"] < d[2] <= y["t"])
        main = next((tid for tid, r in y["tasks"].items() if r["py"] == "main"), None)
        mx, my = x["tasks"].get(main), y["tasks"].get(main)
        intervals.append({
            "t0": x["t"], "t1": y["t"], "reads_per_s": reads / (y["t"] - x["t"]),
            "host_busy": 1 - (hy["idle"] - hx["idle"]) / tot,
            "host_steal": (hy["steal"] - hx["steal"]) / tot,
            "load1": hy["load1"], "mhz": hy["mhz"],
            "dirty_kb": hy["dirty_kb"], "writeback_kb": hy["writeback_kb"],
            "main_cpu": (my["cpu_s"] - mx["cpu_s"]) / (y["t"] - x["t"]) if mx and my else None,
            "main_wait": ((my["wait_s"] or 0) - (mx["wait_s"] or 0)) / (y["t"] - x["t"])
            if mx and my else None,
            "gc_s": sum(y["gc_s"]) - sum(x["gc_s"])})
    ha, hb = a["host"], b["host"]
    tot = max(1, hb["total"] - ha["total"])
    return {"seconds": dt, "roles": roles,
            "process_cpu_s": hb["process_cpu_s"] - ha["process_cpu_s"],
            "gc_n": [q - p for p, q in zip(a["gc_n"], b["gc_n"])],
            "gc_s": [q - p for p, q in zip(a["gc_s"], b["gc_s"])],
            "host_busy": 1 - (hb["idle"] - ha["idle"]) / tot,
            "host_steal": (hb["steal"] - ha["steal"]) / tot,
            "dirty_kb_max": max((s["host"]["dirty_kb"] or 0) for s in ins),
            "writeback_kb_max": max((s["host"]["writeback_kb"] or 0) for s in ins),
            "intervals": intervals}


def probe(seconds: float) -> int:
    """A fixed load on one core of the host beside a run (--probe-for): the sort
    of one 2^20-key array, again and again; one line a second on stdout,
    (perf_counter, sorts done in that second). Its rate follows the host's
    speed, not the run's."""
    import numpy as np

    keys = np.random.default_rng(0).integers(0, 2**62, 1 << 20)
    t_end = perf_counter() + seconds
    t0, n = perf_counter(), 0
    while t0 < t_end:
        np.sort(keys)
        n += 1
        t = perf_counter()
        if t - t0 >= 1.0:
            print(f"{t} {n / (t - t0)}", flush=True)
            t0, n = t, 0
    return 0


def probe_rates(lines: list, intervals: list) -> list:
    """The probe's mean sorts a second over each interval of the readings
    (its lines: perf_counter and rate pairs; the clock is the host's)."""
    pts = [(float(a), float(b)) for a, b in zip(lines[::2], lines[1::2])]
    out = []
    for iv in intervals:
        got = [r for t, r in pts if iv["t0"] < t <= iv["t1"]]
        out.append(sum(got) / len(got) if got else None)
    return out


def one(args) -> int:
    """One run of run.py's, with readings: the result line last."""
    import threading

    sys.path.insert(0, os.path.abspath(args.root))  # that checkout's harness
    from benchmark import drive
    from benchmark import run as bench_run
    from benchmark.cells import Bench

    bench = Bench(args.root)
    cell = bench.cell(args.workload)
    import torch

    if args.device == "cuda" and (not torch.cuda.is_available()
                                  or torch.cuda.device_count() < cell.chips):
        print("no result: no card", file=sys.stderr)
        return 2
    seen, roles = {}, {}
    orig_process = drive._process

    def process(engine, spans, primary):  # names the finish worker's thread
        f = orig_process(engine, spans, primary)

        def g(handle):
            roles[str(threading.get_native_id())] = "worker"
            return f(handle)
        return g

    drive._process = process
    import bwtpu_torch.readblock as rb

    orig_stream = rb.read_fastq_stream

    def stream(path, chunk, start=0):  # names the parse-ahead thread
        res = orig_stream(path, chunk, start)
        before = {t.native_id for t in threading.enumerate()}

        def gen():
            try:
                for x in res[2]:
                    for t in threading.enumerate():
                        if t.native_id not in before and t.name.startswith("ThreadPool"):
                            roles.setdefault(str(t.native_id), "parse")
                    yield x
            finally:
                res[2].close()  # as run_sam closes the program's stream
        return (res[0], res[1], gen()) if res is not None else None

    rb.read_fastq_stream = stream
    orig_window = bench_run.Session.window

    def window(self, *a, **k):
        out = orig_window(self, *a, **k)
        seen["w"] = out[0]
        return out

    bench_run.Session.window = window
    side = None
    if args.probe:
        side = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--workload", "-",
                                 "--probe-for", str(args.seconds + 600)],
                                stdout=subprocess.PIPE, text=True)
    try:
        with Readings(args.every) as rd:
            result, info = bench_run.run(bench, args.workload, args.seed, args.seconds, False,
                                         device=args.device, t_start=T_START)
    finally:
        if side is not None:
            side.kill()
            lines = side.communicate()[0].split()
    w = seen["w"]
    info["readings"] = summarize(rd.samples, w.t_open, w.t_close, w.in_window(), roles)
    if side is not None:
        info["readings"]["probe"] = probe_rates(lines, info["readings"]["intervals"])
    print(json.dumps({"info": info}))
    print(json.dumps(result))
    return 0


# ---- sets of runs ------------------------------------------------------------

def run_once(root: str, args, seed: int) -> dict:
    if args.readings:
        cmd = [sys.executable, os.path.join(HERE, "steady.py"), "--one", "--root", root,
               "--every", str(args.every), "--device", args.device] + (
                   ["--probe"] if args.probe else [])
    else:
        cmd = [sys.executable, "benchmark/run.py", "--trace", "0"]
    cmd += ["--workload", args.workload, "--seed", str(seed), "--seconds", str(args.seconds)]
    t0 = perf_counter()
    p = subprocess.run(cmd, cwd=root, capture_output=True, text=True)
    lines = p.stdout.strip().splitlines()
    rec = {"root": root, "seed": seed, "rc": p.returncode, "wall_s": perf_counter() - t0,
           "stderr": p.stderr[-4000:]}
    try:
        rec["result"] = json.loads(lines[-1])
        if args.readings:
            rec["info"] = json.loads(lines[-2])["info"]
    except (IndexError, ValueError, KeyError):
        rec["result"] = None
    return rec


def report(recs: list, bench_spec: dict, workload: str, n_sets: int) -> dict:
    bounds = {m["name"]: m["bound"] for m in bench_spec["end_to_end"]}
    out = {}
    for root in dict.fromkeys(r["root"] for r in recs):
        mine = [r for r in recs if r["root"] == root]
        bad = [r["seed"] for r in mine if not r["result"] or r["result"]["correct"] is not True]
        per = {}
        for name in bounds:
            sets = [[r["result"]["metrics"][name]["value"] for r in mine
                     if r["set"] == s and r["result"] and name in r["result"]["metrics"]]
                    for s in range(n_sets)]
            if all(len(v) >= 2 for v in sets):
                per[name] = verdicts(sets, bounds[name])
        out[root] = {"not_correct": bad, "metrics": per}
    return out


def sets(args) -> int:
    roots = [os.path.abspath(r) for r in (args.roots or [ROOT])]
    with open(os.path.join(roots[-1], "BENCHMARK.json")) as f:
        spec = json.load(f)
    if args.seconds is None:
        args.seconds = spec["run_seconds"]
    recs = []
    turn = 0
    for s in range(args.sets):
        for seed in args.seeds:
            order = roots if turn % 2 == 0 else roots[::-1]
            turn += 1
            for root in order:
                rec = run_once(root, args, seed)
                rec["set"] = s
                recs.append(rec)
                res = rec["result"] or {}
                print(json.dumps({"set": s, "seed": seed, "root": root, "rc": rec["rc"],
                                  "correct": res.get("correct"),
                                  "metrics": {k: v["value"] for k, v in
                                              res.get("metrics", {}).items()},
                                  "check": {k: v["value"] for k, v in
                                            res.get("check", {}).items()},
                                  "wall_s": round(rec["wall_s"], 1)}), flush=True)
                if rec["result"] is None:
                    print(rec["stderr"][-1500:], file=sys.stderr, flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(rec) + "\n")
    rep = report(recs, spec, args.workload, args.sets)
    print(json.dumps({"workload": args.workload, "report": rep}), flush=True)
    return 0 if all(not r["not_correct"] for r in rep.values()) else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+")
    p.add_argument("--seed", type=int)
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--seconds", type=float, help="default: BENCHMARK.json's run_seconds")
    p.add_argument("--roots", nargs="+")
    p.add_argument("--readings", action="store_true")
    p.add_argument("--every", type=float, default=5.0)
    p.add_argument("--out")
    p.add_argument("--probe", action="store_true",
                   help="with --readings: a fixed load on one more core beside each run")
    p.add_argument("--probe-for", type=float, help=argparse.SUPPRESS)
    p.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--root", default=ROOT, help=argparse.SUPPRESS)
    p.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.one:
        return one(args)
    if args.probe_for:
        return probe(args.probe_for)
    if not args.seeds:
        p.error("--seeds is required")
    return sets(args)


if __name__ == "__main__":
    sys.exit(main())
