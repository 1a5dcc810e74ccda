"""The harness on the CPU with the program's plain versions, on a tiny
configuration (tests/data/tiny.json): a run is correct, its line has the
contract's keys, a planted fault or a control makes it incorrect, and a new
configuration, cell and metric are added as new files."""

import hashlib
import json
import logging
import os
import shutil

import pytest

from benchmark import devtrace
from benchmark.cells import Bench
from benchmark.control import readings
from benchmark.run import Session, run

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
REPO = os.path.dirname(BENCH)
DATA = os.path.join(HERE, "data")
LIMITS = {"wrong_reads": {"max": 0}, "extra_marked_permille": {"max": 1000.0},
          "checked_reads": {"min": 1}}


def make_root(root, cells=(("tiny.align", "tiny.align"), ("tiny.sam", "tiny.sam"))):
    """A checkout-like root: BENCHMARK.json with the tiny cells added, and
    a copy of benchmark/'s data files with theirs."""
    os.makedirs(os.path.join(root, "benchmark"), exist_ok=True)
    for d in ("configs", "workloads", "metrics", "limits"):
        shutil.copytree(os.path.join(BENCH, d), os.path.join(root, "benchmark", d),
                        dirs_exist_ok=True)
    shutil.copy(os.path.join(DATA, "tiny.json"), os.path.join(root, "benchmark", "configs"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "tiny", "source": "tests", "reduced": [], "why": "tests",
                            "file": "benchmark/configs/tiny.json"})
    for name, traffic in cells:
        shutil.copy(os.path.join(DATA, traffic + ".json"),
                    os.path.join(root, "benchmark", "workloads"))
        spec["workloads"].append({"name": name, "config": "tiny", "traffic": traffic,
                                  "chips": 1, "why": "tests"})
        with open(os.path.join(root, "benchmark", "limits", name + ".json"), "w") as f:
            json.dump({"limits": LIMITS}, f)
        entry = json.load(open(os.path.join(DATA, traffic + ".json")))["entry"]
        for m in spec["end_to_end"] + spec["per_layer"]:
            if "workloads" in m and any(w.endswith("." + entry) for w in m["workloads"]):
                m["workloads"].append(name)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return Bench(root)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    logging.disable(logging.WARNING)  # the engine logs every heal
    yield make_root(str(tmp_path_factory.mktemp("root")))
    logging.disable(logging.NOTSET)


@pytest.fixture(scope="module")
def align_session(bench):
    return Session(bench, "tiny.align", "cpu")


@pytest.mark.parametrize("cell", ["tiny.align", "tiny.sam"])
def test_run_is_correct_and_its_line_has_the_contracts_keys(bench, cell):
    res, info = run(bench, cell, 2**31 + 3, 1.0, False, device="cpu")
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "check"]
    assert res["correct"] is True, (res, info)
    assert res["check"]["wrong_reads"] == {"value": 0, "max": 0}
    assert res["check"]["checked_reads"]["value"] > 0
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    want = {"tiny.align": {"align_reads_per_s", "block_ms_p95", "setup_s"},
            "tiny.sam": {"sam_reads_per_s", "setup_s"}}[cell]
    assert set(res["metrics"]) <= want and "setup_s" in res["metrics"]
    json.dumps(res)


class FakeTrace:
    """Stands in for the profiler on the CPU: one kernel over the window."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def anchor(self):
        from time import perf_counter
        self.t = getattr(self, "t", []) + [perf_counter()]
        return self.t[-1]

    def events(self):
        a, b = self.t
        return [{"name": "cudaDeviceSynchronize", "ph": "X", "cat": "cuda_runtime",
                 "ts": a * 1e6 + 5e6, "dur": 1},
                {"name": "cudaDeviceSynchronize", "ph": "X", "cat": "cuda_runtime",
                 "ts": b * 1e6 + 5e6, "dur": 1},
                {"name": "search_multistep_kernel", "ph": "X", "cat": "kernel",
                 "ts": a * 1e6 + 5e6 + 10, "dur": (b - a) * 0.5e6}]


def test_traced_line_has_the_per_layer_metrics_and_breakdown(bench, monkeypatch):
    monkeypatch.setattr(devtrace, "DeviceTrace", FakeTrace)
    res, info = run(bench, "tiny.align", 9, 12.0, True, device="cpu")
    assert info["blocks_done"] >= 1, info  # the CPU plain path takes seconds a block
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "check"]
    assert res["correct"] is True
    assert {"dispatch_ms_per_block.align", "finish_ms_per_block.align", "heals_per_block",
            "kernel_ms_per_mread.align", "idle_share.align"} <= set(res["metrics"])
    assert "setup_s" not in res["metrics"]
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert info["trace_anchored"] is True
    assert res["breakdown"]["device_ops"][0][0] == "search_multistep_kernel"
    assert len(res["breakdown"]["idle_gaps"]) >= 1


@pytest.mark.parametrize("fault", ["stale", "half", "altered", "tiered"])
def test_faults_and_the_control_come_out_incorrect(align_session, fault):
    (rec,) = readings(align_session, [77], [fault], 0.5)
    assert rec["correct"] is False and rec["wrong_reads"] > 0, rec


def test_sound_and_noheal_readings(align_session):
    """Sound runs read no wrong reads; heals switched off mark more reads."""
    sound, noheal = readings(align_session, [78], ["sound", "noheal"], 0.5)
    assert sound["correct"] and sound["wrong_reads"] == 0
    assert noheal["extra_marked_permille"] > sound["extra_marked_permille"]


def _digest(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            if ".cache" not in p:
                out[os.path.relpath(p, root)] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


def test_a_new_configuration_cell_and_metric_are_new_files(tmp_path):
    root = str(tmp_path)
    make_root(root, cells=(("tiny.align", "tiny.align"),))
    before = _digest(os.path.join(root, "benchmark"))
    b = os.path.join(root, "benchmark")
    cfg = json.load(open(os.path.join(DATA, "tiny.json")))
    cfg.update(name="tiny2", genome_seed=8, length=300_000)
    json.dump(cfg, open(os.path.join(b, "configs", "tiny2.json"), "w"))
    tr = json.load(open(os.path.join(DATA, "tiny.align.json")))
    tr.update(k=1, block_reads=1024)
    json.dump(tr, open(os.path.join(b, "workloads", "k1.small.json"), "w"))
    json.dump({"limits": LIMITS}, open(os.path.join(b, "limits", "tiny2.k1.json"), "w"))
    with open(os.path.join(b, "metrics", "blocks_per_s.py"), "w") as f:
        f.write("def read(w):\n    return len(w.in_window()) / w.seconds\n")
    spec = json.load(open(os.path.join(root, "BENCHMARK.json")))
    spec["configs"].append({"name": "tiny2", "source": "tests", "reduced": ["length"],
                            "why": "tests", "file": "benchmark/configs/tiny2.json"})
    spec["workloads"].append({"name": "tiny2.k1", "config": "tiny2", "traffic": "k1.small",
                              "chips": 1, "why": "tests"})
    spec["end_to_end"].append({"name": "blocks_per_s", "unit": "blocks/s", "better": "higher",
                               "bound": 0.05, "source": "host_clock", "workloads": ["tiny2.k1"]})
    json.dump(spec, open(os.path.join(root, "BENCHMARK.json"), "w"))
    logging.disable(logging.WARNING)
    try:
        res, _ = run(Bench(root), "tiny2.k1", 5, 1.0, False, device="cpu")
    finally:
        logging.disable(logging.NOTSET)
    assert res["correct"] is True
    assert set(res["metrics"]) == {"blocks_per_s", "setup_s"}
    after = _digest(b)
    assert {p: h for p, h in after.items() if p in before} == before
    assert set(after) - set(before) == {"configs/tiny2.json", "workloads/k1.small.json",
                                        "limits/tiny2.k1.json", "metrics/blocks_per_s.py"}


def test_summarize_busy_idle_and_gaps():
    """Busy time merges overlapping device events; idle gaps are named by the
    spans open on each thread; the clock comes from the two anchors."""
    off = 100.0  # the trace's clock runs 100 s ahead of the host's
    sync = {"name": "cudaDeviceSynchronize", "cat": "cuda_runtime", "ph": "X"}
    ev = [{**sync, "ts": (1.0 + off) * 1e6}, {**sync, "ts": (9.0 + off) * 1e6},
          {"name": "k1", "cat": "kernel", "ph": "X", "ts": (2.0 + off) * 1e6, "dur": 1e6},
          {"name": "k2", "cat": "kernel", "ph": "X", "ts": (2.5 + off) * 1e6, "dur": 1e6},
          {"name": "Memcpy HtoD", "cat": "gpu_memcpy", "ph": "X", "ts": (6.0 + off) * 1e6,
           "dur": 0.5e6}]
    spans = [("dispatch_block", "main", 1.0, 4.0), ("finish_block", "worker", 3.0, 7.0),
             ("wait", "main", 4.0, 8.0)]
    s = devtrace.summarize(ev, (1.0, 9.0), 1.0, 8.0, spans)
    assert s["anchored"] and s["anchor_drift_s"] == 0
    assert s["busy_s"] == pytest.approx(2.0) and s["kernel_s"] == pytest.approx(2.0)
    assert s["window_s"] == 7.0
    gaps = dict(s["idle_gaps"])
    assert gaps == pytest.approx({"dispatch_block|-": 1.0, "wait|finish_block": 2.5,
                                  "wait|-": 1.5})
    assert dict(s["device_ops"]) == pytest.approx({"k1": 1.0, "k2": 1.0, "Memcpy HtoD": 0.5})
