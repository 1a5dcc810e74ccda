"""steady.py on the CPU: the spreads as the check computes them, the report
of two sets a root, and one run with readings and the probe on the tiny
cell (the program's plain versions)."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import steady
from benchmark.tests.test_bm_harness import BENCH, make_root

SET = [100.0, 102.0, 98.0, 101.0, 99.0, 130.0]


def test_spread_and_the_run_farthest_from_the_median():
    # exclusive quartiles: 98.75 and 109 about 100.5; less 130: 98.5, 101.5 about 100
    assert steady.spread(SET) == pytest.approx(10.25 / 100.5)
    assert steady.narrowed(SET) == pytest.approx(0.03)
    assert steady.narrowed([100.0, 101.0, 102.0]) == steady.spread([100.0, 101.0, 102.0])


@pytest.mark.parametrize("bound, noisy, loose", [(0.25, False, False), (0.05, True, False),
                                                 (0.9, False, True), (0.01, True, False)])
def test_the_checks_verdicts(bound, noisy, loose):
    v = steady.verdicts([SET, [x * 1.01 for x in SET]], bound)
    assert v["mean_narrowed"] == pytest.approx(0.03)
    assert (v["too_noisy"], v["too_loose"]) == (noisy, loose)
    assert v["five_times_widest"] == pytest.approx(5 * 10.25 / 100.5)
    assert v["medians_apart"] == pytest.approx(0.01)


def test_report_by_root_and_set():
    spec = {"end_to_end": [{"name": "sam_reads_per_s", "bound": 0.25},
                           {"name": "setup_s", "bound": 0.25}]}
    recs = []
    for s in range(2):
        for i, v in enumerate(SET):
            for root in ("parent", "change"):
                ok = not (root == "change" and s == 1 and i == 0)
                recs.append({"root": root, "set": s, "seed": i, "result": {
                    "correct": ok, "metrics": {"sam_reads_per_s": {"value": v},
                                               "setup_s": {"value": 15.0 + i}}}})
    rep = steady.report(recs, spec, "ecoli.k2.sam", 2)
    assert list(rep) == ["parent", "change"]
    assert rep["parent"]["not_correct"] == [] and rep["change"]["not_correct"] == [0]
    assert rep["parent"]["metrics"]["sam_reads_per_s"]["narrowed"] == pytest.approx([0.03] * 2)
    assert set(rep["change"]["metrics"]) == {"sam_reads_per_s", "setup_s"}


def test_a_set_of_runs_with_readings_and_the_probe(tmp_path):
    """The command line as a set of runs takes it: one process a run, here
    `steady.py --one` with the program's plain versions."""
    root, out = str(tmp_path / "root"), str(tmp_path / "runs.jsonl")
    make_root(root, cells=(("tiny.align", "tiny.align"),))
    p = subprocess.run([sys.executable, os.path.join(BENCH, "steady.py"), "--workload",
                        "tiny.align", "--seeds", str(2**31 + 9), "--sets", "1", "--seconds", "3",
                        "--roots", root, "--readings", "--every", "1", "--probe", "--device",
                        "cpu", "--out", out], capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-2000:]
    (rec,) = [json.loads(line) for line in open(out)]
    assert rec["rc"] == 0 and rec["result"]["correct"] is True
    rd = rec["info"]["readings"]
    assert rd["roles"]["main"]["cpu_s"] > 0 and rd["process_cpu_s"] > 0
    assert len(rd["intervals"]) >= 2 and len(rd["probe"]) == len(rd["intervals"])
    assert all(r is not None and r > 0 for r in rd["probe"])
    assert len(rd["gc_n"]) == 3 and rd["seconds"] > 2
    assert json.loads(p.stdout.strip().splitlines()[-1])["workload"] == "tiny.align"
