"""The per-layer metrics read from the program's recorder (bwtpu_torch.trace):
each reader on a synthetic window with known spans, its None cases (no
recorder, a ring that dropped spans, nothing done), and each on a tiny
traced run on the CPU, whose tiny cells report them."""

import sys

import pytest

from benchmark import devtrace
from benchmark.cells import Bench
from benchmark.drive import Spans, Window
from benchmark.run import run
from benchmark.tests.test_bm_harness import REPO, FakeTrace, bench  # noqa: F401
from bwtpu_torch import trace

ALIGN = ["wait_ms_per_block.align", "fetch_ms_per_block.align", "assemble_ms_per_block.align",
         "heal_ms_per_block.align", "upload_ms_per_block.align", "offcpu_ms_per_block.align"]
SAM = ["heal_ms_per_block.sam", "offcpu_ms_per_block.sam"]
ALL = ALIGN + SAM + ["index_setup_s"]


def _span(name, who, t0, t1, parent=None, cpu=None):
    return trace.Record(next(trace._REC._ids), name, who, -1 if parent is None else parent.id,
                        -1, t0, t1, 0.0, (t1 - t0) if cpu is None else cpu)


def _synthetic(entry):
    """Two blocks done in a window [10, 20): each block's spans, in seconds.
    Block 0: a heal holding a nested heal; block 1: none. Set-up before."""
    sp = [_span("load_index", "main", 1.0, 1.5), _span("upload_index", "main", 2.0, 2.25)]
    for t in (10.0, 14.0):
        d = _span("dispatch", "main", t, t + 0.01)
        sp += [d, _span("pack", "main", t, t + 0.002, d), _span("upload", "main", t + 0.002,
                                                                 t + 0.005, d)]
        f = _span("finish", "worker", t + 0.1, t + 0.2, cpu=0.06)  # off-CPU 0.04
        w = _span("wait", "worker", t + 0.1, t + 0.11, f, cpu=0.0)  # off-CPU 0.01
        sp += [f, w, _span("fetch", "worker", t + 0.11, t + 0.12, f)]
        if t == 10.0:
            h = _span("heal", "worker", t + 0.12, t + 0.19, f)
            f2 = _span("finish", "worker", t + 0.13, t + 0.19, h)
            h2 = _span("heal", "worker", t + 0.15, t + 0.19, f2)
            d2 = _span("dispatch", "worker", t + 0.12, t + 0.13, h)
            sp += [h, f2, h2, d2, _span("upload", "worker", t + 0.12, t + 0.125, d2),
                   _span("wait", "worker", t + 0.13, t + 0.15, f2, cpu=0.005)]  # off 0.015
        else:
            sp.append(_span("assemble", "worker", t + 0.12, t + 0.2, f))
    done = [(0, 10.0, 10.2, 100, 2), (1, 14.0, 14.2, 100, 0)]
    return Window(entry, 10.0, 20.0, done, 200, Spans()), sp


WANT = {"wait_ms_per_block.align": (10 + 20 + 10) / 2, "fetch_ms_per_block.align": 20 / 2,
        "assemble_ms_per_block.align": 80 / 2, "heal_ms_per_block.align": 70 / 2,
        "upload_ms_per_block.align": 6 / 2,
        "offcpu_ms_per_block.align": (40 + 40 - 10 - 15 - 10) / 2,
        "heal_ms_per_block.sam": 70 / 2, "offcpu_ms_per_block.sam": (40 + 40 - 10 - 15 - 10) / 2,
        "index_setup_s": 0.75}


@pytest.mark.parametrize("metric", ALL)
def test_reader_on_a_synthetic_window(metric, monkeypatch):
    entry = "sam" if metric.endswith(".sam") else "align"
    w, sp = _synthetic(entry)
    monkeypatch.setattr(trace, "between",
                        lambda t0, t1: [s for s in sp if t0 <= s.t0 < t1])
    read = Bench(REPO).reader(metric)
    assert read(w) == pytest.approx(WANT[metric])
    if metric != "index_setup_s":
        other, _ = _synthetic("align" if entry == "sam" else "sam")
        assert read(other) is None  # another entry's cells
        w.done = []
        assert read(w) is None  # nothing done in the window


@pytest.mark.parametrize("metric", ALL)
def test_reader_gives_none_without_the_recorder_or_after_drops(metric, monkeypatch):
    entry = "sam" if metric.endswith(".sam") else "align"
    w, _ = _synthetic(entry)
    read = Bench(REPO).reader(metric)
    monkeypatch.setattr(trace, "between", lambda t0, t1: None)
    assert read(w) is None
    import bwtpu_torch

    monkeypatch.delattr(bwtpu_torch, "trace")
    monkeypatch.setitem(sys.modules, "bwtpu_torch.trace", None)
    assert read(w) is None  # a program without bwtpu_torch.trace


def test_tiny_cells_take_the_program_span_metrics(bench):  # noqa: F811
    assert set(ALIGN + ["index_setup_s"]) <= {m["name"] for m in bench.cell("tiny.align").per_layer}
    assert set(SAM + ["index_setup_s"]) <= {m["name"] for m in bench.cell("tiny.sam").per_layer}


@pytest.mark.xdist_group("traced_tiny")  # one CPU window at a time
@pytest.mark.parametrize("cell,want", [("tiny.align", ALIGN), ("tiny.sam", SAM)])
def test_traced_tiny_run_reports_every_program_span_metric(bench, monkeypatch, cell,  # noqa: F811
                                                         want):
    monkeypatch.setattr(devtrace, "DeviceTrace", FakeTrace)
    res, info = run(bench, cell, 2**31 + 11, 30.0, True, device="cpu")
    assert res["correct"] is True and info["blocks_done"] >= 1, (res, info)
    got = res["metrics"]
    for m in want + ["index_setup_s"]:
        assert m in got and got[m]["value"] >= 0, (m, got)
    assert got["index_setup_s"]["unit"] == "s" and got["index_setup_s"]["value"] > 0
