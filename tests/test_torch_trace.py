"""bwtpu_torch.trace, the recorder of the Engine's block path, on the CPU:
nesting, parents, thread labels, block numbers, totals, the ring's drops;
the Engine's spans and counters on a block that heals (one dispatch and
one finish a level, one heal span a heal, the overflow counters equal to
the scalars the block's outputs hold, h2d_bytes equal to the planes'
bytes); timeline() under the harness's device summary; the CLI summary."""

import gc
import sys
import threading
import time
from time import perf_counter

import numpy as np
import pytest
import torch

from benchmark import devtrace
from bwtpu_torch import trace
from bwtpu_torch.cli import _print_summary
from bwtpu_torch.config import EngineConfig
from bwtpu_torch.engine import Engine
from bwtpu_torch.index import build_fm_index
from bwtpu_torch.readblock import ReadBlock, pack_block
from bwtpu_torch.simulate import random_genome, simulate_reads

torch.set_num_threads(1)


def test_nesting_parents_threads_blocks_and_totals():
    rec = trace.Recorder()
    with rec.span("outer", block=rec.new_block(), cpu=True) as outer:
        with rec.span("inner") as inner:
            rec.count("bytes", 5)
            assert rec.current_block() == outer.block
        with rec.span("other", block=7) as other:
            pass
    rec.count("bytes", 2)

    def work():
        with rec.span("outer"):
            with rec.span("inner"):
                pass

    th = threading.Thread(target=work)
    th.start()
    th.join(timeout=30)
    assert not th.is_alive()
    assert rec.current_block() == -1
    got = rec.spans()
    assert [s.name for s in got] == ["outer", "inner", "other", "outer", "inner"]
    assert outer.parent == -1 and inner.parent == outer.id and other.parent == outer.id
    assert inner.block == outer.block == 0 and other.block == 7
    assert [s.who for s in got] == ["main"] * 3 + ["worker"] * 2
    assert got[4].parent == got[3].id and got[3].parent == -1 and got[3].block == -1
    assert outer.t0 <= inner.t0 <= inner.t1 <= other.t0 <= other.t1 <= outer.t1
    assert outer.c0 > 0 and outer.c1 >= outer.c0  # thread CPU where asked for
    assert inner.c0 == inner.c1 == 0.0 and got[1].cpu == 0.0
    spans, counters = rec.totals()
    assert spans["outer"][0] == 2 and spans["inner"][0] == 2 and spans["other"][0] == 1
    assert spans["inner"][1] == pytest.approx(sum(s.wall for s in got if s.name == "inner"))
    assert all(v[1] >= 0 and v[2] >= 0 for v in spans.values())
    assert counters == {"bytes": 7}
    assert rec.dropped() == 0
    assert [r.id for r in rec.between(inner.t0, other.t1)] == [inner.id, other.id]
    assert got[1] == (inner.id, "inner", "main", outer.id, 0, inner.t0, inner.t1, inner.c0,
                      inner.c1) and got[1].wall == inner.wall and got[1].cpu == inner.cpu


def test_ring_drops_the_oldest_and_between_refuses_a_window_with_drops():
    rec = trace.Recorder(ring=4)
    made = []
    for i in range(6):
        with rec.span(f"s{i}") as s:
            pass
        made.append(s)
    assert rec.dropped() == 2
    assert [s.name for s in rec.spans()] == ["s2", "s3", "s4", "s5"]
    assert rec.between(made[0].t0, perf_counter()) is None
    assert rec.between(made[1].t0, perf_counter()) is None
    assert [r.id for r in rec.between(made[2].t0, perf_counter())] == [s.id for s in made[2:]]
    assert rec.totals()[0]["s0"][0] == 1  # the totals keep what the ring dropped


def test_a_full_ring_is_not_tracked_by_the_garbage_collector():
    rec = trace.Recorder(ring=64)
    for _ in range(100):
        with rec.span("x"):
            pass
    gc.collect()
    assert not any(gc.is_tracked(r) for r in rec._ring)


def test_concurrent_spans_and_counts_lose_nothing():
    """More threads than cores, a short switch interval: every span and
    count reaches the totals and the ring."""
    rec, n_threads, n_each = trace.Recorder(), 16, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_each):
                with rec.span("a"):
                    rec.count("n", 1)

        ths = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ths)
    finally:
        sys.setswitchinterval(old)
    spans, counters = rec.totals()
    assert spans["a"][0] == n_threads * n_each and counters["n"] == n_threads * n_each
    got = rec.spans()
    assert len(got) == n_threads * n_each and len({s.id for s in got}) == len(got)
    assert all(s.parent == -1 for s in got)


def _make(rec, name, who, t0, t1, parent=None):
    return trace.Record(next(rec._ids), name, who, -1 if parent is None else parent.id, -1,
                        t0, t1, 0.0, 0.0)


def test_timeline_puts_an_idle_gap_on_the_innermost_span():
    """The outer spans name the gap at t = 5.0 "finish"; the timeline's
    innermost segments name it "heal", whose nested dispatch has closed."""
    rec = trace.Recorder()
    disp = _make(rec, "dispatch", "main", 0.0, 3.0)
    fin = _make(rec, "finish", "worker", 1.0, 9.0)
    kids = [_make(rec, "wait", "worker", 2.0, 4.0, fin),
            _make(rec, "fetch", "worker", 4.0, 4.6, fin)]
    heal = _make(rec, "heal", "worker", 4.6, 8.0, fin)
    nested = _make(rec, "dispatch", "worker", 4.7, 4.9, heal)
    spans = [disp, fin, *kids, heal, nested]
    tl = rec.timeline(spans)
    assert [x for x in tl if x[1] == "worker"] == [
        ("finish", "worker", 1.0, 2.0), ("wait", "worker", 2.0, 4.0),
        ("fetch", "worker", 4.0, 4.6), ("heal", "worker", 4.6, 4.7),
        ("dispatch", "worker", 4.7, 4.9), ("heal", "worker", 4.9, 8.0),
        ("finish", "worker", 8.0, 9.0)]
    assert [x for x in tl if x[1] == "main"] == [("dispatch", "main", 0.0, 3.0)]
    sync = {"name": "cudaDeviceSynchronize", "cat": "cuda_runtime", "ph": "X"}
    ev = [{**sync, "ts": 0.0}, {**sync, "ts": 10e6},
          {"name": "k", "cat": "kernel", "ph": "X", "ts": 0.5e6, "dur": 3e6},
          {"name": "k", "cat": "kernel", "ph": "X", "ts": 6.5e6, "dur": 2.5e6}]
    gaps = dict(devtrace.summarize(ev, (0.0, 10.0), 0.0, 10.0, tl)["idle_gaps"])
    assert gaps == pytest.approx({"dispatch|-": 0.5, "-|heal": 3.0, "-|-": 1.0})
    outer = [(s.name, s.who, s.t0, s.t1) for s in (disp, fin)]
    gaps = dict(devtrace.summarize(ev, (0.0, 10.0), 0.0, 10.0, outer)["idle_gaps"])
    assert "-|finish" in gaps


def _repeat_genome():
    """A 12 bp motif repeated 30 times inside random flanks: reads over
    the array carry ~30 true hits each, past every level-0 cap."""
    motif = "ACGTGGTCAAGT"
    left, right = random_genome(800, seed=9), random_genome(800, seed=10)
    return left + motif * 30 + right, len(left)


@pytest.fixture(scope="module")
def healing():
    """An Engine on the CPU whose caps heal (test_torch_engine_parity's
    test_heals_match_bwtpu), and its block."""
    genome, off = _repeat_genome()
    cfg = EngineConfig(sa_rate=4, max_hits=4, max_cand=4, loc_factor=1, read_len=36,
                       max_heals=4)
    idx = build_fm_index(genome, cfg)
    reads, _ = simulate_reads(genome, 40, read_len=36, max_mismatches=2, seed=3)
    reads[0] = reads[0].__class__("rep0", genome[off:off + 36], "I" * 36)
    return Engine([idx], device="cpu"), ReadBlock.from_reads(reads)


def _one_block(eng, blk, k, monkeypatch):
    """finish_block(dispatch_block(...)) with every handle's outputs kept:
    (the spans it recorded, the counters it added, the handles)."""
    handles = []
    orig = Engine._dispatch_packed

    def keep(self, *args):
        handles.append(orig(self, *args))
        return handles[-1]

    monkeypatch.setattr(Engine, "_dispatch_packed", keep)
    c0 = trace.totals()[1]
    t0 = perf_counter()
    eng.finish_block(eng.dispatch_block(blk, k, pad_to=48))
    spans = trace.between(t0, perf_counter())
    c1 = trace.totals()[1]
    return spans, {n: c1[n] - c0.get(n, 0) for n in c1 if c1[n] != c0.get(n, 0)}, handles


@pytest.mark.parametrize("k", [0, 2])
def test_engine_block_spans_one_pair_a_level(healing, k, monkeypatch):
    eng, blk = healing
    h0 = eng.stats.heals
    spans, _, handles = _one_block(eng, blk, k, monkeypatch)
    heals = eng.stats.heals - h0
    assert heals >= 1 and len(handles) == heals + 1
    by = {n: [s for s in spans if s.name == n] for n in
          ("dispatch", "pack", "upload", "issue", "finish", "wait", "fetch", "heal", "assemble")}
    assert len(by["dispatch"]) == len(by["finish"]) == heals + 1
    assert len(by["heal"]) == heals
    assert len(by["assemble"]) == 1
    assert len(by["pack"]) == len(by["upload"]) == len(by["issue"]) == heals + 1
    ids = {s.id: s for s in spans}
    assert len({s.block for s in spans}) == 1 and spans[0].block >= 0
    assert len({s.who for s in spans}) == 1  # the test's thread
    top = [s for s in by["finish"] if s.parent == -1]
    assert len(top) == 1 and by["dispatch"][0].parent == -1
    for s in by["pack"] + by["upload"] + by["issue"]:
        assert ids[s.parent].name == "dispatch"
    for s in by["wait"] + by["fetch"] + by["heal"] + by["assemble"]:
        assert ids[s.parent].name == "finish"
    for s in by["dispatch"][1:] + [f for f in by["finish"] if f is not top[0]]:
        assert ids[s.parent].name == "heal"
    # the assembly runs at the last level only, inside every heal
    assert all(h.t0 <= by["assemble"][0].t0 <= h.t1 for h in by["heal"])


@pytest.mark.parametrize("k", [0, 2])
def test_engine_counters_equal_the_block_outputs(healing, k, monkeypatch):
    eng, blk = healing
    d0, h0, hits0 = eng.stats.device_s, eng.stats.host_s, eng.stats.hits
    spans, counted, handles = _one_block(eng, blk, k, monkeypatch)
    W = pack_block(blk)[0].shape[1]
    assert counted.pop("h2d_bytes") == len(handles) * 2 * 48 * W * 4
    assert counted.pop("d2h_bytes") > 0
    # the last level's assembly: the keys it sorted less the duplicates it removed
    keys, dupes = counted.pop("assemble_keys"), counted.pop("assemble_dupes", 0)
    assert keys - dupes == eng.stats.hits - hits0 > 0
    want = {}
    for h in handles:
        mode, level, outs = h[6], h[7], h[4]
        assert mode == "hits"  # the loop form's scalars: (n_over, comp_over, hit_over)
        for name, i in (("overflow_rows", 3), ("compact_drops", 4), ("hit_drops", 5)):
            v = int(sum(int(o[i]) for o in outs))
            if v:
                want[f"{name}.l{level}"] = v
    assert want and counted == want
    wall = {n: sum(s.wall for s in spans if s.name == n) for n in ("wait", "fetch", "assemble")}
    assert eng.stats.device_s - d0 == pytest.approx(wall["wait"] + wall["fetch"], abs=1e-9)
    assert eng.stats.host_s - h0 == pytest.approx(wall["assemble"], abs=1e-9)


def test_cli_summary_reads_the_recorders_totals(healing, capsys):
    eng, blk = healing
    eng.finish_block(eng.dispatch_block(blk, 2, pad_to=48))
    summary = _print_summary(eng, blk.n, time.time())
    capsys.readouterr()
    spans, counters = trace.totals()
    assert set(summary["spans"]) == set(spans) >= {"dispatch", "finish", "heal", "assemble"}
    assert all(len(v) == 3 for v in summary["spans"].values())
    assert summary["spans"]["finish"][0] == spans["finish"][0]
    assert summary["counters"] == counters and summary["counters"]["h2d_bytes"] > 0
    assert np.isfinite(summary["device_s"]) and np.isfinite(summary["host_s"])
