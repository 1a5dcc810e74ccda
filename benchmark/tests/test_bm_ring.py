"""The ring harness (ring.py) on the CPU: gloo ranks, each a process with
the program's plain versions, on the tiny genome in 2 and 4 interval
shards, as cells that only data files add. A run's line has the one-card
line's keys; the controls and the planted faults come out as they must;
ranks whose blocks take different times dispatch the same blocks; a lost
rank ends the run with no result; readers find each rank's own readings;
the one-card readers read the joint window; the cells that were there are
as they were."""

import argparse
import json
import os
import shutil
import time
import types

import numpy as np
import pytest

from benchmark import ring
from benchmark.cells import Bench
from benchmark.drive import Spans
from benchmark.reference import align as ref_align
from benchmark.reference import shards as ref_shards
from benchmark.tests.test_bm_harness import LIMITS, make_root

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
REPO = os.path.dirname(os.path.dirname(HERE))
# readers of each rank's own readings, as a cell's metric files would be
RANK_READERS = {
    "ranks_with_load_index": "def read(w):\n"
    "    return sum(any(r.name == 'load_index' for r in s) for s in w.rank_spans if s)\n",
    "ranks_counted": "def read(w):\n"
    "    return sum(isinstance(c, dict) for c in w.rank_counters)\n",
}


def ring_root(root):
    """make_root's checkout with two ring cells added by data files alone:
    tiny.ring2 (2 shards, 2 ranks) and tiny.ring4 (4 and 4), on the align
    cells' rate and tail; tiny.ring2 also reports the RANK_READERS."""
    make_root(root, cells=())
    b = os.path.join(root, "benchmark")
    shutil.copy(os.path.join(DATA, "tiny.ring.json"), os.path.join(b, "workloads"))
    spec = json.load(open(os.path.join(root, "BENCHMARK.json")))
    for name, body in RANK_READERS.items():
        with open(os.path.join(b, "metrics", name + ".py"), "w") as f:
            f.write(body)
        spec["end_to_end"].append({"name": name, "unit": "ranks", "better": "higher",
                                   "bound": 0.01, "source": "host_clock",
                                   "workloads": ["tiny.ring2"]})
    for n in (2, 4):
        shutil.copy(os.path.join(DATA, f"tiny-s{n}.json"), os.path.join(b, "configs"))
        spec["configs"].append({"name": f"tiny-s{n}", "source": "tests", "reduced": [],
                                "why": "tests", "file": f"benchmark/configs/tiny-s{n}.json"})
        spec["workloads"].append({"name": f"tiny.ring{n}", "config": f"tiny-s{n}",
                                  "traffic": "tiny.ring", "chips": n, "why": "tests"})
        for m in spec["end_to_end"]:
            if m["name"] in ("align_reads_per_s", "block_ms_p95"):
                m["workloads"].append(f"tiny.ring{n}")
        with open(os.path.join(b, "limits", f"tiny.ring{n}.json"), "w") as f:
            json.dump({"limits": LIMITS}, f)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return Bench(root)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return ring_root(str(tmp_path_factory.mktemp("root")))


def test_four_ranks_print_the_one_card_lines_keys(bench, capsys):
    args = argparse.Namespace(workload="tiny.ring4", seed=2**31 + 21, seconds=6.0, trace=0)
    assert ring.main(bench, args, time.perf_counter(), device="cpu") == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "check"]
    assert res["correct"] is True, res
    assert res["check"]["wrong_reads"] == {"value": 0, "max": 0}
    assert res["device"] == {"platform": "cpu", "kind": "cpu", "count": 4,
                             "memory_peak_bytes": 0}
    assert set(res["metrics"]) == {"align_reads_per_s", "block_ms_p95", "setup_s"}
    assert res["metrics"]["align_reads_per_s"]["value"] > 0
    assert res["attempted"] % (4 * 512) == 0


def test_controls_and_faults_on_two_ranks(bench):
    """Sound runs are correct; noheal marks more reads; each planted fault
    (the block before's results, half the reads left out, the exchange
    between the cards left out, answers altered) is not correct."""
    recs = ring.launch(bench, "tiny.ring2", [77],
                       ["sound", "noheal", "stale", "half", "exchange", "altered"], 1.0,
                       False, t_start=time.perf_counter(), device="cpu", record="control")
    by = {r["variant"]: r for r in recs}
    assert by["sound"]["correct"] and by["sound"]["wrong_reads"] == 0, by["sound"]
    assert by["noheal"]["extra_marked_permille"] > by["sound"]["extra_marked_permille"]
    for fault in ("stale", "half", "exchange", "altered"):
        assert by[fault]["correct"] is False and by[fault]["wrong_reads"] > 0, by[fault]


def test_a_slow_rank_dispatches_as_many_blocks(bench):
    """Also: the window keeps each rank's program spans and counters."""
    (rec,) = ring.launch(bench, "tiny.ring2", [5], ["slow"], 3.0, False,
                         t_start=time.perf_counter(), device="cpu")
    per = rec["info"]["dispatched_per_rank"]
    assert len(per) == 2 and per[0] == per[1] > 0, rec["info"]
    got = {m: rec["result"]["metrics"][m]["value"] for m in RANK_READERS}
    assert got == {"ranks_with_load_index": 2, "ranks_counted": 2}, got


def test_a_lost_rank_gives_no_result(bench, capsys):
    t0 = time.monotonic()
    recs = ring.launch(bench, "tiny.ring2", [6], ["lost"], 30.0, False,
                       t_start=time.perf_counter(), device="cpu", deadline_s=120)
    assert recs is None and time.monotonic() - t0 < 120
    assert "no result: rank 1 exited with 17" in capsys.readouterr().err


def test_the_cells_before_the_ring_are_as_they_were():
    """Configuration, traffic, chips and end-to-end metrics (bounds
    included) as they were, a metric's list of cells as it was or longer;
    the per-layer metrics as they were, or more."""
    before = json.load(open(os.path.join(DATA, "cells_before_ring.json")))
    bench = Bench(REPO)
    bare = lambda ms: [{k: v for k, v in m.items() if k != "workloads"} for m in ms]  # noqa: E731
    for name, old in before.items():
        c = bench.cell(name)
        assert (c.config, c.traffic, c.chips, bare(c.end_to_end)) == (
            old["config"], old["traffic"], old["chips"], bare(old["end_to_end"])), name
        for m, o in zip(c.end_to_end, old["end_to_end"]):
            assert set(o.get("workloads", [])) <= set(m.get("workloads", [])), name
        assert set(old["per_layer"]) <= {m["name"] for m in c.per_layer}, name


def _window(ranks, trace):
    done = [(0, 0.0, 0.5, 512, 3), (1, 0.1, 0.7, 512, 3), (2, 0.2, 0.9, 512, 2),
            (3, 0.3, 2.5, 512, 3)]
    spans = Spans()
    spans.items = [("dispatch_block", "main", 0.0, 0.01), ("dispatch_block", "main", 0.1, 0.13),
                   ("finish_block", "main", 0.3, 0.5), ("finish_block", "main", 0.5, 0.9)]
    w = ring.RingWindow("align", 0.0, 2.0, done, 4 * 512, spans, ranks=ranks)
    w.trace = trace
    return w


def test_one_card_readers_read_the_joint_window():
    """The harness's spans, heals and the cards' mean trace, as a ring
    cell listed on these metrics would report them."""
    bench = Bench(REPO)
    trace = {"busy_s": 0.5, "window_s": 2.0, "kernel_s": 0.25, "nccl_s": 0.03}
    w = _window(2, trace)
    got = {m: bench.reader(m)(w) for m in ("dispatch_ms_per_block.align",
                                           "finish_ms_per_block.align", "heals_per_block",
                                           "idle_share.align", "align_reads_per_s")}
    assert got == pytest.approx({"dispatch_ms_per_block.align": 20.0,
                                 "finish_ms_per_block.align": 300.0,
                                 "heals_per_block": 8 / 3, "idle_share.align": 75.0,
                                 "align_reads_per_s": 3 * 512 / 2.0})


def test_shard_intervals_follow_the_build_rule():
    from bwtpu_torch.index import plan_shards

    for n, s, v in ((400_000, 2, 256), (46_709_983, 4, 256), (1001, 3, 7)):
        m = plan_shards(n, s, v)
        assert ref_shards.intervals(n, s, v) == [(a, a + b) for a, b in zip(m.starts,
                                                                           m.lengths)]


def test_a_read_is_heavy_by_its_occurrences_in_one_shard():
    """A 40-base read occurring 3 times in each half: heavy at capacity 4
    over the whole genome, not in shards of one half each."""
    rng = np.random.default_rng(3)
    genome = rng.integers(0, 4, 4000, dtype=np.uint8)
    read = rng.integers(0, 4, 40, dtype=np.uint8)
    for p in (100, 600, 1100, 2100, 2600, 3100):
        genome[p:p + 40] = read
    codes, amb = read[None], np.zeros((1, 40), bool)
    assert ref_align.align(ref_align.Genome(genome), codes, amb, 0, 4).heavy[0]
    parts = ref_shards.shard_genomes(genome, 2, 0)
    assert not ref_shards.heavy(parts, codes, amb, 0, 4)[0]
    assert ref_shards.heavy(parts, codes, amb, 0, 2)[0]


class _Pool:
    block_reads, n = 4, 8

    def fastq(self, lo, hi):
        return b"".join(b"@r%d\nACGTACGT\n+\nIIIIIIII\n" % i for i in range(lo, hi))


def test_feed_takes_read_lists_and_samples_their_hits():
    from bwtpu_torch.golden import Hit

    eng = types.SimpleNamespace(heals=2, last_truncated=np.array([0, 1, 0, 0], bool))
    eng.dispatch_batch = lambda reads, k, packed: (len(reads), k, packed, reads[0].rid)
    eng.finish_batch = lambda h: [[Hit(0, "+", 5), Hit(1, "-", 9)], [], [Hit(2, "+", 1)], []]
    feed = ring.Feed(eng, _Pool(), 2)
    assert feed.n_blocks == 2 and feed.heals() == 2
    assert feed.dispatch(1) == (4, 2, True, "r4")
    flat = feed.sampled(feed.finish(None), np.array([0, 1, 2]))
    assert flat.read_idx.tolist() == [0, 0, 2] and flat.pos.tolist() == [5, 9, 1]
    assert flat.strand_rev.tolist() == [False, True, False] and flat.nm.tolist() == [0, 1, 2]
    assert flat.truncated.tolist() == [False, True, False, False]
