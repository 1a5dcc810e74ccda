"""The check's reference for an index of several interval shards
(sharded.py): a read is heavy by the capacity of each shard
(reference/shards.py), on a cell run through run.py's Session and on reads
planted on purpose; an index of one shard, as every cell in BENCHMARK.json
has, is judged exactly as run.py judges it."""

import json
import logging
import os
import shutil
import types
from time import perf_counter

import numpy as np
import pytest

from benchmark import check as chk
from benchmark.cells import Bench
from benchmark.run import Session
from benchmark.sharded import Judge, sharded
from benchmark.tests.test_bm_harness import DATA, REPO, make_root


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """make_root's checkout with tiny.s2.align: the tiny align traffic on
    tiny-s2 (2 shards, overlap 256), added by data files alone."""
    logging.disable(logging.WARNING)
    root = str(tmp_path_factory.mktemp("root"))
    make_root(root, cells=(("tiny.align", "tiny.align"),))
    b = os.path.join(root, "benchmark")
    shutil.copy(os.path.join(DATA, "tiny-s2.json"), os.path.join(b, "configs"))
    shutil.copy(os.path.join(b, "limits", "tiny.align.json"),
                os.path.join(b, "limits", "tiny.s2.align.json"))
    spec = json.load(open(os.path.join(root, "BENCHMARK.json")))
    spec["configs"].append({"name": "tiny-s2", "source": "tests", "reduced": [],
                            "why": "tests", "file": "benchmark/configs/tiny-s2.json"})
    spec["workloads"].append({"name": "tiny.s2.align", "config": "tiny-s2",
                              "traffic": "tiny.align", "chips": 1, "why": "tests"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "tiny.align" in m.get("workloads", []):
            m["workloads"].append("tiny.s2.align")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    yield Bench(root)
    logging.disable(logging.NOTSET)


def _judge(sess) -> Judge:
    m = sess.manifest
    return Judge(sess.cell.config, sess.genome, len(m.starts), m.overlap)


def test_a_two_shard_index_through_session_is_correct(bench):
    """tiny-s2's dense family has more seed occurrences than the capacity
    in the whole genome and fewer in each shard: the program completes
    those reads, the shard rule finds them correct, and Session.judge, by
    the whole genome's capacity, counts them wrong."""
    sess = Session(bench, "tiny.s2.align", "cpu")
    judge = _judge(sess)
    assert (judge.shards, judge.overlap, judge.sharded) == (2, 256, True)
    w, checker, pool, sample = sess.window(2**31 + 5, 2.0, False, perf_counter())
    numbers = checker.judge(judge.reference(pool, sample, int(sess.cell.traffic["k"])))
    correct, compared = chk.verdict(numbers, bench.limits("tiny.s2.align"))
    assert correct, compared
    assert numbers["wrong_reads"] == 0 and numbers["checked_reads"] > 0
    assert sess.judge(checker, pool, sample)["wrong_reads"] > 0


def test_an_index_of_one_shard_is_judged_as_run_py_judges_it(bench):
    sess = Session(bench, "tiny.align", "cpu")
    judge = _judge(sess)
    assert (judge.shards, judge.sharded) == (1, False)
    w, checker, pool, sample = sess.window(2**31 + 6, 1.0, False, perf_counter())
    numbers = checker.judge(judge.reference(pool, sample, int(sess.cell.traffic["k"])))
    assert judge.parts is None and numbers["checked_reads"] > 0
    assert numbers == sess.judge(checker, pool, sample)


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  json.load(open(os.path.join(REPO, "BENCHMARK.json")))
                                  ["workloads"]])
def test_every_cell_of_the_benchmark_takes_the_one_shard_path(cell):
    """The cells' configurations build one shard (shards 0: the CLI's auto
    rule, one shard under 256 Mbp), so their check numbers stay as they are."""
    c = Bench(REPO).cell(cell)
    assert c.chips == 1 and c.config["length"] < 256_000_000
    assert sharded(c.config, 1, 256) is False


def _planted():
    """A 40-base read at 3 places in each half of a 4,000-base genome,
    and a read that occurs once; one pool block of the two."""
    rng = np.random.default_rng(3)
    genome = rng.integers(0, 4, 4000, dtype=np.uint8)
    read = rng.integers(0, 4, 40, dtype=np.uint8)
    places = (100, 600, 1100, 2100, 2600, 3100)
    for p in places:
        genome[p:p + 40] = read
    codes = np.stack([read, genome[1500:1540]])
    seq = np.frombuffer(b"ACGT", np.uint8)[codes]
    pool = types.SimpleNamespace(block_reads=2, seq=seq, qual=np.full_like(seq, ord("I")))
    return genome, pool, np.array([[0, 1]]), places


def _program(places, truncated):
    """The program's FlatHits for the block: read 0 at every place, read 1
    at 1500, all + strand at nm 0."""
    pos = np.array([*places, 1500])
    return types.SimpleNamespace(read_idx=np.array([0] * len(places) + [1]), pos=pos,
                                 strand_rev=np.zeros(len(pos), bool),
                                 nm=np.zeros(len(pos), np.int32),
                                 truncated=np.array(truncated))


@pytest.mark.parametrize("cap, shards, wrong", [
    (4, 2, 0),  # heavy in the whole genome, in no shard: complete and correct
    (2, 2, 1),  # heavy in each shard, left unmarked: wrong
    (4, 1, 1),  # one shard: heavy in the whole genome, so unmarked is wrong
])
def test_a_read_is_judged_by_each_shards_capacity(cap, shards, wrong):
    genome, pool, sample, places = _planted()
    cfg = {"build_index": {"shards": shards if shards > 1 else 0, "overlap": 0,
                           "max_hits": cap, "max_cand": cap},
           "guarantees": {"max_heals": 0}}
    ref = Judge(cfg, genome, shards, 0).reference(pool, sample, 0)
    checker = chk.AlignCheck(sample)
    checker.on_done(0, _program(places, [False, False]))
    assert checker.judge(ref)["wrong_reads"] == wrong
    assert ref.ans.heavy.tolist() == [bool(wrong), False]
    if not wrong:  # the reference's hits are the planted ones
        assert ref.ans.pos.tolist() == [*places, 1500] and not ref.ans.rev.any()


@pytest.mark.parametrize("stated, built, expect", [
    ({"shards": 0}, (1, 256), False),
    ({"shards": 1}, (1, 0), False),
    ({"shards": 2, "overlap": 256}, (2, 256), True),
    ({"shards": 0}, (2, 256), None),  # several shards need both keys stated
    ({"shards": 2}, (2, 256), None),
    ({"shards": 2, "overlap": 128}, (2, 256), None),
    ({"shards": 4, "overlap": 256}, (2, 256), None),
    ({"shards": 2, "overlap": 256}, (1, 256), None),
])
def test_sharded_follows_the_configuration_and_the_index(stated, built, expect):
    cfg = {"build_index": stated}
    if expect is None:
        with pytest.raises(RuntimeError, match="the configuration states"):
            Judge(cfg, np.zeros(8, np.uint8), *built)
    else:
        assert sharded(cfg, *built) is expect
