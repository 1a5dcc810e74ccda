"""bwtpu_torch.multihost on gloo ranks: SAM byte-equal to bwtpu.multihost.

bwtpu.multihost.main runs in this process on the 8-device CPU mesh, as
tests/test_multihost.py runs it, over the concatenated stream; the port
runs one rank per process (1, 2 and 4 ranks), each on its own stream,
and the ranks' SAM bodies, concatenated in rank order, must equal
bwtpu's. Each world size runs all its cases in one spawn; the ranks'
part of this file imports only torch and the port.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import pickle

import pytest
from test_torch_dist import init_gloo, jax_package_modules, run_ranks

COMMON = ["-k", "1", "--batch-size", "16", "--max-insert", "400"]
DISAGREE = ("hosts disagree on paired-ness: every host must pass --paired or none "
            "(the collective program differs)")


# ---------------------------------------------------------------------------
# The ranks' side: torch and the port only
# ---------------------------------------------------------------------------


def _rank_main(rank: int, world: int, tmp: str, cases: list) -> None:
    import torch
    import torch.distributed as dist

    from bwtpu_torch import cli as tcli
    from bwtpu_torch import multihost

    torch.set_num_threads(1)  # ranks share the box's cores
    init_gloo(rank, world, tmp)
    out = {}
    try:
        for name, argv in cases:
            argv = argv[rank] if isinstance(argv, dict) else argv
            stdout = io.StringIO()
            try:
                with contextlib.redirect_stdout(stdout):
                    if argv[0] == "scaling":
                        tcli.main(argv)
                        out[name] = stdout.getvalue()
                    else:
                        out[name] = multihost.main(argv + ["--device", "cpu"])
            except SystemExit as e:
                out[name] = f"SystemExit: {e}"
        out["modules"] = jax_package_modules()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


# ---------------------------------------------------------------------------
# The parent: indexes, streams and bwtpu's SAM
# ---------------------------------------------------------------------------


def _body(path) -> list[str]:
    with open(path) as f:
        return [line for line in f if not line.startswith("@")]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """test_multihost_2proc.py's 2-shard index (and 1- and 3-shard ones of
    the same genome), and the streams: whole, and split 2 and 4 ways."""
    from bwtpu.config import EngineConfig
    from bwtpu.index import build_sharded_index, save_index
    from bwtpu.io import Read, write_fastq
    from bwtpu.simulate import random_genome, simulate_pairs, simulate_reads

    tmp = tmp_path_factory.mktemp("mh")
    genome = random_genome(8000, seed=81)
    cfg = EngineConfig(sa_rate=8, max_hits=16, max_cand=16, read_len=40)
    idx = {}
    for S in (1, 2, 3):
        shards, manifest = build_sharded_index(genome, S, config=cfg, overlap=64)
        idx[S] = str(tmp / f"idx{S}")
        save_index(idx[S], shards, manifest)

    single, _ = simulate_reads(genome, 48, read_len=40, max_mismatches=1, seed=82)
    r40, _ = simulate_reads(genome, 32, read_len=40, max_mismatches=1, seed=84)
    r24, _ = simulate_reads(genome, 6, read_len=24, max_mismatches=1, seed=85)
    pairs, _ = simulate_pairs(genome, 24, read_len=40, insert_mean=200, insert_sd=10,
                              max_mismatches=1, seed=83)
    m1 = [p[0] for p in pairs]
    m2 = [p[1] for p in pairs]
    # every other mate 2 trimmed to 36 bp: keys (40, 40) and (40, 36)
    m2u = [Read(r.rid, r.seq[:36]) if i % 2 else r for i, r in enumerate(m2)]
    streams = {"single": [single[:24], single[24:]],
               "mixed": [r40[:16] + r24, r40[16:]],  # rank 1 has no 24 bp read
               "m1": [m1[:12], m1[12:]], "m2": [m2[:12], m2[12:]],
               "m2u": [m2u[:12], m2u[12:]]}

    def write(name, parts):
        """The whole stream, and its parts for 2 and 4 ranks (4: each
        half split again)."""
        write_fastq(str(tmp / f"{name}.fq"), [r for p in parts for r in p])
        for r, part in enumerate(parts):
            write_fastq(str(tmp / f"{name}_w2_{r}.fq"), part)
            h = (len(part) + 1) // 2
            write_fastq(str(tmp / f"{name}_w4_{2 * r}.fq"), part[:h])
            write_fastq(str(tmp / f"{name}_w4_{2 * r + 1}.fq"), part[h:])

    for name, parts in streams.items():
        write(name, parts)
    return tmp, idx


def _port_cases(tmp, idx, w: int) -> list:
    def fq(name):
        return str(tmp / f"{name}_w{w}_{{rank}}.fq")  # the port's rank placeholder

    def align(name, index, reads, paired=None):
        argv = ["--index", index, "--reads", fq(reads), "--out", str(tmp / f"{name}_w{w}.sam"),
                *COMMON]
        return (name, argv + (["--paired", fq(paired)] if paired else []))

    cases = [align("single", idx[2], "single"), align("paired", idx[2], "m1", "m2")]
    disagree = ["--index", idx[2], "--reads", fq("m1"), "--out", str(tmp / "disagree.sam"),
                *COMMON]
    if w == 2:
        cases += [align("mixed", idx[2], "mixed"),
                  align("paired_uneven", idx[2], "m1", "m2u"),
                  align("not_divisible", idx[3], "single"),
                  ("paired_disagree", {0: disagree + ["--paired", fq("m2")], 1: disagree}),
                  ("scaling", ["scaling", "--shards", "1", "--genome-bp", "20000",
                               "--n-reads", "256", "--device", "cpu"])]
    return cases


class _Runs:
    def __init__(self, tmp, idx):
        self.tmp, self.idx, self.port, self.ref = tmp, idx, {}, {}

    def port_run(self, w: int) -> list[dict]:
        if w not in self.port:
            cases = _port_cases(self.tmp, self.idx, w)
            rdv = self.tmp / f"ranks_w{w}"
            rdv.mkdir()
            run_ranks(_rank_main, w, (w, str(rdv), cases))
            per_rank = []
            for r in range(w):
                with open(rdv / f"rank{r}.pkl", "rb") as f:
                    per_rank.append(pickle.load(f))
            self.port[w] = per_rank
        return self.port[w]

    def bwtpu_sam(self, name, index, reads, paired=None) -> list[str]:
        """bwtpu.multihost's single-process SAM body of a whole stream."""
        from bwtpu import multihost

        if name not in self.ref:
            out = str(self.tmp / f"ref_{name}.sam")
            argv = ["--index", index, "--reads", str(self.tmp / f"{reads}.fq"),
                    "--out", out, *COMMON]
            if paired:
                argv += ["--paired", str(self.tmp / f"{paired}.fq")]
            multihost.main(argv)
            self.ref[name] = _body(out)
        return self.ref[name]

    def merged(self, name, w: int) -> list[str]:
        base = self.tmp / f"{name}_w{w}.sam"
        return [x for r in range(w) for x in _body(f"{base}.h{r}")]


@pytest.fixture(scope="module")
def runs(world):
    return _Runs(*world)


def test_world_of_one_on_one_shard(runs, tmp_path):
    """One rank in this process (no torchrun: an in-process group) on a
    1-shard index; a padded last batch (21 reads, batch 8)."""
    from bwtpu import multihost as ref
    from bwtpu.io import read_fastq, write_fastq
    from bwtpu_torch import multihost

    tmp, idx = runs.tmp, runs.idx
    write_fastq(str(tmp / "one.fq"), read_fastq(str(tmp / "single.fq"))[:21])
    argv = ["--index", idx[1], "--reads", str(tmp / "one.fq"), "-k", "1", "--batch-size", "8"]
    summary = multihost.main(argv + ["--out", str(tmp_path / "port.sam"), "--device", "cpu"])
    ref.main(argv + ["--out", str(tmp_path / "ref.sam")])
    got = (tmp_path / "port.sam").read_bytes()
    assert got == (tmp_path / "ref.sam").read_bytes()
    assert b"__filler__" not in got
    assert summary["reads"] == 21 and summary["rounds"] == 3 and summary["transport"] == "gloo"


@pytest.mark.parametrize("w", [2, 4])
def test_single_end_padded_last_batch(runs, w):
    port = runs.port_run(w)
    assert runs.merged("single", w) == runs.bwtpu_sam("single", runs.idx[2], "single")
    assert "__filler__" not in "".join(runs.merged("single", w))
    assert sum(r["single"]["reads"] for r in port) == 48


def test_mixed_lengths_stay_packed_with_filler_rounds(runs):
    port = runs.port_run(2)
    assert runs.merged("mixed", 2) == runs.bwtpu_sam("mixed", runs.idx[2], "mixed")
    s0, s1 = (r["mixed"] for r in port)
    # one round of 24 bp (rank 1 runs a filler round) + one of 40 bp
    assert s0["rounds"] == s1["rounds"] == 2
    assert s0["packed_rounds"] == s0["dispatches"] == s0["rounds"]
    assert (s0["reads"], s1["reads"]) == (22, 16)


@pytest.mark.parametrize("w", [2, 4])
def test_paired_equal_mates_one_ring_per_round(runs, w):
    port = runs.port_run(w)
    assert runs.merged("paired", w) == runs.bwtpu_sam("paired", runs.idx[2], "m1", "m2")
    assert all(r["paired"]["dispatches"] == r["paired"]["rounds"] for r in port)


def test_paired_unequal_mates(runs):
    port = runs.port_run(2)
    assert runs.merged("paired_uneven", 2) == runs.bwtpu_sam("paired_uneven", runs.idx[2],
                                                             "m1", "m2u")
    # keys (40, 36) and (40, 40): the uneven key runs one ring per mate
    assert all(r["paired_uneven"]["dispatches"] == 3 for r in port)


def test_world_not_divisible_by_the_shards_exits_as_bwtpu(runs):
    from bwtpu import multihost

    port = runs.port_run(2)
    with pytest.raises(SystemExit, match="^8 devices not divisible by 3 shards$"):
        multihost.main(["--index", runs.idx[3], "--reads", str(runs.tmp / "single.fq"),
                        "--out", str(runs.tmp / "ref_nd.sam")])
    assert [r["not_divisible"] for r in port] == [
        "SystemExit: 2 devices not divisible by 3 shards"] * 2


def test_ranks_that_disagree_on_paired_exit_with_bwtpus_message(runs):
    port = runs.port_run(2)
    assert [r["paired_disagree"] for r in port] == [f"SystemExit: {DISAGREE}"] * 2


def test_scaling_on_two_ranks_prints_a_scaling_line(runs):
    port = runs.port_run(2)
    line = json.loads(port[0]["scaling"].strip().splitlines()[-1])
    assert line["event"] == "scaling" and line["shards"] == 1
    assert [r["n_data"] for r in line["rows"]] == [1, 2]
    assert all(r["reads_per_s"] > 0 for r in line["rows"])
    assert port[1]["scaling"] == ""  # rank 0 prints


@pytest.mark.parametrize("w", [2, 4])
def test_ranks_load_no_module_of_the_jax_package(runs, w):
    assert all(r["modules"] == [] for r in runs.port_run(w))
