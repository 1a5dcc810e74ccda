"""bwtpu_torch.dist on gloo ranks against bwtpu.dist on the CPU mesh.

The same index and reads go through the port's DistEngine, one rank per
process (torch.distributed, gloo), and bwtpu's DistEngine on the
8-device CPU mesh that tests/conftest.py forces, as in
tests/test_dist_cpu_mesh.py. Rank r takes bwtpu's batch block r (the
P(('data', 'shard')) order), so both see the same rows per device and
the same caps. Per case: the concatenated hits, the ring mode (bwtpu's
handle tag), the heal count and the truncation marks.

Each layout (S, n_data) runs all its cases in one spawn of S * n_data
ranks; every case is its own test reading that run. The ranks' part of
this file imports only torch and the port (a spawned rank imports this
module): the parent imports bwtpu inside fixtures.
"""

from __future__ import annotations

import datetime
import os
import pickle
import sys
import time

import pytest
import torch.multiprocessing as mp

LAYOUTS = ((2, 1), (2, 2), (4, 1), (1, 2))
CFG = dict(sa_rate=8, max_hits=16, max_cand=16, read_len=50)
RANK_TIMEOUT_S = 120


# ---------------------------------------------------------------------------
# The ranks' side: torch and the port only
# ---------------------------------------------------------------------------


def run_ranks(fn, world: int, args: tuple, timeout: float = RANK_TIMEOUT_S) -> None:
    """Spawn `world` processes running fn(rank, *args); raise on a rank's
    failure, and kill every rank when they have not all ended in
    `timeout` seconds (a hung collective fails the test)."""
    ctx = mp.start_processes(fn, args=args, nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)


def init_gloo(rank: int, world: int, tmp: str) -> None:
    """A gloo group over a file rendezvous, with a short collective
    timeout so that a rank left waiting fails."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))


def jax_package_modules() -> list[str]:
    return sorted(m for m in sys.modules if m in ("bwtpu", "cli")
                  or m.startswith(("bwtpu.", "jax")))


def _rank_main(rank: int, world: int, tmp: str, cases: list) -> None:
    import torch
    import torch.distributed as dist

    from bwtpu_torch.dist import DistEngine, make_layout
    from bwtpu_torch.index import load_index
    from bwtpu_torch.io import Read

    torch.set_num_threads(1)  # ranks share the box's cores
    init_gloo(rank, world, tmp)
    out = {}
    try:
        for name, spec in cases:
            if spec["kind"] == "layout":
                os.environ.update(spec.get("env", {}))
                try:
                    make_layout(spec["n_shard"])
                    out[name] = None
                except ValueError as e:
                    out[name] = str(e)
                finally:
                    for key in spec.get("env", {}):
                        os.environ.pop(key)
                continue
            shards, manifest = load_index(spec["index"])
            eng = DistEngine(shards, manifest, device="cpu", debug_checks=spec["debug"])
            reads = [Read(rid, seq) for rid, seq in spec["reads"]]
            b = max(1, -(-len(reads) // world))  # bwtpu's rows per device
            mine = reads[rank * b:(rank + 1) * b]
            if spec["kind"] == "align_all":  # unequal streams, several batches
                tag, hits = None, eng.align_all(mine, k=spec["k"], batch_size=4)
            else:
                handle = eng.dispatch_batch(mine, k=spec["k"])
                tag, hits = handle[0], eng.finish_batch(handle)
            trunc = eng.last_truncated
            out[name] = dict(
                tag=tag, heals=eng.heals,
                hits=[[(h.nm, h.strand, h.pos) for h in hs] for hs in hits],
                trunc=[False] * len(mine) if trunc is None else [bool(t) for t in trunc])
        out["modules"] = jax_package_modules()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


# ---------------------------------------------------------------------------
# The parent: indexes, reads and bwtpu's answers
# ---------------------------------------------------------------------------


def _cases(world_data) -> dict:
    """{layout: [(name, spec)]}: the same genome, config and reads as
    tests/test_dist_cpu_mesh.py, plus the port's own edge cases."""
    import numpy as np

    from bwtpu.io import Read
    from bwtpu.simulate import simulate_reads

    genome, idx = world_data["genome"], world_data["index"]
    reads, _ = simulate_reads(genome, 24, read_len=40, max_mismatches=2, seed=72)
    rng = np.random.default_rng(76)
    ragged = []
    for i, ln in enumerate(rng.integers(25, 50, 16)):
        s = int(rng.integers(0, len(genome) - int(ln)))
        ragged.append(Read(f"v{i}", genome[s:s + int(ln)]))
    rep, _ = simulate_reads(world_data["rep_genome"], 16, read_len=40, max_mismatches=2,
                            seed=78)
    # reads inside the repeated segment: 3 loci in shard 0, over max_hits
    # = max_cand = 2, all in rank 0's block
    s0 = world_data["rep_at"][0]
    rep = [Read(f"rep{i}", world_data["rep_genome"][s0 + i:s0 + i + 40]) for i in range(6)] + rep

    def align(index, k, rs, debug=False, kind="align"):
        return dict(kind=kind, index=index, k=k, debug=debug,
                    reads=[(r.rid, r.seq) for r in rs])

    def boundary(S):
        return [Read(f"b{s}", genome[s - 20:s + 20]) for s in world_data["starts"][S][1:]]

    out = {}
    for S, nd in LAYOUTS:
        out[(S, nd)] = [(f"k{k}", align(idx[S], k, reads)) for k in (0, 2)]
    out[(2, 1)] += [("packed_k2", align(world_data["no_lattice"][2], 2, reads)),
                    ("one_read_k2", align(idx[2], 2, reads[:1]))]
    out[(2, 2)] += [("ragged_k0", align(idx[2], 0, ragged)),
                    ("ragged_k2", align(idx[2], 2, ragged)),
                    ("debug_k0", align(idx[2], 0, reads[:8], debug=True)),
                    ("boundary_k0", align(idx[2], 0, boundary(2))),
                    # 22 reads: 6, 6, 6 and 4 a rank, batches of 4
                    ("align_all_k2", align(idx[2], 2, reads[:22], kind="align_all"))]
    out[(2, 2)] += [(f"overflow_h{h}_k{k}", align(world_data["small"][h], k, rep))
                    for h in (0, 1) for k in (0, 2)]
    out[(4, 1)] += [("boundary_k0", align(idx[4], 0, boundary(4))),
                    ("layout_world", dict(kind="layout", n_shard=3)),
                    ("layout_node", dict(kind="layout", n_shard=4,
                                         env={"LOCAL_WORLD_SIZE": "2"}))]
    out[(1, 2)] += [(f"packed_k{k}", align(world_data["no_lattice"][1], k, reads))
                    for k in (0, 2)]
    return out


CASE_NAMES = {
    (2, 1): ["k0", "k2", "packed_k2", "one_read_k2"],
    (2, 2): ["k0", "k2", "ragged_k0", "ragged_k2", "debug_k0", "boundary_k0", "align_all_k2",
             "overflow_h0_k0", "overflow_h0_k2", "overflow_h1_k0", "overflow_h1_k2"],
    (4, 1): ["k0", "k2", "boundary_k0"],
    (1, 2): ["k0", "k2", "packed_k0", "packed_k2"],
}
ALIGN_CASES = [pytest.param(lay, name, id=f"{lay[0]}x{lay[1]}-{name}")
               for lay, names in CASE_NAMES.items() for name in names]


@pytest.fixture(scope="module")
def world_data(tmp_path_factory):
    from bwtpu.config import EngineConfig
    from bwtpu.index import build_sharded_index, save_index
    from bwtpu.simulate import random_genome

    tmp = tmp_path_factory.mktemp("dist_idx")
    genome = random_genome(8000, seed=71)
    seg = genome[1000:1080]
    rep_at = (1000, 2000, 3000, 5500)  # 3 copies in shard 0 of 2
    rep_genome = genome
    for p in rep_at[1:]:
        rep_genome = rep_genome[:p] + seg + rep_genome[p + len(seg):]
    cfg = EngineConfig(**CFG)

    def save(name, g, S, config):
        shards, manifest = build_sharded_index(g, S, config=config, overlap=64)
        path = str(tmp / name)
        save_index(path, shards, manifest)
        return path, manifest.starts

    data = dict(genome=genome, rep_genome=rep_genome, rep_at=rep_at, index={}, starts={},
                no_lattice={}, small={})
    for S in (1, 2, 4):
        data["index"][S], data["starts"][S] = save(f"s{S}", genome, S, cfg)
    for S in (1, 2):
        data["no_lattice"][S] = save(f"flat{S}", genome, S, cfg.replace(occ_step=0))[0]
    for h in (0, 1):
        small = cfg.replace(max_hits=2, max_cand=2, max_heals=h)
        data["small"][h] = save(f"small{h}", rep_genome, 2, small)[0]
    data["cases"] = _cases(data)
    return data


class _Runs:
    """Each layout's spawn (port) and bwtpu's answers, made once."""

    def __init__(self, data, tmp_path_factory):
        self.data, self.tmp_factory = data, tmp_path_factory
        self.port, self.ref = {}, {}

    def get(self, layout):
        if layout not in self.port:
            S, nd = layout
            tmp = str(self.tmp_factory.mktemp(f"ranks_{S}x{nd}"))
            cases = self.data["cases"][layout]
            run_ranks(_rank_main, S * nd, (S * nd, tmp, cases))
            per_rank = []
            for r in range(S * nd):
                with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                    per_rank.append(pickle.load(f))
            self.port[layout] = per_rank
            self.ref[layout] = {name: _bwtpu_case(spec, nd) for name, spec in cases
                                if spec["kind"] != "layout"}
        return self.port[layout], self.ref[layout]


def _bwtpu_case(spec, n_data) -> dict:
    from bwtpu.dist import DistEngine
    from bwtpu.index import load_index
    from bwtpu.io import Read

    shards, manifest = load_index(spec["index"])
    eng = DistEngine(shards, manifest, n_data=n_data, debug_checks=spec["debug"])
    reads = [Read(rid, seq) for rid, seq in spec["reads"]]
    handle = eng.dispatch_batch(reads, k=spec["k"])
    hits = eng.finish_batch(handle)
    trunc = eng.last_truncated
    return dict(tag=handle[0] if spec["kind"] == "align" else None, heals=eng.heals,
                hits=[[(h.nm, h.strand, h.pos) for h in hs] for hs in hits],
                trunc=[False] * len(reads) if trunc is None else [bool(t) for t in trunc])


@pytest.fixture(scope="module")
def runs(world_data, tmp_path_factory):
    return _Runs(world_data, tmp_path_factory)


def _merged(per_rank, name, key):
    return [x for r in per_rank for x in r[name][key]]


@pytest.mark.parametrize("layout,name", ALIGN_CASES)
def test_hits_equal_bwtpu(runs, layout, name):
    port, ref = runs.get(layout)
    assert _merged(port, name, "hits") == ref[name]["hits"]
    assert sum(map(len, ref[name]["hits"])) > 0


@pytest.mark.parametrize("layout,name", ALIGN_CASES)
def test_ring_mode_equals_bwtpu(runs, layout, name):
    port, ref = runs.get(layout)
    assert {r[name]["tag"] for r in port} == {ref[name]["tag"]}


@pytest.mark.parametrize("layout,name", ALIGN_CASES)
def test_heals_and_truncation_equal_bwtpu(runs, layout, name):
    port, ref = runs.get(layout)
    assert {r[name]["heals"] for r in port} == {ref[name]["heals"]}
    assert _merged(port, name, "trunc") == ref[name]["trunc"]


def test_the_overflow_cases_overflow(runs):
    """The forced-overflow cases heal (max_heals 1) and mark reads
    truncated (3 loci against caps of 2, then 4 after one heal at k = 0;
    at k = 2 the seed slots' candidates stay over 4)."""
    _, ref = runs.get((2, 2))
    for k in (0, 2):
        assert ref[f"overflow_h0_k{k}"]["heals"] == 0
        assert any(ref[f"overflow_h0_k{k}"]["trunc"])
        assert ref[f"overflow_h1_k{k}"]["heals"] == 1


@pytest.mark.parametrize("name,want", [("layout_world", "4 ranks not divisible by 3 shards"),
                                       ("layout_node", "LOCAL_WORLD_SIZE")])
def test_layout_check(runs, name, want):
    port, _ = runs.get((4, 1))
    assert all(want in r[name] for r in port), [r[name] for r in port]


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda lay: f"{lay[0]}x{lay[1]}")
def test_ranks_load_no_module_of_the_jax_package(runs, layout):
    port, _ = runs.get(layout)
    assert all(r["modules"] == [] for r in port)
