"""bwtpu_torch.bench (the port of bench.py) against the JAX package: the
JSON line's keys, the roofline's row model and calibration stream, the e2e
sections' SAM bytes against `cli.py align`, and the multihost probe, all on
the CPU at a small size. Exact equality: everything compared is integer.
The key set is bench.py's final json.dumps dict, read from its source
(chip_smoke.bench_py_keys, which the card's smoke run checks it with too)."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import bench  # noqa: E402
import chip_smoke  # noqa: E402
import cli  # noqa: E402
from bwtpu import config as jconfig  # noqa: E402
from bwtpu import engine as jengine  # noqa: E402
from bwtpu import index as jindex  # noqa: E402
from bwtpu_torch import bench as tbench  # noqa: E402
from bwtpu_torch import engine as tengine  # noqa: E402
from bwtpu_torch.config import EngineConfig  # noqa: E402
from bwtpu_torch.index import build_fm_index, build_sharded_index, save_index  # noqa: E402
from bwtpu_torch.simulate import adversarial_genome, random_genome, simulate_reads  # noqa: E402

torch.set_num_threads(1)


def test_bench_smoke_cpu_has_bench_py_keys():
    proc = subprocess.run(
        [sys.executable, "-m", "bwtpu_torch.cli", "bench", "--smoke", "--cpu", "--batch", "256"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    top, extras = chip_smoke.bench_py_keys(ROOT)  # read with ast, not run
    assert set(out) == top and set(out["extras"]) == extras
    ex = out["extras"]
    assert out["value"] > 0 and ex["k2_reads_per_s"] > 0 and ex["k2_tiered_reads_per_s"] > 0
    assert ex["platform"] == "cpu" and ex["backend"] == "plain"
    assert ex["exact_overflow"] == ex["k2_overflow"] == ex["k2_tiered_overflow"] == 0
    assert ex["sol_fraction"] > 0 and ex["ns_per_row_measured"] > 0
    assert ex["hbm_gbps_assumed"] is None  # no CPU figure stands in a card's
    # uniform {0,1,2}-mismatch reads: most have no exact hit and escalate
    assert 0.5 < ex["k2_escalated_frac"] < 0.9
    sections = [ln.split()[2] for ln in proc.stderr.splitlines() if ln.startswith("# section ")]
    assert sections == ["setup", "exact", "k2", "tiered", "lowerr", "e2e_setup", "e2e_exact",
                        "e2e_k2", "e2e_paired", "e2e_k2_lowerr", "e2e_tiered_lowerr",
                        "roofline", "golden"]


def test_bench_without_a_card_fails():
    """No --cpu and no card: a non-zero exit and no JSON line; the CPU is
    never taken in the card's place. An unknown option fails in argparse."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "bwtpu_torch.cli", "bench", "--smoke"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and not proc.stdout.strip()
    assert "no CUDA device" in proc.stderr
    with pytest.raises(SystemExit) as e:
        tbench.main(["--smoke", "--no-such-option"])
    assert e.value.code == 2


def test_gather_model_equal():
    for B2 in (512, 8192, 1 << 20):
        for d, trips, n_unf, nS in ((11, 0, 0, 1), (7, 3, 5, 1), (6, 2, 0, 3), (10, 4, 9, 3)):
            for sa_rate, locv in ((1, True), (1, False), (4, False), (32, False)):
                for lf in (0.45, 1.5, 2):
                    a = (B2, 100, d, 3, trips, n_unf, 8, nS, lf, sa_rate)
                    assert tbench.gather_model(*a, locv=locv) == bench.gather_model(*a, locv=locv)


@pytest.mark.parametrize("seed", [0, 7])
def test_calibration_gather_sum_equal_to_bench_py(seed):
    """The calibration's index stream and wrapped column sum, against
    bench.py's probe written in jnp: (i * (2654435761 + 2 seed)) mod 2^32
    mod N, jnp.take, sum over axis 0 in uint32."""
    rng = np.random.default_rng(seed)
    tbl = rng.integers(0, 2**32, size=(4096, 16), dtype=np.uint64).astype(np.uint32)
    n_rows = 8192
    idx = (jnp.arange(n_rows, dtype=jnp.uint32) * (jnp.uint32(2654435761)
                                                   + jnp.uint32(2) * jnp.uint32(seed))
           ) % jnp.uint32(tbl.shape[0])
    want = np.asarray(jnp.take(jnp.asarray(tbl), idx.astype(jnp.int32), axis=0).sum(axis=0))
    got_idx = tbench.gather_index_stream(n_rows, seed, tbl.shape[0], "cpu")
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(idx).astype(np.int32))
    got = tbench.gather_sum(torch.from_numpy(tbl.view(np.int32)), got_idx)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert tbench.calibrate_ns_per_row(torch.from_numpy(tbl.view(np.int32)), n_rows, 2) > 0


def test_pack_reads_for_bench_and_hbm_table():
    g = random_genome(3000, seed=3)
    reads, _ = simulate_reads(g, 50, read_len=70, max_mismatches=2, n_frac=0.02, seed=4)
    for a, b in zip(tengine.pack_reads_for_bench(reads), jengine.pack_reads_for_bench(reads)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert tbench.hbm_bandwidth("NVIDIA H100 80GB HBM3") == 3.35e12
    assert tbench.hbm_bandwidth("NVIDIA H100 PCIe") == 2.0e12
    assert tbench.hbm_bandwidth("NVIDIA H100 NVL") == 3.9e12
    assert tbench.hbm_bandwidth("NVIDIA A100-SXM4-80GB") is None
    assert tbench.hbm_bandwidth(None) is None


@pytest.fixture(scope="module")
def e2e_world(tmp_path_factory):
    """bench.py's configuration on a 20 kbp genome: its index saved as an
    artifact, and its e2e FASTQs at chunks of 256 reads (2 chunks; pairs:
    one chunk of 128)."""
    tmp = tmp_path_factory.mktemp("e2e")
    genome = random_genome(20000, seed=1)
    cfg = EngineConfig(sa_rate=1, max_hits=4, max_cand=8, read_len=100)
    shards, manifest = build_sharded_index(genome, 1, config=cfg)
    save_index(str(tmp / "idx"), shards, manifest)
    idx = shards[0]
    fqs = tbench.write_e2e_inputs(genome, str(tmp), 256, 2, 1, 100)
    return tmp, idx, cfg, fqs


@pytest.mark.parametrize("case", ["exact", "k2", "tiered_lowerr", "paired"])
def test_e2e_sam_byte_equal_to_cli_py(e2e_world, case):
    tmp, idx, cfg, (fq, fq_le, fq1, fq2) = e2e_world
    got, want = tmp / f"{case}.port.sam", tmp / f"{case}.bwtpu.sam"
    if case == "paired":
        res = tbench.e2e_paired(idx, cfg, fq1, fq2, str(got), 2, 4, 256, "cpu")
        argv = [fq1, "-k", "2", "--paired", fq2, "--batch-size", "128"]
    else:
        k, fastq, tiered = {"exact": (0, fq, False), "k2": (2, fq, False),
                            "tiered_lowerr": (2, fq_le, True)}[case]
        res = tbench.e2e_single(idx, cfg, fastq, str(got), k, 2 if k == 0 else 4, 256, "cpu",
                                tiered=tiered)
        argv = [fastq, "-k", str(k), "--batch-size", "256"] + (["--tiered"] if tiered else [])
    cli.main(["align", str(tmp / "idx"), *argv, "-o", str(want)])
    assert got.read_bytes() == want.read_bytes()
    assert got.read_bytes().count(b"\tNM:i:") > 100
    assert res[2] == (256 if case == "paired" else 512)
    assert res[4] == 0 and res[0] > 0  # no overflowed read


def test_multihost_probe_two_hosts_cpu():
    rps, reads, wall, launches = tbench.multihost_probe(n_reads_per_host=96, batch=32,
                                                        n_procs=2, device="cpu")
    assert reads == 2 * 96 and wall > 0 and rps == pytest.approx(reads / wall)
    assert len(launches) == 2 * tbench.PROBE_SHARDS


@pytest.mark.parametrize("kind", ["exact", "k2", "tiered"])
def test_overflow_slots_equal_to_bench_py(kind):
    """The output slots the bench's overflow counts read, on batches that
    overflow (a tandem-array genome: intervals wider than max_hits; loc
    factor 0.01: the 4,096-candidate floor; tiered esc_factor 0.1): the
    port's count of the port's outputs equals bench.py's expression on
    bwtpu's outputs, and tiered's escalated count o[9] is bwtpu's."""
    g = adversarial_genome(30000, "tandem", seed=5)
    cfg = dict(sa_rate=1, max_hits=4, max_cand=8, read_len=60)
    jidx = jindex.build_fm_index(g, jconfig.EngineConfig(**cfg))
    jshard = jax.tree.map(lambda x: x[0], jengine.upload_index([jidx]).shard)
    tshard = tengine.upload_index([build_fm_index(g, EngineConfig(**cfg))], "cpu")[0]
    reads, _ = simulate_reads(g, 2500, read_len=60, max_mismatches=2, seed=6)
    rw, ab = tengine.pack_reads_for_bench(reads)
    depths = sorted(jidx.kmer_tables)
    d, d_seed = tengine.pick_kmer_depth(depths, 60), tengine.pick_kmer_depth(depths, 20)
    common = dict(L=60, sa_rate=1, min_trips=1)
    if kind == "exact":
        kw = dict(common, d=d, max_hits=4, loc_factor=0.01)
        want = jengine.exact_pipeline_packed(jshard, rw, ab, compact_output=True, **kw)
        got = tengine.exact_pipeline_packed(tshard, torch.from_numpy(rw),
                                            torch.from_numpy(ab), **kw)
    elif kind == "k2":
        kw = dict(common, k=2, d=d_seed, max_loc=8, loc_factor=0.01)
        want = jengine.inexact_pipeline_packed(jshard, rw, ab, compact_output=True, **kw)
        got = tengine.inexact_pipeline_packed(tshard, torch.from_numpy(rw),
                                              torch.from_numpy(ab), **kw)
    else:
        kw = dict(common, k=2, d=d, d_seed=d_seed, max_hits=4, max_cand=8, loc_factor=0.01,
                  k2_loc_factor=0.01, esc_factor=0.1)
        want = jengine.tiered_pipeline_packed(jshard, rw, ab, **kw)
        got = tengine.tiered_pipeline_packed(tshard, torch.from_numpy(rw),
                                             torch.from_numpy(ab), **kw)
    if kind == "tiered":  # bench.py:414-418
        ref = int((np.asarray(want[10]) > 0).sum()) + int(np.asarray(want[11]))
        assert int(got[9]) == int(np.asarray(want[9])) > 0
        count = tbench.overflow_count(got, 10, 11)
    else:  # bench.py:356-359, 383-386
        ref = int(np.asarray(want[5])) + int((np.asarray(want[4]) > 0).sum())
        count = tbench.overflow_count(got, 4, 5)
    assert count == ref > 0
