"""scripts/torch_scale_human.py (the port's human-scale run) on the CPU
against the JAX package's scripts/scale_human.py, at 2 Mbp in 10 shards.

The build half: the same truth counts, shard count and artifact size as
scale_human.py's JSON line, and the same artifact (meta.json byte-equal,
every array equal). The card half with --device cpu, small batches and
--tiered on that artifact: every key of scale_human_chip.py's `out` dict
(read from its source, chip_smoke.scale_human_keys, which the card's
smoke run checks with too), every truth recovered, every hit sound, no
overflowed read; then again with --kmer-d 4, the ladder's shallowest
depth, whose start intervals need wide steps on 200 kbp shards, and with
--fuse (the fused multi-shard dispatch), equal to the loop's."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

BP = "2000000"
SMALL = ["--batch", "128", "--k2-batch", "128", "--n-truth", "128"]


def _json_lines(out: str) -> list:
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def _port(*argv) -> list:
    env = dict(os.environ, SCALE_HUMAN_ALLOW_SMALL="1", OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "scripts/torch_scale_human.py", *argv,
                           "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return _json_lines(proc.stdout)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both build halves (the JAX one on a 10-device CPU mesh) run side by
    side, each keeping its artifact; the port's goes on to its card half."""
    tmp = tmp_path_factory.mktemp("scale_human")
    want, got = str(tmp / "jax_idx"), str(tmp / "port_idx")
    env = dict(os.environ, SCALE_HUMAN_ALLOW_SMALL="1", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=10")
    jax_run = subprocess.Popen([sys.executable, "scripts/scale_human.py", "--bp", BP, "--keep",
                                "--out", want], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)
    try:
        port = _port("--bp", BP, "--keep", "--out", got, *SMALL, "--tiered")
        out, err = jax_run.communicate(timeout=600)
    finally:
        if jax_run.poll() is None:
            jax_run.kill()
            jax_run.wait()
    assert jax_run.returncode == 0, err[-3000:]
    return dict(jax=_json_lines(out)[-1], port=port, want=want, got=got)


def test_build_half_counts_equal_scale_human(runs):
    jax_line, port_line = runs["jax"], runs["port"][0]
    for key in ("truth_recovered", "truth_beyond_int32", "recovered_beyond_int32", "n_shards",
                "artifact_gb", "sample_reads", "genome_bp"):
        assert port_line[key] == jax_line[key], key
    assert port_line["truth_recovered"] == port_line["sample_reads"] == 64
    assert port_line["truth_beyond_int32"] > 0


def test_build_half_artifact_equal_to_scale_human(runs):
    """meta.json byte-equal, every array equal once loaded (the .npz zip
    headers carry write times)."""
    meta = [open(os.path.join(d, "meta.json"), "rb").read() for d in (runs["want"], runs["got"])]
    assert meta[1] == meta[0]
    assert json.loads(meta[0])["n_shards"] == 10
    for i in range(10):
        zw, zg = (np.load(os.path.join(d, f"shard{i}.npz")) for d in (runs["want"], runs["got"]))
        assert sorted(zg.files) == sorted(zw.files)
        for name in zw.files:
            assert zg[name].dtype == zw[name].dtype, (i, name)
            np.testing.assert_array_equal(zg[name], zw[name], err_msg=f"shard{i}.{name}")


def test_card_half_keys_truth_and_soundness(runs):
    build, card, out = runs["port"]
    want_build, want_chip = chip_smoke.scale_human_keys(ROOT)
    assert want_build <= set(build), sorted(want_build - set(build))
    assert want_chip <= set(out), sorted(want_chip - set(out))
    assert "k2_tiered_reads_per_s" in want_chip and "k0_lf_tuned" in want_chip
    assert out["platform"] == "cpu" and out["n_shards"] == 10
    assert out["truth_recovered"] == out["truth_reads"] == 128
    assert out["recovered_beyond_int32"] == out["truth_beyond_int32"]
    assert out["unsound_hits"] == 0 and out["sound_hits"] >= 128
    assert out["overflow_reads"] == 0
    # the depth kept: 11 is not in the ladder (4, 8), so the deepest
    assert card["kmer_d"] == 8 and card["wide_steps"] == 0
    assert card["multistep_calls"] > 0 and card["wide_multistep_calls"] == 0
    assert card["card"] is None and card["multistep_wide_call"] == {}


def test_card_half_at_kmer_d_4_runs_wide_steps(runs):
    """--kmer-d 4 on the same artifact: E[width] = 200,257 / 4^4 = 782
    falls to 3.1 after four wide steps, on every search call."""
    card, out = _port("--index", runs["got"], "--kmer-d", "4", *SMALL)
    assert card["kmer_d"] == 4 and card["wide_steps"] == 4
    assert card["wide_multistep_calls"] == card["multistep_calls"] > 0
    assert out["truth_recovered"] == out["truth_reads"] == 128
    assert out["unsound_hits"] == 0 and out["overflow_reads"] == 0


def test_card_half_with_fuse_equals_the_loop(runs):
    """--fuse (Engine fuse_shards=True) on the same artifact: fused_dispatch
    reads true, and truth and the hits checked equal the loop's; both
    lines carry the per-block dispatch / fetch / assembly split."""
    card, out = _port("--index", runs["got"], *SMALL, "--tiered", "--fuse")
    loop_card, loop = runs["port"][1:]
    assert out["fused_dispatch"] is True and loop["fused_dispatch"] is False
    for key in ("truth_recovered", "recovered_beyond_int32", "sound_hits", "unsound_hits",
                "overflow_reads", "k2_tiered_escalated_frac"):
        assert out[key] == loop[key], key
    for c in (card, loop_card):
        assert sorted(c["per_block_ms"]) == ["k0", "k2", "k2_tiered"]
        assert all(v["fetch_ms"] > 0 and v["assembly_ms"] > 0
                   for v in c["per_block_ms"].values()), c["per_block_ms"]
    assert card["graph_captures"] == []  # the CPU runs the fused program eagerly


def test_without_a_card_the_run_fails_unless_device_cpu(runs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device runs")
    proc = subprocess.run([sys.executable, "scripts/torch_scale_human.py", "--index",
                           runs["got"]], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and not proc.stdout.strip()


def test_soundness_check_flags_a_wrong_position_strand_or_nm():
    """The card half's check of every hit against the genome: the truth's
    hits are sound; a position off by one or by 2^31, the other strand or
    another nm are not."""
    import importlib.util

    from bwtpu_torch import dna
    from bwtpu_torch.results import FlatHits
    from bwtpu_torch.simulate import random_genome, simulate_reads

    spec = importlib.util.spec_from_file_location(
        "torch_scale_human", os.path.join(ROOT, "scripts", "torch_scale_human.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    genome = random_genome(50000, seed=3)
    reads, truth = simulate_reads(genome, 40, read_len=100, max_mismatches=2, n_frac=0.01,
                                  seed=4)
    codes = dna.encode(genome)
    pos = np.array([t["pos"] for t in truth], np.int64)
    rev = np.array([t["strand"] == "-" for t in truth])
    nm = np.array([t["nm"] for t in truth], np.int32)
    flat = FlatHits(np.arange(40, dtype=np.int32), pos, rev, nm, 40)
    assert script.unsound_hits(codes, reads, flat, 2 + int(nm.max())) == (40, 0)
    for bad in (flat._replace(pos=pos + 1), flat._replace(pos=pos + 2**31),
                flat._replace(strand_rev=~rev), flat._replace(nm=nm + 1)):
        assert script.unsound_hits(codes, reads, bad, 99) == (0, 40)
    assert script.unsound_hits(codes, reads, flat, int(nm.max()) - 1)[1] > 0
