"""The port's measurement sweeps on the CPU against the JAX package's:
scripts/torch_{scale_chr21,sweep_locate,tune_exact,ab_batch,sweep_depth}.py
with --device cpu against scripts/{scale_chr21,...}.py under
JAX_PLATFORMS=cpu, each pair at the same arguments, all run at once as
subprocesses (a few at a time).

Every deterministic field of each output equals the reference's: the
overflow counts, cap_occ, the index bytes, the depths, the read counts,
the key sets and the exit codes; the keys and line formats that
chip_smoke's phase 14c requires of the port's programs on the card are
the references' own. Rates are timings of two different programs on the
CPU: only checked to be positive and finite."""

import concurrent.futures
import json
import math
import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

CHR21 = ("--genome-bp", "2000000", "--reads", "2048", "--batch", "1024")
TUNE = ("--batch", "1024", "--min-trips", "0,1", "--loc-factors", "1.0")
# name: (the reference's arguments, the port's; the port adds --device cpu)
RUNS = {
    # locv on and off at sa_rate 1, and the LF walk at sa_rate 2
    "sweep_locate": ("sweep_locate", ("--quick", "--configs", "1:1:0.75:1:1024",
                                      "1:0:0.75:1:1024", "2:0:0.5:2:2048")),
    "scale_chr21_s2": ("scale_chr21", CHR21 + ("--shards", "2", "--sa-rates", "1")),
    "scale_chr21": ("scale_chr21", CHR21),
    "sweep_depth": ("sweep_depth", ("--quick",)),
    # 2048:4: start intervals of the E. coli-size genome far wider than
    # max_hits, so the run must fail on its overflow as the reference does
    "ab_batch": ("ab_batch", ("--configs", "2048:11", "2048:4")),
    "ab_batch_k2": ("ab_batch", ("--configs", "2048:11", "--k2")),
    "tune_exact": ("tune_exact", TUNE),
    "tune_exact_k2": ("tune_exact", TUNE + ("--kind", "k2")),
}
SCRIPTS = ("scale_chr21", "sweep_locate", "tune_exact", "ab_batch", "sweep_depth")


def _run(cmd, env) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)


def run_pairs(runs: dict, workers: int = 5) -> dict:
    """{name: (reference's CompletedProcess, port's)}: every run of `runs`
    ({name: (script, args)}) as scripts/<script>.py under JAX_PLATFORMS=cpu
    and scripts/torch_<script>.py --device cpu, `workers` at a time."""
    jax_env = dict(os.environ, JAX_PLATFORMS="cpu")
    port_env = dict(os.environ, OMP_NUM_THREADS="2")
    with concurrent.futures.ThreadPoolExecutor(workers) as ex:
        futs = {name: (ex.submit(_run, [sys.executable, f"scripts/{s}.py", *a], jax_env),
                       ex.submit(_run, [sys.executable, f"scripts/torch_{s}.py", *a,
                                        "--device", "cpu"], port_env))
                for name, (s, a) in runs.items()}
        return {name: (fj.result(), fp.result()) for name, (fj, fp) in futs.items()}


def json_lines(out: str) -> list:
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def rate_ok(x) -> bool:
    return isinstance(x, float) and math.isfinite(x) and x > 0


@pytest.fixture(scope="module")
def runs():
    return run_pairs(RUNS)


def ok_pair(runs, name: str) -> tuple[str, str]:
    want, got = runs[name]
    assert want.returncode == 0, want.stderr[-3000:]
    assert got.returncode == 0, got.stderr[-3000:]
    return want.stdout, got.stdout


CHR21_EXACT = ("exact_overflow", "k2_overflow", "hbm_index_bytes", "hbm_index_mb", "kmer_d",
               "reads", "sa_rate", "n_shards", "genome_bp", "min_trips", "config")


def test_scale_chr21_fields_equal_the_reference(runs):
    want, got = (json_lines(s) for s in ok_pair(runs, "scale_chr21"))
    assert [ln["sa_rate"] for ln in got] == [ln["sa_rate"] for ln in want] == [1, 8]
    for w, g in zip(want, got):
        assert set(g) == set(w) == chip_smoke.SWEEP_KEYS["scale_chr21"]
        for key in CHR21_EXACT:
            assert g[key] == w[key], key
        assert g["kmer_d"] == 10 and g["reads"] == 2048 and g["platform"] == "cpu"
        assert rate_ok(g["exact_reads_per_s"]) and rate_ok(g["k2_reads_per_s"])
    # the locv table (16 int32 a row) is the difference
    assert [g["hbm_index_bytes"] for g in got] == [151_916_096, 16_916_036]


def test_scale_chr21_two_shards_differs_by_the_stacked_padding(runs):
    """--shards 2: the reference stacks both shards padded to common shapes
    (one vmapped dispatch); the port uploads each shard as it is. Their
    hbm_index_bytes differ by exactly that padding, here computed from the
    port's own build of the same shards."""
    from bwtpu_torch.config import EngineConfig
    from bwtpu_torch.engine import upload_index
    from bwtpu_torch.index import build_sharded_index
    from bwtpu_torch.simulate import random_genome

    want, got = (json_lines(s) for s in ok_pair(runs, "scale_chr21_s2"))
    assert len(got) == len(want) == 1
    genome = random_genome(2_000_000, seed=21)
    for w, g in zip(want, got):
        assert set(g) == set(w)
        for key in ("exact_overflow", "k2_overflow", "kmer_d", "reads", "sa_rate", "n_shards"):
            assert g[key] == w[key], key
        assert g["n_shards"] == 2 and g["kmer_d"] == 9
        cfg = EngineConfig(sa_rate=g["sa_rate"], max_hits=4, max_cand=8, read_len=100,
                           min_trips=1)
        shards, _ = build_sharded_index(genome, 2, cfg, overlap=256, jobs=1)
        dev = upload_index(shards, "cpu")
        pad = 0
        for field in dev[0]._fields:
            ts = [getattr(sh, field) for sh in dev]
            if isinstance(ts[0], torch.Tensor):  # k-mer tables and ints: one shape
                pad += sum(max(t.numel() for t in ts) - t.numel() for t in ts) * 4
        assert pad > 0
        assert w["hbm_index_bytes"] - g["hbm_index_bytes"] == pad, g["sa_rate"]
    # 18,304 B: most of it the 256 rows of the ssa and the locv table (68 B a
    # row) by which the first shard is longer
    assert want[0]["hbm_index_bytes"] - got[0]["hbm_index_bytes"] == 18_304


LOCATE_ROW = re.compile(chip_smoke.SWEEP_LINES["sweep_locate"])


def test_sweep_locate_rows_equal_the_reference(runs):
    want, got = ok_pair(runs, "sweep_locate")

    def rows(out):
        return [LOCATE_ROW.match(ln).groups() for ln in out.splitlines()
                if ln.startswith("sa_rate=")]
    w, g = rows(want), rows(got)
    assert len(g) == len(w) == 3
    for (wt, _, wo, wc), (gt, rate, go, gc) in zip(w, g):
        assert (gt, go, gc) == (wt, wo, wc)
        assert float(rate) >= 0
    assert [t for t, *_ in g] == ["sa_rate=1 locv=1 lf=0.75 mt=1 B=1024",
                                  "sa_rate=1 locv=0 lf=0.75 mt=1 B=1024",
                                  "sa_rate=2 locv=0 lf=0.5 mt=2 B=2048"]
    built = [ln.split(" in ")[0] for ln in got.splitlines() if ln.startswith("# built")]
    assert built == [ln.split(" in ")[0] for ln in want.splitlines()
                     if ln.startswith("# built")]
    assert got.splitlines()[-1].startswith("# best: sa_rate=")


@pytest.mark.parametrize("name", ["tune_exact", "tune_exact_k2"])
def test_tune_exact_points_equal_the_reference(runs, name):
    want, got = (json_lines(s) for s in ok_pair(runs, name))
    assert len(got) == len(want) == 2
    for w, g in zip(want, got):
        assert set(g) == set(w) == chip_smoke.SWEEP_KEYS["tune_exact"]
        for key in ("kind", "batch", "min_trips", "loc_factor", "compact_overflow"):
            assert g[key] == w[key], key
        assert rate_ok(g["reads_per_s"])
    if name == "tune_exact_k2":  # min_trips 0 overflows the cap; the sweep goes on
        assert [g["compact_overflow"] for g in got] == [5452, 0]


BATCH_ROW = re.compile(chip_smoke.SWEEP_LINES["ab_batch"])


@pytest.mark.parametrize("name", ["ab_batch", "ab_batch_k2"])
def test_ab_batch_lines_and_exit_code_equal_the_reference(runs, name):
    want, got = runs[name]
    assert got.returncode == want.returncode == (1 if name == "ab_batch" else 0), \
        got.stderr[-3000:]

    def rows(out):
        return [(m[1], m[3]) for m in map(BATCH_ROW.match, out.splitlines()) if m]
    assert rows(got.stdout) == rows(want.stdout)
    assert len(rows(got.stdout)) == (2 if name == "ab_batch" else 1)
    if name == "ab_batch":
        assert rows(got.stdout)[1] == ("B=2048 d=4 k2=False", "7680")
        assert "ERROR: 7680 overflowed rows" in got.stderr


def test_sweep_depth_rows_equal_the_reference(runs):
    want, got = (json_lines(s) for s in ok_pair(runs, "sweep_depth"))
    assert len(got) == len(want) == 3
    for w, g in zip(want[:2], got[:2]):
        assert set(g) == set(w) == chip_smoke.SWEEP_KEYS["sweep_depth"]
        for key in ("d", "exact_overflow", "k2_overflow", "table_mb"):
            assert g[key] == w[key], key
        assert rate_ok(g["exact_rps"]) and rate_ok(g["k2_rps"])
    assert [(g["d"], g["exact_overflow"], g["k2_overflow"]) for g in got[:2]] == \
        [(4, 2897, 5344), (7, 0, 0)]
    assert got[2]["config"] == want[2]["config"] and got[2]["rows"] == got[:2]


@pytest.mark.parametrize("script", SCRIPTS)
def test_without_a_card_the_script_fails_unless_device_cpu(script):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device runs")
    proc = subprocess.run([sys.executable, f"scripts/torch_{script}.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and not proc.stdout.strip()
