"""The port's profiles on the CPU against the JAX package's:
scripts/torch_e2e_profile.py and scripts/torch_profile_build.py with
--device cpu against scripts/e2e_profile.py (--cpu) and
scripts/profile_build.py under JAX_PLATFORMS=cpu, run side by side as
subprocesses at the same sizes.

The deterministic fields equal the reference's (the key sets, the read
count, the FASTQ's and the SAM's size), and the keys are those that
chip_smoke's phase 14c requires of the port's programs on the card. The
stage times are timings of two different programs on the CPU: only
checked to be finite and not negative, the walls positive."""

import concurrent.futures
import json
import math
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

E2E = ("--reads", "2048", "--batch", "1024")
# name: (script, the reference's arguments, the port's but --device cpu)
RUNS = {
    "e2e_profile": ("e2e_profile", E2E + ("--cpu",), E2E),
    "profile_build": ("profile_build", ("--mbp", "2"), ("--mbp", "2")),
}


def _run(cmd, env) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)


@pytest.fixture(scope="module")
def runs():
    jax_env = dict(os.environ, JAX_PLATFORMS="cpu")
    port_env = dict(os.environ, OMP_NUM_THREADS="2")
    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        futs = {name: (ex.submit(_run, [sys.executable, f"scripts/{s}.py", *ja], jax_env),
                       ex.submit(_run, [sys.executable, f"scripts/torch_{s}.py", *pa,
                                        "--device", "cpu"], port_env))
                for name, (s, ja, pa) in RUNS.items()}
        out = {}
        for name, (fj, fp) in futs.items():
            want, got = fj.result(), fp.result()
            assert want.returncode == 0, want.stderr[-3000:]
            assert got.returncode == 0, got.stderr[-3000:]
            (w,), (g,) = ([json.loads(ln) for ln in p.stdout.splitlines() if ln.startswith("{")]
                          for p in (want, got))
            out[name] = (w, g)
        return out


def seconds_ok(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x) and x >= 0


def test_e2e_profile_fields_equal_the_reference(runs):
    want, got = runs["e2e_profile"]
    assert list(got) == list(want)
    assert set(got) == chip_smoke.SWEEP_KEYS["e2e_profile"]
    for key in ("reads", "fq_mb", "sam_mb"):
        assert got[key] == want[key], key
    assert got["reads"] == 2048 and got["sam_mb"] > got["fq_mb"] > 0
    stages = ("parse", "slice", "dispatch", "finish", "primary", "emit", "write")
    assert all(seconds_ok(got[f"{k}_s"]) for k in stages)
    assert seconds_ok(got["engine_device_s"]) and seconds_ok(got["engine_host_s"])
    assert got["wall_s"] > 0 and got["serialized_reads_per_s"] > 0


def test_profile_build_keys_equal_the_reference(runs):
    want, got = runs["profile_build"]
    assert list(got) == list(want)
    assert set(got) == chip_smoke.SWEEP_KEYS["profile_build"]
    assert got["mbp"] == want["mbp"] == 2.0
    assert all(seconds_ok(v) for v in got.values())
    phases = sum(v for k, v in got.items()
                 if k not in ("mbp", "rss_gb", "build_total_s", "genome_gen"))
    assert got["sais"] > 0 and abs(got["build_total_s"] - phases) < 0.2


@pytest.mark.parametrize("script", ["e2e_profile", "profile_build"])
def test_without_a_card_the_script_fails_unless_device_cpu(script):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device runs")
    proc = subprocess.run([sys.executable, f"scripts/torch_{script}.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and not proc.stdout.strip()
