"""Nothing under benchmark/ imports jax, jaxlib, flax or the JAX package
bwtpu (top-level names compared whole: bwtpu_torch is not bwtpu); the
reference imports nothing of the program; a run without a card, or in a
directory that holds only BENCHMARK.json and benchmark/, prints no result
and exits non-zero."""

import ast
import glob
import os
import shutil
import subprocess
import sys
import types

import pytest

from benchmark import run as run_mod

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
REPO = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "bwtpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _files(sub=""):
    return sorted(glob.glob(os.path.join(BENCH, sub, "**", "*.py"), recursive=True))


def test_no_jax_and_no_jax_package():
    bad = {(os.path.relpath(p, REPO), m) for p in _files() for m in _imports(p)
           if m.split(".")[0] in FORBIDDEN}
    assert not bad


def test_the_reference_imports_nothing_of_the_program():
    mods = {m for p in _files("reference") for m in _imports(p)}
    assert mods and all(m.split(".")[0] not in ("bwtpu_torch", "bwtpu") for m in mods)
    assert {m.split(".")[0] for m in mods} <= {"__future__", "dataclasses", "numpy"}


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "bwtpu_torch_lookalike", types.ModuleType("x"))
    assert run_mod.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "bwtpu.engine", types.ModuleType("bwtpu.engine"))
    assert run_mod.forbidden_modules() == ["bwtpu"]


def _run(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "ecoli.k2.align",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_no_card_no_result():
    out = _run(REPO)
    assert out.returncode != 0 and out.stdout == "", out.stderr


def test_only_the_benchmarks_files_no_result(tmp_path):
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = _run(str(tmp_path))
    assert out.returncode != 0 and out.stdout == "", out.stderr


@pytest.mark.parametrize("path", ["BENCHMARK.json"])
def test_benchmark_json_names_files_that_exist(path):
    import json

    spec = json.load(open(os.path.join(REPO, path)))
    for c in spec["configs"]:
        assert os.path.exists(os.path.join(REPO, c["file"]))
    for w in spec["workloads"]:
        assert os.path.exists(os.path.join(BENCH, "workloads", w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(BENCH, "limits", w["name"] + ".json"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics", m["name"] + ".py"))
