"""Finding a cell's parts by name: BENCHMARK.json at the root names each
cell's configuration and traffic, and each metric; their files are

  benchmark/configs/<config>.json      (the entry's "file")
  benchmark/workloads/<traffic>.json   the traffic mix: one parameter file
  benchmark/metrics/<metric>.py        a reader: read(window) -> number or None
  benchmark/limits/<cell>.json         the limits of the numbers check.py compares

so a new configuration, cell or metric is new files and new entries,
with no existing file edited. The configuration's genome and index are
kept in benchmark/.cache/<config>-<hash>/ (git-ignored, a fixed path from
the configuration's file and the genome generator's source), built by the
program's own `build-index` on the first run in a checkout.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list


class Bench:
    def __init__(self, root: str = ROOT):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.spec = json.load(f)

    def path(self, *parts: str) -> str:
        return os.path.join(self.root, "benchmark", *parts)

    def cell(self, name: str) -> Cell:
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
        w = cells[name]
        conf = next(c for c in self.spec["configs"] if c["name"] == w["config"])
        with open(os.path.join(self.root, conf["file"])) as f:
            config = json.load(f)
        with open(self.path("workloads", w["traffic"] + ".json")) as f:
            traffic = json.load(f)
        e2e = [m for m in self.spec["end_to_end"] if name in m.get("workloads", [name])]
        moved = {m["name"] for m in e2e}
        per_layer = [m for m in self.spec["per_layer"]
                     if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
        return Cell(name, config, traffic, int(w["chips"]), e2e, per_layer)

    def limits(self, name: str) -> dict:
        with open(self.path("limits", name + ".json")) as f:
            return json.load(f)["limits"]

    def reader(self, metric: str):
        """The read() of benchmark/metrics/<metric>.py."""
        path = self.path("metrics", metric + ".py")
        spec = importlib.util.spec_from_file_location(
            "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def cache_dir(self, config: dict) -> str:
        h = hashlib.sha256(json.dumps(config, sort_keys=True).encode())
        with open(os.path.join(HERE, "gen", "genome.py"), "rb") as f:
            h.update(f.read())
        return self.path(".cache", f"{config['name']}-{h.hexdigest()[:12]}")


def prepare(bench: Bench, config: dict) -> tuple[np.ndarray, str]:
    """(genome codes, index directory) of a configuration: from the cache,
    else generated and built by `python -m bwtpu_torch.cli build-index`
    with the configuration's options (what a user runs)."""
    from benchmark.gen.genome import make_genome, write_fasta

    d = bench.cache_dir(config)
    g_path, idx = os.path.join(d, "genome.npy"), os.path.join(d, "index")
    if os.path.exists(g_path) and os.path.exists(os.path.join(idx, "meta.json")):
        return np.load(g_path), idx
    os.makedirs(d, exist_ok=True)
    genome, _ = make_genome(config)
    fa = os.path.join(d, "ref.fa")
    write_fasta(fa, config["contig"], genome)
    tmp = idx + ".partial"
    shutil.rmtree(tmp, ignore_errors=True)
    b = config["build_index"]
    cmd = [sys.executable, "-m", "bwtpu_torch.cli", "build-index", fa, tmp,
           "--shards", str(b["shards"]), "--sa-rate", str(b["sa_rate"]),
           "--read-len", str(b["read_len"]), "--max-hits", str(b["max_hits"]),
           "--max-cand", str(b["max_cand"])]
    if b.get("kmer_d") is not None:
        cmd += ["--kmer-d", str(b["kmer_d"])]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True)
    sys.stderr.write(out.stdout + out.stderr)
    out.check_returncode()
    os.rename(tmp, idx)
    os.remove(fa)
    np.save(g_path + ".partial.npy", genome)
    os.rename(g_path + ".partial.npy", g_path)
    return genome, idx
