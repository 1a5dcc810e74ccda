"""Host assembly of a block's last-level hits, old route against new, in
alternating turns on the same inputs.

  old: engine.compact_to_columns (hm % 4, hm // 4, boolean masks) and the
       lexsort flatten_hits (two four-key np.lexsorts; its copy is below,
       as the port had it before the packed key)
  new: results.flatten_hit_buffers (one packed int64 key a hit, built from
       each shard's (cand, hm, count) buffer; two value sorts)

Inputs:
  synthetic   one shard's hit buffer shaped like an E. coli k = 2 block's
              last level: 65,536 reads, Ct 192 lanes a read-strand row
              (level 1 at k = 2), loci on a 4,641,652 bp text, each found
              by 1-5 seed slots, nm 0-2, lanes in order as the hit
              compaction keeps them; one input per --sizes hit count
  real        the buffer Engine.finish_block assembles at the last heal
              level of one block of --block k = 2 reads, on a
              configuration of benchmark/configs (genome from
              benchmark/gen/genome.py, index from the CLI's build-index,
              both cached in benchmark/.cache), reads from
              benchmark/gen/reads.py; needs the card unless --device cpu

For each input: --reps turns of each route (old, new, new, old, ...), a
median and quartiles in ms, and the FlatHits of the two field- and
dtype-equal (exit 1 where they differ). One JSON line an input on stdout,
then a line with the host's CPU model, numpy's version and, where a card
captured the real buffers, its name and power limit.

Run: python3 scripts/torch_assemble_ab.py [--sizes 100000 200000 400000]
     [--configs ecoli-k12-mg1655 chr21-grch38] [--reps 7] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ECOLI_BP = 4_641_652
FIELDS = ("read_idx", "pos", "strand_rev", "nm")


def lexsort_flatten_hits(n_reads, read_lens, B, s_idx, row_idx, p, m, text_lens, offsets):
    """The column form of results.flatten_hits before the packed key: the
    same filters, then np.lexsort on (read, pos, strand, nm) for the
    dedupe and on (read, nm, strand, pos) for the report order."""
    from bwtpu_torch.results import FlatHits

    p = np.asarray(p, dtype=np.int64)
    b = row_idx % B
    keep = b < n_reads
    s_idx, row_idx, p, b = s_idx[keep], row_idx[keep], p[keep], b[keep]
    m = np.asarray(m)[keep]
    rl = (np.asarray(read_lens, dtype=np.int64)[b] if np.ndim(read_lens)
          else np.int64(read_lens))
    tl = np.asarray(text_lens, dtype=np.int64)[s_idx]
    keep = (p >= 0) & (p + rl <= tl)
    s_idx, row_idx, p, m, b = s_idx[keep], row_idx[keep], p[keep], m[keep], b[keep]
    gpos = np.asarray(offsets, dtype=np.int64)[s_idx] + p
    sr = row_idx >= B
    order = np.lexsort((m, sr, gpos, b))
    b, gpos, sr, m = b[order], gpos[order], sr[order], m[order]
    first = np.ones(len(b), dtype=bool)
    if len(b) > 1:
        first[1:] = (b[1:] != b[:-1]) | (gpos[1:] != gpos[:-1]) | (sr[1:] != sr[:-1])
    b, gpos, sr, m = b[first], gpos[first], sr[first], m[first]
    order = np.lexsort((gpos, sr, m, b))
    return FlatHits(read_idx=b[order].astype(np.int32), pos=gpos[order],
                    strand_rev=sr[order], nm=m[order].astype(np.int32), n_reads=n_reads)


def old_route(a: dict):
    from bwtpu_torch.engine import compact_to_columns

    comp = [(cand, hm % 4, hm // 4, count) for cand, hm, count in a["shard_hits"]]
    cols = compact_to_columns(comp, a["k"], a["Ct"])
    return lexsort_flatten_hits(a["n_reads"], a["read_len"], a["B"], *cols,
                                a["text_lens"], a["offsets"])


def new_route(a: dict):
    from bwtpu_torch.results import flatten_hit_buffers

    return flatten_hit_buffers(a["n_reads"], a["read_len"], a["B"], a["Ct"], a["k"],
                               a["shard_hits"], a["text_lens"], a["offsets"])


def synthetic(hits: int, seed: int) -> dict:
    """One shard's buffer of about `hits` live lanes (see the module doc)."""
    rng = np.random.default_rng(seed)
    n, Ct, L = 65_536, 192, 100
    loci = hits // 3  # 1-5 slots a locus: 3 on average
    row = rng.integers(0, 2 * n, loci)
    rep = rng.integers(1, 6, loci)
    lane = np.repeat(row, rep) * Ct + rng.integers(0, Ct, int(rep.sum()))
    cand = np.repeat(rng.integers(0, ECOLI_BP - L + 1, loci), rep)
    nm = rng.integers(0, 3, len(lane))
    order = np.argsort(lane, kind="stable")  # lane order, as the compaction keeps it
    hm = (lane[order] * 4 + nm[order]).astype(np.int32)
    return dict(n_reads=n, read_len=L, B=n, Ct=Ct, k=2, text_lens=[ECOLI_BP], offsets=[0],
                shard_hits=[(cand[order].astype(np.int32), hm, len(hm))])


def capture_real(config_name: str, device, block_reads: int, seed: int) -> dict:
    """The arguments Engine.finish_block gives flatten_hit_buffers at the
    last heal level of one k = 2 block on a benchmark configuration."""
    from benchmark.cells import Bench, prepare
    from benchmark.gen.reads import make_pool
    from bwtpu_torch import engine as engine_mod
    from bwtpu_torch.index import load_index
    from bwtpu_torch.readblock import read_fastq_block

    bench = Bench(ROOT)
    conf = next(c for c in bench.spec["configs"] if c["name"] == config_name)
    with open(os.path.join(ROOT, conf["file"])) as f:
        config = json.load(f)
    with open(bench.path("workloads", "k2.align.json")) as f:
        traffic = dict(json.load(f), block_reads=block_reads, pool_blocks=1)
    genome, index_dir = prepare(bench, config)
    shards, _ = load_index(index_dir)
    eng = engine_mod.Engine(shards, device=device)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "reads.fq")
        with open(path, "wb") as f:
            f.write(make_pool(genome, traffic, seed).fastq(0, block_reads))
        block = read_fastq_block(path)
    seen = []
    orig = engine_mod.flatten_hit_buffers

    def keep(n_reads, read_len, B, Ct, k, shard_hits, text_lens, offsets):
        seen.append(dict(n_reads=n_reads, read_len=read_len, B=B, Ct=Ct, k=k,
                         shard_hits=[(c.copy(), h.copy(), n) for c, h, n in shard_hits],
                         text_lens=list(text_lens), offsets=list(offsets)))
        return orig(n_reads, read_len, B, Ct, k, shard_hits, text_lens, offsets)

    engine_mod.flatten_hit_buffers = keep
    try:
        eng.finish_block(eng.dispatch_block(block, int(traffic["k"])))
    finally:
        engine_mod.flatten_hit_buffers = orig
    if len(seen) != 1:
        raise SystemExit(f"torch_assemble_ab: {len(seen)} hits-mode assemblies in one block")
    seen[0]["heals"] = eng.stats.heals
    return seen[0]


def same(a, b) -> bool:
    return a.n_reads == b.n_reads and all(
        getattr(a, f).dtype == getattr(b, f).dtype
        and np.array_equal(getattr(a, f), getattr(b, f)) for f in FIELDS)


def ab(args: dict, reps: int) -> dict:
    times = {"old": [], "new": []}
    routes = {"old": old_route, "new": new_route}
    want = old_route(args)  # one untimed turn each: pages and caches warm
    got = new_route(args)
    equal = same(got, want)
    for i in range(reps):
        for name in (("old", "new") if i % 2 == 0 else ("new", "old")):
            t0 = time.perf_counter()
            out = routes[name](args)
            times[name].append(time.perf_counter() - t0)
            equal &= same(out, want)
    out = {"hits": int(sum(n for _, _, n in args["shard_hits"])), "flat_hits": len(want.pos),
           "equal": bool(equal)}
    for name, ts in times.items():
        q = statistics.quantiles(ts, n=4) if len(ts) > 1 else [ts[0]] * 3
        out[f"{name}_ms"] = [round(1e3 * v, 3) for v in (q[0], statistics.median(ts), q[2])]
    out["old_over_new"] = round(out["old_ms"][1] / out["new_ms"][1], 3)
    return out


def host_line(card: str | None) -> dict:
    cpu = platform.processor()
    try:
        with open("/proc/cpuinfo") as f:
            cpu = next(ln.split(":", 1)[1].strip() for ln in f if ln.startswith("model name"))
    except (OSError, StopIteration):
        pass
    line = {"host_cpu": cpu, "cores": os.cpu_count(), "numpy": np.__version__, "card": card}
    if card:
        q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True)
        line["nvidia_smi"] = q.stdout.strip().splitlines()[0] if q.returncode == 0 else None
    return line


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", type=int, nargs="*", default=[100_000, 200_000, 400_000])
    ap.add_argument("--configs", nargs="*", default=["ecoli-k12-mg1655", "chr21-grch38"])
    ap.add_argument("--block", type=int, default=65_536)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--seed", type=int, default=2_100_000_021)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from bwtpu_torch.hosttune import tune_malloc

    tune_malloc()  # as the CLI and the benchmark do at entry
    inputs = [(f"synthetic_{h}", lambda h=h: synthetic(h, args.seed)) for h in args.sizes]
    card = None
    if args.configs:
        import torch

        if args.device == "cuda" and not torch.cuda.is_available():
            raise SystemExit("torch_assemble_ab: no CUDA device for the real buffers "
                             "(torch.cuda.is_available() is false); --device cpu or --configs")
        device = torch.device(args.device)
        card = torch.cuda.get_device_name(device) if device.type == "cuda" else None
        inputs += [(f"real_{c}", lambda c=c: capture_real(c, device, args.block, args.seed))
                   for c in args.configs]
    ok = True
    for name, make in inputs:
        a = make()
        line = {"input": name, **ab(a, args.reps)}
        if "heals" in a:
            line["heals"] = a["heals"]
        print(json.dumps(line), flush=True)
        ok &= line["equal"]
    print(json.dumps(host_line(card)), flush=True)
    if not ok:
        raise SystemExit("torch_assemble_ab: the two routes' FlatHits differ")


if __name__ == "__main__":
    main()
