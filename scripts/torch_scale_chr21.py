"""chr21-scale run of bwtpu_torch on one card: the port of
scripts/scale_chr21.py.

Builds the index of a random genome of --genome-bp bases (seed 21;
chr21's 46,709,983 by default), simulates --reads 100 bp reads (seeds
40 + i, one batch of --batch reads each) once for every sa_rate, and
for each sa_rate of --sa-rates (1: the whole suffix array resident and
the fused locate+verify table, one gather a candidate; 8: a sampled
suffix array and a bounded LF walk) measures the exact packed pipeline
(loc_factor 0.75) and the k = 2 one (the config's loc_factor), both at
--min-trips, as reads/s on the card: best of 2 passes over every batch,
each pass closed by one synchronize, after one untimed warm call
(bwtpu_torch.bench.device_rate). Prints scale_chr21.py's JSON line per
sa_rate. exact_overflow and k2_overflow are the compaction overflows
summed over the batches (the larger of the 2 passes); hbm_index_bytes is
every tensor of the uploaded shards (the k-mer tables too) plus 4 bytes
for each of a shard's three integer fields, as the reference's int32
leaves count them; index_build_s is the host build and upload_s the
upload with the locv rows, which are built on the host inside it.

--shards S > 1: build_sharded_index into S shards (overlap 256, 2 worker
processes), and each timed pass runs every shard's pipeline in turn, as
Engine's loop form does (the reference runs all shards as one vmapped
dispatch). hbm_index_bytes is then the sum over the port's shards as
uploaded, without the padding to common shapes of the reference's stacked
form, so it is smaller than the reference's.

Nothing falls back to the CPU: without a card the run fails unless
--device cpu, which runs the kernels' plain versions.

Run:  python3 scripts/torch_scale_chr21.py [--reads 1048576] [--sa-rates 1,8]
      python3 scripts/torch_scale_chr21.py --genome-bp 2000000 --reads 2048 \\
          --batch 1024 --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def device_bytes(shards) -> int:
    """Bytes of every tensor of each Shard (its k-mer tables too), plus 4 for
    each integer field."""
    total = 0
    for shard in shards:
        for v in shard:
            if isinstance(v, torch.Tensor):
                total += v.numel() * v.element_size()
            elif isinstance(v, dict):
                total += sum(t.numel() * t.element_size() for t in v.values())
            else:
                total += 4
    return total


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reads", type=int, default=1048576)
    ap.add_argument("--batch", type=int, default=262144)
    ap.add_argument("--sa-rates", default="1,8")
    ap.add_argument("--genome-bp", type=int, default=46_709_983)
    ap.add_argument("--shards", type=int, default=1,
                    help="interval shards; > 1 runs every shard's pipeline in turn "
                         "in each pass")
    ap.add_argument("--min-trips", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_scale_chr21: no CUDA device (torch.cuda.is_available() is "
                         "false); --device cpu runs the plain-torch versions")
    device = torch.device(args.device)

    from bwtpu_torch.bench import device_rate, pack_batches
    from bwtpu_torch.config import EngineConfig
    from bwtpu_torch.engine import (exact_pipeline_packed, inexact_pipeline_packed,
                                    pick_kmer_depth, upload_index)
    from bwtpu_torch.index import build_fm_index, build_sharded_index
    from bwtpu_torch.kernels import _build
    from bwtpu_torch.simulate import random_genome

    if device.type == "cuda":
        _build.build_all(_build.SOURCES)
    L = 100
    genome = random_genome(args.genome_bp, seed=21)
    n_batches = -(-args.reads // args.batch)
    S = args.shards
    mt = args.min_trips
    # the reference simulates the same reads again for every sa_rate
    encs, _ = pack_batches(genome, args.batch, n_batches, L, 40, device)

    def comp_over(outs):
        return (sum(int(o[5]) for out in outs for o in out),)

    for sa_rate in [int(s) for s in args.sa_rates.split(",")]:
        cfg = EngineConfig(sa_rate=sa_rate, max_hits=4, max_cand=8, read_len=L,
                           min_trips=mt)
        t0 = time.time()
        if S > 1:
            shards, _manifest = build_sharded_index(genome, S, cfg, overlap=256, jobs=2)
        else:
            shards = [build_fm_index(genome, cfg)]
        build_s = time.time() - t0
        t0 = time.time()
        dev = upload_index(shards, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        upload_s = time.time() - t0
        hbm = device_bytes(dev)
        depths = sorted(shards[0].kmer_tables)

        d = pick_kmer_depth(depths, L)

        def fx(rw, ab):
            return [exact_pipeline_packed(sh, rw, ab, L=L, d=d, max_hits=cfg.max_hits,
                                          sa_rate=cfg.sa_rate, loc_factor=0.75,
                                          min_trips=mt) for sh in dev]
        exact_rps, (exact_over,) = device_rate(fx, encs, args.batch, device, comp_over)

        d_seed = pick_kmer_depth(depths, L // 3)

        def fi(rw, ab):
            return [inexact_pipeline_packed(sh, rw, ab, L=L, k=2, d=d_seed,
                                            max_loc=cfg.max_cand, sa_rate=cfg.sa_rate,
                                            loc_factor=cfg.loc_factor, min_trips=mt)
                    for sh in dev]
        k2_rps, (k2_over,) = device_rate(fi, encs, args.batch, device, comp_over)

        print(json.dumps({
            "config": f"chr21-scale 1 chip, S={S} shard(s), min_trips={mt}",
            "genome_bp": args.genome_bp,
            "n_shards": S,
            "min_trips": mt,
            "exact_overflow": exact_over,
            "k2_overflow": k2_over,
            "sa_rate": sa_rate,
            "reads": args.batch * n_batches,
            "exact_reads_per_s": round(exact_rps, 1),
            "k2_reads_per_s": round(k2_rps, 1),
            "index_build_s": round(build_s, 1),
            "upload_s": round(upload_s, 1),
            "hbm_index_bytes": hbm,
            "hbm_index_mb": round(hbm / 1e6, 1),
            "kmer_d": d,
            "platform": device.type,
        }), flush=True)
        del dev, shards
        if device.type == "cuda":
            torch.cuda.empty_cache()
    print(f"# launches {json.dumps(_build.launch_counts())}", file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
