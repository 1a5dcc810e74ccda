"""A/B of the packed compacted pipeline's rate by batch size and k-mer
depth on one card: the port of scripts/ab_batch.py.

On a random E. coli-size genome (seed 1, sa_rate 1) each --configs entry
B:d runs the exact pipeline (loc_factor 0.75), or with --k2 the k = 2
one (--loc-factor, else the config's), at min_trips 1 with start-table
depth d, on --nbatches batches of B simulated 100 bp reads (seeds 2 + i,
simulated and put on the device once per entry). A rate is the best of 2
passes over the batches, each pass closed by one synchronize, after one
untimed warm call (bwtpu_torch.bench.device_rate). overflow counts the
rows with a non-zero incompleteness count plus the compaction overflow,
summed over the batches (the larger of the 2 passes); any overflow fails
the run (stderr, exit 1), since a lossy entry's rate is inflated. The
reference pins the jnp backend; the port has one route, its kernels.

Nothing falls back to the CPU: without a card the run fails unless
--device cpu, which runs the kernels' plain versions.

Run: python3 scripts/torch_ab_batch.py [--configs 262144:11 524288:11 ...] [--k2]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", nargs="*", default=["262144:11", "524288:11"])
    ap.add_argument("--nbatches", type=int, default=2)
    ap.add_argument("--k2", action="store_true",
                    help="measure the k=2 inexact pipeline instead")
    ap.add_argument("--loc-factor", type=float, default=None,
                    help="override compaction cap factor (k2 default 2)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_ab_batch: no CUDA device (torch.cuda.is_available() is "
                         "false); --device cpu runs the plain-torch versions")
    device = torch.device(args.device)

    from bwtpu_torch.bench import device_rate, overflow_count, pack_batches
    from bwtpu_torch.config import EngineConfig
    from bwtpu_torch.engine import (exact_pipeline_packed, inexact_pipeline_packed,
                                    upload_index)
    from bwtpu_torch.index import build_fm_index
    from bwtpu_torch.kernels import _build
    from bwtpu_torch.simulate import ECOLI_SCALE, random_genome

    if device.type == "cuda":
        _build.build_all(_build.SOURCES)
    L = 100
    cfg = EngineConfig(sa_rate=1, max_hits=4, max_cand=8, read_len=L)
    genome = random_genome(ECOLI_SCALE, seed=1)
    idx = build_fm_index(genome, cfg)
    shard = upload_index([idx], device)[0]

    def over_sum(outs):
        return (sum(overflow_count(o, 4, 5) for o in outs),)

    any_overflow = 0
    for spec in args.configs:
        B, d = (int(x) for x in spec.split(":"))
        encs, _ = pack_batches(genome, B, args.nbatches, L, 2, device)
        if args.k2:
            def fx(rw, ab):
                return inexact_pipeline_packed(shard, rw, ab, L=L, k=2, d=d,
                                               max_loc=cfg.max_cand, sa_rate=cfg.sa_rate,
                                               loc_factor=args.loc_factor or cfg.loc_factor,
                                               min_trips=1)
        else:
            def fx(rw, ab):
                return exact_pipeline_packed(shard, rw, ab, L=L, d=d, max_hits=cfg.max_hits,
                                             sa_rate=cfg.sa_rate, loc_factor=0.75,
                                             min_trips=1)
        best, (over,) = device_rate(fx, encs, B, device, over_sum)
        print(f"B={B} d={d} k2={args.k2}: {best/1e6:.3f} M reads/s  "
              f"overflow={over}", flush=True)
        any_overflow += over
        del encs
    print(f"# launches {json.dumps(_build.launch_counts())}", file=sys.stderr, flush=True)
    if any_overflow:
        print(f"ERROR: {any_overflow} overflowed rows across configs — "
              "rates above are from lossy configs", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
