"""Tuning sweep of the packed compacted pipelines on one card, min_trips
(candidate thinning) x loc_factor (the compaction cap), exact or k = 2:
the port of scripts/tune_exact.py.

The located and verified candidates are as many as the compaction cap,
so a smaller cap is less work, but only a point with compact_overflow
0 drops no candidate; more min_trips narrow the intervals before the
search stops, so fewer false candidates reach the cap. On a random E.
coli-size genome (seed 1, sa_rate 1), 2 batches of --batch simulated
100 bp reads (seeds 2, 3, put on the device once), each point's rate is
the best of 2 passes over both batches, each pass closed by one
synchronize, after one untimed warm call (bwtpu_torch.bench.device_rate);
compact_overflow is the largest compaction overflow of one batch. One
JSON line a point, the reference's keys; a point that overflows is
reported, not refused.

Nothing falls back to the CPU: without a card the run fails unless
--device cpu, which runs the kernels' plain versions.

Run:  python3 scripts/torch_tune_exact.py [--kind exact|k2] [--batch N]
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
    ap.add_argument("--kind", default="exact", choices=["exact", "k2"])
    ap.add_argument("--batch", type=int, default=262144)
    ap.add_argument("--min-trips", default="0,1,2,3")
    ap.add_argument("--loc-factors", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_tune_exact: no CUDA device (torch.cuda.is_available() is "
                         "false); --device cpu runs the plain-torch versions")
    device = torch.device(args.device)

    from bwtpu_torch.bench import device_rate, pack_batches
    from bwtpu_torch.config import EngineConfig
    from bwtpu_torch.engine import (exact_pipeline_packed, inexact_pipeline_packed,
                                    pick_kmer_depth, upload_index)
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
    depths = sorted(idx.kmer_tables)

    B = args.batch
    encs, _ = pack_batches(genome, B, 2, L, 2, device)

    if args.loc_factors:
        lfs = [float(x) for x in args.loc_factors.split(",")]
    else:
        lfs = [1.5, 1.0, 0.5, 0.25, 0.125] if args.kind == "exact" else \
              [3.0, 2.0, 1.0, 0.5, 0.25]

    def comp_over(outs):  # the scalar compaction overflow, both kinds' out[5]
        return (max(int(o[5]) for o in outs),)

    for mt in [int(x) for x in args.min_trips.split(",")]:
        for lf in lfs:
            if args.kind == "exact":
                d = pick_kmer_depth(depths, L)

                def fn(rw, ab):
                    return exact_pipeline_packed(shard, rw, ab, L=L, d=d,
                                                 max_hits=cfg.max_hits, sa_rate=cfg.sa_rate,
                                                 loc_factor=lf, min_trips=mt)
            else:
                d = pick_kmer_depth(depths, L // 3)

                def fn(rw, ab):
                    return inexact_pipeline_packed(shard, rw, ab, L=L, k=2, d=d,
                                                   max_loc=cfg.max_cand, sa_rate=cfg.sa_rate,
                                                   loc_factor=lf, min_trips=mt)
            best, (over,) = device_rate(fn, encs, B, device, comp_over)
            print(json.dumps({
                "kind": args.kind, "batch": B, "min_trips": mt,
                "loc_factor": lf,
                "reads_per_s": round(best, 1),
                "compact_overflow": over,
            }), flush=True)
    print(f"# launches {json.dumps(_build.launch_counts())}", file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
