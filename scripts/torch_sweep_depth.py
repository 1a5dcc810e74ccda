"""Sweep of the k-mer start table's depth for the exact and k = 2 packed
pipelines on one card: the port of scripts/sweep_depth.py.

A depth-d start table has 4^d rows of 2 int32 (table_mb); a shallower
one is smaller but leaves wider start intervals (E[width] = n / 4^d),
which take more multi-step trips. On a random E. coli-size genome (seed
1) one index is built per depth (sa_rate 1, kmer_d d: the ladder holds
{4, 8, d}), and on 2 batches of B simulated 100 bp reads (seeds 2, 3,
simulated and put on the device once; the k = 2 batches are their first
--k2-batch rows) it measures the exact pipeline at loc_factor 0.45 and,
where d <= L // 3, the k = 2 one at loc_factor 1.5, both at min_trips 1.
A rate is the best of 2 passes over both batches, each pass closed by
one synchronize, after one untimed warm call
(bwtpu_torch.bench.device_rate); an overflow counts the rows with a
non-zero incompleteness count plus the compaction overflow, summed over
the batches (the larger of the 2 passes), and is reported, not refused.
Prints the reference's row per depth and its closing results line.

Nothing falls back to the CPU: without a card the run fails unless
--device cpu, which runs the kernels' plain versions. --quick only
shrinks the sizes (50 kbp, B 1,024, depths 4 and 7).

Run: python3 scripts/torch_sweep_depth.py [--quick] [--depths 9 10 11 12]
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="smoke scale (50 kbp, B 1,024, depths 4 and 7)")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--k2-batch", type=int, default=None)
    ap.add_argument("--depths", type=int, nargs="*", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_sweep_depth: no CUDA device (torch.cuda.is_available() is "
                         "false); --device cpu runs the plain-torch versions")
    device = torch.device(args.device)

    from bwtpu_torch.bench import device_rate, overflow_count, pack_batches
    from bwtpu_torch.config import EngineConfig
    from bwtpu_torch.engine import (exact_pipeline_packed, inexact_pipeline_packed,
                                    upload_index)
    from bwtpu_torch.hosttune import tune_malloc
    from bwtpu_torch.index import build_fm_index
    from bwtpu_torch.kernels import _build
    from bwtpu_torch.simulate import ECOLI_SCALE, random_genome

    tune_malloc()
    if device.type == "cuda":
        _build.build_all(_build.SOURCES)
    L = 100
    n = 50_000 if args.quick else ECOLI_SCALE
    B = args.batch or (1024 if args.quick else 524288)
    Bk = args.k2_batch or (1024 if args.quick else 262144)
    depths = args.depths or ([4, 7] if args.quick else [9, 10, 11, 12])
    genome = random_genome(n, seed=1)

    encs, _ = pack_batches(genome, B, 2, L, 2, device)
    encs_k = [(rw[:Bk], ab[:Bk]) for rw, ab in encs]

    def over_sum(outs):
        return (sum(overflow_count(o, 4, 5) for o in outs),)

    results = {"config": f"depth sweep n={n} B={B} Bk={Bk}", "rows": []}
    for d in depths:
        cfg = EngineConfig(sa_rate=1, max_hits=4, max_cand=8, read_len=L, kmer_d=d)
        idx = build_fm_index(genome, cfg)
        shard = upload_index([idx], device)[0]

        def fx(rw, ab):
            return exact_pipeline_packed(shard, rw, ab, L=L, d=d, max_hits=cfg.max_hits,
                                         sa_rate=1, loc_factor=0.45, min_trips=1)
        best, (over,) = device_rate(fx, encs, B, device, over_sum)
        row = {"d": d, "exact_rps": round(best, 1), "exact_overflow": over,
               "table_mb": round(4 ** d * 8 / 1e6, 1)}
        if d <= L // 3:
            def fi(rw, ab):
                return inexact_pipeline_packed(shard, rw, ab, L=L, k=2, d=d,
                                               max_loc=cfg.max_cand, sa_rate=1,
                                               loc_factor=1.5, min_trips=1)
            bestk, (overk,) = device_rate(fi, encs_k, Bk, device, over_sum)
            row["k2_rps"] = round(bestk, 1)
            row["k2_overflow"] = overk
        results["rows"].append(row)
        print(json.dumps(row), flush=True)
        del shard, idx
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps(results))
    print(f"# launches {json.dumps(_build.launch_counts())}", file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
