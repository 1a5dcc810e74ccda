"""Sweep of the exact packed pipeline's locate and candidate stage on one
card: the port of scripts/sweep_locate.py.

On a random E. coli-size genome (seed 1) at sa_rate 1 the candidates
are located and verified either by one gather from the fused
locate+verify table (locv on) or by a suffix array element and a text
row apiece (locv off, verify_nm); at sa_rate 2 and 4 by a bounded LF
walk (locate_walk) and verify_nm. Each row of the grid sets sa_rate,
locv, loc_factor (the compaction cap), min_trips (candidate thinning)
and the batch size B; the default grid is the reference's nine rows.
This is the only program of the port that runs locate_walk and
verify_nm on an E. coli-size index at sa_rate 2 and 4, and at sa_rate 1
with the table off.

One index is built per sa_rate and uploaded once per row (the locv table
only at sa_rate 1 and only where the row asks for it); each row's device
tensors are freed before the next. The reads (--nbatches batches of B,
seeds 2 + i) are simulated and put on the device once per B. A row's
rate is the best of 2 passes over its batches, each pass closed by one
synchronize, after one untimed warm call (bwtpu_torch.bench.device_rate).
overflow counts the rows with a non-zero incompleteness count plus the
compaction overflow, summed over the batches (the larger of the 2
passes); cap_occ is the largest candidate count over the compaction cap
compact_cap(2B, loc_factor). Prints the reference's lines; any overflow
fails the sweep (stderr, exit 1), since a lossy row's rate is inflated.

Nothing falls back to the CPU: without a card the run fails unless
--device cpu, which runs the kernels' plain versions. --quick only
shrinks the sizes (50 kbp, B 1,024).

Run: python3 scripts/torch_sweep_locate.py [--quick] [--configs 1:1:0.75:1:524288 ...]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nbatches", type=int, default=2)
    ap.add_argument("--quick", action="store_true",
                    help="shrink to smoke scale (50 kbp, B 1,024)")
    ap.add_argument("--configs", nargs="*", default=None,
                    help="sa_rate:locv:loc_factor:min_trips:B entries")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_sweep_locate: no CUDA device (torch.cuda.is_available() is "
                         "false); --device cpu runs the plain-torch versions")
    device = torch.device(args.device)

    from bwtpu_torch.bench import device_rate, overflow_count, pack_batches
    from bwtpu_torch.config import EngineConfig
    from bwtpu_torch.engine import compact_cap, exact_pipeline_packed, upload_index
    from bwtpu_torch.index import build_fm_index
    from bwtpu_torch.kernels import _build
    from bwtpu_torch.simulate import ECOLI_SCALE, random_genome

    if device.type == "cuda":
        _build.build_all(_build.SOURCES)
    L = 100
    n_genome = 50_000 if args.quick else ECOLI_SCALE
    genome = random_genome(n_genome, seed=1)

    if args.configs:
        grid = []
        for spec in args.configs:
            sr, lv, lf, mt, B = spec.split(":")
            grid.append((int(sr), lv in ("1", "true"), float(lf), int(mt), int(B)))
    else:
        B0 = 1024 if args.quick else 524288
        grid = [
            # (sa_rate, locv, loc_factor, min_trips, B)
            (1, True, 0.75, 1, B0),
            (1, False, 0.75, 1, B0),     # suffix array element + text row
            (2, False, 0.75, 1, B0),     # LF walk
            (4, False, 0.75, 1, B0),
            (2, False, 0.5, 1, B0),      # tighter cap
            (2, False, 0.5, 2, B0),      # one more thinning trip
            (1, True, 0.5, 1, B0),
            (2, False, 0.5, 1, B0 * 2),  # bigger batch
            (1, True, 0.75, 1, B0 * 2),
        ]

    idx_cache: dict = {}
    enc_cache: dict = {}
    results = []
    any_overflow = 0
    for sa_rate, locv, loc_factor, min_trips, B in grid:
        if sa_rate not in idx_cache:
            cfg = EngineConfig(sa_rate=sa_rate, max_hits=4, max_cand=8, read_len=L)
            t0 = time.time()
            idx_cache[sa_rate] = build_fm_index(genome, cfg)
            print(f"# built index sa_rate={sa_rate} in {time.time()-t0:.1f}s", flush=True)
        idx = idx_cache[sa_rate]
        if B not in enc_cache:
            enc_cache[B] = pack_batches(genome, B, args.nbatches, L, 2, device)[0]
        shard = upload_index([idx], device, locv=locv if sa_rate == 1 else False)[0]
        d = max(dd for dd in sorted(idx.kmer_tables) if dd <= L)
        cap = compact_cap(2 * B, loc_factor)

        def fx(rw, ab):
            return exact_pipeline_packed(shard, rw, ab, L=L, d=d, max_hits=4,
                                         sa_rate=sa_rate, loc_factor=loc_factor,
                                         min_trips=min_trips)

        def stat(outs):
            return (sum(overflow_count(o, 4, 5) for o in outs),
                    max(int(o[3]) for o in outs) / cap)
        best, (over, occ) = device_rate(fx, enc_cache[B], B, device, stat)
        tag = (f"sa_rate={sa_rate} locv={int(locv)} lf={loc_factor} "
               f"mt={min_trips} B={B}")
        print(f"{tag}: {best/1e6:.3f} M reads/s  overflow={over}  "
              f"cap_occ={occ:.2f}", flush=True)
        results.append((tag, best, over))
        any_overflow += over
        del shard, fx
        if device.type == "cuda":
            torch.cuda.empty_cache()

    best_cfg = max(results, key=lambda r: r[1])
    print(f"# best: {best_cfg[0]} at {best_cfg[1]/1e6:.3f} M reads/s")
    print(f"# launches {json.dumps(_build.launch_counts())}", file=sys.stderr, flush=True)
    if any_overflow:
        print(f"ERROR: {any_overflow} overflowed rows in some configs — "
              "those rates are lossy", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
