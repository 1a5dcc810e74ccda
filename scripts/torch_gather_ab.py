"""A/B on one CUDA card: the hand-written row gather (bwtpu_torch
kernels/gather.py::row_gather_sum, csrc/gather.cu) against torch's
index_select + column sum, by table size.

The port of scripts/pallas_gather_ab.py (the TPU's A/B of gather cost
against table size, whose 295 MB table is the size of the fused
locate+verify table at E. coli scale). The same options: table sizes in
MB, row width in int32 words (128 = a 512 B multi-step lattice record,
16 = a 64 B locv row at L 100), indices per call, and rows in flight
per row group of the kernel (the TPU kernel's outstanding DMAs).

Prints the card's name and power limit, then one JSON line per table
size: ns per gathered row of the plain version and of the kernel at each
in-flight depth (median of --reps CUDA-event timings, each call on fresh
random indices), and whether the kernel's result equals the plain one
(checked before timing; exact).

Run (one card): python scripts/torch_gather_ab.py
           or:  python scripts/torch_gather_ab.py --width 16 --sizes-mb 2.3 297
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

G = 1024  # indices per CTA (the TPU kernel's indices per grid step)


def cuda_ms(fn, args_list) -> float:
    """Median CUDA-event time of fn(*args) over args_list, after one
    warm-up call."""
    import torch

    fn(*args_list[0])
    times = []
    for args in args_list:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(*args)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def main(argv=None) -> int:
    """Run the A/B; returns 0, 1 if a kernel result differed from the
    plain one, 2 without a CUDA device."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes-mb", type=float, nargs="*", default=[9, 36, 147, 295])
    ap.add_argument("--width", type=int, default=128,
                    help="row width in int32 words (128 = the 512 B multi-step "
                         "lattice record, 16 = a locv row at L 100)")
    ap.add_argument("--n-idx", type=int, default=1 << 20)
    ap.add_argument("--outstanding", type=int, nargs="*", default=[4, 8, 16],
                    help="rows in flight per row group (the kernel's inflight)")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)

    import torch

    from bwtpu_torch.kernels.gather import row_gather_sum, row_gather_sum_plain

    if not torch.cuda.is_available():
        print("torch_gather_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    Wr, n_idx = args.width, args.n_idx
    all_equal = True
    for mb in args.sizes_mb:
        N = max(int(mb * 1e6 / (Wr * 4)), 64)
        table = torch.randint(0, 1000, (N, Wr), dtype=torch.int32, device=dev,
                              generator=gen)
        idxs = [(table, torch.randint(0, N, (n_idx,), dtype=torch.int32, device=dev,
                                      generator=gen), G)
                for _ in range(args.reps)]
        want = row_gather_sum_plain(*idxs[0])
        rec = {"size_mb": mb, "table_bytes": N * Wr * 4, "rows": N, "width": Wr,
               "n_idx": n_idx, "G": G,
               "plain_ns_per_row": cuda_ms(row_gather_sum_plain, idxs) * 1e6 / n_idx,
               "kernel_ns_per_row": {}, "equal": True}
        for K in args.outstanding:
            got = row_gather_sum(*idxs[0], inflight=K)
            rec["equal"] &= bool(torch.equal(got, want))
            rec["kernel_ns_per_row"][str(K)] = cuda_ms(
                lambda t, i, g: row_gather_sum(t, i, g, K), idxs) * 1e6 / n_idx
        best = min(rec["kernel_ns_per_row"], key=rec["kernel_ns_per_row"].get)
        rec["best_inflight"] = int(best)
        rec["card"] = smi
        print(json.dumps(rec), flush=True)
        all_equal &= rec["equal"]
        del table, idxs
    return 0 if all_equal else 1


if __name__ == "__main__":
    sys.exit(main())
