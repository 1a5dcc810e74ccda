"""A/B on one CUDA card: the hand-written row gather (bwtpu_torch
kernels/gather.py::row_gather_sum, csrc/gather.cu) against torch's
index_select + column sum, by table size and row width, with the card's
L2 fetch granularity hint as a probe.

The port of scripts/pallas_gather_ab.py (the TPU's A/B of gather cost
against table size, whose 295 MB table is the size of the fused
locate+verify table at E. coli scale). The same options: table sizes in
MB, row widths in int32 words (128 = a 512 B multi-step lattice record,
16 = a 64 B locv row at L 100), indices per call, and rows in flight per
row group of the kernel (the TPU kernel's outstanding DMAs). --sources
names .cu files with csrc/gather.cu's C entry points: bwtpu_torch/csrc/
gather.cu itself (the default), or an earlier or variant design kept
outside the package, for example in the gitignored _ab/; they are timed
in turns, forward then backward, --pairs times (for two: A, B, B, A per
pair). --granularity sets the L2 fetch granularity hint
(cudaLimitMaxL2FetchGranularity, bytes) for a second pass of every source
at its best depth, restored afterwards: if 32 B, 64 B and 128 B rows cost
about the same per row, the card's access granularity, not the kernel,
sets the pace.

Prints the card's name, power limit and default L2 fetch granularity,
then one JSON line per width and table size: ns per gathered row of the
plain version and of each source at each in-flight depth and turn (--reps
calls, each on fresh random indices, back to back between one CUDA event
pair behind a device sleep; the median of 3 such runs),
at each granularity, and whether every kernel result equals the plain
one (checked before timing; exact).

Run (one card): python scripts/torch_gather_ab.py
           or:  python scripts/torch_gather_ab.py --widths 8 16 32 --sizes-mb 297 \\
                    --granularity 32 64 128
           or:  python scripts/torch_gather_ab.py --widths 16 --sizes-mb 297 \\
                    --sources _ab/parent/gather.cu bwtpu_torch/csrc/gather.cu --pairs 5
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

G = 1024  # indices per block (the TPU kernel's indices per grid step)


def source_name(path: str) -> str:
    """The build's name of a .cu file: its path relative to
    bwtpu_torch/csrc, without `.cu`."""
    from bwtpu_torch.kernels import _build

    return os.path.relpath(os.path.splitext(os.path.abspath(path))[0], _build.CSRC)


@contextlib.contextmanager
def launching(name: str):
    """While the block runs, row_gather_sum launches the build of `name`
    (a source_name) in place of csrc/gather.cu."""
    from bwtpu_torch.kernels import _build

    lib, library = _build.library(name), _build.library
    _build.library = lambda n: lib if n == "gather" else library(n)
    try:
        yield
    finally:
        _build.library = library


def cuda_ms(fn, args_list, rounds: int = 3) -> float:
    """Device ms of one fn(*args) call: the calls on every args of
    args_list back to back between one CUDA event pair, queued behind a
    device sleep (so the host's per-call time does not leave the card
    idle between launches), divided by their number; the median of
    `rounds` such runs, after one warm-up call."""
    import torch

    fn(*args_list[0])
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for args in args_list:
            fn(*args)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / len(args_list))
    times.sort()
    return times[len(times) // 2]


def main(argv=None) -> int:
    """Run the A/B; returns 0, 1 if a kernel result differed from the
    plain one, 2 without a CUDA device."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes-mb", type=float, nargs="*", default=[9, 36, 147, 295])
    ap.add_argument("--widths", type=int, nargs="+", default=[128],
                    help="row widths in int32 words (128 = the 512 B multi-step "
                         "lattice record, 16 = a locv row at L 100)")
    ap.add_argument("--n-idx", type=int, default=1 << 20)
    ap.add_argument("--outstanding", type=int, nargs="*", default=[4, 8, 16],
                    help="rows in flight per row group (the kernel's inflight)")
    ap.add_argument("--sources", nargs="+", default=["bwtpu_torch/csrc/gather.cu"],
                    help=".cu files with csrc/gather.cu's C entry points")
    ap.add_argument("--pairs", type=int, default=1,
                    help="forward-and-backward passes over the sources")
    ap.add_argument("--granularity", type=int, nargs="*", default=[],
                    help="L2 fetch granularity hints in bytes for the probe pass")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)

    import torch

    from bwtpu_torch.kernels import _build
    from bwtpu_torch.kernels.gather import (l2_fetch_granularity, row_gather_sum,
                                            row_gather_sum_plain)

    if not torch.cuda.is_available():
        print("torch_gather_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    names = [source_name(p) for p in args.sources]
    _build.build_all(names)
    default_gran = l2_fetch_granularity()
    print(f"{smi}; L2 fetch granularity hint {default_gran} B", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    n_idx, all_equal = args.n_idx, True
    order = (names + names[::-1]) * args.pairs if len(names) > 1 else names
    for Wr in args.widths:
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
                   "sources": {s: {} for s in names}, "equal": True}
            for s in order:
                with launching(s):
                    for K in args.outstanding:
                        got = row_gather_sum(*idxs[0], inflight=K)
                        rec["equal"] &= bool(torch.equal(got, want))
                        ns = cuda_ms(lambda t, i, g: row_gather_sum(t, i, g, K),
                                     idxs) * 1e6 / n_idx
                        rec["sources"][s].setdefault(str(K), []).append(ns)
            best = {s: min(per, key=lambda k: min(per[k])) for s, per in rec["sources"].items()}
            rec["best_inflight"] = {s: int(k) for s, k in best.items()}
            # the last source named (the current kernel when the baseline comes
            # first): its best time at each depth, as the A/B always printed it
            cur = rec["sources"][names[-1]]
            rec["kernel_ns_per_row"] = {k: min(v) for k, v in cur.items()}
            if args.granularity:
                rec["granularity_ns_per_row"] = {}
                for gbytes in args.granularity:
                    was = l2_fetch_granularity(gbytes)
                    try:
                        row = {}
                        for s in order:
                            K = best[s]
                            with launching(s):
                                ns = cuda_ms(lambda t, i, g: row_gather_sum(t, i, g, int(K)),
                                             idxs) * 1e6 / n_idx
                            row.setdefault(s, []).append(ns)
                        rec["granularity_ns_per_row"][str(gbytes)] = row
                    finally:
                        l2_fetch_granularity(was)
            rec["l2_fetch_granularity"] = default_gran
            rec["card"] = smi
            print(json.dumps(rec), flush=True)
            all_equal &= rec["equal"]
            del table, idxs
    return 0 if all_equal else 1


if __name__ == "__main__":
    sys.exit(main())
