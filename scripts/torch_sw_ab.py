"""A/B on one CUDA card: sw_band (bwtpu_torch/sw.py::sw_score_batch) built
from several kernel sources, timed in turns on the same inputs.

The inputs have the shape of --rescore's call for one Read-list batch:
--lanes lanes, read lengths 50-100 (L 100), each lane's text window its
read's locus with 8 bases of flank on each side (Lt 116), the read a copy
of its window with up to 2 substitutions, band 8. Each source is a .cu
file with csrc/sw.cu's C entry points: bwtpu_torch/csrc/sw.cu itself (the
default), or an earlier or variant design kept outside the package, for
example in the gitignored _ab/. The sources run in
turns, forward then backward (for two: A, B, B, A), each timed as 50
back-to-back launches between one CUDA event pair behind a device sleep,
divided by 50; each result must equal sw_score_plain exactly.

Prints the card's name and power limit, for each source the loops of its
band-8 instance in SASS (instructions, DPX and other opcode counts; where
the toolkit has cuobjdump), then one JSON line: ms per call of each source
in each turn, the plain version's ms, and the card.

Run (one card): python scripts/torch_sw_ab.py
           or:  python scripts/torch_sw_ab.py --lanes 16384 \\
                    --sources _ab/parent/sw.cu bwtpu_torch/csrc/sw.cu
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def rescore_like(lanes: int, seed: int = 0):
    """int32 (text [lanes, 116], text_lens, reads [lanes, 100], read_lens):
    --rescore's shapes, each read its window's middle with <= 2
    substitutions."""
    import numpy as np

    rng = np.random.default_rng(seed)
    L, flank = 100, 8
    rl = rng.integers(50, L + 1, size=lanes).astype(np.int32)
    tl = rl + 2 * flank
    text = np.zeros((lanes, L + 2 * flank), np.int32)
    reads = np.zeros((lanes, L), np.int32)
    for b in range(lanes):
        t = rng.integers(0, 4, size=tl[b])
        r = t[flank:flank + rl[b]].copy()
        sub = rng.choice(rl[b], size=rng.integers(0, 3), replace=False)
        r[sub] = (r[sub] + 1) % 4
        text[b, :tl[b]], reads[b, :rl[b]] = t, r
    return text, tl, reads, rl


def cuda_ms(fn, reps: int = 50) -> float:
    """Device ms of one fn() call: `reps` back-to-back calls between one
    CUDA event pair, queued behind a device sleep, divided by `reps`."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def source_name(path: str) -> str:
    """The build's name of a .cu file: its path relative to
    bwtpu_torch/csrc, without `.cu`."""
    from bwtpu_torch.kernels import _build

    return os.path.relpath(os.path.splitext(os.path.abspath(path))[0], _build.CSRC)


@contextlib.contextmanager
def launching(name: str):
    """While the block runs, sw_score_batch launches the build of `name`
    (a source_name) in place of csrc/sw.cu."""
    from bwtpu_torch.kernels import _build

    lib, library = _build.library(name), _build.library
    _build.library = lambda n: lib if n == "sw" else library(n)
    try:
        yield
    finally:
        _build.library = library


def sass_summary(name: str, band: int = 8) -> list:
    """[(instructions, {opcode: count}), ...] of the loops of the source's
    band instance, largest first; [] without cuobjdump."""
    from bwtpu_torch.kernels import _build

    listing = _build.sass(name)
    if listing is None:
        return []
    loops = _build.sass_loops(listing)
    inst = [f for f in loops if "sw_band_kernel" in f and f"ILi{band}E" in f]
    return loops[inst[0]] if inst else []


def main(argv=None) -> int:
    """Run the A/B; returns 0, 1 if a source's result differed from the
    plain one, 2 without a CUDA device."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sources", nargs="+", default=["bwtpu_torch/csrc/sw.cu"],
                    help=".cu files with csrc/sw.cu's C entry points")
    ap.add_argument("--lanes", type=int, default=16384)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from bwtpu_torch.kernels import _build
    from bwtpu_torch.sw import sw_score_batch, sw_score_plain

    if not torch.cuda.is_available():
        print("torch_sw_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(smi, flush=True)
    names = [source_name(p) for p in args.sources]
    _build.build_all(names)
    args_t = [torch.from_numpy(a).cuda() for a in rescore_like(args.lanes)]
    want = sw_score_plain(*args_t)
    ok = True
    for name in names:
        with launching(name):
            got = sw_score_batch(*args_t)
        torch.cuda.synchronize()
        same = bool(torch.equal(got, want))
        ok &= same
        for size, ops in sass_summary(name)[:2]:
            dpx = {k: v for k, v in ops.items() if k.startswith(("VIADDMNMX", "VIMNMX"))}
            top = sorted(ops.items(), key=lambda kv: -kv[1])[:8]
            print(f"{name}: loop of {size} SASS instructions; DPX {dpx}; most {top}",
                  flush=True)
        print(f"{name}: equal to sw_score_plain: {same}", flush=True)
    turns = []
    for name in names + names[::-1]:
        with launching(name):
            turns.append([name, cuda_ms(lambda: sw_score_batch(*args_t))])
    plain = cuda_ms(lambda: sw_score_plain(*args_t), reps=2)
    print(json.dumps({"lanes": args.lanes, "L": 100, "Lt": 116, "band": 8, "turns": turns,
                      "plain_ms": plain, "max_score": int(want.max()),
                      "mean_read_len": float(np.mean(args_t[3].cpu().numpy())),
                      "equal": ok, "card": smi}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
