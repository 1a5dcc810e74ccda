"""A/B on one CUDA card: read prep, revcomp_both (bwtpu_torch/kernels/prep.py),
built from several kernel sources, timed in turns.

The calls: B uniform reads of L bases (W = ceil(L / 16) words), random
2-bit words and sparse ambiguity bits from --seed, at the shapes given as
B:L (default: phase 5's block of 16,384 reads of 100 bp, a human-scale
block of 65,536, the bench's call of 524,288, the floor of 256 reads,
and 4,096 reads of 400 bp for the run-time-W instance).

Each source is a .cu file with csrc/prep.cu's C entry point. The earlier
one-instance design (whose `bwtpu_revcomp_both` has no `forward`
argument) runs as one variant, which writes both halves of the stacked
planes from separate rows. A source whose entry point takes `int forward` runs as
two: "<name>:inplace", the engine's call (the reads are rows [0, B) of
the planes, only the reverse half and the lengths are written) and
"<name>:forward" (separate rows, both halves written). --set NAME=V ...
builds a copy of the first source for each, with its `constexpr int
NAME` set to V (a tile's rows, a CTA's threads). The csrc/*.cuh headers
are copied beside a source that lacks them (scripts/torch_compact_ab.py's
machinery).

For every shape and variant: every output against revcomp_both_plain;
then in turns (forward, then backward, --pairs times) the whole call's
device ms (50 back-to-back calls between one CUDA event pair behind a
device sleep, divided by 50); per variant the device µs of each device
operation of a call (torch.profiler, 20 calls) and the bound of its own
bytes (kernels/bounds.py: 24 B a word forward, 16 in place, 8 a read).

Prints the card's name and power limit, each source's ptxas report, a
line per shape, then one JSON line with everything.

Run (one card): python scripts/torch_prep_ab.py \\
                    --sources bwtpu_torch/csrc/prep.cu _ab/parent/bwtpu_torch/csrc/prep.cu
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

SHAPES = ("16384:100", "65536:100", "524288:100", "256:100", "4096:400")
REPS = 50


class Variant:
    """One instance of one built source, called through its C entry point:
    form None (a one-instance source), "inplace" or "forward"."""

    def __init__(self, label: str, lib, form: str | None):
        self.name = label if form is None else f"{label}:{form}"
        self.lib, self.form = lib, form

    def outputs(self, words, amb):
        """Fresh output planes for this variant's call, and its inputs:
        (words, amb, rw2, ab2, lens2); in place the reads are copied into
        rows [0, B) of the planes and the inputs are those rows."""
        import torch

        B, W = words.shape
        rw2 = torch.empty((2 * B, W), dtype=torch.int32, device=words.device)
        ab2 = torch.empty_like(rw2)
        lens2 = torch.empty(2 * B, dtype=torch.int32, device=words.device)
        if self.form == "inplace":
            rw2[:B] = words
            ab2[:B] = amb
            words, amb = rw2[:B], ab2[:B]
        return words, amb, rw2, ab2, lens2

    def __call__(self, args, L: int) -> None:
        from bwtpu_torch.kernels import _build

        words, amb, rw2, ab2, lens2 = args
        B, W = words.shape
        head = (words.data_ptr(), amb.data_ptr(), B, W, L, rw2.data_ptr(), ab2.data_ptr(),
                lens2.data_ptr())
        extra = () if self.form is None else (int(self.form == "forward"),)
        _build.launch(self.lib, self.lib.bwtpu_revcomp_both, self.name, words, *head, *extra)

    def work(self, args, L: int):
        from bwtpu_torch.kernels.bounds import revcomp_both_work

        words, amb, rw2, ab2, _ = args
        return revcomp_both_work((words, amb, L, (rw2, ab2)))


def variants(path: str, label: str | None = None) -> list:
    """The variants of the source at `path`."""
    from torch_compact_ab import source_name

    from bwtpu_torch.kernels import _build

    with open(path) as f:
        two = re.search(r"bwtpu_revcomp_both\s*\([^)]*\bint\s+forward\b", f.read())
    lib = _build.library(source_name(path))
    label = label or os.path.relpath(os.path.splitext(os.path.abspath(path))[0], ROOT)
    p, i = ctypes.c_void_p, ctypes.c_int
    f = lib.bwtpu_revcomp_both
    f.restype = i
    if not two:
        f.argtypes = [p, p, i, i, i, p, p, p, p]
        return [Variant(label, lib, None)]
    f.argtypes = [p, p, i, i, i, p, p, p, i, p]
    return [Variant(label, lib, "inplace"), Variant(label, lib, "forward")]


def set_copies(path: str, sets: list, tmp: str) -> list:
    """(path, label) of a copy of the source at `path` for each NAME=V of
    `sets`, with its `constexpr int NAME` set to V."""
    with open(path) as f:
        src = f.read()
    label = os.path.relpath(os.path.splitext(os.path.abspath(path))[0], ROOT)
    out = []
    for k, item in enumerate(sets):
        name, value = item.split("=")
        pat = re.compile(rf"constexpr int {name} = \d+;")
        if not pat.search(src):
            raise SystemExit(f"torch_prep_ab: {path} has no `constexpr int {name}`")
        d = os.path.join(tmp, f"set{k}")
        os.makedirs(d, exist_ok=True)
        dst = os.path.join(d, "prep.cu")
        with open(dst, "w") as f:
            f.write(pat.sub(f"constexpr int {name} = {int(value)};", src))
        out.append((dst, f"{label}@{name}={int(value)}"))
    return out


def inputs(B: int, L: int, seed: int):
    """Random packed words (slots >= L zero) and sparse ambiguity bits,
    int32[B, W] on the card."""
    import numpy as np
    import torch

    W = -(-L // 16)
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(B, W), dtype=np.uint64).astype(np.uint32)
    amb = np.where(rng.random((B, W)) < 0.02,
                   rng.integers(0, 1 << 32, size=(B, W), dtype=np.uint64), 0).astype(np.uint32)
    dead = 16 * W - L
    if dead:
        keep = np.uint32((1 << (2 * (16 - dead))) - 1)
        words[:, -1] &= keep
        amb[:, -1] &= keep
    put = lambda a: torch.from_numpy(a.view(np.int32)).cuda()  # noqa: E731
    return put(words), put(amb)


def main(argv=None) -> int:
    """Run the A/B; returns 0, 1 if a variant's result differed from the
    plain one, 2 without a CUDA device."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sources", nargs="+", default=["bwtpu_torch/csrc/prep.cu"],
                    help=".cu files with csrc/prep.cu's C entry point")
    ap.add_argument("--shapes", nargs="+", default=list(SHAPES), help="B:L")
    ap.add_argument("--set", nargs="*", default=[], metavar="NAME=V",
                    help="copies of the first source, each with one constexpr int set")
    ap.add_argument("--pairs", type=int, default=2, help="forward-backward turns")
    ap.add_argument("--seed", type=int, default=20261016)
    opts = ap.parse_args(argv)

    import torch

    from torch_compact_ab import device_ops, source_name

    from bwtpu_torch.kernels import _build
    from bwtpu_torch.kernels.bounds import bound, cuda_ms
    from bwtpu_torch.kernels.prep import revcomp_both_plain

    if not torch.cuda.is_available():
        print("torch_prep_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(smi, flush=True)
    tmp = tempfile.mkdtemp(prefix="bwtpu_torch_prep_ab_")
    try:
        srcs = [(p, None) for p in opts.sources]
        if opts.set:
            srcs += set_copies(opts.sources[0], opts.set, tmp)
        _build.build_all([source_name(p) for p, _ in srcs])
        for p, label in srcs:
            name = source_name(p)
            lines = [ln.strip() for ln in _build.build_info[name]["ptxas"].splitlines()
                     if "Used" in ln or "stack frame" in ln]
            print(f"{label or p}: built in {_build.build_info[name]['seconds']:.1f} s; "
                  f"ptxas {' | '.join(lines)}", flush=True)
        vs = [v for p, label in srcs for v in variants(p, label)]
        report = {"card": smi, "shapes": []}
        ok = True
        for shape in opts.shapes:
            B, L = map(int, shape.split(":"))
            words, amb = inputs(B, L, opts.seed)
            want = revcomp_both_plain(words, amb, L)
            rec = {"reads": B, "L": L, "variants": {}}
            args = {}
            for v in vs:
                args[v.name] = v.outputs(words, amb)
                v(args[v.name], L)
                torch.cuda.synchronize()
                got = args[v.name][2:]
                same = all(torch.equal(a, b) for a, b in zip(got, want, strict=True))
                ok &= same
                nbytes, ops, what = v.work(args[v.name], L)
                rec["variants"][v.name] = {"equal": same, "what": what,
                                           **bound(nbytes, ops)}
            turns = []
            for _ in range(opts.pairs):
                turns += [[v.name, cuda_ms(lambda v=v: v(args[v.name], L), REPS)]
                          for v in vs + vs[::-1]]
            rec["turns"] = turns
            for v in vs:
                r = rec["variants"][v.name]
                mine = sorted(ms for n, ms in turns if n == v.name)
                r["ms"] = mine[len(mine) // 2]
                r["share_of_bound"] = r["bound_ms"] / r["ms"]
                r["ops_us"] = device_ops(lambda v=v: v(args[v.name], L))
            report["shapes"].append(rec)
            del args, want, words, amb
            torch.cuda.empty_cache()
            print(f"{B} reads x L {L}:", flush=True)
            print("  turns " + ", ".join(f"{n} {ms:.4f}" for n, ms in turns), flush=True)
            for n, r in rec["variants"].items():
                print(f"  {n} ({r['what']}): equal {r['equal']}; {r['ms']:.4f} ms, bound "
                      f"{r['bound_ms']:.5f} ms ({r['bound_by']}, {r['bound_bytes']} B), "
                      f"{100 * r['share_of_bound']:.0f} % of it; ops µs "
                      + ", ".join(f"{k} {u:.2f}" for k, u in r["ops_us"].items()),
                      flush=True)
        print(json.dumps(report), flush=True)
        return 0 if ok else 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
