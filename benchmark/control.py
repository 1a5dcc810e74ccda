"""The controls and the planted faults of the check (check.py), for setting
and proving its limits; the benchmark's own runs never run them.

  python3 benchmark/control.py --workload <name> --seeds <n> ... \\
      [--variants sound tiered noheal] [--seconds 5]

One process: the cell's program once (run.Session), then for each seed and
each variant the pool, the warm-up pass, a short window and the check. One
JSON line a (variant, seed) on stdout: the numbers compared, blocks done,
reads/s. Variants:

  sound    the program as the configuration states it: the lower readings
  tiered   control: the program's own tiered path switched on (a read with
           an exact hit gets only its nm = 0 stratum), which breaks the
           guarantee of every hit within k: wrong_reads
  noheal   control: the program's heals switched off (heal_overflow), so
           capacity-cut reads are marked instead of healed:
           extra_marked_permille
  stale    fault: finish_block returns the block before's FlatHits (a step
           that returns its state unchanged)
  half     fault: the hits of the second half of each block left out
  altered  fault: the nm of the hits of every 16th read changed where
           finish_block produces it

There is one card and no exchange between cards, so that fault has no
place here. The tests drive readings() on the CPU with the plain versions.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import sys
from time import perf_counter

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0]) == HERE:
    sys.path.pop(0)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

VARIANTS = ("sound", "tiered", "noheal", "stale", "half", "altered")


def _wrap_finish(engine, alter):
    """alter(flat, state) on what finish_block returns to its caller (a heal
    calls finish_block again inside: those inner results pass unaltered)."""
    orig = engine.finish_block
    state = {"depth": 0}

    def finish(handle):
        state["depth"] += 1
        try:
            flat = orig(handle)
        finally:
            state["depth"] -= 1
        if state["depth"]:
            return flat
        out = alter(flat, state)
        state["last"] = flat
        return out

    engine.finish_block = finish


def _stale(flat, state):
    return state.get("last", flat)


def _half(flat, state):
    keep = flat.read_idx < flat.n_reads // 2
    return flat._replace(read_idx=flat.read_idx[keep], pos=flat.pos[keep],
                         strand_rev=flat.strand_rev[keep], nm=flat.nm[keep])


def _altered(flat, state):
    nm = flat.nm.copy()
    hit = flat.read_idx % 16 == 0
    nm[hit] = (nm[hit] + 1) % 3
    return flat._replace(nm=nm)


@contextlib.contextmanager
def variant(engine, name: str):
    """The engine with `name` applied, restored on exit."""
    config = engine.config
    if name == "tiered":
        engine.dispatch_block = functools.partial(type(engine).dispatch_block, engine,
                                                  tiered=True)
    elif name == "noheal":
        engine.config = config.replace(heal_overflow=False)
    elif name in ("stale", "half", "altered"):
        _wrap_finish(engine, {"stale": _stale, "half": _half, "altered": _altered}[name])
    elif name != "sound":
        raise ValueError(f"unknown variant {name!r}")
    try:
        yield engine
    finally:
        engine.config = config
        for attr in ("dispatch_block", "finish_block"):
            engine.__dict__.pop(attr, None)


def readings(sess, seeds, variants, seconds: float):
    """Yield one record a (variant, seed)."""
    from benchmark import check as chk

    limits = sess.bench.limits(sess.name)
    for seed in seeds:
        for v in variants:
            with variant(sess.engine, v):
                w, checker, pool, sample = sess.window(seed, seconds, False, perf_counter())
            numbers = sess.judge(checker, pool, sample)
            correct, _ = chk.verdict(numbers, limits)
            yield {"variant": v, "seed": seed, "correct": correct, **numbers,
                   "blocks_done": len(w.in_window()), "heals": w.heals,
                   "reads_per_s": w.reads / w.seconds}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--variants", nargs="+", default=["sound", "tiered", "noheal"],
                   choices=VARIANTS)
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)

    from benchmark.cells import Bench
    from benchmark.run import Session

    sess = Session(Bench(ROOT), args.workload)
    for rec in readings(sess, args.seeds, args.variants, args.seconds):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
