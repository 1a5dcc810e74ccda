"""The fused multi-shard dispatch against the loop, in turns on one card:
the card half of scripts/torch_scale_human.py on one kept artifact in
three forms, (a) an earlier tree's loop (--parent, imported with the
script's --package), (b) this tree's loop (the grouped fetch), (c) this
tree with --fuse (one CUDA graph replay a block), in the order a b c c b
a. Each run's output goes to --out; one JSON line a run on stdout: the
card and its power limit, exact / k <= 2 / tiered reads/s, truth and
unsound hits, heals, peak allocated and reserved memory, the busy share of
each profiled pass, per block of the timed passes the dispatch_block
wall split into pack, upload and issue and the finish_block wall split
into fetch and host assembly, and each CUDA graph's warm-up and capture
seconds.

    python3 scripts/torch_scale_human.py --jobs 5 --keep --out DIR --skip-truth
    mkdir -p _ab/parent && git archive <parent> | tar -x -C _ab/parent
    python3 scripts/torch_fuse_ab.py --index DIR --parent _ab/parent

--two-shard DIR first builds the 2-shard index of chip_smoke.py's phase 10
(a random genome of chr21's length with its repeat family, `build-index
--shards 2 --jobs 2`) into DIR and runs on it, without truth (the card
half regenerates only its own genome). Without --parent the forms are b
and c (b c c b). Other options go to torch_scale_human.py as they are.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "torch_scale_human.py")


def build_two_shard(path: str) -> None:
    """chip_smoke.py phase 10's index: `build-index --shards 2 --jobs 2` of
    its chr21-length genome."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    from bwtpu_torch.io import write_fasta

    os.makedirs(path, exist_ok=True)
    fa = os.path.join(path, "chr21.fa")
    write_fasta(fa, [("chr21_sim", chip_smoke.paired_genome())])
    with contextlib.redirect_stdout(io.StringIO()):
        chip_smoke.run_cli(["build-index", fa, os.path.join(path, "idx"), "--shards", "2",
                            "--jobs", "2"])


def summary(name: str, lines: list) -> dict:
    """The numbers of one run's card line and scale_human_chip.py line."""
    card, chip = lines[-2:]
    return {"run": name, "card": card["card"], "fused_dispatch": chip["fused_dispatch"],
            **{k: chip.get(k) for k in ("exact_reads_per_s", "k2_reads_per_s",
                                        "k2_tiered_reads_per_s", "truth_recovered",
                                        "truth_reads", "unsound_hits", "heals",
                                        "overflow_reads")},
            "max_memory_allocated_gb": card["max_memory_allocated_gb"],
            "max_memory_reserved_gb": card.get("max_memory_reserved_gb"),
            "busy_share": {k: v["busy_share"] for k, v in card["profiled_pass"].items()},
            "per_block_ms": card.get("per_block_ms"),
            "graph_captures": card.get("graph_captures")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--index", help="a kept artifact of torch_scale_human.py")
    ap.add_argument("--two-shard", metavar="DIR",
                    help="build chip_smoke.py phase 10's 2-shard index into DIR and use it")
    ap.add_argument("--parent", help="an earlier tree (form a), e.g. from git archive")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "fuse_ab"))
    ap.add_argument("--timeout", type=int, default=900, help="seconds a run")
    args, extra = ap.parse_known_args(argv)  # the rest goes to the script
    extra.append("--tiered")
    if args.two_shard:
        t0 = time.time()
        build_two_shard(args.two_shard)
        print(f"# built the 2-shard index in {time.time() - t0:.1f} s", file=sys.stderr)
        args.index = os.path.join(args.two_shard, "idx")
        extra.append("--skip-truth")
    if not args.index:
        ap.error("--index or --two-shard is required")
    forms = {"a": ["--package", args.parent]} if args.parent else {}
    forms.update(b=[], c=["--fuse"])
    order = list(forms) + list(forms)[::-1]
    os.makedirs(args.out, exist_ok=True)
    rc = 0
    for i, form in enumerate(order):
        name = f"{form}{1 + (i >= len(forms))}"
        with open(os.path.join(args.out, f"{name}.out"), "w") as f, \
                open(os.path.join(args.out, f"{name}.err"), "w") as e:
            proc = subprocess.run([sys.executable, SCRIPT, "--index", args.index, *extra,
                                   *forms[form]], cwd=ROOT, stdout=f, stderr=e, text=True,
                                  timeout=args.timeout)
        with open(os.path.join(args.out, f"{name}.out")) as f:
            lines = [json.loads(ln) for ln in f if ln.startswith("{")]
        if proc.returncode != 0 or len(lines) < 2:
            print(json.dumps({"run": name, "rc": proc.returncode}), flush=True)
            rc = 1
            continue
        print(json.dumps(summary(name, lines)), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
