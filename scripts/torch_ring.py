"""The ring across cards: bwtpu_torch.multihost on NCCL, one rank per card.

For each shard count S in 1, 2 and 4 that divides the number of cards: a
random genome of chr21's length (chip_smoke.py's phase 10 genome,
46,709,983 bp) built into S shards (`build-index --shards S` at the CLI
defaults), 524,288 simulated reads of 100 bp (<= 2 substitutions) split
into one stream per rank (8 batches of 16,384 a rank on 4 cards),
`python -m bwtpu_torch.multihost` on one NCCL rank per card at k = 0 and
2 (ranks started as chip_smoke.py starts them: torchrun's environment,
one untimed warm-up batch each). At S = 1 every rank is its own data
group and nothing crosses cards; at S > 1 the reads of each ring hop
S - 1 times a batch and the hits come home in one all_to_all. Each run's
merged per-rank SAM must be byte-equal to the single-process Engine's
over all S shards on card 0 (Engine.align_all + sam.emit_sam), and each
rank must launch locate_walk, verify_nm and search_chain2.

Prints the card's name and power limit, each rank's reads/s, wall, heals
and transport, then one JSON line per (S, k).

Run (every card of one host): python scripts/torch_ring.py
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHARDS = (1, 2, 4)
N_READS = 524288


def main() -> int:
    import torch

    import chip_smoke as cs
    from bwtpu_torch.index import load_index
    from bwtpu_torch.io import write_fasta
    from bwtpu_torch.simulate import simulate_reads

    if not torch.cuda.is_available():
        print("torch_ring: no CUDA device", file=sys.stderr)
        return 2
    _, smi = cs.phase_card()
    smi = "; ".join(sorted(set(smi.splitlines())))  # one line for every card
    cs.phase_build()  # before any rank starts, so that no rank runs nvcc
    world = torch.cuda.device_count()
    genome = cs.paired_genome()
    reads, _ = simulate_reads(genome, N_READS, read_len=100, max_mismatches=2,
                              seed=cs.SEED + 12)
    lines = []
    with tempfile.TemporaryDirectory(prefix="bwtpu_torch_ring_") as tmp:
        fa = os.path.join(tmp, "genome.fa")
        write_fasta(fa, [("chr21_sim", genome)])
        paths = cs.split_fastq(tmp, "reads", reads, world)
        for S in SHARDS:
            if world % S:
                cs.say(f"S = {S}: skipped ({world} ranks)")
                continue
            idx = os.path.join(tmp, f"idx{S}")
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                cs.run_cli(["build-index", fa, idx, "--shards", str(S), "--jobs", str(S)])
            shards, manifest = load_index(idx)
            cs.say(f"[S = {S}] {world} ranks, {world // S} data group(s); build-index "
                   f"{time.perf_counter() - t0:.1f} s")
            refs = {f"k{k}": cs.engine_sam(shards, manifest.contigs, reads, k) for k in (0, 2)}
            _, table = cs.ring_runs(tmp, smi, f"S{S}", "cuda", None, idx,
                                    [(f"k{k}", k, paths, None) for k in (0, 2)], refs)
            for k in (0, 2):
                row = table[f"k{k}"]
                wall = max(r["wall_s"] for r in row["ranks"])
                lines.append({
                    "shards": S, "ranks": world, "k": k, "reads": len(reads),
                    "rank_reads_per_s": [r["reads_per_s"] for r in row["ranks"]],
                    "rank_wall_s": [r["wall_s"] for r in row["ranks"]],
                    "heals": [r["heals"] for r in row["ranks"]],
                    "transport": row["ranks"][0]["transport"],
                    "reads_per_s": round(len(reads) / wall, 1),
                    "engine_reads_per_s": round(row["engine"]["reads"] / row["engine"]["wall"], 1),
                    "card": smi})
    for line in lines:
        print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
