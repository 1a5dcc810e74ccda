"""Host-side attribution of the FASTQ -> SAM loop on one card: the port of
scripts/e2e_profile.py.

On a random E. coli-size genome (seed 1) at the reference's config
(sa_rate 1, max_hits 4, max_cand 8, read_len 100, loc_factor 0.75, k 0,
min_trips 1, hit_factor 0.5), --reads simulated 100 bp reads (batches of
--batch, seeds 100 + i) are written to a FASTQ in a temporary directory,
then aligned the way `align` runs a uniform FASTQ, with a wall clock
around every stage and the stages serialized (no overlap, so the
attribution is clean; the CLI overlaps finish and emit with the next
dispatch): readblock.read_fastq_block (parse), ReadBlock.slice (slice),
Engine.dispatch_block(sub, 0, pad_to=B) for every block (dispatch), then
for each block Engine.finish_block (finish), results.select_primary_flat
(primary), samfast.emit_single (emit) and the file write (write). One
block is dispatched and finished untimed first (the kernels loaded, the
allocator's blocks reserved).

On the card the launches are asynchronous: dispatch_s is the host's
issue of each block (its packing, upload and kernel launches), and
finish_s includes the wait for the card, the device-to-host copies and
the host assembly. engine_device_s is Engine.stats.device_s, the sum of
finish_block's "wait" and "fetch" spans (the host blocked on the card,
then copying the outputs from it); engine_host_s is Engine.stats.host_s,
the sum of its "assemble" spans (the last heal level's columns,
flatten_hits and truncation flags; bwtpu_torch/trace.py). Prints the
reference's JSON line.

Nothing falls back to the CPU: without a card the run fails unless
--device cpu, which runs the kernels' plain versions.

Run: python3 scripts/torch_e2e_profile.py [--reads 1048576] [--batch 262144]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reads", type=int, default=1048576)
    ap.add_argument("--batch", type=int, default=262144)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_e2e_profile: no CUDA device (torch.cuda.is_available() is "
                         "false); --device cpu runs the plain-torch versions")
    device = torch.device(args.device)

    from bwtpu_torch.config import EngineConfig
    from bwtpu_torch.engine import Engine
    from bwtpu_torch.hosttune import tune_malloc
    from bwtpu_torch.index import build_fm_index
    from bwtpu_torch.kernels import _build
    from bwtpu_torch.readblock import read_fastq_block
    from bwtpu_torch.results import ContigTable, select_primary_flat
    from bwtpu_torch.sam import sam_header
    from bwtpu_torch.samfast import emit_single
    from bwtpu_torch.simulate import ECOLI_SCALE, random_genome, simulate_reads

    tune_malloc()
    if device.type == "cuda":
        _build.build_all(_build.SOURCES)
    L = 100
    B = args.batch
    cfg = EngineConfig(sa_rate=1, max_hits=4, max_cand=8, read_len=L,
                       loc_factor=0.75, k=0, min_trips=1, hit_factor=0.5)
    genome = random_genome(ECOLI_SCALE, seed=1)
    idx = build_fm_index(genome, cfg)
    eng = Engine([idx], device=device)
    ctable = ContigTable.build(idx.contigs)

    with tempfile.TemporaryDirectory(prefix="bwtpu_torch_e2e_prof_") as d:
        fq = os.path.join(d, "reads.fq")
        n_batches = -(-args.reads // B)
        with open(fq, "w") as f:
            for i in range(n_batches):
                rds, _ = simulate_reads(genome, B, read_len=L, max_mismatches=2,
                                        seed=100 + i)
                for r in rds:
                    f.write(f"@{r.rid}.{i}\n{r.seq}\n+\n{'I' * L}\n")
        fq_mb = os.path.getsize(fq) / 1e6

        t = {k: 0.0 for k in ("parse", "slice", "dispatch", "finish",
                              "primary", "emit", "write")}

        # warm: the kernels loaded, the allocator's blocks reserved
        blk0 = read_fastq_block(fq)
        select_primary_flat(eng.finish_block(eng.dispatch_block(blk0.slice(0, B), 0,
                                                                pad_to=B)))
        del blk0

        sam = os.path.join(d, "out.sam")
        t_all = time.time()
        t0 = time.time()
        blk = read_fastq_block(fq)
        t["parse"] += time.time() - t0
        with open(sam, "wb") as out:
            out.write(sam_header(idx.contigs).encode())
            recs = []
            for i in range(0, blk.n, B):
                t0 = time.time()
                sub = blk.slice(i, i + B)
                t["slice"] += time.time() - t0
                t0 = time.time()
                h = eng.dispatch_block(sub, 0, pad_to=B)
                t["dispatch"] += time.time() - t0
                recs.append((sub, h))
            for sub, h in recs:
                t0 = time.time()
                flat = eng.finish_block(h)
                t["finish"] += time.time() - t0
                t0 = time.time()
                prim = select_primary_flat(flat)
                t["primary"] += time.time() - t0
                t0 = time.time()
                buf = emit_single(sub, prim, ctable)
                t["emit"] += time.time() - t0
                t0 = time.time()
                out.write(buf)
                t["write"] += time.time() - t0
        wall = time.time() - t_all
        sam_mb = os.path.getsize(sam) / 1e6

    print(json.dumps({
        "reads": blk.n, "fq_mb": round(fq_mb, 1),
        "sam_mb": round(sam_mb, 1),
        "wall_s": round(wall, 2),
        "serialized_reads_per_s": round(blk.n / wall, 1),
        "engine_device_s": round(eng.stats.device_s, 2),
        "engine_host_s": round(eng.stats.host_s, 2),
        **{f"{k}_s": round(v, 3) for k, v in t.items()},
    }), flush=True)
    print(f"# launches {json.dumps(_build.launch_counts())}", file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
