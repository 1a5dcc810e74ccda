"""Multi-process launcher on torch.distributed (counterpart of bwtpu/multihost.py).

Each rank is one process on one device and runs the same program, under
torchrun (env://):

    torchrun --nproc-per-node N -m bwtpu_torch.multihost \\
        --index idx/ --reads reads_{rank}.fq --out out.sam

or started by hand on each host (tcp://, as bwtpu.multihost takes it):

    python -m bwtpu_torch.multihost --coordinator host0:8476 \\
        --num-processes H --process-id h --index idx/ --reads reads_h.fq

`{rank}` in --reads, --paired and --out is replaced by the rank, since
torchrun gives every rank the same arguments. bwtpu_torch.dist lays the
ranks out as rank = data * S + shard (S = the index's shards): each ring
of S ranks holds every shard once, and each rank ingests its own read
stream.

Per-rank output: each rank writes the SAM records of ITS OWN reads
(out.sam.h<rank>; out.sam itself when there is one rank); the merge is a
plain concatenation in rank order, since the streams are disjoint.

Scheduling, as in bwtpu: reads are bucketed by length and every round
runs the packed ring at that round's length, so a mixed-length stream
costs extra rounds, never the ragged ring; output order stays input
order through a reorder buffer. Paired mates of equal length are stacked
into ONE ring per round; mixed-length pairs run one ring per mate length.
Proper pairs follow the pinned FR rule (sam.pair_and_emit_sam).

Exchange-order safety: every rank must run the same exchanges in the
same order. The schedule is a pure function of the length histograms
(element-wise max) and paired-ness of all ranks, agreed up front (two
all_gathers: paired-ness and refusals, then the histograms); a rank with
fewer reads of a length runs filler batches (dropped from the output).

Device and backend: --device cuda (default) is cuda:LOCAL_RANK with
NCCL, --device cpu is gloo. --backend gloo with a CUDA device runs
several ranks on one card, their exchanges through host memory (the
counterpart of bwtpu's --platform cpu --host-devices N: several
participants on one machine); NCCL refuses two ranks on one card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist


def initialize(coordinator: str | None, num_processes: int, process_id: int,
               device: str = "cuda", backend: str | None = None) -> tuple[torch.device, bool]:
    """Set this rank's device, then bring up the process group: env://
    under torchrun (RANK in the environment), tcp://coordinator when
    given, an in-process store for one process. Returns (device, whether
    this call created the group; an existing group is kept when its
    backend is the one asked for)."""
    from bwtpu_torch.dist import default_device

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = default_device()
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, not {dev}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev}: no CUDA device is available")
        torch.cuda.set_device(dev)  # before the group exists (NCCL)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise ValueError(f"a {dist.get_backend()} process group exists, not {backend}")
        return dev, False
    if coordinator:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                rank=process_id, world_size=num_processes)
    elif "RANK" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    elif num_processes == 1:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    else:
        raise ValueError("--num-processes > 1 needs --coordinator (or torchrun)")
    return dev, True


def run(args):
    from bwtpu_torch.hosttune import tune_malloc

    tune_malloc()  # the host's page-fault wall, as in bwtpu
    dev, created = initialize(args.coordinator, args.num_processes, args.process_id,
                              args.device, args.backend)
    try:
        return _run(args, dev)
    finally:
        if created:
            dist.destroy_process_group()


def _run(args, dev):
    from bwtpu_torch.dist import DistEngine
    from bwtpu_torch.index import load_index
    from bwtpu_torch.io import Read, read_reads
    from bwtpu_torch.kernels._build import launch_counts
    from bwtpu_torch.sam import emit_sam, pair_and_emit_sam, sam_header

    rank, world = dist.get_rank(), dist.get_world_size()
    shards, manifest = load_index(args.index)
    S = len(shards)
    if world % S != 0:
        raise SystemExit(f"{world} devices not divisible by {S} shards")
    eng = DistEngine(shards, manifest, device=dev)

    reads = read_reads(args.reads.format(rank=rank))
    reads2 = read_reads(args.paired.format(rank=rank)) if args.paired else None
    bs = args.batch_size
    Lcap = eng.config.read_len
    paired = reads2 is not None
    # a rank that refuses its input says so in the first agreement, so
    # that no rank is left waiting in the second
    problem = None
    if paired and len(reads2) != len(reads):
        problem = "paired files differ in read count"
    all_lens = [len(r.seq) for r in reads] + ([len(r.seq) for r in reads2] if paired else [])
    bad = next((x for x in all_lens if x < 1 or x > Lcap), None)
    if problem is None and bad is not None:
        problem = (f"read length {bad} outside (0, {Lcap}] (index read_len); "
                   "rebuild the index with a larger read_len")

    agg = eng.layout.agree([int(problem is not None), int(paired)])
    if agg[:, 0].any():
        raise SystemExit(problem or f"rank {int(np.flatnonzero(agg[:, 0])[0])} refused "
                                    "its reads")
    if int(agg[:, 1].min()) != int(agg[:, 1].max()):
        raise SystemExit(
            "hosts disagree on paired-ness: every host must pass "
            "--paired or none (the collective program differs)"
        )

    # ---- length-bucketed round schedule ----
    # Key = L (single) or (L1, L2) (paired). Every round runs the packed
    # ring at one uniform length; the schedule is a pure function of the
    # element-wise MAX of the ranks' key histograms (one all_gather)
    buckets: dict = {}
    if paired:
        for i, (a, b) in enumerate(zip(reads, reads2)):
            buckets.setdefault((len(a.seq), len(b.seq)), []).append(i)
        hist = np.zeros((Lcap + 1) * (Lcap + 1), dtype=np.int64)
        for key, idxs in buckets.items():
            hist[key[0] * (Lcap + 1) + key[1]] = len(idxs)
    else:
        for i, r in enumerate(reads):
            buckets.setdefault(len(r.seq), []).append(i)
        hist = np.zeros(Lcap + 1, dtype=np.int64)
        for key, idxs in buckets.items():
            hist[key] = len(idxs)
    hist = eng.layout.agree(hist).max(axis=0)
    schedule = []  # (key, n_rounds)
    for flat in np.nonzero(hist)[0]:
        key = ((int(flat) // (Lcap + 1), int(flat) % (Lcap + 1)) if paired else int(flat))
        schedule.append((key, -(-int(hist[flat]) // bs)))

    out_path = args.out.format(rank=rank)
    if world > 1:
        out_path = f"{out_path}.h{rank}"
    t0 = time.time()
    total = 0
    rounds = 0
    dispatches = 0
    with open(out_path, "w") as out:
        out.write(sam_header(manifest.contigs))

        # reorder buffer: rounds are length-bucketed, output is emitted
        # in INPUT order (deterministic resume/merge)
        results: dict = {}
        # reads still capacity-truncated after the final heal level get
        # the xo:i:1 mark the single-device block path emits
        trunc1: set = set()
        trunc2: set = set()
        next_emit = 0

        def flush():
            nonlocal next_emit, total
            run_idx = []
            while next_emit in results:
                run_idx.append(next_emit)
                next_emit += 1
            if not run_idx:
                return
            if paired:
                recs = [results.pop(i) for i in run_idx]
                pair_and_emit_sam(
                    [(reads[i], reads2[i]) for i in run_idx],
                    [r[0] for r in recs], [r[1] for r in recs],
                    manifest.contigs, out, min_insert=args.min_insert,
                    max_insert=args.max_insert, header=False,
                    tags1=["xo:i:1" if i in trunc1 else None for i in run_idx],
                    tags2=["xo:i:1" if i in trunc2 else None for i in run_idx],
                )
                total += 2 * len(run_idx)
            else:
                emit_sam(
                    [reads[i] for i in run_idx],
                    [results.pop(i) for i in run_idx],
                    manifest.contigs, out, header=False,
                    tags_per_read=["xo:i:1" if i in trunc1 else None for i in run_idx],
                )
                total += len(run_idx)

        # pipelined dispatch: a few rounds in flight so that host-side
        # assembly overlaps the ring. The dispatch order is the same on
        # every rank (same schedule), so pipelining reorders no exchange.
        inflight: list = []

        def drain_one():
            rec = inflight.pop(0)
            idxs = rec[0]
            if not paired:
                hits = eng.finish_batch(rec[1])
                tr = eng.last_truncated
                for j, i in enumerate(idxs):
                    results[i] = hits[j]
                    if tr is not None and tr[j]:
                        trunc1.add(i)
            elif len(rec) == 2:  # mates stacked in ONE ring
                hits = eng.finish_batch(rec[1])
                tr = eng.last_truncated
                for j, i in enumerate(idxs):
                    results[i] = (hits[j], hits[bs + j])
                    if tr is not None:
                        if tr[j]:
                            trunc1.add(i)
                        if tr[bs + j]:
                            trunc2.add(i)
            else:  # mixed-length pair: one ring per mate length
                hits1 = eng.finish_batch(rec[1])
                tr1 = eng.last_truncated
                hits2 = eng.finish_batch(rec[2])
                tr2 = eng.last_truncated
                for j, i in enumerate(idxs):
                    results[i] = (hits1[j], hits2[j])
                    if tr1 is not None and tr1[j]:
                        trunc1.add(i)
                    if tr2 is not None and tr2[j]:
                        trunc2.add(i)
            flush()

        for key, n_rounds in schedule:
            local = buckets.get(key, [])
            if paired:
                L1, L2 = key
                fill1 = Read(rid="__filler__", seq="A" * L1)
                fill2 = Read(rid="__filler__", seq="A" * L2)
            else:
                fill1 = Read(rid="__filler__", seq="A" * key)
            for ri in range(n_rounds):
                idxs = local[ri * bs:(ri + 1) * bs]
                rounds += 1
                if not paired:
                    chunk = [reads[i] for i in idxs]
                    chunk += [fill1] * (bs - len(chunk))
                    inflight.append((idxs, eng.dispatch_batch(chunk, k=args.k, packed=True)))
                    dispatches += 1
                else:
                    c1 = [reads[i] for i in idxs]
                    c2 = [reads2[i] for i in idxs]
                    c1 += [fill1] * (bs - len(c1))
                    c2 += [fill2] * (bs - len(c2))
                    if L1 == L2:
                        # one ring for both mates (stacked on the batch axis)
                        inflight.append((idxs, eng.dispatch_batch(c1 + c2, k=args.k,
                                                                  packed=True)))
                        dispatches += 1
                    else:
                        h1 = eng.dispatch_batch(c1, k=args.k, packed=True)
                        h2 = eng.dispatch_batch(c2, k=args.k, packed=True)
                        inflight.append((idxs, h1, h2))
                        dispatches += 2
                if len(inflight) > args.pipeline_depth:
                    drain_one()
        while inflight:
            drain_one()
        if results:
            raise RuntimeError("reorder buffer not drained")
    dt = time.time() - t0
    summary = {
        "event": "host_summary", "process": rank,
        "reads": total, "reads_per_s": round(total / max(dt, 1e-9), 1),
        "wall_s": round(dt, 2), "devices": world,
        "paired": paired, "rounds": rounds, "dispatches": dispatches,
        "packed_rounds": rounds,  # every round runs the packed ring
        "heals": eng.heals, "device": str(dev), "transport": eng.transport,
        "launches": launch_counts(),  # this process's, since the last reset
    }
    print(json.dumps(summary), file=sys.stderr)
    return summary


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--coordinator", default=None, help="host:port of process 0 (tcp://)")
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--index", required=True)
    p.add_argument("--reads", required=True, help="this rank's read stream ({rank}: the rank)")
    p.add_argument("--paired", default=None,
                   help="mate FASTQ for paired-end; every rank must pass it or none")
    p.add_argument("--out", default="out.sam")
    p.add_argument("-k", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=4096)
    p.add_argument("--pipeline-depth", type=int, default=3)
    p.add_argument("--min-insert", type=int, default=0)
    p.add_argument("--max-insert", type=int, default=1000)
    p.add_argument("--device", default="cuda",
                   help="cuda (cuda:LOCAL_RANK, the kernels), cuda:N, or cpu (plain torch)")
    p.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                   help="default: nccl on a CUDA device, gloo on the CPU; gloo with a "
                        "CUDA device runs several ranks on one card through host memory")
    return run(p.parse_args(argv))


if __name__ == "__main__":
    main()
