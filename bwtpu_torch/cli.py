"""bwtpu_torch command line (counterpart of the repository's cli.py).

Subcommands:
  build-index  FASTA -> index artifact: the port's copy of the builder
               of `cli.py build-index`, with its options and defaults;
               the artifact is the one bwtpu writes and reads (any number
               of shards: one per ~256 Mbp by default, or --shards N)
  align        index + single-end or paired reads -> SAM, streamed in
               batches with a checkpointed batch cursor for resume. Routed
               as cli.py routes them: uniform-length FASTQ -> columnar
               blocks (paired: both mates stacked into one dispatch),
               mixed-length FASTQ -> one block per read length, FASTA (or
               reads longer than the index's read_len, or --rescore) ->
               Read lists. --tiered (exact first, seed expansion of the
               rest), --esc-factor, --autotune-caps, --min-insert,
               --max-insert and --rescore (banded Smith-Waterman score of
               each primary hit as an AS:i tag, single-end) as in cli.py
  simulate     deterministic random genome + reads (+ pairs), byte-equal
               to `cli.py simulate`'s files for the same arguments
  scaling      the ring's reads/s over 1, 2, 4, ... data groups of
               --shards ranks (bwtpu_torch.dist), under torchrun
  bench        bench.py's benchmark on the port (bwtpu_torch.bench; its
               options: --smoke, --cpu, --batch, --nbatches): one JSON line

Examples:
  python -m bwtpu_torch.cli build-index ref.fa idx/ --sa-rate 8
  python -m bwtpu_torch.cli align idx/ reads.fq -o out.sam -k 2 --device cuda
  python -m bwtpu_torch.cli align idx/ reads.fa -o out.sam -k 2 --device cpu
  python -m bwtpu_torch.cli align idx/ reads.fq -o out.sam -k 2 --tiered --autotune-caps
  python -m bwtpu_torch.cli align idx/ r1.fq --paired r2.fq -o out.sam -k 2
  python -m bwtpu_torch.cli align idx/ reads.fa -o out.sam -k 2 --rescore
  python -m bwtpu_torch.cli simulate --scale ecoli -o data/sim --pairs 1000
  torchrun --nproc-per-node 4 -m bwtpu_torch.cli scaling --shards 2
  python -m bwtpu_torch.cli align idx/ reads.fq -o out.sam -k 2 --profile prof/
  python -m bwtpu_torch.cli bench --smoke --cpu

The device defaults to cuda and never falls back: without a card the
align command fails (pass --device cpu for the plain-torch versions).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

log = logging.getLogger("bwtpu_torch.cli")


def cmd_build_index(args):
    """FASTA -> sharded index artifact (cli.py's cmd_build_index on the
    port's host layer)."""
    from bwtpu_torch.config import EngineConfig
    from bwtpu_torch.index import build_sharded_index, save_index
    from bwtpu_torch.io import read_fasta

    t0 = time.time()
    genome, contigs = read_fasta(args.fasta)
    cfg = EngineConfig(
        sa_rate=args.sa_rate,
        kmer_d=args.kmer_d,
        read_len=args.read_len,
        max_hits=args.max_hits,
        max_cand=args.max_cand,
    )
    n_shards = args.shards
    if n_shards == 0:  # auto: keep every shard under ~256 Mbp
        n_shards = max(1, -(-len(genome) // (256 * 10**6)))
    shards, manifest = build_sharded_index(
        genome, n_shards, config=cfg, contigs=contigs, overlap=args.overlap,
        jobs=args.jobs,
    )
    save_index(args.out, shards, manifest)
    total_bytes = sum(
        s.search_lattice.nbytes + s.ssa.nbytes + s.text_packed.nbytes
        + s.mark_rank_ck.nbytes
        + sum(t.nbytes for t in s.kmer_tables.values())
        for s in shards
    )
    print(
        f"built index: {len(genome)} bp, {len(contigs)} contig(s), "
        f"{n_shards} shard(s), {total_bytes/1e6:.1f} MB, "
        f"{time.time()-t0:.1f}s -> {args.out}"
    )


def _align_block_stream(engine, stream, manifest, out_path, k, tiered, bs,
                        start_batch, cursor_path, mode):
    """Columnar single-end path: ReadBlock batches -> device -> FlatHits
    -> primary SAM records through the C formatter. finish_block runs on
    one worker thread so host assembly overlaps the next batch's device
    work; SAM and the cursor are written strictly in order."""
    from bwtpu_torch.results import ContigTable, select_primary_flat
    from bwtpu_torch.sam import sam_header
    from bwtpu_torch.samfast import emit_single

    ctable = ContigTable.build(manifest.contigs)
    out = (sys.stdout.buffer if out_path in (None, "-")
           else open(out_path, mode + "b"))
    t_start = time.time()
    total = 0
    ex = ThreadPoolExecutor(max_workers=1)

    def process(handle):
        flat = engine.finish_block(handle)
        return flat, select_primary_flat(flat)

    try:
        if mode == "w":
            out.write(sam_header(manifest.contigs).encode())
        inflight = []

        def drain_one():
            nonlocal total
            bi0, t0, sub, fut = inflight.pop(0)
            flat, prim = fut.result()
            out.write(emit_single(sub, prim, ctable, truncated=flat.truncated))
            total += sub.n
            print(json.dumps({
                "event": "batch", "batch": bi0, "reads": sub.n,
                "hits": int(len(flat.read_idx)),
                "reads_per_s": round(sub.n / (time.time() - t0), 1),
                "ms": round((time.time() - t0) * 1e3, 1),
            }), file=sys.stderr)
            _save_cursor(cursor_path, bi0 + 1)

        for bi, sub in enumerate(stream, start=start_batch):
            handle = engine.dispatch_block(sub, k, pad_to=bs, tiered=tiered)
            inflight.append((bi, time.time(), sub, ex.submit(process, handle)))
            if len(inflight) > 3:
                drain_one()
        while inflight:
            drain_one()
    finally:
        ex.shutdown(wait=True)
        if out is not sys.stdout.buffer:
            out.close()
    return total, t_start


def _align_ragged_block_stream(engine, gen, manifest, out_path, k, tiered,
                               start_batch, cursor_path, mode):
    """Mixed-length FASTQ: each input-order chunk dispatches one columnar
    block per distinct read length (padded to the next power of two) and
    emits in INPUT order (samfast.reorder_sam_records). finish_block runs
    on one worker thread; SAM and the cursor are written in order."""
    from bwtpu_torch.results import ContigTable, select_primary_flat
    from bwtpu_torch.sam import sam_header
    from bwtpu_torch.samfast import emit_single, reorder_sam_records

    ctable = ContigTable.build(manifest.contigs)
    out = (sys.stdout.buffer if out_path in (None, "-")
           else open(out_path, mode + "b"))
    t_start = time.time()
    total = 0
    ex = ThreadPoolExecutor(max_workers=1)

    def process(handles):
        blobs, idxs, n = [], [], 0
        for blk, sub, h in handles:
            flat = engine.finish_block(h)
            prim = select_primary_flat(flat)
            blobs.append(emit_single(blk, prim, ctable, truncated=flat.truncated))
            idxs.append(sub)
            n += blk.n
        return reorder_sam_records(blobs, idxs), n

    try:
        if mode == "w":
            out.write(sam_header(manifest.contigs).encode())
        inflight = []

        def drain_one():
            nonlocal total
            bi0, t0, fut = inflight.pop(0)
            blob, nreads = fut.result()
            out.write(blob)
            total += nreads
            print(json.dumps({
                "event": "batch", "batch": bi0, "reads": nreads,
                "reads_per_s": round(nreads / (time.time() - t0), 1),
                "ms": round((time.time() - t0) * 1e3, 1),
            }), file=sys.stderr)
            _save_cursor(cursor_path, bi0 + 1)

        for bi, groups in enumerate(gen, start=start_batch):
            handles = []
            for blk, sub in groups:
                pad = 1 << max(0, (blk.n - 1).bit_length())
                handles.append((blk, sub, engine.dispatch_block(blk, k, pad_to=pad,
                                                                tiered=tiered)))
            inflight.append((bi, time.time(), ex.submit(process, handles)))
            if len(inflight) > 2:
                drain_one()
        while inflight:
            drain_one()
    finally:
        ex.shutdown(wait=True)
        if out is not sys.stdout.buffer:
            out.close()
    return total, t_start


def _align_read_lists(engine, reads, manifest, out_path, k, bs, start_batch,
                      cursor_path, mode, rescore=False):
    """Read-list path (FASTA, FASTQ the columnar readers refuse, or
    --rescore): Engine.dispatch_batch / finish_batch with a few batches in
    flight, SAM through sam.emit_sam; SAM and the cursor in order.
    rescore: each primary hit's banded Smith-Waterman score
    (sw.rescore_candidates, on the engine's device) as an AS:i tag."""
    from bwtpu_torch.golden import select_primary
    from bwtpu_torch.sam import emit_sam, sam_header
    from bwtpu_torch import sw

    out = sys.stdout if out_path in (None, "-") else open(out_path, mode)
    t_start = time.time()
    total = 0
    try:
        if mode == "w":
            out.write(sam_header(manifest.contigs))
        inflight = []

        def drain_one():
            nonlocal total
            bi0, t0, chunk, handle = inflight.pop(0)
            hits = engine.finish_batch(handle)
            tags = None
            if rescore:
                primaries = [[select_primary(h)[0]] if h else [] for h in hits]
                tags = sw.as_tags(sw.rescore_candidates(engine, chunk, primaries),
                                  len(chunk))
            emit_sam(chunk, hits, manifest.contigs, out, header=False, tags_per_read=tags)
            total += len(chunk)
            _log_batch(bi0, len(chunk), hits, t0)
            _save_cursor(cursor_path, bi0 + 1)

        for bi in range(0, len(reads), bs):
            if bi // bs < start_batch:
                continue
            chunk = reads[bi : bi + bs]
            inflight.append((bi // bs, time.time(), chunk,
                             engine.dispatch_batch(chunk, k)))
            if len(inflight) > 3:
                drain_one()
        while inflight:
            drain_one()
    finally:
        if out is not sys.stdout:
            out.close()
    return total, t_start


def _align_paired_block_stream(engine, stream1, stream2, manifest, out_path, k, tiered,
                               bs, start_batch, cursor_path, mode, min_insert, max_insert):
    """Columnar paired path: both mates of a chunk stack on the batch axis
    into ONE dispatch (pad_to = 2 * bs); pairing is vectorised
    (results.select_pairs) and the chunk emits through one interleaved
    C-formatter call (samfast.emit_paired). --tiered is passed through as
    cli.py does (reference fault C.1: pairs are chosen from hit lists the
    stratum contract may cut short). finish_block and the pairing run on
    one worker thread; SAM and the cursor are written in order."""
    from bwtpu_torch.readblock import concat_blocks
    from bwtpu_torch.results import (ContigTable, select_pairs, select_primary_flat,
                                     split_flat)
    from bwtpu_torch.sam import sam_header
    from bwtpu_torch.samfast import emit_paired

    ctable = ContigTable.build(manifest.contigs)
    out = (sys.stdout.buffer if out_path in (None, "-")
           else open(out_path, mode + "b"))
    t_start = time.time()
    total = 0
    ex = ThreadPoolExecutor(max_workers=1)

    def process(sub1, sub2, handle):
        flat = engine.finish_block(handle)
        f1, f2 = split_flat(flat, sub1.n)
        choice = select_pairs(f1, f2, sub1.L, sub2.L, min_insert, max_insert)
        return emit_paired(sub1, sub2, f1, f2, choice, select_primary_flat(f1),
                           select_primary_flat(f2), ctable)

    try:
        if mode == "w":
            out.write(sam_header(manifest.contigs).encode())
        inflight = []

        def drain_one():
            nonlocal total
            bi0, t0, n_pair, fut = inflight.pop(0)
            out.write(fut.result())
            total += 2 * n_pair
            print(json.dumps({
                "event": "batch", "batch": bi0, "reads": 2 * n_pair,
                "reads_per_s": round(2 * n_pair / (time.time() - t0), 1),
                "ms": round((time.time() - t0) * 1e3, 1),
            }), file=sys.stderr)
            _save_cursor(cursor_path, bi0 + 1)

        for bi, (sub1, sub2) in enumerate(zip(stream1, stream2), start=start_batch):
            if sub1.n != sub2.n:
                raise SystemExit("paired files differ in read count")
            handle = engine.dispatch_block(concat_blocks(sub1, sub2), k, pad_to=2 * bs,
                                           tiered=tiered)
            inflight.append((bi, time.time(), sub1.n, ex.submit(process, sub1, sub2, handle)))
            if len(inflight) > 3:
                drain_one()
        while inflight:
            drain_one()
    finally:
        ex.shutdown(wait=True)
        if out is not sys.stdout.buffer:
            out.close()
    return total, t_start


def _align_paired_read_lists(engine, reads, reads2, manifest, out_path, k, bs,
                             start_batch, cursor_path, mode, min_insert, max_insert):
    """Read-list paired path (FASTA, mates the columnar readers refuse,
    or --rescore, which adds no tag here, as in cli.py): align_batch on
    each mate's chunk, then sam.pair_and_emit_sam."""
    from bwtpu_torch.sam import pair_and_emit_sam, sam_header

    if len(reads2) != len(reads):
        raise SystemExit("paired files differ in read count")
    out = sys.stdout if out_path in (None, "-") else open(out_path, mode)
    t_start = time.time()
    total = 0
    try:
        if mode == "w":
            out.write(sam_header(manifest.contigs))
        for bi in range(0, len(reads), bs):
            if bi // bs < start_batch:
                continue
            t0 = time.time()
            r1, r2 = reads[bi : bi + bs], reads2[bi : bi + bs]
            h1, h2 = engine.align_batch(r1, k=k), engine.align_batch(r2, k=k)
            pair_and_emit_sam(list(zip(r1, r2)), h1, h2, manifest.contigs, out,
                              min_insert=min_insert, max_insert=max_insert, header=False)
            total += 2 * len(r1)
            _log_batch(bi // bs, 2 * len(r1), h1 + h2, t0)
            _save_cursor(cursor_path, bi // bs + 1)
    finally:
        if out is not sys.stdout:
            out.close()
    return total, t_start


def cmd_align(args) -> dict:
    """Align; returns the summary that is also printed to stderr."""
    from bwtpu_torch.index import load_index
    from bwtpu_torch.io import read_reads
    from bwtpu_torch.readblock import read_fastq_stream, read_fastq_stream_ragged
    from bwtpu_torch.engine import Engine

    shards, manifest = load_index(args.index)
    if args.esc_factor is not None:
        shards = [dataclasses.replace(s, config=s.config.replace(esc_factor=args.esc_factor))
                  for s in shards]
    engine = Engine(shards, device=args.device)
    k = args.k if args.k is not None else shards[0].config.k
    bs = args.batch_size
    read_len = engine.config.read_len
    if args.autotune_caps:
        _autotune(engine, args.reads, k, bs)

    cursor_path = (args.out + ".cursor") if args.out and args.out != "-" else None
    start_batch = 0
    if args.resume and cursor_path and os.path.exists(cursor_path):
        with open(cursor_path) as f:
            start_batch = json.load(f)["next_batch"]
        log.info("resuming at batch %d", start_batch)
    mode = "a" if (args.resume and start_batch > 0) else "w"
    where = (manifest, args.out, k)
    inserts = (args.min_insert, args.max_insert)

    if not args.rescore and not args.profile:  # both run on the Read lists
        res = read_fastq_stream(args.reads, bs, start=start_batch)
        if args.paired:
            res2 = read_fastq_stream(args.paired, bs, start=start_batch)
            if (res is not None and res2 is not None and res[:2] == res2[:2]
                    and 0 < res[1] <= read_len):
                total, t_start = _align_paired_block_stream(
                    engine, res[2], res2[2], *where, args.tiered, bs, start_batch,
                    cursor_path, mode, *inserts)
                return _print_summary(engine, total, t_start)
        elif res is not None and 0 < res[1] <= read_len:
            total, t_start = _align_block_stream(
                engine, res[2], *where, args.tiered, bs, start_batch, cursor_path, mode)
            return _print_summary(engine, total, t_start)
        elif res is None:
            resr = read_fastq_stream_ragged(args.reads, bs, start=start_batch)
            if resr is not None and 0 < resr[1] <= read_len:
                total, t_start = _align_ragged_block_stream(
                    engine, resr[2], *where, args.tiered, start_batch, cursor_path, mode)
                return _print_summary(engine, total, t_start)
    with _profiler(args.profile, engine.device):
        if args.paired:
            total, t_start = _align_paired_read_lists(
                engine, read_reads(args.reads), read_reads(args.paired), *where, bs,
                start_batch, cursor_path, mode, *inserts)
        else:
            total, t_start = _align_read_lists(
                engine, read_reads(args.reads), *where, bs, start_batch, cursor_path, mode,
                rescore=args.rescore)
    return _print_summary(engine, total, t_start)


def _profiler(trace_dir, device):
    """align --profile: a torch.profiler window (CPU activity, and CUDA
    activity on a card) whose Chrome trace is written into trace_dir,
    created if needed, as <host>_<pid>.<ms>.pt.trace.json; without a
    directory, no profiler."""
    if not trace_dir:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    os.makedirs(trace_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    return profile(activities=acts, on_trace_ready=tensorboard_trace_handler(trace_dir))


def _autotune(engine, reads_path, k, bs) -> None:
    """Probe the first chunk at the configured ceilings and size the
    candidate/hit capacities to the measured occupancy
    (Engine.autotune_caps); prints the same autotune event as cli.py. An
    input the columnar reader does not take (FASTA, mixed lengths, reads
    longer than read_len) skips tuning; an unreadable one is logged and
    skips it, as in cli.py. The probe itself runs outside any handler: a
    kernel build or launch failure, or a CUDA error, propagates."""
    from bwtpu_torch.readblock import read_fastq_stream

    try:
        res = read_fastq_stream(reads_path, bs)
        sample = next(res[2], None) if res else None
    except (OSError, ValueError) as e:
        log.warning("autotune-caps skipped: %s", e)
        return
    if sample is None or not 0 < sample.L <= engine.config.read_len:
        return
    lf = engine.autotune_caps(sample, k, pad_to=bs)
    print(json.dumps({"event": "autotune", "loc_factor": lf,
                      "hit_factor": engine._hf(k)}), file=sys.stderr)


def cmd_simulate(args):
    """Random genome (ref.fa), simulated reads (reads.fq, truth.json) and,
    with --pairs, FR pairs (reads_1.fq, reads_2.fq, truth_pairs.json):
    cli.py's cmd_simulate on the port's host copies."""
    from bwtpu_torch.io import write_fasta, write_fastq
    from bwtpu_torch.simulate import (CHR21_SCALE, ECOLI_SCALE, PHIX_SCALE, random_genome,
                                      simulate_pairs, simulate_reads)

    scale = {"phix": PHIX_SCALE, "ecoli": ECOLI_SCALE, "chr21": CHR21_SCALE}.get(args.scale)
    n = scale if scale else int(args.scale)
    os.makedirs(args.out, exist_ok=True)
    genome = random_genome(n, seed=args.seed)
    write_fasta(os.path.join(args.out, "ref.fa"), [("sim1", genome)])
    reads, truth = simulate_reads(
        genome, args.n_reads, read_len=args.read_len, max_mismatches=args.mismatches,
        n_frac=args.n_frac, seed=args.seed + 1)
    write_fastq(os.path.join(args.out, "reads.fq"), reads)
    with open(os.path.join(args.out, "truth.json"), "w") as f:
        json.dump(truth, f)
    if args.pairs:
        pairs, ptruth = simulate_pairs(genome, args.pairs, read_len=args.read_len,
                                       seed=args.seed + 2)
        write_fastq(os.path.join(args.out, "reads_1.fq"), [p[0] for p in pairs])
        write_fastq(os.path.join(args.out, "reads_2.fq"), [p[1] for p in pairs])
        with open(os.path.join(args.out, "truth_pairs.json"), "w") as f:
            json.dump(ptruth, f)
    print(f"simulated {n} bp genome + {args.n_reads} reads -> {args.out}")


def cmd_scaling(args):
    """Ring-scaling harness (cli.py's cmd_scaling on torch.distributed):
    run under torchrun, it aligns the same simulated reads over n_data =
    1, 2, 4, ... data groups of --shards ranks while shards * n_data <=
    the world, and prints reads/s and the efficiency against n_data = 1
    from rank 0. The ranks outside a row wait for it. One process without
    torchrun is a world of one."""
    import torch.distributed as dist

    from bwtpu_torch import multihost
    from bwtpu_torch.config import EngineConfig
    from bwtpu_torch.dist import DistEngine, make_layout
    from bwtpu_torch.index import build_sharded_index
    from bwtpu_torch.simulate import random_genome, simulate_reads

    dev, created = multihost.initialize(None, 1, 0, args.device)
    try:
        cfg = EngineConfig(sa_rate=8, max_hits=4, max_cand=8, read_len=args.read_len)
        genome = random_genome(args.genome_bp, seed=1)
        shards, manifest = build_sharded_index(genome, args.shards, config=cfg,
                                               overlap=cfg.read_len * 2)
        reads, _ = simulate_reads(genome, args.n_reads, read_len=args.read_len,
                                  max_mismatches=2, seed=2)
        world, me = dist.get_world_size(), dist.get_rank()
        base, rows, transport, nd = None, [], None, 1
        while args.shards * nd <= world:
            n = args.shards * nd
            lay = make_layout(args.shards, list(range(n)))
            if lay is not None:
                eng = DistEngine(shards, manifest, layout=lay, device=dev)
                transport = eng.transport
                # rank r aligns block r of each batch, as bwtpu's devices do
                warm, b = 2, -(-len(reads) // n)
                eng.align_batch(reads[lay.rank * warm:(lay.rank + 1) * warm], k=args.k)
                lay.total(0)  # start together
                t0 = time.time()
                eng.align_batch(reads[lay.rank * b:(lay.rank + 1) * b], k=args.k)
                lay.total(0)  # the last rank's end
                rps = len(reads) / (time.time() - t0)
                base = rps if base is None else base
                rows.append({"n_data": nd, "devices": n, "reads_per_s": round(rps, 1),
                             "efficiency": round(rps / (base * nd), 3)})
            dist.barrier()
            nd *= 2
        line = {"event": "scaling", "shards": args.shards, "rows": rows,
                "device": str(dev), "transport": transport}
        if me == 0:
            print(json.dumps(line))
        return line
    finally:
        if created:
            dist.destroy_process_group()


def _print_summary(engine, total, t_start) -> dict:
    from bwtpu_torch import trace

    dt = time.time() - t_start
    st = engine.stats
    summary = {
        "event": "summary", "device": str(engine.device), "reads": total,
        "hits": st.hits, "reads_per_s": round(total / dt, 1),
        "wall_s": round(dt, 2), "device_s": round(st.device_s, 2),
        "host_s": round(st.host_s, 2), "overflow_reads": st.overflow_reads,
        "compact_overflows": st.compact_overflows, "heals": st.heals,
        "escalated": st.escalated, "truncated_reads": st.truncated_reads,
    }
    spans, counters = trace.totals()  # everything the recorder holds
    summary["spans"] = {n: [c, round(w, 4), round(u, 4)] for n, (c, w, u) in spans.items()}
    summary["counters"] = counters
    print(json.dumps(summary), file=sys.stderr)
    return summary


def _log_batch(bid, n, hits, t0):
    dt = time.time() - t0
    print(json.dumps({
        "event": "batch", "batch": bid, "reads": n,
        "hits": sum(len(h) for h in hits),
        "reads_per_s": round(n / dt, 1), "ms": round(dt * 1e3, 1),
    }), file=sys.stderr)


def _save_cursor(path, next_batch):
    if path:
        with open(path, "w") as f:
            json.dump({"next_batch": next_batch}, f)


def main(argv=None):
    """Parse argv and run the subcommand; returns what it returns."""
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s %(message)s")
    from bwtpu_torch.hosttune import tune_malloc

    tune_malloc()
    p = argparse.ArgumentParser(prog="bwtpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build-index", help="build an FM-index artifact")
    b.add_argument("fasta")
    b.add_argument("out")
    b.add_argument("--shards", type=int, default=0, help="0 = auto")
    b.add_argument("--sa-rate", type=int, default=8)
    b.add_argument("--kmer-d", type=int, default=None)
    b.add_argument("--read-len", type=int, default=100)
    b.add_argument("--max-hits", type=int, default=16)
    b.add_argument("--max-cand", type=int, default=32)
    b.add_argument("--overlap", type=int, default=256)
    b.add_argument("--jobs", type=int, default=1,
                   help="parallel shard-build processes")
    b.set_defaults(fn=cmd_build_index)

    a = sub.add_parser("align", help="align reads, emit SAM")
    a.add_argument("index")
    a.add_argument("reads")
    a.add_argument("-o", "--out", default="-")
    a.add_argument("-k", type=int, default=None, help="max mismatches (default: index config)")
    a.add_argument("--batch-size", type=int, default=16384)
    a.add_argument("--device", default="cuda",
                   help="torch device: cuda (the kernels) or cpu (plain torch)")
    a.add_argument("--resume", action="store_true",
                   help="resume from <out>.cursor after an interrupted run")
    a.add_argument("--paired", help="mate FASTQ for paired-end")
    a.add_argument("--min-insert", type=int, default=0)
    a.add_argument("--max-insert", type=int, default=1000)
    a.add_argument("--tiered", action="store_true",
                   help="exact-first tiered inexact search: only reads with no "
                        "exact hit escalate to the seed expansion (stratum "
                        "contract: primary/MAPQ identical to full enumeration)")
    a.add_argument("--esc-factor", type=float, default=None,
                   help="tiered: escalated-read capacity as a fraction of the "
                        "batch (default: index config, 1.0)")
    a.add_argument("--autotune-caps", action="store_true",
                   help="probe the first chunk and size the candidate/hit "
                        "capacities to measured occupancy")
    a.add_argument("--rescore", action="store_true",
                   help="banded Smith-Waterman rescore of each primary hit; adds "
                        "an AS:i tag (single-end, Read-list path)")
    a.add_argument("--profile", metavar="DIR",
                   help="write a torch.profiler Chrome trace of the alignment loop "
                        "into DIR (takes the Read-list route, as cli.py does)")
    a.set_defaults(fn=cmd_align)

    sm = sub.add_parser("simulate", help="generate test genome + reads")
    sm.add_argument("--scale", default="phix", help="phix|ecoli|chr21|<bp>")
    sm.add_argument("-o", "--out", default="data/sim")
    sm.add_argument("--n-reads", type=int, default=1000)
    sm.add_argument("--read-len", type=int, default=100)
    sm.add_argument("--mismatches", type=int, default=2)
    sm.add_argument("--n-frac", type=float, default=0.0)
    sm.add_argument("--pairs", type=int, default=0)
    sm.add_argument("--seed", type=int, default=0)
    sm.set_defaults(fn=cmd_simulate)

    sc = sub.add_parser("scaling", help="ring-scaling efficiency harness (under torchrun)")
    sc.add_argument("--shards", type=int, default=2)
    sc.add_argument("--genome-bp", type=int, default=200_000)
    sc.add_argument("--n-reads", type=int, default=2048)
    sc.add_argument("--read-len", type=int, default=100)
    sc.add_argument("-k", type=int, default=0)
    sc.add_argument("--device", default="cuda",
                    help="cuda (cuda:LOCAL_RANK, NCCL) or cpu (gloo)")
    sc.set_defaults(fn=cmd_scaling)

    sub.add_parser("bench", add_help=False,  # its options: bwtpu_torch.bench
                   help="bench.py's benchmark on the port (bwtpu_torch.bench)")

    args, rest = p.parse_known_args(argv)
    if args.cmd == "bench":  # bwtpu_torch.bench parses its own options
        from bwtpu_torch import bench

        return bench.main(rest)
    if rest:
        p.error(f"unrecognized arguments: {' '.join(rest)}")
    return args.fn(args)


if __name__ == "__main__":
    main()
