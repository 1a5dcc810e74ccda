"""bwtpu_torch command line (counterpart of the repository's cli.py).

Subcommands:
  build-index  FASTA -> index artifact; the same builder as `cli.py
               build-index` (the artifact is shared by both packages)
  align        index + uniform-length single-end FASTQ -> SAM, streamed
               in batches with a checkpointed batch cursor for resume

Examples:
  python -m bwtpu_torch.cli build-index ref.fa idx/ --sa-rate 8
  python -m bwtpu_torch.cli align idx/ reads.fq -o out.sam -k 2 --device cuda

The device defaults to cuda and never falls back: without a card the
align command fails (pass --device cpu for the plain-torch versions).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

log = logging.getLogger("bwtpu_torch.cli")


def _align_block_stream(engine, stream, manifest, out_path, k, bs,
                        start_batch, cursor_path, mode):
    """Columnar single-end path: ReadBlock batches -> device -> FlatHits
    -> primary SAM records through the C formatter. finish_block runs on
    one worker thread so host assembly overlaps the next batch's device
    work; SAM and the cursor are written strictly in order."""
    from bwtpu.results import ContigTable, select_primary_flat
    from bwtpu.sam import sam_header
    from bwtpu.samfast import emit_single

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
            handle = engine.dispatch_block(sub, k, pad_to=bs)
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


def cmd_align(args) -> dict:
    """Align; returns the summary that is also printed to stderr."""
    from bwtpu.index import load_index
    from bwtpu.readblock import read_fastq_stream
    from bwtpu_torch.engine import Engine

    if args.paired:
        raise NotImplementedError("paired-end align is ROADMAP slice 7 of the port")
    if args.rescore:
        raise NotImplementedError("--rescore is ROADMAP slice 7 of the port")
    if args.tiered or args.autotune_caps:
        raise NotImplementedError(
            "--tiered and --autotune-caps are ROADMAP slice 4 of the port")
    shards, manifest = load_index(args.index)
    engine = Engine(shards, device=args.device)
    k = args.k if args.k is not None else shards[0].config.k
    bs = args.batch_size

    cursor_path = (args.out + ".cursor") if args.out and args.out != "-" else None
    start_batch = 0
    if args.resume and cursor_path and os.path.exists(cursor_path):
        with open(cursor_path) as f:
            start_batch = json.load(f)["next_batch"]
        log.info("resuming at batch %d", start_batch)
    mode = "a" if (args.resume and start_batch > 0) else "w"

    res = read_fastq_stream(args.reads, bs, start=start_batch)
    if res is None or not (0 < res[1] <= engine.config.read_len):
        raise NotImplementedError(
            "only uniform-length FASTQ with reads no longer than the index's "
            "read_len is covered; ragged, FASTA and Read-list input are "
            "ROADMAP slice 6 of the port")
    total, t_start = _align_block_stream(
        engine, res[2], manifest, args.out, k, bs, start_batch, cursor_path, mode,
    )
    return _print_summary(engine, total, t_start)


def _print_summary(engine, total, t_start) -> dict:
    dt = time.time() - t_start
    st = engine.stats
    summary = {
        "event": "summary", "device": str(engine.device), "reads": total,
        "hits": st.hits, "reads_per_s": round(total / dt, 1),
        "wall_s": round(dt, 2), "device_s": round(st.device_s, 2),
        "host_s": round(st.host_s, 2), "overflow_reads": st.overflow_reads,
        "compact_overflows": st.compact_overflows, "heals": st.heals,
        "truncated_reads": st.truncated_reads,
    }
    print(json.dumps(summary), file=sys.stderr)
    return summary


def _save_cursor(path, next_batch):
    if path:
        with open(path, "w") as f:
            json.dump({"next_batch": next_batch}, f)


def main(argv=None):
    """Parse argv and run the subcommand; returns what it returns."""
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s %(message)s")
    from bwtpu.hosttune import tune_malloc

    tune_malloc()
    p = argparse.ArgumentParser(prog="bwtpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    # its arguments go unparsed to cli.py build-index (see below)
    sub.add_parser("build-index", add_help=False,
                   help="build an FM-index artifact: cli.py build-index")

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
    a.add_argument("--paired", help="not covered yet (ROADMAP slice 7)")
    a.add_argument("--tiered", action="store_true", help="not covered yet (ROADMAP slice 4)")
    a.add_argument("--autotune-caps", action="store_true",
                   help="not covered yet (ROADMAP slice 4)")
    a.add_argument("--rescore", action="store_true", help="not covered yet (ROADMAP slice 7)")
    a.set_defaults(fn=cmd_align)

    args, rest = p.parse_known_args(argv)
    if args.cmd == "build-index":
        import cli  # the repository's own parser, defaults and builder

        return cli.main(["build-index", *rest])
    if rest:
        p.error(f"unrecognized arguments: {' '.join(rest)}")
    return args.fn(args)


if __name__ == "__main__":
    main()
