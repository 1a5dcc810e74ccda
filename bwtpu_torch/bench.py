"""Benchmark harness of the port (counterpart of the repository's bench.py):
prints ONE JSON line, with bench.py's keys, as the last line of stdout.

    python -m bwtpu_torch.cli bench [--smoke] [--cpu] [--batch N] [--nbatches N]

Configuration, bench.py's: an E. coli-scale random genome (4,641,652 bp,
random_genome(seed=1)), 100 bp simulated reads with <= 2 substitutions,
both strands, EngineConfig(sa_rate=1, max_hits=4, max_cand=8,
read_len=100), so the full suffix array and the fused locate+verify
(locv) table are on the device. `--smoke` runs a 20 kbp / 1,024-read
miniature of the same code (no multihost probe).

Sections, in bench.py's order; each prints `# section <name> <seconds> s`
and `# launches <name> {kernel: launches}` on stderr as it ends:
  exact, k2, tiered, lowerr  the packed pipelines on read batches already
             on the device: warm-up call, then the best of 2 passes over
             every batch, each pass closed by one torch.cuda.synchronize()
  e2e_*      FASTQ -> SAM as `align` runs it (Engine.dispatch_block /
             finish_block, one finish thread, the C SAM formatter)
  roofline   gathered rows per read by stage (gather_model) priced at the
             rate row_gather_sum measures on the index's own tables
  multihost  bwtpu_torch.multihost on 1 and 2 hosts (weak scaling)
  golden     GoldenFMIndex's interpreted per-read rate, the CPU reference
The roofline and the multihost probe are guarded as in bench.py: a failure
prints its traceback (each line behind `# `) and leaves their keys null.

The device is the card; without one the bench fails. `--cpu` runs every
section on the plain-torch versions ("backend": "plain").
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import torch

# HBM bytes/s by device-name substring, first match wins (NVIDIA's H100
# data sheet): NVL 3.9 TB/s, PCIe 2.0 TB/s, SXM (HBM3) 3.35 TB/s
HBM_BYTES_S = (("h100 nvl", 3.9e12), ("h100 pcie", 2.0e12), ("h100", 3.35e12))
GATHER_G = 1024  # indices per row_gather_sum block
PROBE_SHARDS = 2  # the multihost probe's index shards: one rank each


def hbm_bandwidth(device_name: str | None) -> float | None:
    """HBM bytes/s of the named card; None for a card (or CPU) not listed."""
    name = (device_name or "").lower()
    return next((bw for key, bw in HBM_BYTES_S if key in name), None)


def gather_index_stream(n_rows: int, seed: int, N: int, device) -> torch.Tensor:
    """bench.py's calibration indices: int32[n_rows], row i =
    (i * (2654435761 + 2 * seed) mod 2^32) mod N."""
    i = torch.arange(n_rows, dtype=torch.int64, device=device)
    mult = (2654435761 + 2 * seed) & 0xFFFFFFFF
    return (((i * mult) & 0xFFFFFFFF) % N).to(torch.int32)


def gather_sum(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """int32[Wr]: the column sum of table[idx], wrapping mod 2^32 (every
    column, so no column goes unread): row_gather_sum's kernel on a card,
    its plain version on the CPU. len(idx) must be a multiple of GATHER_G."""
    from bwtpu_torch.kernels.gather import row_gather_sum

    if idx.shape[0] % GATHER_G:
        raise ValueError(f"gather_sum: {idx.shape[0]} indices, not a multiple of {GATHER_G}")
    return row_gather_sum(table, idx, GATHER_G)[0]


def calibrate_ns_per_row(table: torch.Tensor, n_rows: int = 1 << 22, reps: int = 3) -> float:
    """This device's data-dependent gather rate (ns per row) on an index
    table: `reps` calls of gather_sum, each on its own index stream (seeds
    1..reps), after a warm-up on seed 0. On a card the time is CUDA events
    around the calls; on the CPU the host clock."""
    N = table.shape[0]
    streams = [gather_index_stream(n_rows, s, N, table.device) for s in range(reps + 1)]
    gather_sum(table, streams[0])
    secs = _device_seconds(lambda: [gather_sum(table, idx) for idx in streams[1:]],
                           table.device)
    return secs / (reps * n_rows) * 1e9


def gather_model(B2, L, d, step, trips, n_unf, max_loc, nS,
                 loc_factor, sa_rate, locv=False):
    """Data-dependent gather (rows, bytes, locv_rows) of one packed
    compacted-path batch, bench.py's model:

      kmer start        B2*nS lanes x 1 row (8 B)
      multi-step probes trips x B2*nS lanes x 1 OCCK record (step 3: 512 B)
      finisher          cap_fix lanes x (slen-d) steps x 2 rows (128 B)
      locate+verify     locv: cap_loc x 1 locv row (SA value + verify
                        window) plus the fused read row; else cap_loc x 1
                        locate row (4 B direct SA | sa_rate x 128 B walk)
                        plus cap_loc x 2 verify rows
    Compacted arrays have static shapes, so traffic is the capacity, not
    the live count; n_unf only decides whether the finisher runs.
    locv_rows come apart from rows: they are priced at the locv table's
    own measured rate."""
    from bwtpu_torch.index import OCCK_WIDTH
    from bwtpu_torch.kernels.verify2 import locv_row_width, window_row_width

    lanes = B2 * nS
    slen = L // nS if nS > 1 else L
    rec_k = OCCK_WIDTH[step] * 4
    cap_fix = max(256, B2 // 64)
    cap_loc = max(B2 * loc_factor, 4096)
    W = (L + 15) // 16

    rows = lanes                            # kmer table rows
    bytes_ = lanes * 8
    rows += trips * lanes                   # multi-step probe gathers
    bytes_ += trips * lanes * rec_k
    if n_unf > 0:                           # compacted 1-step finisher
        fix_rows = nS * cap_fix * max(slen - d, 0) * 2
        rows += fix_rows
        bytes_ += fix_rows * 128
    locv_rows = 0
    if locv:                                # fused locate+verify row
        locv_rows = cap_loc
        bytes_ += cap_loc * locv_row_width(L) * 4
    elif sa_rate == 1:                      # locate
        rows += cap_loc
        bytes_ += cap_loc * 4
    else:
        rows += cap_loc * sa_rate
        bytes_ += cap_loc * sa_rate * 128
    if not locv:                            # verify text row (stride-8)
        rows += cap_loc
        bytes_ += cap_loc * (window_row_width(L) + 7) * 4
    rows += cap_loc                         # fused read row
    bytes_ += cap_loc * (3 * W + 1 + nS) * 4
    return rows, bytes_, locv_rows


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _device_seconds(fn, device) -> float:
    """Seconds of fn()'s device work: CUDA events on a card (after a
    synchronize), the host clock on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    torch.cuda.synchronize(device)
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / 1e3


@contextlib.contextmanager
def section(name: str):
    """Reset the kernel launch counters; at the end print the section's
    wall and its launches on stderr."""
    from bwtpu_torch.kernels import _build

    _build.reset_launches()
    t0 = time.perf_counter()
    yield
    say(f"# section {name} {time.perf_counter() - t0:.3f} s")
    say(f"# launches {name} {json.dumps(_build.launch_counts())}")


def say(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def report_failure(what: str) -> None:
    """The current exception's whole traceback on stderr, each line behind `# `."""
    say(f"# {what} failed:")
    for line in traceback.format_exc().splitlines():
        say(f"# {line}")


def device_rate(fn, batches, n_reads: int, device, stat=None, warm: bool = True):
    """(best reads/s of 2 passes over every batch, the element-wise max over
    both passes of stat(outputs)): each pass calls fn(*batch) on every
    batch, then synchronizes once. warm: one untimed call on batches[0]
    first (fn's kernels loaded, the allocator's blocks reserved)."""
    if warm:
        fn(*batches[0])
        _sync(device)
    best, worst = 0.0, None
    for _ in range(2):
        t0 = time.perf_counter()
        outs = [fn(*b) for b in batches]
        _sync(device)
        best = max(best, n_reads * len(batches) / (time.perf_counter() - t0))
        if stat is not None:
            s = stat(outs)
            worst = s if worst is None else tuple(map(max, worst, s))
    return best, worst


def overflow_count(out, rows: int, comp: int) -> int:
    """bench.py's overflow count of one pipeline output tuple: the rows
    whose incompleteness count out[rows] is non-zero, plus the compaction
    overflow out[comp]. Exact and k = 2 outputs: (4, 5); tiered: (10, 11)
    (out[9] is its escalated-read count)."""
    return int((out[rows] > 0).sum()) + int(out[comp])


def pack_batches(genome: str, n_reads: int, n_batches: int, L: int, seed0: int, device,
                 error_rate: float | None = None):
    """n_batches device batches (read_words, amb_bits) of simulated reads
    (seeds seed0, seed0 + 1, ...): uniform {0,1,2} substitutions, or
    Binomial(L, error_rate) ones truncated at 2; also returns the first
    batch's reads."""
    from bwtpu_torch.engine import pack_reads_for_bench
    from bwtpu_torch.simulate import simulate_reads

    out, first = [], None
    for i in range(n_batches):
        rds, _ = simulate_reads(genome, n_reads, read_len=L, max_mismatches=2,
                                seed=seed0 + i, error_rate=error_rate)
        first = first or rds
        out.append(tuple(torch.from_numpy(a).to(device) for a in pack_reads_for_bench(rds)))
    return out, first


def write_e2e_inputs(genome: str, where: str, Bc: int, n_e2e: int, n_pair_chunks: int,
                     L: int) -> tuple[str, str, str, str]:
    """bench.py's e2e FASTQs: n_e2e chunks of Bc uniform {0,1,2}-mismatch
    reads, the same at 0.5 %/base errors, and n_pair_chunks chunks of Bc/2
    pairs (so the stacked two-mate dispatch stays at Bc rows)."""
    from bwtpu_torch.simulate import simulate_pairs, simulate_reads

    fq, fq_le, fq1, fq2 = (os.path.join(where, f) for f in
                           ("reads.fq", "reads_le.fq", "reads_1.fq", "reads_2.fq"))
    qual = "I" * L
    for path, seed0, err in ((fq, 100, None), (fq_le, 500, 0.005)):
        with open(path, "w") as f:
            for i in range(n_e2e):
                rds, _ = simulate_reads(genome, Bc, read_len=L, max_mismatches=2,
                                        seed=seed0 + i, error_rate=err)
                for r in rds:
                    f.write(f"@{r.rid}.{i}\n{r.seq}\n+\n{qual}\n")
    with open(fq1, "w") as f1, open(fq2, "w") as f2:
        for i in range(n_pair_chunks):
            prs, _ = simulate_pairs(genome, Bc // 2, read_len=L, max_mismatches=2,
                                    seed=300 + i)
            for r1, r2 in prs:
                f1.write(f"@{r1.rid}.{i}\n{r1.seq}\n+\n{qual}\n")
                f2.write(f"@{r2.rid}.{i}\n{r2.seq}\n+\n{qual}\n")
    return fq, fq_le, fq1, fq2


def _e2e_engine(idx, cfg, k: int, lf_ceiling: float, device):
    """An Engine at a generic loc_factor ceiling (the config default a user
    would start from); autotune_caps tightens it from measured occupancy."""
    from bwtpu_torch.engine import Engine

    return Engine([dataclasses.replace(idx, config=cfg.replace(
        loc_factor=lf_ceiling, k=k, min_trips=1, hit_factor=0.5))], device=device)


def e2e_single(idx, cfg, fq: str, sam_path: str, k: int, lf_ceiling: float, Bc: int,
               device, tiered: bool = False):
    """FASTQ -> SAM the way `align` runs it: chunked columnar parse,
    dispatch, finish (fetch, assembly, primary) on one worker thread with
    up to 3 chunks in flight, C SAM formatter. Capacities are autotuned
    on the first chunk (tiered: the k = 0 tier's too), and that chunk runs
    once untimed. Returns (reads/s, wall, reads, SAM MB, overflows, heals,
    tuned loc_factor, escalated fraction); the SAM stays at sam_path."""
    from bwtpu_torch.readblock import read_fastq_block, read_fastq_stream
    from bwtpu_torch.results import ContigTable, select_primary_flat
    from bwtpu_torch.sam import sam_header
    from bwtpu_torch.samfast import emit_single

    eng = _e2e_engine(idx, cfg, k, lf_ceiling, device)
    wslice = read_fastq_block(fq).slice(0, Bc)
    eng.autotune_caps(wslice, k, pad_to=Bc)
    if tiered:  # tier 1 runs at the k = 0 caps
        eng.autotune_caps(wslice, 0, pad_to=Bc)
    eng.finish_block(eng.dispatch_block(wslice, k, pad_to=Bc, tiered=tiered))
    del wslice
    ctable = ContigTable.build(idx.contigs)

    def process(h):
        flat = eng.finish_block(h)
        return flat, select_primary_flat(flat)

    n_reads = 0
    eng.stats.escalated = 0
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as ex, open(sam_path, "wb") as out:
        out.write(sam_header(idx.contigs).encode())
        inflight = []

        def drain():
            sub, fut = inflight.pop(0)
            flat, prim = fut.result()
            out.write(emit_single(sub, prim, ctable, truncated=flat.truncated))

        for sub in read_fastq_stream(fq, Bc)[2]:
            n_reads += sub.n
            h = eng.dispatch_block(sub, k, pad_to=Bc, tiered=tiered)
            inflight.append((sub, ex.submit(process, h)))
            if len(inflight) > 2:
                drain()
        while inflight:
            drain()
    wall = time.perf_counter() - t0
    over = eng.stats.overflow_reads + eng.stats.compact_overflows
    return (n_reads / wall, wall, n_reads, os.path.getsize(sam_path) / 1e6, over,
            eng.stats.heals, eng._lf(k), eng.stats.escalated / max(n_reads, 1))


def e2e_paired(idx, cfg, fq1: str, fq2: str, sam_path: str, k: int, lf_ceiling: float,
               Bc: int, device):
    """Paired FASTQs -> SAM (`align --paired`): both mates of a chunk of
    Bc/2 pairs stacked into one dispatch, vectorised pairing
    (results.select_pairs, inserts 0-1000), one interleaved C-formatter
    call; capacities autotuned as in e2e_single. Returns (reads/s, wall,
    reads, SAM MB, overflows, heals, tuned loc_factor)."""
    from bwtpu_torch.readblock import concat_blocks, read_fastq_block, read_fastq_stream
    from bwtpu_torch.results import ContigTable, select_pairs, select_primary_flat, split_flat
    from bwtpu_torch.sam import sam_header
    from bwtpu_torch.samfast import emit_paired

    Bcp = Bc // 2
    eng = _e2e_engine(idx, cfg, k, lf_ceiling, device)
    wblk = concat_blocks(read_fastq_block(fq1).slice(0, Bcp),
                         read_fastq_block(fq2).slice(0, Bcp))
    eng.autotune_caps(wblk, k, pad_to=Bc)
    eng.finish_block(eng.dispatch_block(wblk, k, pad_to=Bc))
    del wblk
    ctable = ContigTable.build(idx.contigs)

    def process(sub1, sub2, h):
        flat = eng.finish_block(h)
        f1, f2 = split_flat(flat, sub1.n)
        choice = select_pairs(f1, f2, sub1.L, sub2.L, 0, 1000)
        return emit_paired(sub1, sub2, f1, f2, choice, select_primary_flat(f1),
                           select_primary_flat(f2), ctable)

    n_reads = 0
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as ex, open(sam_path, "wb") as out:
        out.write(sam_header(idx.contigs).encode())
        inflight = []
        for sub1, sub2 in zip(read_fastq_stream(fq1, Bcp)[2], read_fastq_stream(fq2, Bcp)[2]):
            n_reads += sub1.n + sub2.n
            h = eng.dispatch_block(concat_blocks(sub1, sub2), k, pad_to=Bc)
            inflight.append(ex.submit(process, sub1, sub2, h))
            if len(inflight) > 2:
                out.write(inflight.pop(0).result())
        while inflight:
            out.write(inflight.pop(0).result())
    wall = time.perf_counter() - t0
    over = eng.stats.overflow_reads + eng.stats.compact_overflows
    return (n_reads / wall, wall, n_reads, os.path.getsize(sam_path) / 1e6, over,
            eng.stats.heals, eng._lf(k))


def roofline(shard, batch, batch_k2, L: int, d: int, d_seed: int, step: int, cfg,
             min_trips: int, exact_lf: float, k2_lf: float, n_rows: int) -> dict:
    """The measured inputs of the roofline: ns per row of the multi-step
    lattice (and of the locv table when it is on), the probe trips and
    finisher lanes of one exact batch and of each k = 2 seed slot, and
    gather_model's (rows, bytes, locv_rows) for both."""
    from bwtpu_torch.engine import device_prep_packed
    from bwtpu_torch.kernels.searchk import search_early_stop_packed
    from bwtpu_torch.kernels.verify import seed_layout

    ns_per_row = calibrate_ns_per_row(shard.latk, n_rows)
    locv_on = shard.locv.shape[-1] > 1
    # the locv table gathers at its own, size-dependent rate
    ns_locv = calibrate_ns_per_row(shard.locv, n_rows) if locv_on else ns_per_row
    args = (shard.lattice, shard.latk, shard.latk_inv, shard.C, shard.dollar_row)

    rw2, ab2, *_ = device_prep_packed(*batch, L)
    *_, trips, n_unf = search_early_stop_packed(
        *args, shard.kmer_tables[d], rw2, ab2, 0, L, d, step, cfg.max_hits, min_trips,
        with_stats=True)
    trips, n_unf = int(trips), int(n_unf)
    ex = gather_model(rw2.shape[0], L, d, step, trips, n_unf, cfg.max_hits, 1, exact_lf,
                      cfg.sa_rate, locv=locv_on)
    # k = 2 on a batch of the k = 2 measurement's size, which it models
    rw2k, ab2k, *_ = device_prep_packed(*batch_k2, L)
    trips_k2 = n_unf_k2 = 0
    for off, slen in seed_layout(L, 3):
        *_, t_s, u_s = search_early_stop_packed(
            *args, shard.kmer_tables[d_seed], rw2k, ab2k, off, slen, d_seed, step,
            cfg.max_cand, min_trips, with_stats=True)
        trips_k2 += int(t_s)
        n_unf_k2 += int(u_s)
    k2 = gather_model(rw2k.shape[0], L, d_seed, step, trips_k2, n_unf_k2, cfg.max_cand, 3,
                      k2_lf, cfg.sa_rate, locv=locv_on)
    return {"ns_per_row": ns_per_row, "ns_locv": ns_locv, "trips": trips,
            "trips_k2": trips_k2, "ex": ex, "k2": k2}


def multihost_probe(n_reads_per_host: int = 2048, batch: int = 512, n_procs: int = 2,
                    device: str = "cuda", timeout: float = 600.0):
    """One bwtpu_torch.multihost run over n_procs hosts on this machine,
    on bench.py's probe: a 400 kbp genome in a 2-shard sa_rate 4 index,
    n_reads_per_host reads per host (host h simulated from seed 40 + h),
    k = 0, `batch` reads per batch. A port rank holds one device and one
    shard, so a host is one ring of PROBE_SHARDS ranks (rank = host *
    PROBE_SHARDS + shard), each taking its share of the host's reads; every
    rank is a `python -m bwtpu_torch.multihost --coordinator` process. On a
    card every rank runs on cuda:0 with --backend gloo (NCCL refuses two
    ranks on one card), on the CPU with --device cpu. At equal reads per
    host, rps(2) / (2 * rps(1)) is the weak-scaling efficiency. Returns
    (reads / the slowest rank's wall, reads, that wall, each rank's
    kernel launches); every rank is killed on a failure or at the timeout."""
    from bwtpu_torch.config import EngineConfig
    from bwtpu_torch.index import build_sharded_index, save_index
    from bwtpu_torch.io import write_fastq
    from bwtpu_torch.simulate import random_genome, simulate_reads

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    world = n_procs * PROBE_SHARDS
    per_rank = -(-n_reads_per_host // PROBE_SHARDS)
    dev_args = (["--device", "cuda:0", "--backend", "gloo"] if device == "cuda"
                else ["--device", "cpu"])
    with tempfile.TemporaryDirectory(prefix="bwtpu_torch_mh_") as tmp:
        genome = random_genome(400_000, seed=17)
        cfg = EngineConfig(sa_rate=4, max_hits=8, max_cand=8, read_len=100)
        shards, manifest = build_sharded_index(genome, PROBE_SHARDS, config=cfg, overlap=128)
        idx_dir = os.path.join(tmp, "idx")
        save_index(idx_dir, shards, manifest)
        for h in range(n_procs):
            rds, _ = simulate_reads(genome, n_reads_per_host, read_len=100,
                                    max_mismatches=2, seed=40 + h)
            for s in range(PROBE_SHARDS):
                write_fastq(os.path.join(tmp, f"reads{h * PROBE_SHARDS + s}.fq"),
                            rds[s * per_rank:(s + 1) * per_rank])
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs, logs = [], []
        try:
            for r in range(world):
                logs.append(os.path.join(tmp, f"rank{r}.log"))
                with open(logs[-1], "w") as log:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", "bwtpu_torch.multihost",
                         "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(world),
                         "--process-id", str(r), "--index", idx_dir,
                         "--reads", os.path.join(tmp, f"reads{r}.fq"),
                         "--out", os.path.join(tmp, "out.sam"), "-k", "0",
                         "--batch-size", str(batch), *dev_args],
                        cwd=root, env=env, stdout=subprocess.DEVNULL, stderr=log))
            deadline = time.monotonic() + timeout
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        summaries = []
        for r, (p, log) in enumerate(zip(procs, logs)):
            with open(log) as f:
                text = f.read()
            if p.returncode != 0:
                raise RuntimeError(f"multihost rank {r} exited with {p.returncode}:\n"
                                   f"{text[-2000:]}")
            summaries += [json.loads(ln) for ln in text.splitlines()
                          if '"host_summary"' in ln]
    if len(summaries) != world:
        raise RuntimeError(f"{len(summaries)} host_summary lines from {world} ranks")
    total = sum(s["reads"] for s in summaries)
    wall = max(s["wall_s"] for s in summaries)
    return total / max(wall, 1e-9), total, wall, [s["launches"] for s in summaries]


def golden_rates(genome: str, reads) -> tuple[float, float, float]:
    """(index build seconds, exact reads/s on 20 reads, k = 2 reads/s on
    5) of GoldenFMIndex, the interpreted per-read walk."""
    from bwtpu_torch.golden import GoldenFMIndex

    t0 = time.perf_counter()
    golden = GoldenFMIndex(genome)
    build_s = time.perf_counter() - t0
    sample = reads[:20]
    t0 = time.perf_counter()
    for r in sample:
        golden.align_read(r.seq, k=0)
    exact = len(sample) / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    for r in sample[:5]:
        golden.align_read(r.seq, k=2)
    return build_s, exact, 5 / (time.perf_counter() - t0)


def _r(x, nd):
    """round(x, nd); None where a guarded section left x unset."""
    return None if x is None else round(x, nd)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="bwtpu_torch bench", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--smoke", action="store_true",
                    help="20 kbp genome, 1 K reads: a shape and control-flow check")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--nbatches", type=int, default=2)
    ap.add_argument("--cpu", action="store_true",
                    help="the plain-torch versions on the CPU (default: the card)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run every section; print the JSON line and return it."""
    from bwtpu_torch.config import EngineConfig
    from bwtpu_torch.engine import (exact_pipeline_packed, inexact_pipeline_packed,
                                    pick_kmer_depth, tiered_pipeline_packed, upload_index)
    from bwtpu_torch.hosttune import tune_malloc
    from bwtpu_torch.index import build_fm_index
    from bwtpu_torch.kernels import _build
    from bwtpu_torch.simulate import ECOLI_SCALE, random_genome

    tune_malloc()
    args = parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device (torch.cuda.is_available() is false); "
                         "--cpu runs the plain-torch versions")
    device = torch.device("cpu" if args.cpu else "cuda")
    t0_all = time.perf_counter()
    timings = {}
    L = 100
    cfg = EngineConfig(sa_rate=1, max_hits=4, max_cand=8, read_len=L)
    mt = 1
    # bench.py's configuration, kept as it is so that both packages run the
    # same work (the port has tuned none of it): batches of 524,288 reads,
    # 458,752 at k = 2, e2e chunks of 262,144; loc_factor 0.45 exact (one
    # guaranteed multi-step trip thins false candidates), 1.5 at k = 2 (the
    # 3-seed pool is mostly true duplicates), esc_factor 0.75 tiered
    exact_lf, k2_lf = 0.45, 1.5
    B = args.batch or (1024 if args.smoke else 524288)
    B_k2 = min(B, 458752)
    n_batches = args.nbatches

    with section("setup"):
        if device.type == "cuda":  # every kernel (the probe's ranks load them too) before any
            _build.build_all(_build.SOURCES)  # timed window: one nvcc per source, together
        genome = random_genome(20_000 if args.smoke else ECOLI_SCALE, seed=1)
        t0 = time.perf_counter()
        idx = build_fm_index(genome, cfg)
        timings["index_build_s"] = round(time.perf_counter() - t0, 1)
        shard = upload_index([idx], device)[0]
        depths = sorted(idx.kmer_tables)
        step = cfg.occ_step
        d = pick_kmer_depth(depths, L)
        d_seed = pick_kmer_depth(depths, L // 3)
        t0 = time.perf_counter()
        encs, reads = pack_batches(genome, B, n_batches, L, 2, device)
        # same geometry: the k = 2 batches are the exact ones
        encs_k2 = encs if B_k2 == B else [(rw[:B_k2], ab[:B_k2]) for rw, ab in encs]
        timings["encode_upload_s"] = round(time.perf_counter() - t0, 1)

    with section("exact"):
        def fx(rw, ab):
            return exact_pipeline_packed(shard, rw, ab, L=L, d=d, max_hits=cfg.max_hits,
                                         sa_rate=cfg.sa_rate, loc_factor=exact_lf,
                                         min_trips=mt)
        exact_rps, (exact_over,) = device_rate(
            fx, encs, B, device, lambda outs: (sum(overflow_count(o, 4, 5) for o in outs),))

    with section("k2"):
        def fi(rw, ab):
            return inexact_pipeline_packed(shard, rw, ab, L=L, k=2, d=d_seed,
                                           max_loc=cfg.max_cand, sa_rate=cfg.sa_rate,
                                           loc_factor=k2_lf, min_trips=mt)
        k2_rps, (k2_over,) = device_rate(
            fi, encs_k2, B_k2, device, lambda outs: (sum(overflow_count(o, 4, 5) for o in outs),))

    # tiered k = 2: exact first, the reads with no exact hit escalate
    def tiered_stat(outs):
        return (sum(overflow_count(o, 10, 11) for o in outs),
                max(int(o[9]) for o in outs) / B_k2)

    with section("tiered"):
        def ftd(rw, ab):
            return tiered_pipeline_packed(
                shard, rw, ab, L=L, k=2, d=d, d_seed=d_seed, max_hits=cfg.max_hits,
                max_cand=cfg.max_cand, sa_rate=cfg.sa_rate, loc_factor=exact_lf,
                k2_loc_factor=k2_lf, esc_factor=0.75, min_trips=mt)
        k2t_rps, (k2t_over, esc_frac) = device_rate(ftd, encs_k2, B_k2, device, tiered_stat)

    # tiered and flat k = 2 on the SAME reads at 0.5 %/base errors (~61 %
    # of 100 bp reads error-free, against ~1/3 in the uniform set above)
    with section("lowerr"):
        encs_le, _ = pack_batches(genome, B_k2, n_batches, L, 60, device, error_rate=0.005)
        k2t_le_rps, (_, esc_frac_le) = device_rate(ftd, encs_le, B_k2, device, tiered_stat,
                                                   warm=False)
        k2_le_rps, _ = device_rate(fi, encs_le, B_k2, device, warm=False)
        del encs_le

    # end to end, FASTQ -> SAM; chunks of 262,144 reads at most (bench.py's)
    Bc = min(B, 262144)
    with tempfile.TemporaryDirectory(prefix="bwtpu_torch_e2e_") as e2e_dir:
        with section("e2e_setup"):
            t0 = time.perf_counter()
            fq, fq_le, fq1, fq2 = write_e2e_inputs(
                genome, e2e_dir, Bc, 1 if args.smoke else max(2, 1048576 // Bc),
                1 if args.smoke else 2, L)
            timings["e2e_setup_s"] = round(time.perf_counter() - t0, 1)
        sam = os.path.join(e2e_dir, "out.sam")
        runs = {}
        for name, fn, fargs in (
                ("e2e_exact", e2e_single, (fq, sam, 0, 2)),
                ("e2e_k2", e2e_single, (fq, sam, 2, 4)),
                ("e2e_paired", e2e_paired, (fq1, fq2, sam, 2, 4)),
                ("e2e_k2_lowerr", e2e_single, (fq_le, sam, 2, 4)),
                ("e2e_tiered_lowerr", e2e_single, (fq_le, sam, 2, 4))):
            with section(name):
                kw = {"tiered": True} if name == "e2e_tiered_lowerr" else {}
                runs[name] = fn(idx, cfg, *fargs, Bc, device, **kw)
                os.remove(sam)
    e2e_rps, e2e_s, n_reads_e2e, sam_mb, e2e_over, e2e_heals, e2e_lf_tuned, _ = \
        runs["e2e_exact"]
    e2e_k2, e2e_pe = runs["e2e_k2"], runs["e2e_paired"]
    e2e_k2_le, e2e_k2t_le = runs["e2e_k2_lowerr"], runs["e2e_tiered_lowerr"]

    bw = hbm_bandwidth(torch.cuda.get_device_name(device) if device.type == "cuda" else None)
    roof = {}
    with section("roofline"):
        try:
            roof = roofline(shard, encs[0], encs_k2[0], L, d, d_seed, step, cfg, mt,
                            exact_lf, k2_lf, (1 << 16) if args.smoke else (1 << 22))
        except Exception:  # diagnostic calibration, never fatal (bench.py's guard)
            report_failure("roofline calibration")
    del encs, encs_k2
    ns_per_row, ns_locv = roof.get("ns_per_row"), roof.get("ns_locv")
    ex_rows, ex_bytes, ex_lrows = roof.get("ex", (None,) * 3)
    k2_rows, k2_bytes, k2_lrows = roof.get("k2", (None,) * 3)
    sol_exact_rps = sol_k2_rps = None
    if roof:
        sol_exact_rps = B / ((ex_rows * ns_per_row + ex_lrows * ns_locv) * 1e-9)
        sol_k2_rps = B_k2 / ((k2_rows * ns_per_row + k2_lrows * ns_locv) * 1e-9)

    mh_rps = mh_reads = mh_wall = mh1_rps = scaling_eff = None
    if not args.smoke:
        with section("multihost"):
            try:
                for n in (2, 1):
                    rps, total, wall, launches = multihost_probe(n_procs=n,
                                                                 device=device.type)
                    for r, c in enumerate(launches):
                        say(f"# launches multihost_{n}proc_rank{r} {json.dumps(c)}")
                    if n == 2:
                        mh_rps, mh_reads, mh_wall = rps, total, wall
                    else:
                        mh1_rps = rps
                scaling_eff = mh_rps / (2.0 * mh1_rps)
            except Exception:  # launcher liveness is reported, not fatal
                report_failure("multihost probe")

    with section("golden"):
        golden_build_s, cpu_exact_rps, cpu_k2_rps = golden_rates(genome, reads)
        timings["golden_build_s"] = round(golden_build_s, 1)

    line = {
        "metric": "reads/s/chip exact 100bp E.coli-scale (both strands)"
                  + (" [SMOKE]" if args.smoke else ""),
        "value": round(exact_rps, 1),
        "unit": "reads/s",
        "vs_baseline": round(exact_rps / cpu_exact_rps, 1),
        "extras": {
            "e2e_exact_reads_per_s": round(e2e_rps, 1),
            "e2e_wall_s": round(e2e_s, 2),
            "e2e_reads": n_reads_e2e,
            "e2e_sam_mb": round(sam_mb, 1),
            "e2e_overflows": int(e2e_over),
            "e2e_heals": int(e2e_heals),
            "e2e_exact_lf_autotuned": e2e_lf_tuned,
            "e2e_k2_lf_autotuned": e2e_k2[6],
            "e2e_k2_reads_per_s": round(e2e_k2[0], 1),
            "e2e_k2_wall_s": round(e2e_k2[1], 2),
            "e2e_k2_reads": e2e_k2[2],
            "e2e_k2_overflows": int(e2e_k2[4]),
            "e2e_paired_reads_per_s": round(e2e_pe[0], 1),
            "e2e_paired_wall_s": round(e2e_pe[1], 2),
            "e2e_paired_reads": e2e_pe[2],
            "e2e_paired_overflows": int(e2e_pe[4]),
            "e2e_k2_lowerr_reads_per_s": round(e2e_k2_le[0], 1),
            "e2e_k2_tiered_lowerr_reads_per_s": round(e2e_k2t_le[0], 1),
            "e2e_tiered_lowerr_speedup": round(e2e_k2t_le[0] / max(e2e_k2_le[0], 1e-9), 2),
            "e2e_tiered_escalated_frac": round(e2e_k2t_le[7], 3),
            "e2e_tiered_overflows": int(e2e_k2t_le[4]),
            # on a card: every rank on cuda:0 through gloo (names as bench.py's)
            "multihost_2proc_cpu_reads_per_s": _r(mh_rps, 1),
            "multihost_2proc_reads": mh_reads,
            "multihost_2proc_wall_s": mh_wall,
            "multihost_1proc_cpu_reads_per_s": _r(mh1_rps, 1),
            "scaling_eff_2proc_cpu": _r(scaling_eff, 3),
            "k2_reads_per_s": round(k2_rps, 1),
            "k2_tiered_reads_per_s": round(k2t_rps, 1),
            "k2_tiered_overflow": int(k2t_over),
            "k2_escalated_frac": round(esc_frac, 3),
            "k2_tiered_lowerr_reads_per_s": round(k2t_le_rps, 1),
            "k2_lowerr_reads_per_s": round(k2_le_rps, 1),
            "k2_lowerr_escalated_frac": round(esc_frac_le, 3),
            "k2_tiered_lowerr_speedup": round(k2t_le_rps / max(k2_le_rps, 1e-9), 2),
            "exact_overflow": exact_over,
            "k2_overflow": k2_over,
            "min_trips": mt,
            "exact_loc_factor": exact_lf,
            "k2_loc_factor": k2_lf,
            "cpu_ref_exact_reads_per_s": round(cpu_exact_rps, 2),
            "cpu_ref_k2_reads_per_s": round(cpu_k2_rps, 2),
            "k2_vs_baseline": round(k2_rps / cpu_k2_rps, 1),
            # sol_* and the model fields are null when the roofline failed
            "sol_fraction": _r(exact_rps / sol_exact_rps if roof else None, 4),
            "k2_sol_fraction": _r(k2_rps / sol_k2_rps if roof else None, 4),
            "sol_exact_reads_per_s": _r(sol_exact_rps, 1),
            "sol_k2_reads_per_s": _r(sol_k2_rps, 1),
            "model_rows_per_read_exact": _r((ex_rows + ex_lrows) / B if roof else None, 2),
            "model_rows_per_read_k2": _r((k2_rows + k2_lrows) / B_k2 if roof else None, 2),
            "model_locv_rows_per_read_exact": _r(ex_lrows / B if roof else None, 2),
            "ns_per_row_locv": _r(ns_locv, 2),
            "model_bytes_per_read_exact": _r(ex_bytes / B if roof else None, 1),
            "model_bytes_per_read_k2": _r(k2_bytes / B_k2 if roof else None, 1),
            "hbm_frac_of_byte_bw": _r(ex_bytes / B * exact_rps / bw if roof and bw else None, 5),
            "probe_trips_exact": roof.get("trips"),
            "probe_trips_k2": roof.get("trips_k2"),
            "ns_per_row_measured": _r(ns_per_row, 2),
            "hbm_gbps_assumed": _r(bw / 1e9 if bw else None, 1),
            "backend": "cuda" if device.type == "cuda" else "plain",
            "kmer_d": d,
            "platform": device.type,
            "batch_reads": B,
            "batch_reads_k2": B_k2,
            "total_s": round(time.perf_counter() - t0_all, 1),
            **timings,
        },
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
