#!/usr/bin/env python3
"""Smoke run of the bwtpu_torch port on one CUDA card.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, in order; any failure raises and the exit code is not 0:
  1. the card: nvidia-smi name + power limit, torch's device name;
  2. build and load the port's native host library (g++, from
     bwtpu_torch/csrc/host; required), then the nine CUDA kernel sources
     (nvcc, sm_90a) from bwtpu_torch/csrc, one nvcc per source, all
     started together; registers, stack frame and spills of each source;
  3. `build-index --sa-rate 1` of the E. coli-size genome (phase 7's
     index); each kernel against its plain-torch version on the card
     (exact equality), with CUDA-event times of both (a run of 50
     launches between one event pair, divided by 50) and its bound:
     search_multistep, search_chain2, locate_walk, verify_nm, revcomp_both,
     compact_slots and compact_mask on the very arguments one block of
     phase 5's reads hands them (k = 0 and k = 2; revcomp_both's in-place
     call as the engine makes it, then its forward instance on the same
     reads and both instances on a floor call of 256 reads;
     compact_mask's library
     call torch.nonzero_static timed beside it; both compactions also on
     their empty call, and on phase 5's k = 2 call tiled to both sides of
     the edge between their two forms, with the cluster size compact.cu
     found placeable;
     search_multistep also as the whole search_early_stop_packed against
     its plain version, its floors (the empty call, the lane with the
     largest exit trip alone) and the operations one whole call puts on
     the card (<= 4), on edge calls (step 4, wide phase, min_trips,
     cap_scale, T = 0), at the bench's size (phase 5's reads tiled 4x:
     1,048,576 lanes, on the sa_rate 1 index) and under sync debug mode
     "error", with a report of the first syncing op of a whole
     Engine.dispatch_block; one dispatch of the block at each k under
     torch.profiler with no cummax or scatter_reduce op; search_chain2
     also on one lane alone, its latency floor), search_chain1 on the
     very arguments one batch of phase 6's reads hands it through
     Engine.dispatch_batch (k = 0 reads and k = 2 seeds, each timed 3x;
     also one lane alone, its latency floor, and the L2 sectors its chain
     requests), verify_locv at that index's locv table, row_gather_sum at
     that table (Wr 16) and at the 9.3 MB multi-step lattice (Wr 128);
     verify_nm's run-time-W instance at W = 25 (400 bp reads); sw_band on
     the very arguments --rescore hands it for one batch of phase 6's
     reads at k = 2, with the SASS size of its interior row loop;
  4. phiX174 through the port's CLI on the card, byte-equal to
     data/phiX174_golden.sam;
  5. slice 1's path at E. coli scale: `build-index` with the CLI
     defaults, 131,072 simulated 100 bp reads (<= 2 mismatches), port
     CLI `align -k 0` and `-k 2` at batch 16,384; checks truth recovery,
     a brute-force Hamming scan of 256 sampled reads, SAM determinism,
     zero truncated reads and that search_multistep, locate_walk,
     verify_nm, (in the straggler finisher) search_chain2, revcomp_both,
     compact_slots and compact_mask ran on that path;
  6. the Read-list path on the same index: 131,072 reads of 50-100 bp
     as FASTA through the port CLI at k = 0 and k = 2, batch 16,384
     (Engine.dispatch_batch -> backward_search_ra); the same checks, and
     all four kernels launched, search_multistep not;
  7. bench.py's single-end configuration: phase 3's sa_rate 1 index (the
     locv table on), the same FASTQ through the port CLI at batch 16,384:
     `-k 0 --autotune-caps`, `-k 2 --autotune-caps` and `-k 2 --tiered
     --autotune-caps`. The k = 0 and k = 2 SAM byte-equal to phase 5's;
     tiered holds the stratum contract against brute force on 256
     sampled reads; truth; 0 truncated reads; the tuned loc_factor <= its
     ceiling; search_multistep, verify_locv, search_chain2, revcomp_both,
     compact_slots and compact_mask launched, locate_walk and verify_nm
     not;
  8. the A/B entry point of the row gather (scripts/torch_gather_ab.py)
     at a locv row's width, at the text-row table's size (phase 3 timed
     the locv table's): an L2-resident gather rate, against which
     search_chain1's L2 sectors are read; then the L2 fetch granularity
     probe: ns per row at Wr 8, 16 and 32 from a 297 MB table, at the
     card's default hint and at 32, 64 and 128 B;
  9. --rescore: phase 6's FASTA on phase 5's index at k = 2 through the
     port CLI: every AS:i tag equal to sw_score_plain on the card for the
     same windows, 256 sampled primaries equal to sw_score_reference,
     sw_band launched; the host time of rescore_candidates split into the
     window cut, the per-read encode loop, the sw_score_batch call and
     the rest, and the AS formatting;
 10. paired-end on a sharded index: a random genome of chr21's length
     (46,709,983 bp, the same repeat family at the same density),
     `build-index --shards 2 --jobs 2` at the CLI defaults (both shards
     on the card), 65,536 pairs of 100 bp through `align --paired` at
     k = 0 and 2: pair truth, the paired Read-list loop byte-equal to the
     columnar path, brute force on 256 sampled mate-1 reads against a
     single-end pass, no truncated read, search_multistep, locate_walk,
     verify_nm, search_chain2, compact_slots and compact_mask launched at
     least once per shard and block, revcomp_both exactly once a
     dispatched block (the block's prep serves both shards); then a
     single-shard `build-index --kmer-d 11` of the same genome (its s-mer
     lattice larger than L2) and one block of 16,384 mate-1 reads through
     Engine.dispatch_block + finish_block at k = 0 and 2: every
     search_multistep call with wide_steps 1, the first of each k held
     against its plain version, timed, bounded and floored as in phase 3,
     and the block's truth;
 10b. the fused multi-shard dispatch on phase 10's 2-shard index:
     Engine(fuse_shards=True), one CUDA graph replay a block, with four
     blocks of 16,384 mate-1 reads in flight at k = 0, k = 2 (hit_factor
     0.5: one heal a block) and tiered k = 2, in turns with the loop
     form (loop, fused, fused, loop): hits, truncation flags and
     BatchStats equal to the loop's; each mode's dispatch in both forms
     under sync debug mode "error" once the reads are on the card; each
     mode's fused run once more under torch.profiler, its launches
     counted from the trace's kernel names and equal to what each
     replayed graph's capture recorded (a replay calls no wrapper, so
     these measured counts are the path's launches), revcomp_both,
     compact_slots and compact_mask among them, revcomp_both exactly once
     a replayed block (and once a block in the loop form's runs); a
     window of one
     replayed dispatch_block with one graph launch and no kernel launch;
     the dispatch and finish walls and each graph's warm-up and capture
     printed, not gated;
 11. wide reads: `build-index --read-len 400` of a 1 Mbp random genome,
     4,096 reads of 400 bp at k = 2 through the port CLI (verify_nm's
     run-time-W instance): truth, brute force on 256 sampled reads, the
     SAM equal to an engine pass, verify_nm launched;
 12. the ring (bwtpu_torch.multihost over bwtpu_torch.dist's DistEngine),
     ranks started as subprocesses with the environment torchrun sets:
     12a. NCCL, one rank per card (world = the card count): phase 5's
          index and reads, split into one stream per rank, at k = 0 and
          2; then `python -m torch.distributed.run --nproc-per-node
          <count> -m bwtpu_torch.cli scaling --shards 1`;
     12b. two gloo ranks on card 0, their hops through host memory:
          phase 10's 2-shard index, one shard per rank; its mate-1 reads
          (32,768 per rank) at k = 0 and 2 and its pairs through
          --paired at k = 2.
     Each run's merged per-rank SAM bodies byte-equal to sam.emit_sam /
     pair_and_emit_sam over the single-process Engine.align_all on the
     same reads (which phases 5 and 10 hold against truth and brute
     force); search_multistep, locate_walk, verify_nm, search_chain2,
     revcomp_both and compact_slots launched in every rank and run (the
     ring's packed pipelines return compacted candidates: no hit
     compaction); reads/s, wall, heals and transport per rank;
 13. the bench: `python -m bwtpu_torch.cli bench` at its defaults (bench.py's
     configuration at full size) in a subprocess: rc 0, the JSON line with
     every key of bench.py's, platform cuda, every rate > 0, every overflow
     0, no null roofline or probe field, no guarded section failed;
     verify_locv, search_chain2 and row_gather_sum launched in its sections,
     search_multistep in each device, e2e and roofline section, it,
     locate_walk and verify_nm in every probe rank; then `align --profile`
     on phase 5's FASTQ at k = 2: SAM byte-equal to phase 5's, and
     search_multistep, locate_walk, verify_nm and search_chain2 named as
     kernels in the trace;
 14. human scale on one card:
     14a. test_scale_int32 (bwtpu's row-math check) at a human shard's
          size: build_fm_index of its genome (random, 2^28 + 4096 bp, seed
          77) with its config and kmer_d 11, built in a process of its own
          while phases 3-13 run, so that Engine._wide_steps(11) == 2. Its
          48 simulated reads plus its head and tail reads through
          Engine.align_batch at k = 0 and 2 (truth as the test asserts it,
          at least 8 truths past 2^27), then one block of 65,536 reads
          (scale_human_chip.py's --batch) through dispatch_block +
          finish_block at k = 0 and 2: every search_multistep call with
          wide_steps 2, the first of each k held against its plain version,
          timed, bounded and floored as in phase 10, and the first
          compact_slots and compact_mask call of each k (131,072 and
          393,216 candidate lanes) held against its plain version and
          timed; the block's truth;
          brute force over the whole shard on as many sampled reads as fit
          in 30 s (at least 16); search_multistep, locate_walk, verify_nm,
          search_chain2, revcomp_both, compact_slots and compact_mask
          launched; the shard's bytes on the card;
     14b. scripts/torch_scale_human.py as a subprocess (started beside
          14a's brute force, which is not timed) at 40 Mbp (10
          shards of ~4 Mbp) with small batches and --tiered: rc 0, both JSON
          lines with every key of scripts/scale_human.py's and
          scale_human_chip.py's (read with ast), every truth recovered,
          every hit sound, no overflowed read, search_multistep launched in
          both halves and search_chain2, locate_walk, verify_nm,
          revcomp_both, compact_slots and compact_mask in the card half;
          then its card half again on the kept artifact with
          --fuse: the same checks, fused_dispatch true, graphs replayed,
          and the same hits sound as the loop's (its launches: only the
          eager warm-ups, the replays' are not counted);
     14c. the port's measurement programs (scripts/torch_<name>.py, the
          JAX scripts' counterparts), all started at once as subprocesses,
          each in a session of its own (SWEEPS): scale_chr21 on an E.
          coli-size genome with 131,072 reads at sa_rate 1 and 8;
          sweep_locate at B 65,536 with locv on and off and at sa_rate 2;
          tune_exact at B 65,536, loc_factor 0.25 and 0.125 (the caps
          bite); ab_batch 65536:11 with and without --k2; sweep_depth at
          depths 10 and 11; e2e_profile on 131,072 reads; profile_build
          at 16 Mbp. Each: rc 0, every line with the reference's keys
          (SWEEP_KEYS) or format (SWEEP_LINES), overflow 0 where the
          reference fails on it (sweep_locate, ab_batch), search_multistep
          launched (all but profile_build, which runs on the host); each
          one's wall and lines printed, their launches summed.
     Cuts: 14a is 1 shard of a human genome's 10, at its own offset of 0;
     14b is 40 Mbp of 2.5 Gbp; 14c as listed (the full sizes are the
     programs' defaults). Positions past 2^31 on the card come only
     from the script's full-size run, not from this smoke;
 15. the result lines.

The genome is random at E. coli size (4,641,652 bp) with one dispersed
repeat family (300 copies of a 12 bp motif), so that some 11-mer start
intervals span more than two lattice blocks and the 1-step search's
straggler fixup runs, as a real genome's repeat families make it do.

The JAX package is never imported: correctness comes from independent
oracles (the golden SAM, truth, brute force, the plain versions).
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

SEED = 20261016
N_READS = 131072
GATHER_IDX = 1 << 20  # indices of one row_gather_sum call
BATCH = 16384
N_SAMPLED = 256
LANES = 65536  # compacted candidate lanes of one k = 2 batch (cap = 2 x 2B)
REPEAT, N_REPEATS = "GATCCGTTAGCA", 300
N_PAIRS = 4 * BATCH  # phase 10
WIDE_GENOME, WIDE_READS, WIDE_L = 1_000_000, 4096, 400  # phase 11


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def say(*a) -> None:
    print(*a, flush=True)


def phase_card():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    say("[1] card")
    say(smi)
    name = torch.cuda.get_device_name(0)
    say(f"torch: {torch.__version__} cuda {torch.version.cuda}; device 0: {name}; "
        f"count {torch.cuda.device_count()}")
    return name, smi


def phase_build():
    from bwtpu_torch import sais
    from bwtpu_torch.kernels import _build

    say("[2] the port's native host library (g++), then the kernel build (nvcc "
        "-gencode arch=compute_90a,code=sm_90a), in parallel")
    require(sais.native_available(), "the native host library did not build or load "
                                     "(bwtpu_torch/csrc/host/*.cc)")
    say(f"  native host library loaded: {os.path.relpath(sais.build_info['so'])} "
        f"(built in {sais.build_info['seconds']:.2f} s)")
    t0 = time.perf_counter()
    _build.build_all(_build.SOURCES)
    for name in _build.SOURCES:
        info = _build.build_info[name]
        regs = [int(w) for line in info["ptxas"].splitlines() if "Used" in line
                for w in line.split("Used")[1].split()[:1]]
        spills = [line.strip() for line in info["ptxas"].splitlines() if "spill" in line
                  and "0 bytes spill stores, 0 bytes spill loads" not in line]
        # a register array indexed by a value the compiler cannot fold
        # lives in local memory: its stack frame
        stack = [int(line.split("bytes stack frame")[0].split()[-1])
                 for line in info["ptxas"].splitlines() if "bytes stack frame" in line]
        say(f"  {name}.cu: built in {info['seconds']:.2f} s; {len(regs)} kernels, "
            f"registers {min(regs, default=0)}-{max(regs, default=0)}; largest stack frame "
            f"{max(stack, default=0)} B; spills: {'; '.join(spills) or 'none'}")
    say(f"  build total {time.perf_counter() - t0:.2f} s")


def build_sa1_index(tmp: str, fa: str) -> str:
    """`build-index --sa-rate 1` through the port CLI, otherwise at the
    CLI defaults; returns the index directory."""
    idx_dir = os.path.join(tmp, "ecoli_idx_sa1")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as built:
        run_cli(["build-index", fa, idx_dir, "--sa-rate", "1"])
    say(f"  build-index --sa-rate 1: {time.perf_counter() - t0:.1f} s; "
        f"{built.getvalue().strip()}")
    return idx_dir


def phase_kernels(tmp: str, genome: str, fa: str, reads, p5_reads):
    """Kernel vs plain: edge cases, then the main path's own calls;
    returns the kernel records and the sa_rate 1 index directory.
    `reads` are the Read-list phase's mixed-length reads, `p5_reads`
    phase 5's reads (its first block; all of them, tiled, the bench-sized
    search call)."""
    import numpy as np
    import torch

    from bwtpu_torch.config import EngineConfig
    from bwtpu_torch.index import build_fm_index
    from bwtpu_torch.kernels.locate import _locate_plain, locate_walk
    from bwtpu_torch.kernels.verify2 import build_text_rows

    say("[3] kernels vs plain torch on the card (exact equality)")
    sa1_dir = build_sa1_index(tmp, fa)
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731

    for sa_rate in (8, 16):
        idx = build_fm_index(genome, EngineConfig(sa_rate=sa_rate))
        lat, ssa, C = put(idx.search_lattice), put(idx.ssa), put(idx.C)
        rows = rng.integers(0, idx.n, size=LANES).astype(np.int32)
        rows[:4] = [idx.dollar_row, idx.n - 1, 0, 1]  # '$' row, last row
        valid = rng.random(LANES) < 0.9
        valid[:4] = True
        # compacted lanes as compact_counts hands them over: the first
        # `count` slots name distinct rows, the rest are 0
        n_live = int(valid.sum())
        sel = np.zeros(LANES, np.int32)
        sel[:n_live] = rng.permutation(np.flatnonzero(valid))
        rows_t, sel_t, count_t = put(rows), put(sel), torch.tensor(n_live, device=dev,
                                                                   dtype=torch.int32)
        # the index's own walk, then a walk too short for it: lanes not
        # found within the trips must report ssa[0] + 0 in both versions
        for trips in (sa_rate, sa_rate // 2):
            got = locate_walk(lat, ssa, C, idx.dollar_row, rows_t, sel_t, count_t, trips)
            ref = _locate_plain(lat, ssa, C, idx.dollar_row, rows_t, sel_t, count_t, trips)
            torch.cuda.synchronize()
            err = int((got.long() - ref.long()).abs().max())
            require(err == 0, f"locate_walk != plain (sa_rate {sa_rate}, "
                              f"{trips} trips): max |diff| {err}")
        at_ssa0 = int((ref[:n_live] == int(idx.ssa[0])).sum())
        say(f"  locate_walk  sa_rate {sa_rate:2d}, {n_live} of {LANES} lanes on random "
            f"rows: equal; lanes at ssa[0] after the short walk: {at_ssa0}")
        if sa_rate == 8:  # the CLI default: the main path's index
            idx8 = idx
            text_rows = put(build_text_rows(idx.text_packed, 100))
            text_len = idx.text_len
            latk = put(idx.occk_lattice)

    verify_edges(text_rows, text_len, put, rng)
    wide = verify_wide(idx8, put, rng)
    records = main_path_kernels(idx8, p5_reads[:BATCH])
    records["search_multistep"]["bench"] = multistep_bench(sa1_dir, p5_reads)
    records["verify_nm"].update(wide)
    records.update(search_kernels(idx8, reads[:BATCH], put))
    records["sw_band"] = sw_kernel(idx8, reads[:BATCH])
    locv = locv_kernel(genome, sa1_dir, put, rng, records)
    records["row_gather_sum"] = gather_kernel(put(locv), latk, rng)
    return records, sa1_dir


def verify_edges(text_rows, text_len: int, put, rng, L: int = 100):
    """verify_nm against its plain version on random compacted candidates
    of L bp reads (W = ceil(L / 16) words; text rows built for L): 1,024
    read rows x 3 seed slots x 32 slots each, 61,440 of 65,536 slots live,
    positions in and out of the text, -1, bit phase 0, the last two
    starts; seed offsets past the read's end; reads shorter than L.
    Returns the arguments and the plain version's outputs."""
    import numpy as np
    import torch

    from bwtpu_torch.kernels.verify2 import pack_reads, verify_nm, verify_nm_plain

    B2, n_slots, max_loc, count = 1024, 3, 32, LANES * 15 // 16
    codes = rng.integers(0, 4, size=(B2, L)).astype(np.int32)
    amb = (rng.random((B2, L)) < 0.01).astype(np.int32)
    lens = np.full(B2, L, np.int32)
    lens[::7] = rng.integers(30, L, size=len(lens[::7]))
    rw, ab, lm = pack_reads(codes, amb, lens)
    seed_off = rng.integers(0, L, size=B2 * n_slots).astype(np.int32)
    seed_off[::11] = rng.integers(L, L + 30, size=len(seed_off[::11]))
    sel = np.zeros(LANES, np.int32)
    sel[:count] = np.sort(rng.choice(B2 * n_slots * max_loc, count, replace=False))
    spos = rng.integers(-10, text_len + 10, size=LANES).astype(np.int32)
    spos[2::6] &= ~15  # bit phase 0
    spos[:5] = [-1, 0, 16 * 1000, text_len - L, text_len - L + 1]
    spos[:5] += seed_off[sel[:5] // max_loc]
    spos[count:] = -1
    args = (text_rows, text_len, put(spos), put(sel),
            torch.tensor(count, dtype=torch.int32, device=text_rows.device), put(seed_off),
            put(rw), put(ab), put(lm), put(lens), max_loc, n_slots)
    got, want = verify_nm(*args), verify_nm_plain(*args)
    torch.cuda.synchronize()
    err = max(int((a - b).abs().max()) for a, b in zip(got, want))
    require(err == 0, f"verify_nm != verify_nm_plain (L {L}): max |diff| {err}")
    say(f"  verify_nm    L {L}, W {rw.shape[1]}, {LANES} compacted slots ({count} live, "
        f"{n_slots} seed slots): equal; in range {int((want[1] != 255).sum())}")
    return args, want


def verify_wide(idx, put, rng) -> dict:
    """verify_nm's run-time-W instance (reads over 320 bases) at W = 25
    (L 400, text rows built for 400) on verify_edges' inputs: checked,
    timed beside its plain version, its bound counted from the inputs."""
    from bwtpu_torch.kernels.bounds import bound, cuda_ms
    from bwtpu_torch.kernels.verify2 import build_text_rows, verify_nm, verify_nm_plain

    args, want = verify_edges(put(build_text_rows(idx.text_packed, 400)), idx.text_len,
                              put, rng, L=400)
    ms = sorted(cuda_ms(lambda: verify_nm(*args)) for _ in range(RUNS))[RUNS // 2]
    plain = cuda_ms(lambda: verify_nm_plain(*args))
    nbytes, ops, what = verify_work(args)
    b = bound(nbytes, ops)
    say(f"  verify_nm W 25 (run-time W; {what}): kernel {ms:.4f} ms, plain {plain:.4f} ms; "
        f"bound {b['bound_ms']:.5f} ms ({b['bound_by']}: {b['bound_bytes']} B, "
        f"{b['bound_ops']} ops)")
    return {"w25_ms": ms, "w25_plain_ms": plain, "w25_bound_ms": b["bound_ms"]}


def sw_kernel(idx, batch) -> dict:
    """sw_band on the very arguments --rescore hands it for one Read-list
    batch (16,384 of phase 6's reads, k = 2, on the CLI-default index):
    Engine.align_batch, the primary of each mapped read, then
    sw.rescore_candidates with sw_score_batch captured. Exact equality
    with sw_score_plain, CUDA-event times of both, the bound (each lane's
    text window and read codes and the two lengths read once, one score
    written; ~10 integer operations per band cell and row), and the SASS
    of the band-8 instance's row loop."""
    import torch

    from bwtpu_torch import sw
    from bwtpu_torch.engine import Engine
    from bwtpu_torch.golden import select_primary
    from bwtpu_torch.kernels.bounds import bound, cuda_ms

    eng = Engine([idx], device="cuda")
    hits = eng.align_batch(batch, 2)
    primaries = [[select_primary(h)[0]] if h else [] for h in hits]
    calls = []
    with capturing(sw, "sw_score_batch", calls):
        sw.rescore_candidates(eng, batch, primaries)
    require(len(calls) == 1, f"rescore_candidates made {len(calls)} sw_score_batch calls")
    text, tl, reads, rl = calls[0][:4]
    got, want = sw.sw_score_batch(*calls[0]), sw.sw_score_plain(*calls[0])
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    require(err == 0, f"sw_band != sw_score_plain: max |diff| {err}")
    ms = sorted(cuda_ms(lambda: sw.sw_score_batch(*calls[0])) for _ in range(RUNS))[RUNS // 2]
    plain = cuda_ms(lambda: sw.sw_score_plain(*calls[0]), reps=5)
    B, L = reads.shape
    band = 8
    b = bound((text.numel() + reads.numel() + 3 * B) * 4, B * L * (2 * band + 1) * 10)
    say(f"  sw_band {B} lanes x L {L}, Lt {text.shape[1]}, band {band} (--rescore's call for "
        f"one Read-list batch at k = 2): equal; kernel {ms:.4f} ms, "
        f"plain {plain:.4f} ms; bound {b['bound_ms']:.5f} ms ({b['bound_by']}: "
        f"{b['bound_bytes']} B, {b['bound_ops']} ops); scores {int(want.min())}-"
        f"{int(want.max())}; read length {float(rl.float().mean()):.1f} on average")
    rec = dict(max_abs_err=err, ms=ms, plain_ms=plain, **b)
    rec.update(sw_sass(band))
    return rec


def sw_sass(band: int) -> dict:
    """The interior row loop (the largest loop; 4 rows an iteration, as
    csrc/sw.cu unrolls it) of each sw_band instance in SASS, where the
    toolkit has cuobjdump: its instructions, and for the `band` instance
    its DPX instructions; {} without cuobjdump."""
    from bwtpu_torch.kernels import _build

    listing = _build.sass("sw")
    if listing is None:
        say("  sw_band SASS: no cuobjdump in the toolkit")
        return {}
    loops = _build.sass_loops(listing)
    sizes = {}
    for fn, found in loops.items():
        if "sw_band_kernel" in fn and found:
            sizes[int(fn.split("ILi")[1].split("E")[0])] = found[0]
    size, ops = sizes[band]
    dpx = sum(v for k, v in ops.items() if k.startswith(("VIADDMNMX", "VIMNMX")))
    say(f"  sw_band interior row loop in SASS (4 rows an iteration), instructions by band: "
        f"{ {k: sizes[k][0] for k in sorted(sizes)} }; band {band}: {size}, of which DPX "
        f"{dpx}; most frequent {sorted(ops.items(), key=lambda kv: -kv[1])[:6]}")
    return {"row_loop_sass": size, "row_loop_dpx": dpx}


def clone_args(args) -> tuple:
    """Clones of a call's positional arguments (tensors, and tuples of
    them). The in-place prep call (words and amb that are rows [0, B) of
    the `out` planes, as Engine makes it) is cloned as such a call."""
    import torch

    def clone(a):
        if isinstance(a, torch.Tensor):
            return a.clone()
        if isinstance(a, tuple) and a and all(isinstance(t, torch.Tensor) for t in a):
            return tuple(t.clone() for t in a)
        return a

    out = [clone(a) for a in args]
    if (len(args) == 4 and isinstance(out[3], tuple)
            and args[0].data_ptr() == args[3][0].data_ptr()):
        B = args[0].shape[0]
        out[0], out[1] = out[3][0][:B], out[3][1][:B]
    return tuple(out)


@contextlib.contextmanager
def capturing(owner, name: str, calls: list):
    """Record a copy of the positional arguments of every call of
    owner.name while the block runs (the call itself goes through;
    clone_args)."""
    orig = getattr(owner, name)

    def rec(*args):
        calls.append(clone_args(args))
        return orig(*args)

    rec.launches = 0  # the wrapper counts its launch on the name it is called by
    setattr(owner, name, rec)
    try:
        yield
    finally:
        setattr(owner, name, orig)
        if hasattr(orig, "launches"):  # the launches made under the capture
            orig.launches += rec.launches


@contextlib.contextmanager
def timing(owner, name: str, secs: dict, sync: bool = False):
    """Add the wall seconds of every call of owner.name while the block
    runs to secs[name] (0.0 without a call); with sync, the card is
    synchronised before and after each call, so its device work counts."""
    import torch

    orig = getattr(owner, name)
    secs.setdefault(name, 0.0)

    def timed(*args, **kw):
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return orig(*args, **kw)
        finally:
            if sync:
                torch.cuda.synchronize()
            secs[name] += time.perf_counter() - t0

    timed.launches = 0  # as in capturing: a wrapper counts on the name it is called by
    setattr(owner, name, timed)
    try:
        yield
    finally:
        setattr(owner, name, orig)
        if hasattr(orig, "launches"):
            orig.launches += timed.launches


def main_path_kernels(idx, block_reads):
    """search_multistep, search_chain2, locate_walk, verify_nm and the
    prep and compaction kernels (revcomp_both, compact_slots, compact_mask)
    on the arguments the main path itself hands them: one block of phase
    5's reads through Engine.dispatch_block + finish_block on the
    CLI-default index, at k = 0 (the full-read search and its finisher)
    and k = 2 (three seed searches and their finishers, 65,536 locate and
    verify lanes). Each call is checked against its plain version and
    timed (RUNS timings, their median recorded and their range printed);
    its bound is counted from these inputs; compact_mask's library call
    is timed. search_multistep's calls are also held as the whole
    search_early_stop_packed against its plain version; then its edge
    calls and the sync check, and a trace of one dispatch at each k with
    no plain compaction in it."""
    import torch

    from bwtpu_torch import engine
    from bwtpu_torch.kernels import compact, locate, prep, search2, searchk
    from bwtpu_torch.kernels.bounds import (bound, compact_mask_work, compact_slots_work,
                                            cuda_ms, multistep_work, revcomp_both_work)
    from bwtpu_torch.kernels.verify2 import verify_nm, verify_nm_plain
    from bwtpu_torch.readblock import ReadBlock

    blk = ReadBlock.from_reads(block_reads)
    # (owner, name called) of each kernel's wrapper on the main path
    owners = {"search_multistep": (searchk, "search_multistep"),
              "search_chain2": (search2, "search_chain2"),
              "locate_walk": (engine, "locate_walk"), "verify_nm": (engine, "verify_nm"),
              "revcomp_both": (engine, "revcomp_both"),
              "compact_slots": (engine, "compact_counts"), "compact_mask": (engine, "compact")}
    calls = {k: {n: [] for n in owners} for k in (0, 2)}
    for k in (0, 2):
        eng = engine.Engine([idx], device="cuda")
        with contextlib.ExitStack() as stack:
            for n, (owner, attr) in owners.items():
                stack.enter_context(capturing(owner, attr, calls[k][n]))
            eng.finish_block(eng.dispatch_block(blk, k, pad_to=BATCH))
        say(f"  one block of phase 5 at k={k}: heals {eng.stats.heals}; calls "
            f"{ {n: len(c) for n, c in calls[k].items()} }")
    kernels = {"search_multistep": (searchk.search_multistep, searchk.search_multistep_plain,
                                    multistep_work),
               "search_chain2": (search2.search_chain2, search2._chain2_plain, chain2_work),
               "locate_walk": (locate.locate_walk, locate._locate_plain, locate_work),
               "verify_nm": (verify_nm, verify_nm_plain, verify_work),
               "revcomp_both": (prep.revcomp_both, prep.revcomp_both_plain, revcomp_both_work),
               "compact_slots": (compact.compact_counts, compact.compact_counts_plain,
                                 compact_slots_work),
               "compact_mask": (compact.compact, compact.compact_plain, compact_mask_work)}
    # (name, k, call index, time the plain version too): the first call of
    # the block at each k; the heal's re-run repeats them at doubled caps
    require(len(calls[0]["search_multistep"]) >= 1 and len(calls[2]["search_multistep"]) >= 3
            and calls[0]["search_chain2"] and len(calls[2]["search_chain2"]) >= 3
            and calls[2]["locate_walk"] and calls[2]["verify_nm"]
            and all(calls[k][n] for k in (0, 2) for n in PACKED),
            f"the block did not reach every kernel: "
            f"{ {k: {n: len(c) for n, c in v.items()} for k, v in calls.items()} }")
    plan = [("search_multistep", 0, 0, True)] + [
        ("search_multistep", 2, i, i == 0) for i in range(3)] + [
        ("search_chain2", 0, 0, True)] + [
        ("search_chain2", 2, i, i == 0) for i in range(3)] + [
        ("locate_walk", 2, 0, True), ("verify_nm", 2, 0, True)] + [
        (n, k, 0, True) for n in PACKED for k in (0, 2)]
    records = {}
    for name, k, i, time_plain in plan:
        kern, plain, work = kernels[name]
        args = calls[k][name][i]
        want = call_outputs(name, plain, args)
        got = call_outputs(name, kern, args)
        torch.cuda.synchronize()
        err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(got, want))
        require(err == 0, f"{name} != plain on the main path's call (k={k}, #{i})")
        if name == "search_multistep":
            multistep_whole(args, f"k={k} call {i}")
        targs = fresh_args(name, args)
        mine = sorted(cuda_ms(lambda: kern(*targs)) for _ in range(RUNS))
        ms = mine[RUNS // 2]
        plain_ms = (cuda_ms(lambda: plain(*fresh_args(name, args)),
                            reps=5 if name == "search_multistep" else 50) if time_plain
                    else None)
        nbytes, ops, what = work(args)
        rec = dict(max_abs_err=0, ms=ms, plain_ms=plain_ms, **bound(nbytes, ops))
        say(f"  {name} k={k} call {i} ({what}): equal; kernel {ms:.4f} ms (runs "
            f"{mine[0]:.4f}-{mine[-1]:.4f})"
            + (f", plain {plain_ms:.4f} ms" if time_plain else "")
            + f"; bound {rec['bound_ms']:.5f} ms ({rec['bound_by']}: "
              f"{rec['bound_bytes']} B, {rec['bound_ops']} ops)")
        if name == "search_chain2" and k == 0:
            rec.update(chain2_floor(kern, args))
        if name == "search_multistep" and k == 2:
            records[name].setdefault("k2_ms", []).append(ms)
            records[name].setdefault("k2_bound_ms", []).append(rec["bound_ms"])
            if time_plain:
                records[name]["k2_plain_ms"] = plain_ms
        if name in PACKED and k == 2:
            records[name]["k2"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=rec["bound_ms"],
                                       shape=what)
        if name not in records:
            records[name] = rec
    ms = records["search_multistep"]
    ms.update(multistep_floor(calls[0]["search_multistep"][0], "k=0"))
    require(ms["ops_per_call"] is not None, "the profiler saw no device activity of the "
                                            "k = 0 search_early_stop_packed call")
    ms["k2_floor"] = multistep_floor(calls[2]["search_multistep"][0], "k=2 seed 0")
    multistep_edges(idx, calls[0]["search_multistep"][0])
    multistep_no_sync(idx, calls[0]["search_multistep"][0], blk)
    records["revcomp_both"].update(revcomp_instances(calls[0]["revcomp_both"][0]))
    records["compact_mask"].update(nonzero_static_ms(*calls[0]["compact_mask"][0]))
    for name in ("compact_slots", "compact_mask"):
        records[name].update(compaction_edges(name, calls[0][name][0], calls[2][name][0]))
    records["compact_slots"]["cluster"] = compaction_cluster()
    for k in (0, 2):
        no_plain_compaction(engine.Engine([idx], device="cuda"), blk, k)
    return records


PREP_FLOOR = 256  # reads of the floor call: the launch and one round trip to memory


def revcomp_instances(args) -> dict:
    """revcomp_both's two instances on the main path's reads (the in-place
    call `args`, which the engine makes and phase 3 timed): the forward one
    (the same reads as rows of their own, both halves written) held
    against the plain version, timed and bounded; then the floor, a call
    of PREP_FLOOR reads, of each instance."""
    import torch

    from bwtpu_torch.kernels import prep
    from bwtpu_torch.kernels.bounds import bound, cuda_ms, revcomp_both_work

    words, amb, L = args[0].clone(), args[1].clone(), args[2]
    B, W = PREP_FLOOR, words.shape[1]
    planes = tuple(torch.empty((2 * B, W), dtype=torch.int32, device=words.device)
                   for _ in range(2))
    planes[0][:B] = words[:B]
    planes[1][:B] = amb[:B]
    calls = {"forward": (words, amb, L),
             "floor_in_place": (planes[0][:B], planes[1][:B], L, planes),
             "floor_forward": (words[:B].clone(), amb[:B].clone(), L)}
    rec = {}
    for label, call in calls.items():
        got = prep.revcomp_both(*fresh_args("revcomp_both", call))
        want = prep.revcomp_both_plain(*fresh_args("revcomp_both", call))
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(got, want, strict=True)),
                f"revcomp_both {label} != plain")
        targs = fresh_args("revcomp_both", call)
        runs = sorted(cuda_ms(lambda: prep.revcomp_both(*targs)) for _ in range(RUNS))
        nbytes, ops, what = revcomp_both_work(call)
        b = bound(nbytes, ops)
        rec[f"{label}_ms"], rec[f"{label}_bound_ms"] = runs[RUNS // 2], b["bound_ms"]
        say(f"  revcomp_both {label} ({what}): equal; kernel {runs[RUNS // 2]:.4f} ms (runs "
            f"{runs[0]:.4f}-{runs[-1]:.4f}); bound {b['bound_ms']:.5f} ms ({b['bound_by']}: "
            f"{b['bound_bytes']} B)")
    return rec


def compaction_kernels(name: str):
    """(wrapper, plain version, work) of a compaction kernel."""
    from bwtpu_torch.kernels import compact
    from bwtpu_torch.kernels.bounds import compact_mask_work, compact_slots_work

    if name == "compact_slots":
        return compact.compact_counts, compact.compact_counts_plain, compact_slots_work
    return compact.compact, compact.compact_plain, compact_mask_work


def compaction_call(name: str, label: str, args) -> dict:
    """One compaction call held against its plain version on every
    output and timed (RUNS timings, their median), with its bound and the
    form the wrapper's plan took."""
    import torch

    from bwtpu_torch.kernels import compact
    from bwtpu_torch.kernels.bounds import bound, cuda_ms

    kern, plain, work = compaction_kernels(name)
    got, want = kern(*args), plain(*args)
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(got, want, strict=True)),
            f"{name} != plain on the {label} call")
    runs = sorted(cuda_ms(lambda: kern(*args)) for _ in range(RUNS))
    nbytes, ops, what = work(args)
    lib = compact._lib()
    form = compact.plan(args[0].shape[0], args[-1], compact._cluster_ctas(lib, args[0].device),
                        lib.tile)[0]
    form = f"cluster of {form} CTAs" if form else "tiles"
    rec = dict(ms=runs[RUNS // 2], form=form, **bound(nbytes, ops))
    say(f"  {name} {label} ({what}; {form}): equal on every output; kernel {rec['ms']:.4f} ms "
        f"(runs {runs[0]:.4f}-{runs[-1]:.4f}); bound {rec['bound_ms']:.5f} ms "
        f"({rec['bound_by']})")
    return rec


def compaction_cluster() -> dict:
    """The cluster compact.cu's cluster form takes on this card (the
    widest of 16, 8, 4, 2, 1 CTAs that cudaOccupancyMaxActiveClusters
    places)."""
    import torch

    from bwtpu_torch.kernels import compact

    lib = compact._lib()
    ctas = compact._cluster_ctas(lib, torch.device("cuda", 0))
    say(f"  compact.cu's cluster form: a cluster of {ctas} CTAs of {lib.tile} lanes; the "
        f"tiles form above {ctas * lib.tile} lanes")
    return {"ctas": ctas}


def compaction_edges(name: str, args0, args2) -> dict:
    """A compaction kernel's empty call (every count 0 / every lane false
    at the main path's k = 0 shape and capacity: its launch floor), and
    the edge between its forms: phase 5's k = 2 call tiled (capacity
    scaled alike) to one cluster's capacity and one lane more; each held
    against the plain version and timed."""
    import torch

    from bwtpu_torch.kernels import compact

    lib = compact._lib()
    x = args2[0]
    cluster = compact._cluster_ctas(lib, x.device) * lib.tile
    edges = {}
    for m in (cluster, cluster + 1):
        big = x.repeat(-(-m // x.shape[0]))[:m].contiguous()
        rec = compaction_call(name, f"edge {m} lanes",
                              (big, *args2[1:-1], max(1, args2[-1] * m // x.shape[0])))
        edges[str(m)] = {"ms": rec["ms"], "bound_ms": rec["bound_ms"], "form": rec["form"]}
        del big
    torch.cuda.empty_cache()
    empty = compaction_call(name, "empty call at k=0 call 0's shape",
                            (torch.zeros_like(args0[0]), *args0[1:]))
    return {"empty_ms": empty["ms"], "edges": edges}


def nonzero_static_ms(valid, cap) -> dict:
    """compact_mask's library call: torch.nonzero_static(valid, size=cap,
    fill_value=0), the same sel as int64, timed as the kernel is; its
    refusal recorded where the card's torch has no CUDA version of it."""
    import torch

    from bwtpu_torch.kernels.bounds import cuda_ms
    from bwtpu_torch.kernels.compact import compact_plain

    try:
        got = torch.nonzero_static(valid, size=cap, fill_value=0)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        say(f"  compact_mask's library call torch.nonzero_static refused: {e}")
        return {"library_ms": None, "library_refused": str(e)[:200]}
    require(torch.equal(got[:, 0], compact_plain(valid, cap)[0].long()),
            "torch.nonzero_static != compact_mask's sel")
    ms = sorted(cuda_ms(lambda: torch.nonzero_static(valid, size=cap, fill_value=0))
                for _ in range(RUNS))[RUNS // 2]
    say(f"  compact_mask's library call torch.nonzero_static({valid.shape[0]} lanes, size "
        f"{cap}): the same sel; {ms:.4f} ms")
    return {"library_ms": ms}


PLAIN_COMPACTION = ("cummax", "scatter_reduce")  # aten ops of compact_counts_plain


def no_plain_compaction(eng, blk, k: int) -> None:
    """One dispatch_block + finish_block of phase 5's block at k under
    torch.profiler (CPU and CUDA activity): no aten op or kernel of the
    plain compaction (cummax, scatter_reduce) in the trace; its device
    operations printed."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng.finish_block(eng.dispatch_block(blk, k, pad_to=BATCH))  # warm
    for _ in range(3):  # a window with no device activity delivered is retried
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            eng.finish_block(eng.dispatch_block(blk, k, pad_to=BATCH))
            torch.cuda.synchronize()
        events = prof.events()
        dev = [e for e in events if e.device_type == DeviceType.CUDA]
        if dev:
            break
    require(dev, f"k={k}: the profiler saw no device activity of the dispatch")
    bad = sorted({e.name for e in events if any(p in e.name for p in PLAIN_COMPACTION)})
    require(not bad, f"k={k}: the dispatch ran the plain compaction: {bad}")
    say(f"  one dispatch of phase 5's block at k={k} (heals {eng.stats.heals}) under "
        f"torch.profiler: {len(dev)} device operations, none of {PLAIN_COMPACTION}")


def chain2_floor(kern, args) -> dict:
    """search_chain2's latency floor: one lane's chain alone (count = 1)
    on the main path's lattice (L2-resident), then the same lane on the
    lattice of a 4,096 bp genome (4.2 KB, L1-resident) from [0, n): the
    same steps and loads, so the difference is the L2 round trip."""
    import torch

    from bwtpu_torch.config import EngineConfig
    from bwtpu_torch.index import build_fm_index
    from bwtpu_torch.kernels import search2
    from bwtpu_torch.kernels.bounds import cuda_ms
    from bwtpu_torch.simulate import random_genome

    one = torch.ones_like(args[7])
    steps = args[3].slen - args[10]
    small = build_fm_index(random_genome(4096, seed=SEED), EngineConfig(sa_rate=8))
    lat, C = (torch.from_numpy(a).to(args[0].device) for a in (small.search_lattice, small.C))
    runs = {"L2": (*args[:7], one, *args[8:]),
            "L1": (lat, C, small.dollar_row, args[3], torch.zeros_like(args[4]),
                   torch.full_like(args[5], small.n), args[6], one, *args[8:])}
    out = {}
    for where, a in runs.items():
        want = call_outputs("search_chain2", search2._chain2_plain, a)
        got = call_outputs("search_chain2", kern, a)
        require(all(torch.equal(x, y) for x, y in zip(got, want)),
                f"search_chain2 != plain on one lane ({where} lattice)")
        targs = fresh_args("search_chain2", a)
        out[where] = cuda_ms(lambda: kern(*targs))
    say(f"    one lane's chain (count = 1), {steps} steps: {out['L2']:.4f} ms "
        f"({out['L2'] / steps * 1e3:.3f} us per step) on the main path's lattice; "
        f"{out['L1']:.4f} ms ({out['L1'] / steps * 1e3:.3f} us per step) on a 4.2 KB "
        f"lattice (L1)")
    return {"one_lane_ms": out["L2"], "one_lane_l1_ms": out["L1"]}


def multistep_whole(args, what: str) -> None:
    """One search_multistep call's arguments through the whole
    search_early_stop_packed and through search_early_stop_packed_plain
    (the plain search, the same finisher): every output equal."""
    import torch

    from bwtpu_torch.kernels import searchk

    got = searchk.search_early_stop_packed(*args, with_stats=True)
    want = searchk.search_early_stop_packed_plain(*args, with_stats=True)
    torch.cuda.synchronize()
    names = ("sp", "ep", "rem", "overflow", "trips", "n_unf")
    bad = [n for n, a, b in zip(names, got, want) if not torch.equal(a, b)]
    require(not bad, f"search_early_stop_packed != plain ({what}): {bad}")
    say(f"  search_early_stop_packed {what} (off {args[8]}, L {args[9]}, d {args[10]}): "
        f"{', '.join(names)} equal to the plain version; trips {int(want[4])}, "
        f"n_unf {int(want[5])}, overflow {int(want[3].sum())}")


def multistep_floor(args, what: str) -> dict:
    """search_multistep's floors on a call's arguments: the empty call
    (stop width 2^30 and min_trips 0: every lane stops at its start
    interval, so the call is its launches and the prologue), and the lane
    with the largest exit trip alone (its chain of dependent trips); each
    against the plain version. Then the operations one
    search_early_stop_packed call puts on the card (torch.profiler, CUDA
    activity, over OPS_CALLS calls: the memset, the search, the exit and
    search_chain2), which must be <= 4; None where no window of three
    delivered a whole multiple of OPS_CALLS device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bwtpu_torch.kernels import searchk
    from bwtpu_torch.kernels.bounds import cuda_ms

    leave = searchk.lanes_plain(*args)[6]
    lane = int(torch.argmax(leave))
    one = (*args[:6], args[6][lane:lane + 1].contiguous(), args[7][lane:lane + 1].contiguous(),
           *args[8:])
    empty = (*args[:12], 1 << 30, 0, *args[14:])
    out = {}
    for name, a in (("one_lane", one), ("empty", empty)):
        got, want = searchk.search_multistep(*a), searchk.search_multistep_plain(*a)
        torch.cuda.synchronize()
        require(all(torch.equal(x, y) for x, y in zip(got, want)),
                f"search_multistep != plain on the {name} call ({what})")
        out[f"{name}_ms"] = cuda_ms(lambda: searchk.search_multistep(*a))
    searchk.search_early_stop_packed(*args)
    torch.cuda.synchronize()
    ops, seen = None, []
    for _ in range(3):  # a window the profiler delivered only part of is retried
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(OPS_CALLS):
                searchk.search_early_stop_packed(*args)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        seen.append(len(names))
        if names and len(names) % OPS_CALLS == 0:
            ops = len(names) // OPS_CALLS
            require(ops <= 4, f"search_early_stop_packed ({what}) put {ops} operations a call "
                              f"on the card: {names[:8]}")
            break
    out.update(one_lane_leave=int(leave[lane]), ops_per_call=ops)
    say(f"    {what}: one lane alone (exit trip {out['one_lane_leave']}) "
        f"{out['one_lane_ms']:.4f} ms; empty call {out['empty_ms']:.4f} ms; one "
        f"search_early_stop_packed call puts "
        + (f"{ops} operations on the card" if ops is not None else
           f"operations on the card not measured (the profiler delivered {seen} device "
           f"events for {OPS_CALLS} calls)"))
    return out


OPS_CALLS = 5  # search_early_stop_packed calls in one profiled window


def multistep_shape(label: str, args) -> dict:
    """search_multistep on one call of the main path at another shape:
    kernel against plain (every output), the whole search_early_stop_packed
    against its plain version, the kernel's time (RUNS timings, their
    median), its bound and its floors."""
    import torch

    from bwtpu_torch.kernels import searchk
    from bwtpu_torch.kernels.bounds import bound, cuda_ms, multistep_work

    got = searchk.search_multistep(*args)
    want = searchk.search_multistep_plain(*args)
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(got, want, strict=True)),
            f"search_multistep != plain on the {label} call")
    multistep_whole(args, label)
    runs = sorted(cuda_ms(lambda: searchk.search_multistep(*args)) for _ in range(RUNS))
    nbytes, ops, what = multistep_work(args)
    rec = dict(ms=runs[RUNS // 2], wide_steps=args[15], **bound(nbytes, ops))
    say(f"  search_multistep {label} ({what}, wide_steps {args[15]}): equal (all "
        f"{len(got)} outputs); kernel {rec['ms']:.4f} ms (runs {runs[0]:.4f}-{runs[-1]:.4f}); "
        f"bound {rec['bound_ms']:.5f} ms ({rec['bound_by']}: {rec['bound_bytes']} B, "
        f"{rec['bound_ops']} ops)")
    rec.update(multistep_floor(args, label))
    return rec


def multistep_bench(sa1_dir: str, reads) -> dict:
    """search_multistep at the bench's size: phase 5's reads tiled 4x in
    one block (524,288 reads, 1,048,576 lanes after device_prep_packed)
    through Engine.dispatch_block at k = 0 on phase 3's sa_rate 1 index."""
    from bwtpu_torch import engine
    from bwtpu_torch.index import load_index
    from bwtpu_torch.kernels import searchk
    from bwtpu_torch.readblock import ReadBlock

    blk = ReadBlock.from_reads(reads * 4)
    eng = engine.Engine(load_index(sa1_dir)[0], device="cuda")
    calls: list = []
    with capturing(searchk, "search_multistep", calls):
        eng.dispatch_block(blk, 0, pad_to=blk.n)
    require(len(calls) == 1 and calls[0][6].shape[0] == 2 * blk.n,
            f"the bench-sized block made {len(calls)} search_multistep calls")
    return multistep_shape(f"bench-sized k=0, {blk.n} reads", calls[0])


def multistep_edges(idx, args0) -> None:
    """search_multistep and the whole search against their plain versions
    on edge calls: phase 5's block (args0, its k = 0 call) at min_trips 0
    and 3, wide_steps 1 and 2, T = 0 (the last d + 1 bases), stop width 0 at
    cap_scale 4-32, of which one must exit strictly between min_trips and
    T; then a step-4 lattice (a 1 Mbp random genome built with occ_step=4,
    8,192 reads of 100 bp): the full read, a seed slice with the wide
    phase, and stop width 0."""
    import torch

    from bwtpu_torch.config import EngineConfig
    from bwtpu_torch.engine import device_prep_packed, pack_reads_for_bench
    from bwtpu_torch.index import build_fm_index
    from bwtpu_torch.kernels import searchk
    from bwtpu_torch.simulate import random_genome, simulate_reads

    head = args0[:8]
    off, L, d, step, stop, mt, cs, _ = args0[8:]
    edges = [("min_trips 0", head + (off, L, d, step, stop, 0, cs, 0)),
             ("min_trips 3", head + (off, L, d, step, stop, 3, cs, 0)),
             ("wide_steps 1", head + (off, L, d, step, stop, mt, cs, 1)),
             ("wide_steps 2", head + (off, L, d, step, stop, mt, cs, 2)),
             ("T = 0", head + (L - d - 1, d + 1, d, step, stop, mt, cs, 0))]
    edges += [(f"stop 0, cap_scale {c}", head + (off, L, d, step, 0, mt, c, 0))
              for c in (4, 8, 16, 32)]
    g4 = random_genome(1_000_000, seed=SEED + 15)
    idx4 = build_fm_index(g4, EngineConfig(sa_rate=8, occ_step=4))
    reads4, _ = simulate_reads(g4, 8192, read_len=100, max_mismatches=2, n_frac=0.005,
                               seed=SEED + 16)
    dev = args0[0].device
    put = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    rw2, ab2, _, _ = device_prep_packed(*(put(a) for a in pack_reads_for_bench(reads4)), 100)
    d4 = max(idx4.kmer_tables)
    for dd, (o, sl, sw, m, c, w) in ((d4, (0, 100, 16, 1, 1, 0)), (8, (33, 34, 32, 1, 1, 1)),
                                     (d4, (0, 100, 0, 1, 4, 0))):
        h4 = (put(idx4.search_lattice), put(idx4.occk_lattice), put(idx4.occk_invalid),
              put(idx4.C), idx4.dollar_row, put(idx4.kmer_tables[dd]), rw2, ab2)
        edges.append((f"step 4 (off {o}, L {sl}, d {dd}, stop {sw}, cap_scale {c}, "
                      f"wide {w})", h4 + (o, sl, dd, 4, sw, m, c, w)))
    between = []
    for what, a in edges:
        got, want = searchk.search_multistep(*a), searchk.search_multistep_plain(*a)
        whole = searchk.search_early_stop_packed(*a, with_stats=True)
        whole_plain = searchk.search_early_stop_packed_plain(*a, with_stats=True)
        torch.cuda.synchronize()
        require(all(torch.equal(x, y) for x, y in zip(got, want))
                and all(torch.equal(x, y) for x, y in zip(whole, whole_plain)),
                f"search_multistep edge call {what}: kernel != plain")
        T = searchk._shape(a[9], a[10], a[11], a[15], a[6].shape[0], a[14])[0]
        trips = int(want[6])
        if what.startswith("stop 0") and a[13] < trips < T:
            between.append(what)
        require(what != "T = 0" or T == trips == 0, f"edge call T = 0: T {T}, trips {trips}")
        say(f"  search_multistep edge {what}: equal (all {len(want)} outputs, and the whole "
            f"search's 6); T {T}, trips {trips}, n_unf {int(want[10])}, over_lane "
            f"{int(want[9].sum())}")
    require(between, "no edge call exited strictly between min_trips and T")


def multistep_no_sync(idx, args0, blk) -> None:
    """The k = 0 search (with_stats=False) under sync debug mode "error"
    must not raise; then a report, not a gate: whether a whole
    Engine.dispatch_block raises under it, and at which op."""
    import traceback

    import torch

    from bwtpu_torch import engine
    from bwtpu_torch.kernels import searchk

    want = searchk.search_early_stop_packed(*args0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = searchk.search_early_stop_packed(*args0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    require(all(torch.equal(x, y) for x, y in zip(got, want)), "search under sync debug")
    eng = engine.Engine([idx], device="cuda")
    eng.finish_block(eng.dispatch_block(blk, 0, pad_to=BATCH))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.dispatch_block(blk, 0, pad_to=BATCH)
        where = "it did not raise"
    except RuntimeError as e:
        f = [fr for fr in traceback.extract_tb(e.__traceback__) if "bwtpu_torch" in fr.filename]
        at = f"{os.path.relpath(f[-1].filename)}:{f[-1].lineno} ({f[-1].line})" if f else "?"
        where = f"it raised at {at}: {str(e).splitlines()[0]}"
    finally:
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    say(f"  no sync: search_early_stop_packed (k = 0 call, with_stats=False) ran under "
        f"torch.cuda.set_sync_debug_mode('error'); a whole Engine.dispatch_block (k = 0, "
        f"report only): {where}")


RUNS = 3  # timings of each main-path call (the spread)


def fresh_args(name: str, args):
    """search_chain2 writes into its sp and ep, the in-place revcomp_both
    into its planes: give them clones."""
    if name == "revcomp_both":
        return clone_args(args)
    if name != "search_chain2":
        return args
    return (*args[:8], args[8].clone(), args[9].clone(), args[10])


def call_outputs(name: str, fn, args) -> tuple:
    """fn's outputs on args, as a tuple (search_chain2's: its sp and ep)."""
    args = fresh_args(name, args)
    out = fn(*args)
    if name == "search_chain2":
        return args[8], args[9]
    return out if isinstance(out, tuple) else (out,)


def chain2_work(args):
    """(bytes, ops, what) of a search_chain2 call: the plain chain
    replayed to count the lattice blocks it touches (48 B of each: the
    checkpoint and BWT words), the lane-steps that load, and the deepest
    chain (its dependent record loads set the latency floor). Each lane
    also reads its pattern words (a packed row's words of the slice, or a
    planes row's active columns), sel, sp0 and ep0, and writes sp and ep."""
    import torch

    from bwtpu_torch.kernels import search2
    from bwtpu_torch.kernels.bounds import n_unique

    lat, C, dr, pattern, sp0, ep0, sel, count, _, _, d = args
    lanes = sel[: int(count)].long()
    codes, amb, lens = search2.lane_planes(pattern, lanes)
    sp, ep = sp0[lanes], ep0[lanes]
    blocks, steps = [], torch.zeros((), dtype=torch.int64, device=sp.device)
    for c, a, active in search2._steps(codes, amb, lens, d):
        live = active & (a == 0)
        blocks += [(sp >> 7)[live], (ep >> 7)[live]]
        steps += live.sum()
        sp, ep = search2.search_step(lat.index_select(0, sp >> 7),
                                     lat.index_select(0, ep >> 7), c, a, active, sp, ep,
                                     C, dr)
    n = lanes.numel()
    depth = int((lens.clamp(max=codes.shape[1]) - d).clamp(min=0).max()) if n else 0
    if isinstance(pattern, search2.Packed):
        lo, hi = pattern.off >> 4, (pattern.off + pattern.slen - 1 - d) >> 4
        per_lane = 2 * 4 * (hi - lo + 1)
    else:
        per_lane = 2 * 4 * int((lens - d).clamp(min=0).float().mean()) + 4 if n else 0
    nbytes = (n_unique(torch.cat(blocks)) * 48 if blocks else 0) + n * (per_lane + 4 + 16)
    return nbytes, int(steps) * 200, f"{n} lanes, chain depth {depth}"


def locate_work(args):
    """(bytes, ops, what) of a locate_walk call: the walk replayed to
    count the records it touches (68 B: checkpoints, BWT, marks, rank) and
    the ssa entries it reads; each live lane also reads sel and its row,
    and every lane writes its position."""
    import torch

    from bwtpu_torch.kernels import common
    from bwtpu_torch.kernels.bounds import n_unique

    lat, ssa, C, dr, rows, sel, count, sa_rate = args
    n = int(count)
    r = rows.index_select(0, sel[:n])
    done = torch.zeros(n, dtype=torch.bool, device=r.device)
    blocks, ranks, steps = [], [], 0
    for _ in range(sa_rate):
        j = r >> 7
        m = r & 127
        blocks.append(j[~done])
        steps += int((~done).sum())
        rec = lat.index_select(0, j)
        bit, inrank = common.mark_bit_and_rank(rec, m)
        found = (bit == 1) & ~done
        ranks.append((rec[:, common.MARK_RANK_WORD] + inrank)[found])
        done = done | found
        c = common.bwt_code_at(rec, m)
        lf = (common.select_scalar_table(C, c + 1, 8) + common.select_lane(rec[:, 0:4], c, 4)
              + common.block_rank(rec[:, 4:12], c, m)
              - ((c == 0) & ((dr >> 7) == j) & (dr < r)).to(torch.int32))
        r = torch.where(done, r, lf)
    Cc = sel.shape[0]
    nbytes = (n_unique(torch.cat(blocks)) * 68 + n_unique(torch.cat(ranks)) * 4
              + n * 8 + Cc * 4)
    return nbytes, steps * 60, f"{Cc} lanes, {n} live, {steps} record loads"


def verify_work(args):
    """(bytes, ops, what) of a verify_nm call: the text rows its in-range
    candidates load; each slot's sel and position; the seed offsets and
    the read-level rows (words, ambiguity bits, length mask, length) of
    the lanes and reads the live slots name, each read once (a plane of
    row stride 0 is one row); cand and nm out."""
    from bwtpu_torch.kernels.bounds import n_unique

    tr, tl, spos, sel, count, seed_off, rw, ab, lm, lens, max_loc, n_slots = args
    cap, W = sel.shape[0], rw.shape[1]
    n = int(count)
    lane = sel[:n] // max_loc
    b = lane // n_slots
    cand = spos[:n] - seed_off[lane]
    ok = (spos[:n] >= 0) & (cand >= 0) & (cand + lens[b] <= tl)
    n_ok = int(ok.sum())
    rows = n_unique(b)
    plane_rows = sum(rows if t.stride(0) else 1 for t in (rw, ab, lm))
    nbytes = (n_unique((cand[ok] >> 4) >> 3) * tr.shape[1] * 4 + cap * 8
              + n_unique(lane) * 4 + plane_rows * W * 4 + rows * 4 + cap * 8)
    return nbytes, n_ok * W * 12, f"{cap} slots, {n} live, {n_ok} in range"


def locv_kernel(genome: str, sa1_dir: str, put, rng, records):
    """verify_locv against its plain version at the locv table of the
    sa_rate 1 index in `sa1_dir`, 65,536 candidates of 100 bp reads: a
    third at the true start of their read, the rest at random rows; some
    seed offsets past the read, invalid lanes. Returns the host table
    (row_gather_sum's)."""
    import numpy as np
    import torch

    from bwtpu_torch import dna
    from bwtpu_torch.index import load_index
    from bwtpu_torch.kernels.bounds import bound, cuda_ms, n_unique
    from bwtpu_torch.kernels.verify2 import (build_locv_rows, pack_reads, verify_locv,
                                             verify_locv_plain)
    from bwtpu_torch.simulate import simulate_reads

    L = 100
    idx = load_index(sa1_dir)[0][0]
    locv = build_locv_rows(idx.text_packed, idx.ssa, L)
    reads, truth = simulate_reads(genome, LANES, read_len=L, max_mismatches=2,
                                  n_frac=0.01, seed=SEED + 6)
    c, m = dna.encode_with_mask("".join(r.seq for r in reads))
    codes, amb = c.reshape(LANES, L).astype(np.int32), m.reshape(LANES, L).astype(np.int32)
    rev = np.array([t["strand"] == "-" for t in truth])
    codes[rev] = 3 - codes[rev, ::-1]  # the strand that matches the text
    amb[rev] = amb[rev, ::-1]
    rw, ab, lm = pack_reads(codes, amb, np.full(LANES, L, np.int32))
    rank = np.empty(idx.n, np.int64)
    rank[idx.ssa] = np.arange(idx.n)
    off = rng.integers(0, L, size=LANES).astype(np.int32)
    start = np.array([t["pos"] for t in truth]) + off
    rows = rank[np.minimum(start, idx.text_len)].astype(np.int32)
    rows[1::3] = rng.integers(0, idx.n, size=len(rows[1::3]))
    off[2::11] = rng.integers(-30, 130, size=len(off[2::11]))
    valid = rng.random(LANES) < 0.9
    args = (put(locv), idx.text_len, put(rows), put(valid), put(off), put(rw), put(ab),
            put(lm), put(np.full(LANES, L, np.int32)))
    got, want = verify_locv(*args), verify_locv_plain(*args)
    torch.cuda.synchronize()
    err = max(int((a - b).abs().max()) for a, b in zip(got, want))
    require(err == 0, f"verify_locv != plain: max |diff| {err}")
    n_hit = int((want[1] <= 2).sum())
    require(n_hit > LANES // 4, f"verify_locv: only {n_hit} candidates with nm <= 2")
    ms = cuda_ms(lambda: verify_locv(*args))
    plain = cuda_ms(lambda: verify_locv_plain(*args))
    say(f"  verify_locv  L {L}, locv table {tuple(locv.shape)} ({locv.nbytes / 1e6:.1f} MB), "
        f"{LANES} candidates: equal; kernel {ms:.4f} ms, plain {plain:.4f} ms; "
        f"nm <= 2: {n_hit}")
    W = rw.shape[1]
    nbytes = (n_unique(args[2][args[3]]) * locv.shape[1] * 4 + LANES * 13
              + LANES * 3 * W * 4 + LANES * 8)
    records["verify_locv"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                  **bound(nbytes, int(valid.sum()) * W * 12))
    return locv


def gather_kernel(locv, latk, rng):
    """row_gather_sum against its plain version, 2^20 random indices each:
    the locv table (Wr 16, the record kept) and the multi-step lattice
    (Wr 128, 9.3 MB)."""
    import torch

    from bwtpu_torch.kernels.bounds import bound, cuda_ms, n_unique
    from bwtpu_torch.kernels.gather import row_gather_sum, row_gather_sum_plain

    rec = None
    for table in (locv, latk):
        idx = torch.from_numpy(rng.integers(0, table.shape[0], size=GATHER_IDX)
                               .astype("int32")).cuda()
        got, want = row_gather_sum(table, idx), row_gather_sum_plain(table, idx)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        require(err == 0 and bool(want[0].any()),
                f"row_gather_sum != plain (Wr {table.shape[1]}): max |diff| {err}")
        ms = cuda_ms(lambda: row_gather_sum(table, idx))
        plain = cuda_ms(lambda: row_gather_sum_plain(table, idx))
        say(f"  row_gather_sum {GATHER_IDX} rows of Wr {table.shape[1]} from "
            f"{table.numel() * 4 / 1e6:.1f} MB: equal; kernel {ms:.4f} ms "
            f"({ms * 1e6 / GATHER_IDX:.3f} ns/row), plain {plain:.4f} ms "
            f"({plain * 1e6 / GATHER_IDX:.3f} ns/row)")
        Wr = table.shape[1]
        rec = rec or dict(max_abs_err=err, ms=ms, plain_ms=plain, **bound(
            n_unique(idx) * Wr * 4 + GATHER_IDX * 4 + Wr * 4, GATHER_IDX * Wr))
    return rec


def search_kernels(idx, batch, put):
    """search_chain1 on the very arguments one batch of phase 6's reads
    hands it (Engine.dispatch_batch on the CLI-default index `idx`: 16,384
    mixed-length reads are 32,768 lanes x L 100 at d 11 for k = 0 and
    98,304 seed lanes x 34 at d 11 for k = 2), each call checked against
    its plain chain and timed RUNS times, and its one-lane floor; then
    search_chain2 on planes at the fixup's shape, min(B, max(256, B // 8))
    = 4,096 lanes x 89 steps."""
    import torch

    from bwtpu_torch import engine
    from bwtpu_torch.kernels import search2
    from bwtpu_torch.kernels.bounds import bound, cuda_ms
    from bwtpu_torch.kernels.search2 import (Planes, _search_ra_chain, _two_gather_search,
                                             search_chain1, search_chain2,
                                             start_intervals)

    calls = {0: [], 2: []}
    for k in (0, 2):
        with capturing(search2, "search_chain1", calls[k]):
            engine.Engine([idx], device="cuda").dispatch_batch(batch, k)
        torch.cuda.synchronize()
        require(len(calls[k]) == 1, f"dispatch_batch k={k}: {len(calls[k])} search_chain1 "
                                    f"calls")
    rec = {}
    for k, what in ((0, "k=0 reads"), (2, "k=2 seeds")):
        args = calls[k][0]
        codes, d = args[3], args[8]
        psp, pep, pstrag = _search_ra_chain(*args)
        ok = ~pstrag  # a kernel thread stops at its lane's first straggle
        sp, ep, strag = search_chain1(*args)
        torch.cuda.synchronize()
        err = max(int((strag != pstrag).sum()),
                  int((sp - psp)[ok].abs().max()), int((ep - pep)[ok].abs().max()))
        require(err == 0, f"search_chain1 != plain ({what}): max |diff| {err}")
        mine = sorted(cuda_ms(lambda: search_chain1(*args)) for _ in range(RUNS))
        ms = mine[RUNS // 2]
        plain = cuda_ms(lambda: _search_ra_chain(*args))
        nbytes, ops, (all_sectors, sectors) = chain1_work(args)
        b = bound(nbytes, ops)
        say(f"  search_chain1 {what} (dispatch_batch's call), {tuple(codes.shape)} lanes x "
            f"L, d {d}: equal (flags on all lanes, sp/ep off the {int(pstrag.sum())} "
            f"flagged); kernel {ms:.4f} ms (runs {mine[0]:.4f}-{mine[-1]:.4f}), plain "
            f"{plain:.4f} ms; bound {b['bound_ms']:.5f} ms ({b['bound_by']}: "
            f"{b['bound_bytes']} B, {b['bound_ops']} ops); L2 sectors requested "
            f"{sectors} ({sectors * 32 / 1e6:.1f} MB; the whole records would be "
            f"{all_sectors}, {all_sectors * 32 / 1e6:.1f} MB)")
        if k == 0:
            rec = dict(max_abs_err=0, ms=ms, plain_ms=plain, **b, l2_sectors=sectors,
                       **chain1_floor(args, pstrag))
        else:
            rec.update(seeds_ms=ms, seeds_plain_ms=plain, seeds_bound_ms=b["bound_ms"],
                       seeds_l2_sectors=sectors)
    records = {"search_chain1": rec}
    # the fixup's shape: 4,096 lanes x 89 steps; a quarter of the lanes
    # start from the depth-4 table's (wide) intervals
    lat, C, dr, codes, amb, lens, _, _, d = calls[0][0]
    B = codes.shape[0]
    cap = min(B, max(256, B // 8))
    kt = put(idx.kmer_tables[d])
    sp0, ep0 = start_intervals(kt, idx.n, codes[:cap], amb[:cap], lens[:cap], d)
    wsp, wep = start_intervals(put(idx.kmer_tables[4]), idx.n, codes[:cap], amb[:cap],
                               lens[:cap], 4)
    wide = torch.arange(cap, device=codes.device) % 4 == 0
    sp0 = torch.where(wide, wsp, sp0)
    ep0 = torch.where(wide, wep, ep0)
    want = _two_gather_search(lat, C, dr, codes[:cap], amb[:cap], lens[:cap], sp0, ep0, d)
    got = (torch.zeros_like(sp0), torch.zeros_like(ep0))
    search_chain2(lat, C, dr, Planes(codes[:cap], amb[:cap], lens[:cap]), sp0, ep0,
                  torch.arange(cap, dtype=torch.int32, device=codes.device),
                  torch.tensor(cap, dtype=torch.int32, device=codes.device), *got, d)
    torch.cuda.synchronize()
    err2 = max(int((a - b).abs().max()) for a, b in zip(got, want))
    require(err2 == 0, f"search_chain2 != plain: max |diff| {err2}")
    width = (ep0 - sp0)[wide]
    say(f"  search_chain2 (planes) {cap} lanes x {codes.shape[1] - d} steps: equal; "
        f"wide starts: median width {int(width.median())}")
    return records


def chain1_floor(args, pstrag) -> dict:
    """search_chain1's latency floor: one lane alone (full length, no N
    base, not flagged) on the main path's lattice (L2-resident), then the
    same lane on the lattice of a 4,096 bp genome (4.2 KB, L1-resident)
    from [0, 1): the same steps and loads, so the difference is the L2
    round trip."""
    import torch

    from bwtpu_torch.config import EngineConfig
    from bwtpu_torch.index import build_fm_index
    from bwtpu_torch.kernels import search2
    from bwtpu_torch.kernels.bounds import cuda_ms
    from bwtpu_torch.simulate import random_genome

    lat, C, dr, codes, amb, lens, sp0, ep0, d = args
    L = codes.shape[1]
    lane = int(torch.nonzero((lens == L) & ~pstrag & (amb.sum(1) == 0))[0])
    one = lambda t: t[lane:lane + 1].contiguous()  # noqa: E731
    small = build_fm_index(random_genome(4096, seed=SEED), EngineConfig(sa_rate=8))
    lat_s, C_s = (torch.from_numpy(a).to(lat.device) for a in (small.search_lattice, small.C))
    runs = {"L2": (lat, C, dr, one(codes), one(amb), one(lens), one(sp0), one(ep0), d),
            "L1": (lat_s, C_s, small.dollar_row, one(codes), one(amb), one(lens),
                   torch.zeros_like(one(sp0)), torch.ones_like(one(ep0)), d)}
    out = {}
    for where, a in runs.items():
        got, want = search2.search_chain1(*a), search2._search_ra_chain(*a)
        torch.cuda.synchronize()
        require(all(torch.equal(x, y) for x, y in zip(got, want)) and not bool(want[2]),
                f"search_chain1 != plain on one lane ({where} lattice)")
        out[where] = sorted(cuda_ms(lambda: search2.search_chain1(*a))
                            for _ in range(RUNS))[RUNS // 2]
    steps = L - d
    say(f"    one lane's chain alone, {steps} steps: {out['L2']:.4f} ms "
        f"({out['L2'] / steps * 1e3:.3f} us per step) on the main path's lattice; "
        f"{out['L1']:.4f} ms ({out['L1'] / steps * 1e3:.3f} us per step) on a 4.2 KB "
        f"lattice (L1)")
    return {"one_lane_ms": out["L2"], "one_lane_l1_ms": out["L1"]}


def chain1_work(args):
    """(bytes, ops, (L2 sectors, needed sectors)) of a search_chain1 call:
    the one-record chain replayed to count the lattice blocks it loads
    (96 B: this block's and the next block's checkpoint and BWT words)
    until each lane straggles; each lane reads its active columns of both
    planes, its length and start, and writes sp, ep and its flag. The
    sectors are the 32 B pieces of the lattice a lane-step requests: two
    (words 0-11), two more when ep lies in block j + 1 (words 16-31); the
    needed ones leave out those no rank reads."""
    import torch

    from bwtpu_torch.kernels import search2
    from bwtpu_torch.kernels.bounds import n_unique

    lat, C, dr, codes, amb, lens, sp, ep, d = args
    strag = torch.zeros_like(lens, dtype=torch.bool)
    blocks = []
    steps = torch.zeros((), dtype=torch.int64, device=sp.device)
    sectors = torch.zeros((), dtype=torch.int64, device=sp.device)
    needed = torch.zeros((), dtype=torch.int64, device=sp.device)
    for c, a, active in search2._steps(codes, amb, lens, d):
        j, je = sp >> 7, ep >> 7
        live = active & ~strag & (je <= j + 1)  # the lanes that load a record
        blocks.append(j[live])
        steps += live.sum()
        nxt = live & (je != j)
        sectors += 2 * live.sum() + 2 * nxt.sum()
        # the sectors the ranks need: the second past row 64 of block j,
        # the fourth past row 48 of block j + 1
        m_s, m_e = sp & 127, ep & 127
        needed += (live.sum() + (live & ((m_s > 64) | (~nxt & (m_e > 64)))).sum()
                   + nxt.sum() + (nxt & (m_e > 48)).sum())
        sp, ep, s2 = search2.search_step1(lat.index_select(0, j), c, a, active, sp, ep, C, dr)
        strag = strag | (s2 == 1)
    L = codes.shape[1]
    cols = (lens.clamp(max=L) - d).clamp(min=0).sum()
    nbytes = n_unique(torch.cat(blocks)) * 96 + int(cols) * 8 + lens.numel() * (12 + 9)
    return nbytes, int(steps) * 250, (int(sectors), int(needed))


def run_cli(argv):
    """Port CLI in-process; returns its summary dict."""
    from bwtpu_torch import cli as tcli

    return tcli.main(argv)


def phase_phix(tmp: str, root: str):
    from bwtpu_torch.io import read_fasta, write_fastq
    from bwtpu_torch.simulate import simulate_reads

    say("[4] phiX174 golden SAM through the port CLI on the card")
    fa = os.path.join(root, "data", "phiX174.fa")
    seq, _ = read_fasta(fa)
    reads = simulate_reads(seq, 64, read_len=50, max_mismatches=2, n_frac=0.01,
                           seed=174)[0]
    fq, idx, sam = (os.path.join(tmp, x) for x in ("phix.fq", "phix_idx", "phix.sam"))
    write_fastq(fq, reads)
    with contextlib.redirect_stdout(io.StringIO()):
        run_cli(["build-index", fa, idx, "--sa-rate", "4", "--read-len", "50",
                 "--max-hits", "8", "--max-cand", "8"])
    run_cli(["align", idx, fq, "-o", sam, "-k", "2", "--batch-size", "64",
             "--device", "cuda"])
    with open(sam, "rb") as a, open(os.path.join(root, "data", "phiX174_golden.sam"), "rb") as b:
        got, want = a.read(), b.read()
    require(got == want, "phiX SAM differs from data/phiX174_golden.sam")
    say(f"  byte-equal to data/phiX174_golden.sam ({len(got)} bytes)")


def brute_force(g_t, patterns, masks, k: int):
    """Hits (pattern index, pos, nm) with Hamming <= k over every window
    of the genome codes g_t (uint8, on the card); an ambiguous pattern
    base mismatches everything (golden.brute_force_align's rule)."""
    import torch

    L = patterns.shape[1]
    N = g_t.shape[0] - L + 1
    count_type = torch.uint8 if L < 256 else torch.int16  # counts up to L, no wrap
    out = []
    for lo in range(0, patterns.shape[0], 64):
        P, M = patterns[lo:lo + 64], masks[lo:lo + 64]
        mism = torch.zeros((P.shape[0], N), dtype=count_type, device=g_t.device)
        for i in range(L):
            mism += (g_t[i:i + N].unsqueeze(0) != P[:, i:i + 1]) | M[:, i:i + 1]
        pi, pos = torch.nonzero(mism <= k, as_tuple=True)
        out.append(torch.stack([pi + lo, pos, mism[pi, pos].long()], 1).cpu())
    return torch.cat(out).numpy()


def phase_main(tmp: str, genome: str, fa: str, reads, truth):
    import numpy as np
    import torch

    from bwtpu_torch import dna
    from bwtpu_torch.engine import Engine
    from bwtpu_torch.index import load_index
    from bwtpu_torch.io import write_fastq
    from bwtpu_torch.results import ContigTable
    from bwtpu_torch.sam import sam_header

    say(f"[5] slice 1's path at E. coli scale ({len(genome)} bp, {N_READS} reads x 100 bp)")
    idx_dir, fq = (os.path.join(tmp, x) for x in ("ecoli_idx", "reads.fq"))
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as built:
        run_cli(["build-index", fa, idx_dir])  # CLI defaults: sa_rate 8, L 100
    say(f"  build-index: {time.perf_counter() - t0:.1f} s (native SA-IS); "
        f"{built.getvalue().strip()}")
    shards, manifest = load_index(idx_dir)
    cfg = shards[0].config
    say(f"  config: sa_rate {cfg.sa_rate}, kmer_d {cfg.kmer_d}, read_len {cfg.read_len}, "
        f"max_hits {cfg.max_hits}, max_cand {cfg.max_cand}, min_trips {cfg.min_trips}")

    t0 = time.perf_counter()
    write_fastq(fq, reads)
    say(f"  wrote FASTQ: {time.perf_counter() - t0:.1f} s")

    g_t = torch.from_numpy(dna.encode(genome)).cuda()
    sample = np.sort(np.random.default_rng(SEED + 2).choice(N_READS, N_SAMPLED, replace=False))
    t_pos = np.array([t["pos"] for t in truth], np.int64)
    t_rev = np.array([t["strand"] == "-" for t in truth])
    t_nm = np.array([t["nm"] for t in truth], np.int64)
    ctable = ContigTable.build(manifest.contigs)
    stats = {}
    ctx = dict(fq=fq, reads=reads, g_t=g_t, sample=sample, t_pos=t_pos,
               t_rev=t_rev, t_nm=t_nm, sam={}, keys={}, bf={})

    for k in (0, 2):
        # engine pass over the same FASTQ: hit sets for the checks
        eng = Engine(shards, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cols, sam_body = engine_pass(eng, fq, k, ctable)
        eng_s = time.perf_counter() - t0
        ridx, pos, rev, nm = cols

        key = lambda r, p, s, m: ((r * 4 + m) << 34) | (p << 1) | s  # noqa: E731
        have = key(ridx, pos, rev, nm)
        want_rows = np.flatnonzero(t_nm <= k)
        want = key(want_rows, t_pos[want_rows], t_rev[want_rows].astype(np.int64),
                   t_nm[want_rows])
        found = np.isin(want, have)
        require(found.all(), f"k={k}: truth missing for {int((~found).sum())} of "
                             f"{len(want)} reads")

        bf_set = brute_force_sample(g_t, reads, sample, k)
        ctx["bf"][k], ctx["keys"][k] = bf_set, np.sort(have)
        if k == 0:
            ctx["k0_reads"] = np.unique(ridx)
        check_sampled(cols, bf_set, sample, k, "phase 5")

        # the main path through the CLI, kernel launches counted
        sam = os.path.join(tmp, f"k{k}.sam")
        reset_launches()
        summary = run_cli(["align", idx_dir, fq, "-o", sam, "-k", str(k),
                           "--batch-size", str(BATCH), "--device", "cuda"])
        launches = read_launches()
        # slice 1's path: prep, the multi-step search, its two-record
        # finisher, the compactions, locate and verify; the 1-step
        # mainline is not on it
        need = ("search_multistep", "locate_walk", "verify_nm", "search_chain2") + PACKED
        require(all(launches[n] > 0 for n in need), f"k={k}: a kernel never ran: {launches}")
        with open(sam, "rb") as f:
            sam_bytes = f.read()
        require(sam_bytes == sam_header(manifest.contigs).encode() + sam_body,
                f"k={k}: CLI SAM differs from the engine pass")
        require(summary["reads"] == N_READS, f"k={k}: CLI aligned {summary['reads']} reads")
        require(summary["truncated_reads"] == 0 and b"xo:i:1" not in sam_bytes,
                f"k={k}: truncated reads")
        ctx["sam"][k] = sam_bytes
        say(f"  k={k}: truth {len(want)}/{len(want)} recovered; brute force equal on "
            f"{N_SAMPLED} reads ({len(bf_set)} hits); hits {len(have)}; "
            f"engine pass {N_READS / eng_s:.1f} reads/s ({eng_s:.3f} s); CLI FASTQ->SAM "
            f"{summary['reads_per_s']} reads/s ({summary['wall_s']} s); heals "
            f"{summary['heals']}, overflow_reads {summary['overflow_reads']}, "
            f"compact_overflows {summary['compact_overflows']}; launches {launches}")
        n_blocks = N_READS // BATCH
        say(f"  k={k}: launches per block of {BATCH} reads (heals included): "
            f"{ {n: c / n_blocks for n, c in launches.items()} }")
        stats[k] = launches
    return idx_dir, {name: sum(s[name] for s in stats.values()) for name in stats[0]}, ctx


def phase_read_list(tmp: str, genome: str, idx_dir: str, reads, truth):
    """The Read-list path: FASTA reads of mixed lengths through the port
    CLI (and, for the hit-set checks, Engine.align_all)."""
    import numpy as np
    import torch

    from bwtpu_torch import dna
    from bwtpu_torch.index import load_index
    from bwtpu_torch.io import write_fasta
    from bwtpu_torch.sam import emit_sam
    from bwtpu_torch.engine import Engine

    lens = np.array([len(r.seq) for r in reads])
    say(f"[6] Read-list path at E. coli scale ({N_READS} FASTA reads of "
        f"{lens.min()}-{lens.max()} bp)")
    fa = os.path.join(tmp, "reads.fa")
    write_fasta(fa, [(r.rid, r.seq) for r in reads])
    shards, manifest = load_index(idx_dir)
    g_t = torch.from_numpy(dna.encode(genome)).cuda()
    sample = np.sort(np.random.default_rng(SEED + 3).choice(N_READS, N_SAMPLED, replace=False))
    stats = {}
    for k in (0, 2):
        eng = Engine(shards, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hits = eng.align_all(reads, k, batch_size=BATCH)
        eng_s = time.perf_counter() - t0
        missing = sum(1 for t, hs in zip(truth, hits) if t["nm"] <= k and not any(
            h.pos == t["pos"] and h.strand == t["strand"] and h.nm == t["nm"] for h in hs))
        n_want = sum(t["nm"] <= k for t in truth)
        require(missing == 0, f"k={k}: truth missing for {missing} of {n_want} reads")
        bf_set = brute_force_sample(g_t, reads, sample, k)
        eng_set = {(int(i), h.pos, int(h.strand == "-"), h.nm) for i in sample
                   for h in hits[i]}
        require(bf_set == eng_set, f"k={k}: hit sets of the {N_SAMPLED} sampled reads "
                                   f"differ from brute force ({len(eng_set ^ bf_set)} hits)")
        want_sam = io.StringIO()
        emit_sam(reads, hits, manifest.contigs, want_sam)

        sam = os.path.join(tmp, f"list_k{k}.sam")
        reset_launches()
        summary = run_cli(["align", idx_dir, fa, "-o", sam, "-k", str(k),
                           "--batch-size", str(BATCH), "--device", "cuda"])
        launches = read_launches()
        need = ("search_chain1", "search_chain2", "locate_walk") + (("verify_nm",) if k else ())
        require(all(launches[n] > 0 for n in need) and launches["search_multistep"] == 0,
                f"k={k}: launches {launches}")
        with open(sam, "rb") as f:
            sam_bytes = f.read()
        require(sam_bytes == want_sam.getvalue().encode(),
                f"k={k}: CLI SAM differs from the engine pass")
        require(summary["reads"] == N_READS, f"k={k}: CLI aligned {summary['reads']} reads")
        # the Read-list path reports capacity-cut reads as overflow_reads
        require(summary["overflow_reads"] == 0 and summary["compact_overflows"] == 0
                and summary["truncated_reads"] == 0, f"k={k}: truncated reads: {summary}")
        say(f"  k={k}: truth {n_want}/{n_want} recovered; brute force equal on "
            f"{N_SAMPLED} reads ({len(bf_set)} hits); hits {sum(map(len, hits))}; "
            f"engine pass {N_READS / eng_s:.1f} reads/s ({eng_s:.3f} s); CLI FASTA->SAM "
            f"{summary['reads_per_s']} reads/s ({summary['wall_s']} s); heals "
            f"{summary['heals']}; launches {launches}")
        stats[k] = launches
    return {name: sum(s[name] for s in stats.values()) for name in stats[0]}


def phase_locv(tmp: str, p5: dict, idx_dir: str):
    """bench.py's single-end configuration (sa_rate 1 index in `idx_dir`,
    the locv table on, autotuned caps, tiered k = 2) through the port CLI,
    each run beside an engine pass that mirrors it; returns the launches
    of the CLI runs."""
    import numpy as np
    import torch

    from bwtpu_torch.index import load_index
    from bwtpu_torch.readblock import read_fastq_stream
    from bwtpu_torch.results import ContigTable, select_primary_flat
    from bwtpu_torch.sam import sam_header
    from bwtpu_torch.samfast import emit_single
    from bwtpu_torch.engine import Engine

    say(f"[7] bench.py's single-end configuration: sa_rate 1 (locv), autotuned caps, "
        f"tiered k = 2 ({N_READS} reads x 100 bp)")
    shards, manifest = load_index(idx_dir)
    cfg = shards[0].config
    t0 = time.perf_counter()
    sh = Engine(shards, device="cuda").dev_shards[0]
    up_s = time.perf_counter() - t0
    sizes = {name: getattr(sh, name).numel() * 4 / 1e6
             for name in ("lattice", "latk", "ssa", "text_rows", "locv")}
    sizes.update({f"kmer_d{d}": t.numel() * 4 / 1e6 for d, t in sh.kmer_tables.items()})
    require(tuple(sh.locv.shape) == (sh.n, 16), f"locv table not on: {tuple(sh.locv.shape)}")
    say(f"  resident tables (MB): " + ", ".join(f"{n} {v:.1f}" for n, v in sizes.items())
        + f"; total {sum(sizes.values()):.1f}; Engine() with the locv build and upload "
        f"{up_s:.1f} s")
    del sh
    ctable = ContigTable.build(manifest.contigs)
    reads, sample, g_t = p5["reads"], p5["sample"], p5["g_t"]
    t_pos, t_rev, t_nm = p5["t_pos"], p5["t_rev"], p5["t_nm"]
    stats = {}
    for name, k, tiered in (("k=0", 0, False), ("k=2", 2, False), ("tiered k=2", 2, True)):
        eng = Engine(shards, device="cuda")
        _, _, stream = read_fastq_stream(p5["fq"], BATCH)
        parts, sam_parts = [], [sam_header(manifest.contigs).encode()]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        base, tune_s = 0, 0.0
        for blk in stream:
            if base == 0:
                lf = eng.autotune_caps(blk, k, pad_to=BATCH)
                tune_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                tuned = (lf, eng._hf(k), dict(eng.stats.__dict__))
            flat = eng.finish_block(eng.dispatch_block(blk, k, pad_to=BATCH, tiered=tiered))
            require(flat.truncated is None, f"{name}: truncated reads in the engine pass")
            parts.append((flat.read_idx.astype(np.int64) + base, flat.pos,
                          flat.strand_rev.astype(np.int64), flat.nm.astype(np.int64)))
            sam_parts.append(emit_single(blk, select_primary_flat(flat), ctable,
                                         truncated=flat.truncated))
            base += blk.n
        eng_s = time.perf_counter() - t0
        ridx, pos, rev, nm = (np.concatenate(c) for c in zip(*parts))
        have = ((ridx * 4 + nm) << 34) | (pos << 1) | rev
        st = {key: v - tuned[2][key] for key, v in eng.stats.__dict__.items()}

        sam = os.path.join(tmp, f"sa1_{name.replace(' ', '_')}.sam")
        reset_launches()
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            summary = run_cli(["align", idx_dir, p5["fq"], "-o", sam, "-k", str(k),
                               "--batch-size", str(BATCH), "--device", "cuda",
                               "--autotune-caps"] + (["--tiered"] if tiered else []))
        launches = read_launches()
        sys.stderr.write(err.getvalue())
        events = [json.loads(ln) for ln in err.getvalue().splitlines()
                  if ln.startswith("{") and '"autotune"' in ln]
        require(len(events) == 1, f"{name}: {len(events)} autotune events")
        ev = events[0]
        require(ev["loc_factor"] <= cfg.loc_factor and (ev["loc_factor"], ev["hit_factor"])
                == tuned[:2], f"{name}: autotune event {ev} (engine pass {tuned[:2]}, "
                f"ceiling {cfg.loc_factor})")
        with open(sam, "rb") as f:
            sam_bytes = f.read()
        require(sam_bytes == b"".join(sam_parts), f"{name}: CLI SAM differs from the engine pass")
        require(summary["reads"] == N_READS and summary["truncated_reads"] == 0
                and b"xo:i:1" not in sam_bytes, f"{name}: {summary}")
        need = ("search_multistep", "verify_locv", "search_chain2") + PACKED
        never = ("locate_walk", "verify_nm")
        require(all(launches[n] > 0 for n in need) and not any(launches[n] for n in never),
                f"{name}: launches {launches}")
        if not tiered:
            # the sa_rate changes how a position is found, not which
            require(sam_bytes == p5["sam"][k], f"{name}: SAM differs from phase 5's")
            require(np.array_equal(np.sort(have), p5["keys"][k]),
                    f"{name}: hit set differs from phase 5's")
            check = f"SAM byte-equal to phase 5's, {len(have)} hits equal"
        else:
            # stratum contract on the sampled reads, against brute force
            eng_set: dict = {int(i): set() for i in sample}
            in_sample = np.isin(ridx, sample)
            for r, p, s_, m in zip(ridx[in_sample], pos[in_sample], rev[in_sample],
                                   nm[in_sample]):
                eng_set[int(r)].add((int(p), int(s_), int(m)))
            bf = {kk: {int(i): set() for i in sample} for kk in (0, 2)}
            for kk in (0, 2):
                for r, p, s_, m in p5["bf"][kk]:
                    bf[kk][r].add((p, s_, m))
            n_esc = 0
            for i in sample:
                hs, b0, b2 = eng_set[int(i)], bf[0][int(i)], bf[2][int(i)]
                require({h for h in hs if h[2] == 0} == b0 and hs <= b2
                        and (b0 or hs == b2), f"{name}: read {i} breaks the stratum "
                        f"contract: {sorted(hs)} vs k=0 {sorted(b0)}, k=2 {sorted(b2)}")
                n_esc += not b0
            # truth: nm 0 always; nm <= 2 where phase 5's k = 0 pass found nothing
            want_rows = np.flatnonzero((t_nm == 0) | (
                (t_nm <= 2) & ~np.isin(np.arange(N_READS), p5["k0_reads"])))
            want = ((want_rows * 4 + t_nm[want_rows]) << 34) | (t_pos[want_rows] << 1) \
                | t_rev[want_rows].astype(np.int64)
            found = np.isin(want, have)
            require(found.all(), f"{name}: truth missing for {int((~found).sum())} of "
                                 f"{len(want)} reads")
            check = (f"stratum contract on {N_SAMPLED} sampled reads ({n_esc} with no "
                     f"exact hit); truth {len(want)}/{len(want)}; {len(have)} hits")
        say(f"  {name}: autotune loc_factor {ev['loc_factor']}, hit_factor "
            f"{ev['hit_factor']} (probe {tune_s:.3f} s); {check}; engine pass "
            f"{N_READS / eng_s:.1f} reads/s ({eng_s:.3f} s, heals {st['heals']}, "
            f"escalated {st['escalated']}); CLI FASTQ->SAM {summary['reads_per_s']} "
            f"reads/s ({summary['wall_s']} s, heals {summary['heals']}, escalated "
            f"{summary['escalated']}); launches {launches}")
        stats[name] = launches
    return {n: sum(s[n] for s in stats.values()) for n in stats["k=0"]}


def engine_pass(eng, fq: str, k: int, ctable):
    """Engine.dispatch_block + finish_block over a FASTQ in blocks of
    BATCH, as the CLI's columnar path runs them: (read, pos, reverse, nm)
    columns of every hit and the SAM that the CLI would write, header
    excluded."""
    import numpy as np

    from bwtpu_torch.readblock import read_fastq_stream
    from bwtpu_torch.results import select_primary_flat
    from bwtpu_torch.samfast import emit_single

    _, _, stream = read_fastq_stream(fq, BATCH)
    parts, sam = [], []
    base = 0
    for blk in stream:
        flat = eng.finish_block(eng.dispatch_block(blk, k, pad_to=BATCH))
        require(flat.truncated is None, f"k={k}: truncated reads in the engine pass")
        parts.append((flat.read_idx.astype(np.int64) + base, flat.pos,
                      flat.strand_rev.astype(np.int64), flat.nm.astype(np.int64)))
        sam.append(emit_single(blk, select_primary_flat(flat), ctable))
        base += blk.n
    return tuple(np.concatenate(c) for c in zip(*parts)), b"".join(sam)


def check_sampled(have, bf: set, sample, k: int, what: str) -> int:
    """The hits of the sampled reads (columns of engine_pass) equal the
    brute-force set at k (bf holds the hits with nm <= 2)."""
    import numpy as np

    ridx, pos, rev, nm = have
    m = np.isin(ridx, sample)
    got = {(int(r), int(p), int(s), int(n)) for r, p, s, n in
           zip(ridx[m], pos[m], rev[m], nm[m])}
    want = {h for h in bf if h[3] <= k}
    require(got == want, f"{what} k={k}: hit sets of the {len(sample)} sampled reads differ "
                         f"from brute force ({len(got ^ want)} hits)")
    return len(want)


def phase_rescore(tmp: str, genome: str, idx_dir: str, reads):
    """--rescore: phase 6's FASTA on phase 5's index at k = 2 through the
    port CLI, sw_score_batch captured: every AS:i tag equals
    sw_score_plain on the card for the same windows, 256 sampled
    primaries equal sw_score_reference on windows cut from the genome,
    sw_band launched. Returns the launches."""
    import numpy as np
    import torch

    from bwtpu_torch import dna, sw

    say(f"[9] --rescore: phase 6's {N_READS} FASTA reads, k = 2, phase 5's index")
    fa, sam = os.path.join(tmp, "reads.fa"), os.path.join(tmp, "rescore.sam")
    calls: list = []
    secs: dict = {}
    reset_launches()
    with capturing(sw, "sw_score_batch", calls), \
            timing(sw, "sw_score_batch", secs, sync=True), \
            timing(sw, "rescore_candidates", secs), timing(sw, "_encode_reads", secs), \
            timing(sw, "_cut_windows", secs), timing(sw, "as_tags", secs):
        summary = run_cli(["align", idx_dir, fa, "-o", sam, "-k", "2", "--batch-size",
                           str(BATCH), "--device", "cuda", "--rescore"])
    launches = read_launches()
    parts = ("_cut_windows", "_encode_reads", "sw_score_batch")
    rest = secs["rescore_candidates"] - sum(secs[k] for k in parts)
    say(f"  host time of --rescore over {len(calls)} batches (s): rescore_candidates "
        f"{secs['rescore_candidates']:.3f} = window cut {secs['_cut_windows']:.3f} + per-read "
        f"encode loop {secs['_encode_reads']:.3f} + sw_score_batch call (synced) "
        f"{secs['sw_score_batch']:.3f} + the rest (hit lists, shard lookup, copies) "
        f"{rest:.3f}; AS formatting {secs['as_tags']:.3f}; CLI wall {summary['wall_s']} s")
    require(launches["sw_band"] == len(calls) == N_READS // BATCH
            and launches["search_chain1"] > 0, f"--rescore: launches {launches}, "
                                               f"{len(calls)} calls")
    plain = torch.cat([sw.sw_score_plain(*c) for c in calls]).cpu().numpy()
    recs = [ln.split("\t") for ln in open(sam) if not ln.startswith("@")]
    tags = {i: int(r[-1][5:]) for i, r in enumerate(recs) if r[-1].startswith("AS:i:")}
    require(len(recs) == N_READS and list(tags.values()) == plain.tolist(),
            f"--rescore: {len(tags)} AS tags against {len(plain)} plain scores")
    sample = np.sort(np.random.default_rng(SEED + 7).choice(sorted(tags), N_SAMPLED,
                                                             replace=False))
    for i in sample:
        r, flag, pos = recs[i], int(recs[i][1]), int(recs[i][3]) - 1
        seq = dna.decode(dna.encode_with_mask(reads[i].seq)[0])
        seq = dna.revcomp_str(seq) if flag & 16 else seq
        window = genome[max(0, pos - 8):pos + len(seq) + 8]
        require(tags[i] == sw.sw_score_reference(window, seq),
                f"--rescore: read {i}: AS {tags[i]} != sw_score_reference")
    say(f"  {len(tags)} AS tags equal sw_score_plain on the card; {N_SAMPLED} sampled equal "
        f"sw_score_reference; scores {min(tags.values())}-{max(tags.values())}; CLI "
        f"{summary['reads_per_s']} reads/s ({summary['wall_s']} s); launches {launches}")
    return launches


def paired_genome() -> str:
    """Random genome of human chr21's length with smoke_genome's repeat
    family at its density (one copy per ~15.5 kbp)."""
    import numpy as np

    from bwtpu_torch.simulate import CHR21_SCALE, ECOLI_SCALE, random_genome

    g = bytearray(random_genome(CHR21_SCALE, seed=SEED + 8), "ascii")
    rng = np.random.default_rng(SEED + 9)
    n = N_REPEATS * CHR21_SCALE // ECOLI_SCALE
    for p in rng.choice(len(g) - len(REPEAT), size=n, replace=False):
        g[p:p + len(REPEAT)] = REPEAT.encode()
    return g.decode()


def phase_paired(tmp: str):
    """Paired-end on a sharded index: BASELINE's "chr21 index sharded"
    (`build-index --shards 2 --jobs 2` at the CLI defaults, both shards
    on one card) and 65,536 pairs of 100 bp (insert 300 +- 30, <= 2
    substitutions a mate) through the port CLI at k = 0 and 2: the
    columnar path, then the paired Read-list loop (`--rescore --paired`)
    byte-equal to it; pair truth; brute force on 256 sampled mate-1 reads
    against a single-end engine pass; no truncated read; search_multistep,
    locate_walk, verify_nm, search_chain2, compact_slots and compact_mask
    launched at least once per shard and block, revcomp_both exactly once
    a dispatched block (the prep serves both shards; heals dispatch
    again). Returns the launches of the
    columnar runs, the build's seconds and the index directory and the
    two FASTQs (phase 12 reuses them)."""
    import numpy as np
    import torch

    from bwtpu_torch import dna
    from bwtpu_torch.engine import Engine
    from bwtpu_torch.index import load_index
    from bwtpu_torch.io import write_fasta, write_fastq
    from bwtpu_torch.results import ContigTable
    from bwtpu_torch.simulate import simulate_pairs

    n_pairs = N_PAIRS
    t0 = time.perf_counter()
    genome = paired_genome()
    fa, idx_dir = os.path.join(tmp, "chr21.fa"), os.path.join(tmp, "chr21_idx")
    write_fasta(fa, [("chr21_sim", genome)])
    say(f"[10] paired-end on a 2-shard index of {len(genome)} bp ({n_pairs} pairs x 100 bp); "
        f"genome {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as built:
        run_cli(["build-index", fa, idx_dir, "--shards", "2", "--jobs", "2"])
    build_s = time.perf_counter() - t0
    shards, manifest = load_index(idx_dir)
    eng = Engine(shards, device="cuda")
    sizes = [sum(t.numel() * 4 for t in (sh.lattice, sh.latk, sh.latk_inv, sh.ssa, sh.C,
                                         sh.text_rows, sh.locv, *sh.kmer_tables.values()))
             for sh in eng.dev_shards]
    say(f"  build-index --shards 2 --jobs 2: {build_s:.1f} s; {built.getvalue().strip()}; "
        f"resident per shard (MB): {[round(b / 1e6, 1) for b in sizes]} (offsets "
        f"{[sh.shard_offset for sh in shards]}, text {[sh.text_len for sh in shards]})")
    t0 = time.perf_counter()
    pairs, ptruth = simulate_pairs(genome, n_pairs, read_len=100, insert_mean=300,
                                   insert_sd=30, max_mismatches=2, seed=SEED + 10)
    fq1, fq2 = os.path.join(tmp, "pairs_1.fq"), os.path.join(tmp, "pairs_2.fq")
    write_fastq(fq1, [p[0] for p in pairs])
    write_fastq(fq2, [p[1] for p in pairs])
    say(f"  simulated and wrote the pairs: {time.perf_counter() - t0:.1f} s")

    # each mate's substitutions against its true locus
    g = dna.encode(genome)
    pos1 = np.array([t["pos1"] for t in ptruth], np.int64)
    pos2 = np.array([t["pos2"] for t in ptruth], np.int64)
    win = np.arange(100)
    m1 = np.stack([dna.encode(p[0].seq) for p in pairs])
    m2 = np.stack([dna.encode(dna.revcomp_str(p[1].seq)) for p in pairs])
    nm1 = (m1 != g[pos1[:, None] + win]).sum(1)
    nm2 = (m2 != g[pos2[:, None] + win]).sum(1)

    g_t = torch.from_numpy(g).cuda()
    mates1 = [p[0] for p in pairs]
    sample = np.sort(np.random.default_rng(SEED + 11).choice(n_pairs, N_SAMPLED,
                                                             replace=False))
    bf = brute_force_sample(g_t, mates1, sample, 2)
    del g_t
    ctable = ContigTable.build(manifest.contigs)
    n_blocks = n_pairs // BATCH
    stats = {}
    for k in (0, 2):
        have, _ = engine_pass(Engine(shards, device="cuda"), fq1, k, ctable)
        n_bf = check_sampled(have, bf, sample, k, "mate 1, single-end")
        out = {}
        for route, extra in (("columnar", []), ("Read-list", ["--rescore"])):
            sam = os.path.join(tmp, f"paired_k{k}_{route}.sam")
            reset_launches()
            dispatched: list = []
            with counting_dispatches(dispatched):
                summary = run_cli(["align", idx_dir, fq1, "--paired", fq2, "-o", sam, "-k",
                                   str(k), "--batch-size", str(BATCH), "--device", "cuda",
                                   *extra])
            launches = read_launches()
            with open(sam, "rb") as f:
                out[route] = f.read()
            require(summary["reads"] == 2 * n_pairs and summary["truncated_reads"] == 0
                    and b"xo:i:1" not in out[route], f"paired k={k} {route}: {summary}")
            if route == "columnar":
                stats[k] = launches
                per = {n: launches[n] / (2 * n_blocks) for n in
                       ("search_multistep", "locate_walk", "verify_nm", "search_chain2",
                        "compact_slots", "compact_mask")}
                require(all(v >= 1 for v in per.values()),
                        f"paired k={k}: launches per shard and block {per}")
                require(len(dispatched) >= n_blocks
                        and launches["revcomp_both"] == len(dispatched),
                        f"paired k={k}: revcomp_both launched {launches['revcomp_both']} times "
                        f"for {len(dispatched)} dispatched blocks of 2 shards (once a block)")
                rate = summary["reads_per_s"], summary["wall_s"]
        require(out["Read-list"] == out["columnar"],
                f"paired k={k}: the Read-list loop's SAM differs from the columnar path's")
        recs = [ln.split(b"\t") for ln in out["columnar"].splitlines()
                if not ln.startswith(b"@")]
        flag = np.array([int(r[1]) for r in recs]).reshape(n_pairs, 2)
        pos = np.array([int(r[3]) - 1 for r in recs]).reshape(n_pairs, 2)
        want = (nm1 <= k) & (nm2 <= k)
        ok = (flag[:, 0] & 2 != 0) & (pos[:, 0] == pos1) & (pos[:, 1] == pos2)
        require(ok[want].all(), f"paired k={k}: {int((~ok[want]).sum())} of {int(want.sum())} "
                                f"pairs not recovered as proper pairs at their loci")
        say(f"  k={k}: {int(want.sum())}/{int(want.sum())} pairs recovered as proper pairs at "
            f"their loci ({int((flag[:, 0] & 2 != 0).sum())} proper in all); the Read-list loop "
            f"byte-equal to the columnar path; mate 1 single-end equal to brute force on "
            f"{N_SAMPLED} reads ({n_bf} hits); CLI columnar {rate[0]} reads/s ({rate[1]} s); "
            f"launches per shard and block "
            f"{ {n: c / (2 * n_blocks) for n, c in stats[k].items()} }")
    wide = multistep_wide(tmp, fa, mates1[:BATCH], pos1[:BATCH], nm1[:BATCH])
    return ({n: sum(st[n] for st in stats.values()) for n in stats[0]}, build_s,
            (idx_dir, fq1, fq2), wide)


@contextlib.contextmanager
def counting_dispatches(dispatched: list):
    """Append to `dispatched` for every block Engine dispatches while the
    block runs (Engine._dispatch_packed: a heal dispatches again)."""
    from bwtpu_torch.engine import Engine

    orig = Engine._dispatch_packed

    def counted(self, *args):
        dispatched.append(args[0].n)
        return orig(self, *args)

    Engine._dispatch_packed = counted
    try:
        yield
    finally:
        Engine._dispatch_packed = orig


def multistep_wide(tmp: str, fa: str, mates1, pos1, nm1) -> dict:
    """search_multistep where its s-mer lattice is larger than L2 and the
    wide phase runs on the engine's own calls: a single-shard
    `build-index --kmer-d 11` of phase 10's genome (otherwise the CLI
    defaults; the default depth, 12, leaves E[width] = n / 4^12 = 2.8 and
    no wide phase, d = 11 leaves 11.1 > 8 and one wide step), one block of
    16,384 mate-1 reads through Engine.dispatch_block + finish_block at
    k = 0 and 2. Every captured call must have wide_steps 1; the first of
    each k is held against the plain version (multistep_shape); every
    mate-1 read within k substitutions of its locus must be found there."""
    import numpy as np

    from bwtpu_torch.engine import Engine
    from bwtpu_torch.index import load_index
    from bwtpu_torch.kernels import searchk
    from bwtpu_torch.readblock import ReadBlock

    idx_dir = os.path.join(tmp, "chr21_idx1")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as built:
        run_cli(["build-index", fa, idx_dir, "--kmer-d", "11"])
    build_s = time.perf_counter() - t0
    shards, _ = load_index(idx_dir)
    say(f"  single-shard build-index --kmer-d 11: {build_s:.1f} s; "
        f"{built.getvalue().strip()}")
    eng = Engine(shards, device="cuda")
    blk = ReadBlock.from_reads(mates1)
    out = {"build_s": build_s}
    for k in (0, 2):
        calls: list = []
        with capturing(searchk, "search_multistep", calls):
            flat = eng.finish_block(eng.dispatch_block(blk, k, pad_to=BATCH))
        require(calls and all(c[15] == 1 for c in calls),
                f"single shard k={k}: wide_steps {[c[15] for c in calls]}, expected 1")
        want = nm1 <= k
        key = (flat.read_idx.astype(np.int64) << 36) | (flat.pos.astype(np.int64) << 1) | \
            flat.strand_rev.astype(np.int64)
        found = np.isin((np.flatnonzero(want).astype(np.int64) << 36)
                        | (pos1[want].astype(np.int64) << 1), key)
        require(found.all(), f"single shard k={k}: truth missing for {int((~found).sum())} "
                             f"of {int(want.sum())} mate-1 reads")
        say(f"  single shard k={k}: {int(want.sum())}/{int(want.sum())} mate-1 reads found at "
            f"their loci; {len(calls)} search_multistep call(s), wide_steps 1")
        out[f"k{k}"] = multistep_shape(f"single shard k={k} call 0", calls[0])
    return out


FUSED_MODES = ((0, False), (2, False), (2, True))  # phase 10b: (k, tiered)


def fused_run(eng, blks, k: int, tiered: bool) -> tuple:
    """Every block dispatched before the first finish_block (four in flight,
    as the CLI keeps them): (FlatHits columns and truncation flags per
    block, the run's BatchStats without its times, dispatch wall, finish
    wall) on fresh stats."""
    from bwtpu_torch.engine import BatchStats

    eng.stats = BatchStats()
    t0 = time.perf_counter()
    handles = [eng.dispatch_block(b, k, pad_to=BATCH, tiered=tiered) for b in blks]
    t1 = time.perf_counter()
    flats = [eng.finish_block(h) for h in handles]
    t2 = time.perf_counter()
    cols = [tuple(getattr(f, n).tobytes() for n in ("read_idx", "pos", "strand_rev", "nm"))
            + (None if f.truncated is None else f.truncated.tobytes(),) for f in flats]
    return cols, dict(vars(eng.stats), device_s=0, host_s=0), t1 - t0, t2 - t1


def fused_no_sync(eng, blk, k: int, tiered: bool) -> None:
    """Once the reads are on the card, a dispatch must not sync with the
    host (sync debug mode "error"); its hits equal a plain dispatch's."""
    import torch

    want = fused_run(eng, [blk], k, tiered)[0]
    rw2, ab2, Bp = eng._upload_block(blk, BATCH)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        handle = eng._dispatch_packed(blk, rw2, ab2, Bp, k, 0, tiered)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    f = eng.finish_block(handle)
    got = tuple(getattr(f, n).tobytes() for n in ("read_idx", "pos", "strand_rev", "nm"))
    require(got == want[0][:4], f"k={k} tiered={tiered}: the dispatch under sync debug differs")


def fused_traced(eng, blks, k: int, tiered: bool) -> tuple:
    """fused_run under torch.profiler, every key already captured: (its
    result, cudaGraphLaunch calls, cudaLaunchKernel calls, device events,
    the launches measured from the trace's kernel names). The measured
    launches must equal, kernel by kernel, what each replayed graph's
    capture recorded times its replays, with no graph captured and no
    launch counter moved (a replay calls no wrapper). The window opens with
    one block's dispatch that is not counted (a trace can miss the first
    device events of a profile's first replay); the counted run is a
    record_function range, its calls the CPU events in it and its device
    events those that start after it opens. A window whose trace falls
    short is retried, up to three in all."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from bwtpu_torch.kernels import _build

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fused_run(eng, blks[:1], k, tiered)
            torch.cuda.synchronize()
            n_graphs, replays = len(eng._graphs), collections.Counter(eng.graph_replays)
            before = read_launches()
            with record_function("chip_smoke.counted"):
                res = fused_run(eng, blks, k, tiered)
                torch.cuda.synchronize()
        require(len(eng._graphs) == n_graphs and read_launches() == before,
                f"k={k} tiered={tiered}: a traced fused run captured a graph or launched "
                f"through a wrapper")
        ran = eng.graph_replays - replays
        want = dict.fromkeys(KERNELS, 0)
        for key, n in ran.items():
            for name, c in eng._graphs[key].launches.items():
                want[name] += n * c
        events = prof.events()
        span = next(e.time_range for e in events if e.name == "chip_smoke.counted"
                    and e.device_type == DeviceType.CPU)
        cpu = [e.name for e in events if e.device_type == DeviceType.CPU
               and span.start <= e.time_range.start <= span.end]
        dev = [e.name for e in events if e.device_type == DeviceType.CUDA
               and e.time_range.start >= span.start and e.name != "chip_smoke.counted"]
        measured = _build.launches_in_trace(dev)
        graph = sum("GraphLaunch" in n for n in cpu)
        kernel = sum("LaunchKernel" in n for n in cpu)
        if measured == want and graph == ran.total():
            return res, graph, kernel, len(dev), measured
    raise RuntimeError(f"chip_smoke: check failed: k={k} tiered={tiered}: {graph} graph "
                       f"launches for {ran.total()} replays; launches in the trace "
                       f"{measured}, the captures recorded {want}")


def phase_fused(p10) -> dict:
    """10b: Engine(fuse_shards=True), every shard's pipeline as one CUDA
    graph replay a block, on phase 10's 2-shard index with four blocks of
    16,384 mate-1 reads in flight, hit_factor 0.5: at k = 0, k = 2 (which
    heals once a block) and tiered k = 2, the fused form in turns with the loop
    form (loop, fused, fused, loop), every run's hits, truncation flags
    and BatchStats equal to the first loop run's; the dispatch under sync
    debug mode "error" in both forms; each mode's fused run once more
    under torch.profiler, its hits equal, its kernel launches measured
    from the trace by name (fused_traced); one replayed dispatch alone: one
    graph launch, no kernel launch; the walls and each graph's capture
    printed, not gated. Returns the fused runs' launches: the wrappers'
    (the eager warm-ups) and the traced replays' measured ones."""
    import dataclasses

    import torch

    from bwtpu_torch.engine import Engine
    from bwtpu_torch.index import load_index
    from bwtpu_torch.readblock import read_fastq_stream

    t0 = time.perf_counter()
    idx_dir, fq1, _ = p10
    # hit_factor 0.5: ~0.66 verified hits a lane at k = 2 overflow the hit
    # buffer, so each k = 2 block heals once (through the fused form too)
    shards = [dataclasses.replace(s, config=s.config.replace(hit_factor=0.5))
              for s in load_index(idx_dir)[0]]
    blks = list(read_fastq_stream(fq1, BATCH)[2])
    say(f"[10b] fused dispatch on phase 10's 2-shard index: {len(blks)} blocks of {BATCH} "
        f"mate-1 reads in flight")
    engines = {False: Engine(shards, device="cuda"),
               True: Engine(shards, device="cuda", fuse_shards=True)}
    launches = dict.fromkeys(KERNELS, 0)
    torch.cuda.empty_cache()  # what stays reserved after the phase: the graphs' pools
    mem0 = torch.cuda.memory_reserved()
    for k, tiered in FUSED_MODES:
        runs = []
        for fuse in (False, True, True, False):
            reset_launches()
            runs.append((fuse, *fused_run(engines[fuse], blks, k, tiered)))
            ran = read_launches()
            if fuse:
                launches = {n: launches[n] + c for n, c in ran.items()}
            else:  # the loop preps once a block for both shards, heals included
                blocks = len(blks) + runs[-1][2]["heals"]
                require(ran["revcomp_both"] == blocks,
                        f"k={k} tiered={tiered}: the loop launched revcomp_both "
                        f"{ran['revcomp_both']} times for {blocks} blocks")
        want = runs[0][1:3]
        require(all(r[1:3] == want for r in runs),
                f"k={k} tiered={tiered}: the fused form differs from the loop form")
        require(k == 0 or tiered or want[1]["heals"] >= 1,
                f"k={k}: no heal ({want[1]})")
        walls = [f"{'fused' if f else 'loop'} {d * 1e3:.1f} + {w * 1e3:.1f}"
                 for f, _, _, d, w in runs]
        say(f"  k={k}{' tiered' if tiered else ''}: fused == loop (hits, truncation, stats: "
            f"heals {want[1]['heals']}, escalated {want[1]['escalated']}); dispatch + finish "
            f"ms of {len(blks)} blocks, in turns: {'; '.join(walls)}")
        res, graph, kernel, device, measured = fused_traced(engines[True], blks, k, tiered)
        require(res[:2] == want, f"k={k} tiered={tiered}: the traced fused run differs")
        require(all(measured[n] > 0 for n in PACKED),
                f"k={k} tiered={tiered}: the replays ran no {PACKED}: {measured}")
        replays = res[1]["heals"] + len(blks)
        require(measured["revcomp_both"] == replays,
                f"k={k} tiered={tiered}: the replays ran revcomp_both "
                f"{measured['revcomp_both']} times for {replays} replayed blocks (once a block)")
        launches = {n: launches[n] + c for n, c in measured.items()}
        say(f"  traced fused run: {graph} graph launches, {kernel} kernel launches, {device} "
            f"device events; launches measured by kernel name, equal to the captures' "
            f"record: { {n: c for n, c in measured.items() if c} }")
    for fuse in (False, True):
        for k, tiered in FUSED_MODES:
            fused_no_sync(engines[fuse], blks[0], k, tiered)
    say("  the dispatch of each mode ran under torch.cuda.set_sync_debug_mode('error') in "
        "both forms, its hits equal")
    # one replayed dispatch alone (k = 0, a captured key), not counted
    _, graph, kernel, device, one = fused_traced(engines[True], blks[1:2], 0, False)
    require(graph == 1 and kernel == 0,
            f"a replayed fused dispatch_block: {graph} graph launches, {kernel} kernel launches")
    caps = [f"{key[0]} k={key[1]} level {key[4]}: {v['warmup_s'] * 1e3:.0f} + "
            f"{v['capture_s'] * 1e3:.0f} ms" for key, v in engines[True].captures.items()]
    torch.cuda.empty_cache()
    say(f"  one replayed fused dispatch_block under torch.profiler: {graph} graph launch, "
        f"{kernel} kernel launches, {device} device events, "
        f"{ {n: c for n, c in one.items() if c} } launched; graphs (warm-up + capture): "
        f"{'; '.join(caps)}; {(torch.cuda.memory_reserved() - mem0) / 1e6:.0f} MB more "
        f"reserved, {engines[True].graph_replays.total()} replays; phase 10b "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


def phase_wide(tmp: str):
    """Wide reads: `build-index --read-len 400` of a 1 Mbp random genome,
    4,096 reads of 400 bp (<= 2 substitutions) at k = 2 through the port
    CLI (the columnar path: verify_nm on 25-word reads, its run-time-W
    instance); brute force on 256 sampled reads, the CLI's SAM equal to an
    engine pass, truth, verify_nm launched. Returns the launches."""
    import numpy as np
    import torch

    from bwtpu_torch import dna
    from bwtpu_torch.engine import Engine
    from bwtpu_torch.index import load_index
    from bwtpu_torch.io import write_fasta, write_fastq
    from bwtpu_torch.results import ContigTable
    from bwtpu_torch.sam import sam_header
    from bwtpu_torch.simulate import random_genome, simulate_reads

    n, L = WIDE_READS, WIDE_L
    say(f"[11] wide reads: {n} reads x {L} bp, k = 2, `build-index --read-len {L}` of "
        f"{WIDE_GENOME} bp")
    genome = random_genome(WIDE_GENOME, seed=SEED + 12)
    fa, idx_dir, fq, sam = (os.path.join(tmp, x) for x in
                            ("wide.fa", "wide_idx", "wide.fq", "wide.sam"))
    write_fasta(fa, [("wide_sim", genome)])
    with contextlib.redirect_stdout(io.StringIO()):
        run_cli(["build-index", fa, idx_dir, "--read-len", str(L)])
    reads, truth = simulate_reads(genome, n, read_len=L, max_mismatches=2, seed=SEED + 13)
    write_fastq(fq, reads)
    shards, manifest = load_index(idx_dir)
    have, sam_body = engine_pass(Engine(shards, device="cuda"), fq, 2,
                                 ContigTable.build(manifest.contigs))
    sample = np.sort(np.random.default_rng(SEED + 14).choice(n, N_SAMPLED, replace=False))
    bf = brute_force_sample(torch.from_numpy(dna.encode(genome)).cuda(), reads, sample, 2)
    n_bf = check_sampled(have, bf, sample, 2, "wide reads")
    key = lambda r, p, s: (r << 34) | (p << 1) | s  # noqa: E731
    t_pos = np.array([t["pos"] for t in truth], np.int64)
    t_rev = np.array([t["strand"] == "-" for t in truth], np.int64)
    found = np.isin(key(np.arange(n), t_pos, t_rev), key(have[0], have[1], have[2]))
    require(found.all(), f"wide reads: truth missing for {int((~found).sum())} of {n}")
    reset_launches()
    summary = run_cli(["align", idx_dir, fq, "-o", sam, "-k", "2", "--batch-size", str(n),
                       "--device", "cuda"])
    launches = read_launches()
    with open(sam, "rb") as f:
        sam_bytes = f.read()
    require(sam_bytes == sam_header(manifest.contigs).encode() + sam_body
            and summary["truncated_reads"] == 0, f"wide reads: CLI SAM differs from the "
                                                 f"engine pass ({summary})")
    require(launches["verify_nm"] > 0 and launches["locate_walk"] > 0,
            f"wide reads: launches {launches}")
    say(f"  truth {n}/{n}; brute force equal on {N_SAMPLED} reads ({n_bf} hits); CLI SAM equal "
        f"to the engine pass; {summary['reads_per_s']} reads/s; launches {launches}")
    return launches


def ring_rank(spec_path: str) -> None:
    """One rank of phase 12, started with the environment torchrun sets:
    brings up the process group, runs bwtpu_torch.multihost.main on each
    argv of the spec, and writes each run's summary and kernel launches
    to the spec's output file."""
    import torch.distributed as dist

    from bwtpu_torch import multihost

    with open(spec_path) as f:
        spec = json.load(f)
    multihost.initialize(None, 1, 0, spec["device"], spec["backend"])
    runs = []
    try:
        with contextlib.redirect_stderr(io.StringIO()):
            multihost.main(spec["warmup"])  # first launches, library loads
        for argv in spec["runs"]:
            reset_launches()
            runs.append({"summary": multihost.main(argv), "launches": read_launches()})
    finally:
        dist.destroy_process_group()
    with open(spec["out"], "w") as f:
        json.dump(runs, f)


def launch_ranks(tmp: str, name: str, device: str, backend: str, runs: list, warmup: list,
                 timeout: float = 600) -> list:
    """len(runs) rank processes on this machine with torchrun's
    environment (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT), rank r running ring_rank over runs[r]
    after warmup[r]; every rank is killed on a failure or at the timeout.
    Returns each rank's runs."""
    import socket

    world = len(runs)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.abspath(__file__))
    procs, outs, logs = [], [], []
    try:
        for r in range(world):
            spec, out, log = (os.path.join(tmp, f"{name}_rank{r}{x}")
                              for x in (".json", ".out.json", ".log"))
            with open(spec, "w") as f:
                json.dump({"device": device, "backend": backend, "runs": runs[r],
                           "warmup": warmup[r], "out": out}, f)
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                       LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port))
            with open(log, "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", "import chip_smoke, sys; "
                     "chip_smoke.ring_rank(sys.argv[1])", spec],
                    cwd=root, env=env, stdout=f, stderr=subprocess.STDOUT))
            outs.append(out)
            logs.append(log)
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            with open(log) as f:
                say(f.read()[-4000:])
        require(p.returncode == 0, f"{name}: rank {r} exited with {p.returncode}")
    res = []
    for out in outs:
        with open(out) as f:
            res.append(json.load(f))
    return res


def sam_body(path: str) -> bytes:
    with open(path, "rb") as f:
        return b"".join(ln for ln in f if not ln.startswith(b"@"))


def split_fastq(tmp: str, name: str, reads, world: int) -> list[str]:
    """One FASTQ per rank: rank r's contiguous block of `reads`."""
    from bwtpu_torch.io import write_fastq

    b = -(-len(reads) // world)
    paths = [os.path.join(tmp, f"{name}_{r}.fq") for r in range(world)]
    for r, path in enumerate(paths):
        write_fastq(path, reads[r * b:(r + 1) * b])
    return paths


def ring_runs(tmp: str, smi: str, name: str, device: str, backend: str, index: str,
              jobs: list, refs: dict) -> dict:
    """Run the jobs ((label, k, per-rank mate-1 paths, per-rank mate-2
    paths or None)) on len(paths) ranks, one after another in each rank;
    hold each job's merged SAM body against refs[label] (bytes, reads,
    wall, heals of the single-process Engine) and print the per-rank
    numbers. Returns the launches summed over ranks and jobs, and each
    job's rank summaries beside the Engine's numbers."""
    from bwtpu_torch.io import read_fastq, write_fastq

    world = len(jobs[0][2])

    def argv(label, k, reads, mates=None):
        return (["--index", index, "--reads", reads, "-k", str(k),
                 "--out", os.path.join(tmp, f"{name}_{label}.sam"),
                 "--batch-size", str(BATCH), "--device", device]
                + (["--backend", backend] if backend else [])
                + (["--paired", mates] if mates else []))

    runs = [[argv(label, k, p1[r], p2[r] if p2 else None) for label, k, p1, p2 in jobs]
            for r in range(world)]
    # the warm-up: one batch of each rank's first stream, not timed
    warm = [os.path.join(tmp, f"{name}_warmup_{r}.fq") for r in range(world)]
    for r, path in enumerate(warm):
        write_fastq(path, read_fastq(jobs[0][2][r])[:BATCH])
    res = launch_ranks(tmp, name, device, backend, runs,
                       [argv("warmup", 0, path) for path in warm])
    total: dict = {}
    table = {}
    for j, (label, k, _, _) in enumerate(jobs):
        out = os.path.join(tmp, f"{name}_{label}.sam")
        merged = (sam_body(out) if world == 1 else
                  b"".join(sam_body(f"{out}.h{r}") for r in range(world)))
        ref = refs[label]
        require(merged == ref["sam"], f"{name} {label}: the ranks' SAM differs from the "
                                      f"single-process Engine's")
        # the ring's packed pipelines return compacted candidates (bwtpu's
        # compact ring): prep and the candidate compaction, no hit compaction
        need = ("search_multistep", "locate_walk", "verify_nm", "search_chain2",
                "revcomp_both", "compact_slots")
        for r in range(world):
            launches, sm = res[r][j]["launches"], res[r][j]["summary"]
            require(all(launches[n] > 0 for n in need),
                    f"{name} {label}: rank {r} launched {launches}")
            for n, c in launches.items():
                total[n] = total.get(n, 0) + c
            per = {n: launches[n] / sm["dispatches"] for n in need}
            say(f"  {name} {label} rank {r}: {sm['reads_per_s']} reads/s, wall {sm['wall_s']} s, "
                f"heals {sm['heals']}, transport {sm['transport']}, {sm['reads']} reads, "
                f"{sm['dispatches']} dispatches, launches per dispatch {per}; {smi}")
        say(f"  {name} {label}: SAM of the {world} rank(s) byte-equal to the single-process "
            f"Engine's ({len(merged)} bytes); that Engine: {ref['reads'] / ref['wall']:.1f} "
            f"reads/s, wall {ref['wall']:.2f} s (align_all + emit_sam), heals {ref['heals']}; "
            f"{smi}")
        table[label] = {"ranks": [res[r][j]["summary"] for r in range(world)],
                        "engine": {x: ref[x] for x in ("reads", "wall", "heals")}}
    return total, table


def engine_sam(shards, contigs, mates1, k: int, mates2=None) -> dict:
    """The single-process reference: Engine.align_all at batch BATCH over
    the whole stream, emitted by sam.emit_sam (pair_and_emit_sam with
    multihost's default inserts for pairs); bytes, reads, wall, heals."""
    import torch

    from bwtpu_torch.engine import Engine
    from bwtpu_torch.sam import emit_sam, pair_and_emit_sam

    eng = Engine(shards, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h1 = eng.align_all(mates1, k, batch_size=BATCH)
    buf = io.StringIO()
    if mates2 is None:
        emit_sam(mates1, h1, contigs, buf, header=False)
    else:
        h2 = eng.align_all(mates2, k, batch_size=BATCH)
        pair_and_emit_sam(list(zip(mates1, mates2)), h1, h2, contigs, buf, min_insert=0,
                          max_insert=1000, header=False)
    wall = time.perf_counter() - t0
    n = len(mates1) * (1 if mates2 is None else 2)
    return {"sam": buf.getvalue().encode(), "reads": n, "wall": wall,
            "heals": eng.stats.heals}


def phase_ring(tmp: str, smi: str, idx5: str, fq5: str, reads5, p10) -> dict:
    import torch

    from bwtpu_torch.index import load_index
    from bwtpu_torch.io import read_fastq

    n_cards = torch.cuda.device_count()
    say(f"[12] the ring: bwtpu_torch.multihost on DistEngine; NCCL "
        f"{'.'.join(map(str, torch.cuda.nccl.version()))}, {n_cards} card(s)")
    t_phase = time.perf_counter()

    # 12a: NCCL, one rank per card, phase 5's index and reads
    shards, manifest = load_index(idx5)
    refs = {f"k{k}": engine_sam(shards, manifest.contigs, reads5, k) for k in (0, 2)}
    paths = split_fastq(tmp, "ring_a", reads5, n_cards)
    say(f"  12a: {n_cards} NCCL rank(s), phase 5's index (1 shard) and {len(reads5)} reads "
        f"in {n_cards} stream(s); on one card the ring makes no hop")
    launches, _ = ring_runs(tmp, smi, "12a", "cuda", None, idx5,
                            [(f"k{k}", k, paths, None) for k in (0, 2)], refs)
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
                          str(n_cards), "-m", "bwtpu_torch.cli", "scaling", "--shards", "1"],
                         cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                         text=True, timeout=600)
    lines = [ln for ln in run.stdout.splitlines() if ln.startswith('{"event": "scaling"')]
    require(run.returncode == 0 and len(lines) == 1,
            f"torchrun scaling: rc {run.returncode}; {run.stderr[-2000:]}")
    line = json.loads(lines[0])
    say(f"  torchrun --nproc-per-node {n_cards} -m bwtpu_torch.cli scaling --shards 1 "
        f"({time.perf_counter() - t0:.1f} s): {json.dumps(line)}; {smi}")

    # 12b: two gloo ranks on card 0, phase 10's 2-shard index
    idx10, fq1, fq2 = p10
    shards, manifest = load_index(idx10)
    m1, m2 = read_fastq(fq1), read_fastq(fq2)
    refs = {"k0": engine_sam(shards, manifest.contigs, m1, 0),
            "k2": engine_sam(shards, manifest.contigs, m1, 2),
            "paired_k2": engine_sam(shards, manifest.contigs, m1, 2, m2)}
    p1, p2 = split_fastq(tmp, "ring_b1", m1, 2), split_fastq(tmp, "ring_b2", m2, 2)
    say(f"  12b: 2 gloo ranks on cuda:0, their hops through host memory (not NVLink): "
        f"phase 10's 2-shard index, one shard per rank; {len(m1)} mate-1 reads and "
        f"{len(m1)} pairs, half per rank")
    more, _ = ring_runs(tmp, smi, "12b", "cuda:0", "gloo", idx10,
                        [("k0", 0, p1, None), ("k2", 2, p1, None), ("paired_k2", 2, p1, p2)],
                        refs)
    say(f"  phase 12: {time.perf_counter() - t_phase:.1f} s")
    return {n: launches[n] + more[n] for n in launches}


def phase_gather_ab():
    """The row gather's A/B entry point (scripts/torch_gather_ab.py) at a
    locv row's width and the text-row table's size (2.3 MB, L2-resident),
    then the L2 fetch granularity probe at Wr 8, 16 and 32 from a 297 MB
    table (DRAM-resident, the locv table's size); returns the launches of
    both runs and the kernel's best L2-resident rate in bytes per ms."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                        "torch_gather_ab.py")
    spec = importlib.util.spec_from_file_location("torch_gather_ab", path)
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    reset_launches()
    runs = {}
    for argv in (["--widths", "16", "--sizes-mb", "2.3", "--reps", "5"],
                 ["--widths", "8", "16", "32", "--sizes-mb", "297", "--reps", "5",
                  "--granularity", "32", "64", "128"]):
        say(f"[8] scripts/torch_gather_ab.py {' '.join(argv)}")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = ab.main(argv)
        say(out.getvalue().rstrip())
        require(rc == 0, f"torch_gather_ab {' '.join(argv)}: rc {rc}")
        runs[argv[argv.index("--sizes-mb") + 1]] = [
            json.loads(ln) for ln in out.getvalue().splitlines()[1:]]
    launches = read_launches()
    require(launches["row_gather_sum"] > 0, f"torch_gather_ab: launches {launches}")
    for rec in runs["297"]:
        probe = {g: min(v["gather"]) for g, v in rec["granularity_ns_per_row"].items()}
        say(f"  Wr {rec['width']} ({rec['width'] * 4} B rows) from 297 MB: "
            f"{min(rec['kernel_ns_per_row'].values()):.4f} ns/row at the default hint "
            f"({rec['l2_fetch_granularity']} B); with the hint at "
            + ", ".join(f"{g} B {ns:.4f}" for g, ns in probe.items()))
    rec = runs["2.3"][-1]
    ns_per_row = min(rec["kernel_ns_per_row"].values())
    return launches, rec["width"] * 4 / ns_per_row * 1e6


def chain1_l2(rec: dict, bytes_per_ms: float) -> None:
    """search_chain1's L2 sectors (32 B each) at phase 8's measured
    L2-resident gather rate, beside its kernel time."""
    for key, ms_key in (("l2_sectors", "ms"), ("seeds_l2_sectors", "seeds_ms")):
        at_rate = rec[key] * 32 / bytes_per_ms
        rec[key.replace("sectors", "sector_ms")] = at_rate
        say(f"  search_chain1 {'k=0 reads' if ms_key == 'ms' else 'k=2 seeds'}: "
            f"{rec[key]} L2 sectors ({rec[key] * 32 / 1e6:.1f} MB) take {at_rate:.4f} ms at "
            f"phase 8's L2-resident gather rate ({bytes_per_ms / 1e6:.1f} GB/s); kernel "
            f"{rec[ms_key]:.4f} ms, bound "
            f"{rec['bound_ms' if ms_key == 'ms' else 'seeds_bound_ms']:.5f} ms")


BENCH_TIMEOUT = 600  # seconds for the full-size bench subprocess (~230 s on an H100)
# the kernel function names of the four wrappers align --profile runs
TRACE_KERNELS = {"search_multistep": "multistep_kernel", "locate_walk": "locate_walk_kernel",
                 "verify_nm": "verify_nm", "search_chain2": "chain2_"}


def bench_py_keys(root: str) -> tuple[set, set]:
    """(top-level keys, "extras" keys) of the root bench.py's final
    json.dumps dict, read from its source with ast (nothing is imported):
    the literal keys plus the `timings[...]` keys that `**timings` spreads
    into extras."""
    import ast

    with open(os.path.join(root, "bench.py")) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    line = [n for n in ast.walk(main) if isinstance(n, ast.Call)
            and getattr(n.func, "attr", None) == "dumps" and n.args
            and isinstance(n.args[0], ast.Dict)][-1].args[0]
    names = [k.value for k in line.keys]
    extras = line.values[names.index("extras")]
    keys = {k.value for k in extras.keys if k is not None}
    keys |= {n.targets[0].slice.value for n in ast.walk(main)
             if isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Subscript)
             and getattr(n.targets[0].value, "id", None) == "timings"}
    return set(names), keys


def run_bench(root: str, tmp: str) -> tuple[dict, list, str]:
    """`python -m bwtpu_torch.cli bench` at its defaults in a session of
    its own (killed whole at the timeout, the probe's ranks included).
    Returns (its JSON line, its stderr lines, its stdout)."""
    import signal

    err_path = os.path.join(tmp, "bench.err")
    with open(err_path, "w") as err:
        proc = subprocess.Popen([sys.executable, "-m", "bwtpu_torch.cli", "bench"], cwd=root,
                                stdout=subprocess.PIPE, stderr=err, text=True,
                                start_new_session=True)
        try:
            out, _ = proc.communicate(timeout=BENCH_TIMEOUT)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    with open(err_path) as f:
        lines = f.read().splitlines()
    if proc.returncode != 0:
        say("\n".join(lines[-80:]))
    require(proc.returncode == 0, f"bench exited with {proc.returncode}")
    return json.loads(out.strip().splitlines()[-1]), lines, out


def phase_bench(tmp: str, smi: str, root: str, idx5: str, p5: dict) -> tuple[dict, dict]:
    """13: the bench at full size, then align --profile on phase 5's
    FASTQ at k = 2. Returns the launches of both paths."""
    import torch

    torch.cuda.empty_cache()  # the bench runs in a process of its own
    say("[13] the bench: python -m bwtpu_torch.cli bench (bench.py's configuration: "
        "4,641,652 bp, sa_rate 1 with the locv table, batches of 524,288 reads)")
    t0 = time.perf_counter()
    line, err, _ = run_bench(root, tmp)
    wall = time.perf_counter() - t0
    for ln in err:
        if ln.startswith(("# section", "# launches")):
            say(f"  {ln}")
    say(f"  bench line ({smi}): {json.dumps(line)}")
    failed = [ln for ln in err if ln.startswith("# ") and ln.endswith(" failed:")]
    require(not failed, f"bench: a guarded section failed: {failed}")
    top, extras = bench_py_keys(root)
    ex = line["extras"]
    require(set(line) == top and set(ex) == extras,
            f"bench: keys differ from bench.py's: {sorted(set(line) ^ top)} "
            f"{sorted(set(ex) ^ extras)}")
    require(ex["platform"] == "cuda" and ex["backend"] == "cuda", f"bench ran on {ex['platform']}")
    rates = ["k2_reads_per_s", "k2_tiered_reads_per_s"] + [
        k for k in ex if k.startswith("e2e_") and k.endswith("_reads_per_s")]
    require(line["value"] > 0 and all(ex[k] > 0 for k in rates),
            f"bench: a rate is not positive: {[(k, ex[k]) for k in rates]}")
    zero = ["exact_overflow", "k2_overflow", "k2_tiered_overflow"] + [
        k for k in ex if k.startswith("e2e_") and k.endswith("_overflows")]
    require(all(ex[k] == 0 for k in zero), f"bench: overflows {[(k, ex[k]) for k in zero]}")
    set_ = [k for k in ex if k.startswith(("sol_", "k2_sol_", "ns_per_row_", "multihost_",
                                            "scaling_eff_"))]
    require(all(ex[k] is not None for k in set_),
            f"bench: null fields {[k for k in set_ if ex[k] is None]}")
    # launches: every section of the bench process, and each probe rank's
    total, ranks, sections = {}, [], {}
    for ln in err:
        if ln.startswith("# launches "):
            _, _, name, counts = ln.split(" ", 3)
            counts = json.loads(counts)
            if name.startswith("multihost_"):
                ranks.append((name, counts))
            else:
                sections[name] = counts
            for n, c in counts.items():
                total[n] = total.get(n, 0) + c
    require(all(total[n] > 0 for n in ("verify_locv", "search_chain2", "row_gather_sum")),
            f"bench: launches {total}")
    searched = [n for n in sections if n in ("exact", "k2", "tiered", "lowerr", "roofline")
                or n.startswith("e2e_") and n != "e2e_setup"]
    require(len(searched) == 10 and all(sections[n]["search_multistep"] > 0 for n in searched),
            f"bench: search_multistep launches by section "
            f"{ {n: sections[n]['search_multistep'] for n in sections} }")
    require(len(ranks) == 6 and all(c["locate_walk"] > 0 and c["verify_nm"] > 0
                                    and c["search_multistep"] > 0 for _, c in ranks),
            f"bench: probe ranks launched {ranks}")
    say(f"  bench: {wall:.1f} s; launches (sections and probe ranks) {total}; {smi}")

    # align --profile: the Read-list route inside a torch.profiler window
    prof, sam = os.path.join(tmp, "prof"), os.path.join(tmp, "profiled.sam")
    reset_launches()
    t0 = time.perf_counter()
    summary = run_cli(["align", idx5, p5["fq"], "-o", sam, "-k", "2", "--batch-size",
                       str(BATCH), "--device", "cuda", "--profile", prof])
    wall = time.perf_counter() - t0
    plaunches = read_launches()
    with open(sam, "rb") as f:
        require(f.read() == p5["sam"][2], "align --profile: SAM differs from phase 5's k = 2")
    traces = [f for f in os.listdir(prof) if f.endswith(".pt.trace.json")]
    require(len(traces) == 1, f"align --profile wrote {traces}")
    with open(os.path.join(prof, traces[0])) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    seen = {n: sum(1 for e in kernels if fn in e.get("name", ""))
            for n, fn in TRACE_KERNELS.items()}
    require(all(seen.values()), f"align --profile: trace kernels {seen}")
    busy = sum(e.get("dur", 0) for e in kernels) / 1e6
    say(f"  align --profile -k 2: SAM byte-equal to phase 5's; trace "
        f"{os.path.getsize(os.path.join(prof, traces[0])) / 1e6:.1f} MB, {len(events)} events, "
        f"{len(kernels)} kernels ({busy:.3f} s of kernel time) of which {seen}; wall "
        f"{wall:.1f} s ({summary['reads_per_s']} reads/s under the profiler); launches "
        f"{plaunches}; {smi}")
    return total, plaunches


# phase 14: test_scale_int32's index (bwtpu's row-math check) with
# kmer_d 11, so that Engine._wide_steps(11) == 2 (n / 4^11 = 64 -> 16 -> 4)
INT32_N = 2**28 + 4096
HUMAN_BATCH = 65536  # scale_human_chip.py's --batch
BF_SECONDS, BF_MIN, BF_CHUNK = 30.0, 16, 8  # phase 14a's brute force: reads
SCALE_TIMEOUT = 600  # seconds for phase 14b's subprocess


def int32_index(path: str) -> None:
    """Phase 14a's index, built in a process of its own while phases 3-13
    run: build_fm_index of test_scale_int32's genome (random, 2^28 + 4096
    bp, seed 77) with its config and kmer_d 11, saved to `path`."""
    from bwtpu_torch.config import EngineConfig
    from bwtpu_torch.index import build_fm_index, plan_shards, save_index
    from bwtpu_torch.simulate import random_genome

    t0 = time.perf_counter()
    idx = build_fm_index(random_genome(INT32_N, seed=77),
                         EngineConfig(sa_rate=8, max_hits=4, max_cand=8, read_len=100,
                                      kmer_d=11))
    save_index(path, [idx], plan_shards(idx.text_len, 1, 0))
    print(f"{time.perf_counter() - t0:.1f} s", flush=True)


def start_int32_index(root: str, tmp: str):
    """Start int32_index in a child process; returns (process, directory)."""
    path = os.path.join(tmp, "int32_idx")
    code = f"import chip_smoke; chip_smoke.int32_index({path!r})"
    return subprocess.Popen([sys.executable, "-c", code], cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), path


def phase_int32(index_proc, path: str):
    """14a: test_scale_int32 at a human shard's size on the card, with two
    wide steps on the engine's own calls. One shard of 2^28 + 4096 bp (1 of
    a human genome's 10, at its own offset of 0; positions past 2^31 on the
    card come only from the full-size run of scripts/torch_scale_human.py).
    The test's 48 simulated reads plus its head and tail reads through
    Engine.align_batch at k = 0 and 2, truth as the test asserts it (at
    least 8 truths past 2^27); one block of 65,536 simulated reads through
    dispatch_block + finish_block at k = 0 and 2: every search_multistep
    call with wide_steps 2, the first call of each k held against its plain
    version, timed, bounded and floored (multistep_shape), the block's
    truth; search_multistep, locate_walk, verify_nm, search_chain2 and the
    PACKED kernels launched; the first compact_slots and compact_mask call
    of the block at each k held against its plain version and timed.
    Returns the launches, the search_multistep records, the arguments of
    int32_brute_force and the compaction records."""
    import numpy as np
    import torch

    from bwtpu_torch import engine
    from bwtpu_torch.engine import Engine
    from bwtpu_torch.index import load_index
    from bwtpu_torch.io import Read
    from bwtpu_torch.kernels import searchk
    from bwtpu_torch.readblock import ReadBlock
    from bwtpu_torch.simulate import random_genome, simulate_reads

    say(f"[14] human scale on one card: 14a, one shard of {INT32_N} bp (kmer_d 11, sa_rate 8), "
        f"two wide steps")
    t0 = time.perf_counter()
    out, _ = index_proc.communicate(timeout=1200)
    require(index_proc.returncode == 0, f"the 14a index build failed: {out[-2000:]}")
    shards, _ = load_index(path)
    idx = shards[0]
    require(idx.n == INT32_N + 1 and idx.n > 2**28, f"14a: n {idx.n}")
    eng = Engine(shards, device="cuda")
    sh = eng.dev_shards[0]
    resident = sum(t.numel() * t.element_size() for t in
                   [*(f for f in sh if isinstance(f, torch.Tensor)), *sh.kmer_tables.values()])
    require(eng._wide_steps(11) == 2, f"14a: _wide_steps(11) {eng._wide_steps(11)}")
    say(f"  index: built and saved in a child process in {out.strip()}; waited "
        f"{time.perf_counter() - t0:.1f} s; "
        f"resident on the card {resident} B ({resident / idx.text_len:.3f} B/base); "
        f"_wide_steps(11) = 2")

    t0 = time.perf_counter()
    genome = random_genome(INT32_N, seed=77)
    reads, truth = simulate_reads(genome, 48, read_len=100, max_mismatches=2, seed=78)
    reads.append(Read(rid="head", seq=genome[:100], qual="I" * 100))
    truth.append({"pos": 0, "strand": "+", "nm": 0})
    reads.append(Read(rid="tail", seq=genome[INT32_N - 100:], qual="I" * 100))
    truth.append({"pos": INT32_N - 100, "strand": "+", "nm": 0})
    block_reads, block_truth = simulate_reads(genome, HUMAN_BATCH, read_len=100,
                                              max_mismatches=2, seed=SEED + 17)
    blk = ReadBlock.from_reads(block_reads)
    say(f"  simulated the reads: {time.perf_counter() - t0:.1f} s")

    calls = {"test": [], 0: [], 2: []}
    flats = {}
    reset_launches()
    with capturing(searchk, "search_multistep", calls["test"]):
        for k in (0, 2):
            got = eng.align_batch(reads, k=k)
            for r, t, hits in zip(reads, truth, got):
                require(t["nm"] > k or any(h.pos == t["pos"] and h.strand == t["strand"]
                                           and h.nm == t["nm"] for h in hits),
                        f"14a test reads k={k}: {r.rid} {t} not in {hits[:4]}")
    comp = {name: {0: [], 2: []} for name in ("compact_slots", "compact_mask")}
    for k in (0, 2):
        with capturing(searchk, "search_multistep", calls[k]), \
                capturing(engine, "compact_counts", comp["compact_slots"][k]), \
                capturing(engine, "compact", comp["compact_mask"][k]):
            flats[k] = eng.finish_block(eng.dispatch_block(blk, k, pad_to=blk.n))
    launches = read_launches()
    beyond = sum(1 for t in truth if t["pos"] > 2**27)
    require(beyond >= 8, f"14a: {beyond} truths past 2^27")
    wide = {n: [c[15] for c in v] for n, v in calls.items()}
    require(all(calls.values()) and all(w == 2 for v in wide.values() for w in v),
            f"14a: search_multistep wide_steps {wide}, expected 2 on every call")
    need = ("search_multistep", "locate_walk", "verify_nm", "search_chain2") + PACKED
    require(all(launches[n] > 0 for n in need), f"14a: a kernel never ran: {launches}")
    say(f"  test_scale_int32's {len(reads)} reads at k = 0 and 2: truth as the test asserts it "
        f"({beyond} past 2^27); search_multistep calls with wide_steps 2: "
        f"{ {n: len(v) for n, v in wide.items()} }; launches {launches}")

    t_pos = np.array([t["pos"] for t in block_truth], np.int64)
    t_rev = np.array([t["strand"] == "-" for t in block_truth], np.int64)
    t_nm = np.array([t["nm"] for t in block_truth], np.int64)
    key = lambda r, p, s, m: ((r * 4 + m) << 34) | (p << 1) | s  # noqa: E731
    cols = {}
    for k, flat in flats.items():
        require(flat.truncated is None, f"14a block k={k}: truncated reads")
        cols[k] = (flat.read_idx.astype(np.int64), flat.pos.astype(np.int64),
                   flat.strand_rev.astype(np.int64), flat.nm.astype(np.int64))
        want = np.flatnonzero(t_nm <= k)
        found = np.isin(key(want, t_pos[want], t_rev[want], t_nm[want]), key(*cols[k]))
        require(found.all(), f"14a block k={k}: truth missing for {int((~found).sum())} of "
                             f"{len(want)} reads")
        say(f"  block of {blk.n} reads k={k}: truth {len(want)}/{len(want)} "
            f"({int((t_pos[want] > 2**27).sum())} past 2^27); {len(cols[k][0])} hits; heals "
            f"{eng.stats.heals} so far")
    records = {f"k{k}": multistep_shape(f"268 Mbp shard k={k} call 0", calls[k][0])
               for k in (0, 2)}
    comp_records = {name: {f"k{k}": compaction_call(name, f"268 Mbp shard k={k} call 0",
                                                    c[k][0]) for k in (0, 2)}
                    for name, c in comp.items()}
    return launches, records, (genome, block_reads, cols), comp_records


def int32_brute_force(genome: str, block_reads, cols) -> None:
    """14a's brute force: the hits of as many sampled block reads as fit
    in BF_SECONDS (at least BF_MIN), scanned over the whole shard on the
    card, equal to the block's at k = 0 and 2."""
    import numpy as np
    import torch

    from bwtpu_torch import dna

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    g_t = torch.from_numpy(dna.encode(genome)).cuda()
    order = np.random.default_rng(SEED + 18).permutation(len(block_reads))
    done, bf = 0, set()
    while done < BF_MIN or time.perf_counter() - t0 < BF_SECONDS:
        bf |= brute_force_sample(g_t, block_reads, order[done:done + BF_CHUNK], 2)
        done += BF_CHUNK
    del g_t
    torch.cuda.empty_cache()
    sample = np.sort(order[:done])
    n_bf = {k: check_sampled(cols[k], bf, sample, k, "14a block") for k in (0, 2)}
    say(f"  brute force over the whole shard on {done} sampled block reads in "
        f"{time.perf_counter() - t0:.1f} s (14b running beside it): k = 0 and 2 hit sets "
        f"equal ({n_bf} hits)")


def scale_human_keys(root: str) -> tuple[set, set]:
    """(keys of scripts/scale_human.py's JSON line, keys of
    scripts/scale_human_chip.py's `out` dict), read from their sources with
    ast (nothing is imported): the literal keys and out's subscripted keys,
    f-string keys expanded over the k values `measure` is called with."""
    import ast

    def parse(name):
        with open(os.path.join(root, "scripts", name)) as f:
            return ast.parse(f.read())

    tree = parse("scale_human.py")
    line = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
            and getattr(n.func, "attr", None) == "dumps" and n.args
            and isinstance(n.args[0], ast.Dict)][-1].args[0]
    build = {k.value for k in line.keys}
    tree = parse("scale_human_chip.py")
    ks = {n.args[0].value for n in ast.walk(tree) if isinstance(n, ast.Call)
          and getattr(n.func, "id", None) == "measure"}

    def names(key) -> set:
        if isinstance(key, ast.JoinedStr):
            return {"".join(v.value if isinstance(v, ast.Constant) else str(k)
                            for v in key.values) for k in ks}
        return {key.value}

    chip = set()
    for n in ast.walk(tree):
        if not isinstance(n, ast.Assign):
            continue
        t = n.targets[0]
        if isinstance(t, ast.Name) and t.id == "out" and isinstance(n.value, ast.Dict):
            chip |= {k for key in n.value.keys for k in names(key)}
        elif isinstance(t, ast.Subscript) and getattr(t.value, "id", None) == "out":
            chip |= names(t.slice)
    return build, chip


def json_lines(text: str) -> list:
    """The JSON objects among a program's stdout lines."""
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def start_scale_script(root: str, tmp: str):
    """Start 14b: scripts/torch_scale_human.py at 40 Mbp (of 2.5 Gbp: 10
    shards of ~4 Mbp), both halves, small batches and --tiered, in a
    session of its own, its output to files; returns (process, output
    path, start time)."""
    return scale_script(root, tmp, "scale_human", "--bp", "40000000", "--jobs", "4", "--keep")


SCALE_SMALL = ("--batch", "8192", "--k2-batch", "8192", "--n-truth", "1024", "--tiered")


def scale_script(root: str, tmp: str, name: str, *argv):
    """scripts/torch_scale_human.py on the 40 Mbp artifact (tmp/human_small)
    with small batches and --tiered, in a session of its own, its output to
    tmp/<name>.out; returns (process, output path, start time)."""
    cmd = [sys.executable, os.path.join(root, "scripts", "torch_scale_human.py"), *argv,
           *SCALE_SMALL]
    if "--index" not in argv:
        cmd += ["--out", os.path.join(tmp, "human_small")]
    out = os.path.join(tmp, f"{name}.out")
    with open(out, "w") as f:
        proc = subprocess.Popen(cmd, cwd=root, env=dict(os.environ, SCALE_HUMAN_ALLOW_SMALL="1"),
                                stdout=f, stderr=subprocess.STDOUT, text=True,
                                start_new_session=True)
    return proc, out, time.perf_counter()


def stop_session(proc) -> None:
    """Kill a process started in a session of its own, with its children."""
    import signal

    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def script_lines(run, what: str) -> list:
    """Wait for a run of the scale script (scale_script); its JSON lines."""
    proc, path, _ = run
    try:
        proc.wait(timeout=SCALE_TIMEOUT)
    finally:
        stop_session(proc)
    with open(path) as f:
        out = f.read()
    if proc.returncode != 0:
        say(out[-8000:])
    require(proc.returncode == 0, f"{what} exited with {proc.returncode}")
    return json_lines(out)


def check_card_half(card: dict, chip: dict, want_chip: set, what: str) -> None:
    """The card half's line: every key of scale_human_chip.py's, truth, every
    hit sound, no overflowed read, the kernels launched."""
    require(want_chip <= set(chip), f"{what}: keys missing: {sorted(want_chip - set(chip))}")
    require(chip["truth_recovered"] == chip["truth_reads"]
            and chip["recovered_beyond_int32"] == chip["truth_beyond_int32"]
            and chip["unsound_hits"] == 0 and chip["sound_hits"] > 0
            and chip["overflow_reads"] == 0 and chip["platform"] == "cuda", f"{what}: {chip}")
    lc = card["launches"]
    require(all(lc[n] > 0 for n in ("search_multistep", "search_chain2", "locate_walk",
                                    "verify_nm") + PACKED), f"{what}: launches {lc}")


def phase_scale_script(root: str, tmp: str, run) -> dict:
    """14b: the wiring of scripts/torch_scale_human.py, started by
    start_scale_script: rc 0, both JSON lines with every key of the
    reference scripts', every truth recovered (the sample's and the card
    half's), every hit sound, no overflowed read, search_multistep
    launched in both halves and search_chain2, locate_walk, verify_nm and
    the PACKED kernels in the card half; then its card half again on the
    kept artifact with
    --fuse: the same checks, fused_dispatch true, each graph's capture
    listed, and the same hits checked as the loop's. Returns the launches
    of the three halves."""
    say("[14] 14b: scripts/torch_scale_human.py --bp 40000000 (10 shards), small batches, "
        "--tiered; then its card half with --fuse")
    t0 = run[2]
    build, card, chip = script_lines(run, "torch_scale_human.py")
    want_build, want_chip = scale_human_keys(root)
    require(want_build <= set(build), f"14b: keys missing: {sorted(want_build - set(build))}")
    require(build["truth_recovered"] == build["sample_reads"]
            and build["recovered_beyond_int32"] == build["truth_beyond_int32"], f"14b: {build}")
    check_card_half(card, chip, want_chip, "14b")
    require(build["launches"]["search_multistep"] > 0, f"14b: launches {build['launches']}")
    require(chip["fused_dispatch"] is False, "14b: fused_dispatch without --fuse")
    for line in (build, card, chip):
        say(f"  {json.dumps(line)}")
    lb, lc = build["launches"], card["launches"]
    say(f"  14b: rc 0 in {time.perf_counter() - t0:.1f} s; both lines carry every key of "
        f"scale_human.py's and scale_human_chip.py's; truth {build['truth_recovered']}/"
        f"{build['sample_reads']} and {chip['truth_recovered']}/{chip['truth_reads']}, "
        f"{chip['sound_hits']} hits sound; search_chain1 launched {lb['search_chain1']} + "
        f"{lc['search_chain1']} times (uniform 100 bp reads take the packed path)")
    t0 = time.perf_counter()
    fcard, fchip = script_lines(scale_script(root, tmp, "scale_human_fuse", "--index",
                                             os.path.join(tmp, "human_small"), "--fuse"),
                                "torch_scale_human.py --fuse")
    check_card_half(fcard, fchip, want_chip, "14b --fuse")
    require(fchip["fused_dispatch"] is True and fcard["graph_captures"]
            and fcard["graph_replays"] > 0 and fcard["multistep_calls"] is None
            and fchip["sound_hits"] == chip["sound_hits"],
            f"14b --fuse: {fchip} {fcard['graph_captures']}")
    for line in (fcard, fchip):
        say(f"  {json.dumps(line)}")
    say(f"  14b --fuse: rc 0 in {time.perf_counter() - t0:.1f} s; fused_dispatch true; "
        f"{len(fcard['graph_captures'])} graphs, {fcard['graph_replays']} replays (their "
        f"launches not counted: only the graphs' eager warm-ups are); truth "
        f"{fchip['truth_recovered']}/{fchip['truth_reads']}; the same "
        f"{fchip['sound_hits']} hits sound as the loop's")
    return {n: lb[n] + lc[n] + fcard["launches"][n] for n in lb}


# phase 14c: the port's measurement programs (scripts/torch_<script>.py),
# each at a reduced size: {name: (script, arguments)}
SWEEPS = {
    "scale_chr21": ("scale_chr21", ("--genome-bp", "4641652", "--reads", "131072",
                                    "--batch", "65536")),
    "sweep_locate": ("sweep_locate", ("--configs", "1:1:0.75:1:65536", "1:0:0.75:1:65536",
                                      "2:0:0.75:1:65536")),
    "tune_exact": ("tune_exact", ("--batch", "65536", "--loc-factors", "0.25,0.125")),
    "ab_batch": ("ab_batch", ("--configs", "65536:11")),
    "ab_batch_k2": ("ab_batch", ("--configs", "65536:11", "--k2")),
    "sweep_depth": ("sweep_depth", ("--depths", "10", "11", "--batch", "65536",
                                    "--k2-batch", "65536")),
    "e2e_profile": ("e2e_profile", ("--reads", "131072", "--batch", "65536")),
    "profile_build": ("profile_build", ("--mbp", "16")),
}
SWEEP_TIMEOUT = 300  # seconds for all of phase 14c's subprocesses
# the keys of each JSON-printing reference's lines (tests/test_torch_sweeps.py
# and test_torch_profiles.py hold them equal to the references' own output)
SWEEP_KEYS = {
    "scale_chr21": {"config", "genome_bp", "n_shards", "min_trips", "exact_overflow",
                    "k2_overflow", "sa_rate", "reads", "exact_reads_per_s", "k2_reads_per_s",
                    "index_build_s", "upload_s", "hbm_index_bytes", "hbm_index_mb", "kmer_d",
                    "platform"},
    "tune_exact": {"kind", "batch", "min_trips", "loc_factor", "reads_per_s",
                   "compact_overflow"},
    "sweep_depth": {"d", "exact_rps", "exact_overflow", "table_mb", "k2_rps", "k2_overflow"},
    "e2e_profile": {"reads", "fq_mb", "sam_mb", "wall_s", "serialized_reads_per_s",
                    "engine_device_s", "engine_host_s", "parse_s", "slice_s", "dispatch_s",
                    "finish_s", "primary_s", "emit_s", "write_s"},
    "profile_build": {"mbp", "rss_gb", "build_total_s", "genome_gen", "sanitize_encode", "sais",
                      "bwt_gather", "lattice_native", "tkey_passes", "key_gather",
                      "kmer_searchsorted", "tc_cast", "precode_gathers", "occk_bincount",
                      "occk_pack"},
}
# the text lines of the two references that print no JSON: (tag, M reads/s,
# overflow[, cap_occ])
SWEEP_LINES = {
    "sweep_locate": r"^(sa_rate=\d+ locv=\d lf=[\d.]+ mt=\d+ B=\d+): ([\d.]+) M reads/s  "
                    r"overflow=(\d+)  cap_occ=([\d.]+)$",
    "ab_batch": r"^(B=\d+ d=\d+ k2=(?:True|False)): ([\d.]+) M reads/s  overflow=(\d+)$",
}


def phase_sweeps(root: str, tmp: str) -> collections.Counter:
    """14c: every SWEEPS program on the card at once, each in a session of
    its own, its stdout and stderr to files; each one's wall; rc 0 and
    every line with the reference's keys or format; overflow 0 where the
    reference fails on it (sweep_locate, ab_batch); search_multistep
    launched by every program but profile_build (host only). Returns their
    launches, summed."""
    import re

    say("[14] 14c: the measurement programs on the card, all at once, at reduced sizes")
    t0 = time.perf_counter()
    runs = {}
    for name, (script, argv) in SWEEPS.items():
        out, err = (os.path.join(tmp, f"sweep_{name}.{s}") for s in ("out", "err"))
        with open(out, "w") as fo, open(err, "w") as fe:
            runs[name] = (subprocess.Popen(
                [sys.executable, os.path.join(root, "scripts", f"torch_{script}.py"), *argv],
                cwd=root, stdout=fo, stderr=fe, text=True, start_new_session=True), out, err)
    walls, deadline = {}, t0 + SWEEP_TIMEOUT
    try:
        while len(walls) < len(runs) and time.perf_counter() < deadline:
            for name, (proc, _, _) in runs.items():
                if name not in walls and proc.poll() is not None:
                    walls[name] = time.perf_counter() - t0
            time.sleep(0.1)
    finally:
        for proc, _, _ in runs.values():
            stop_session(proc)
    launches = collections.Counter()
    for name, (proc, out_path, err_path) in runs.items():
        with open(out_path) as f:
            out = f.read()
        with open(err_path) as f:
            err = f.read()
        script = SWEEPS[name][0]
        if proc.returncode != 0:
            say(out[-4000:] + err[-4000:])
        require(name in walls and proc.returncode == 0,
                f"14c: torch_{script}.py exited with {proc.returncode}")
        if script in SWEEP_LINES:
            rows = [m.groups() for m in map(re.compile(SWEEP_LINES[script]).match,
                                            out.splitlines()) if m]
            require(rows and all(int(r[2]) == 0 for r in rows), f"14c {name}: {out}")
            shown = [f"{r[0]}: {r[1]} M reads/s, overflow {r[2]}" for r in rows]
        else:
            lines = json_lines(out)
            if script == "sweep_depth":  # its closing line holds every row
                require(lines[-1]["rows"] == lines[:-1], f"14c {name}: {out}")
                lines = lines[:-1]
            require(lines and all(set(ln) == SWEEP_KEYS[script] for ln in lines),
                    f"14c {name}: keys {[sorted(ln) for ln in lines]}")
            shown = [json.dumps(ln) for ln in lines]
        counts = json_lines(err.replace("# launches ", ""))
        if script != "profile_build":
            require(counts and counts[-1]["search_multistep"] > 0, f"14c {name}: {counts}")
            launches.update(counts[-1])
        say(f"  {name} ({' '.join(SWEEPS[name][1])}): rc 0 in {walls[name]:.1f} s")
        for line in shown:
            say(f"    {line}")
    say(f"  phase 14c: {time.perf_counter() - t0:.1f} s; launches {dict(launches)}")
    return launches


# the packed main path's prep and compaction kernels
PACKED = ("revcomp_both", "compact_slots", "compact_mask")

KERNELS = {  # name: (source, TPU kernel (or jnp code) it replaces)
    "sw_band": ("bwtpu_torch/csrc/sw.cu", "bwtpu/sw.py:28"),
    "locate_walk": ("bwtpu_torch/csrc/locate.cu", "bwtpu/kernels/pallas_step.py:256"),
    "verify_nm": ("bwtpu_torch/csrc/verify.cu", "bwtpu/kernels/pallas_step.py:302"),
    "search_chain1": ("bwtpu_torch/csrc/search1.cu", "bwtpu/kernels/pallas_step.py:179"),
    "search_chain2": ("bwtpu_torch/csrc/search2.cu", "bwtpu/kernels/pallas_step.py:115"),
    "search_multistep": ("bwtpu_torch/csrc/searchk.cu", "bwtpu/kernels/searchk.py:296"),
    "verify_locv": ("bwtpu_torch/csrc/verify.cu",
                    "bwtpu/kernels/verify2.py:129, bwtpu/engine.py:548"),
    "row_gather_sum": ("bwtpu_torch/csrc/gather.cu", "scripts/pallas_gather_ab.py:37"),
    "revcomp_both": ("bwtpu_torch/csrc/prep.cu",
                     "bwtpu/kernels/prep.py:64, bwtpu/engine.py:644"),
    "compact_slots": ("bwtpu_torch/csrc/compact.cu", "bwtpu/kernels/compact.py:39"),
    "compact_mask": ("bwtpu_torch/csrc/compact.cu", "bwtpu/kernels/compact.py:18"),
}


def reset_launches() -> None:
    from bwtpu_torch.kernels import _build

    _build.reset_launches()


def read_launches() -> dict:
    from bwtpu_torch.kernels import _build

    return _build.launch_counts()


def brute_force_sample(g_t, reads, sample, k: int) -> set:
    """{(read, pos, reverse, nm)} of the sampled reads by brute force,
    one scan per read length."""
    import numpy as np
    import torch

    from bwtpu_torch import dna

    by_len: dict = {}
    for i in sample:
        by_len.setdefault(len(reads[i].seq), []).append(int(i))
    out = set()
    for ids in by_len.values():
        pats, msks = [], []
        for i in ids:
            codes, mask = dna.encode_with_mask(reads[i].seq)
            pats += [codes, dna.revcomp_codes(codes, mask)[0]]
            msks += [mask, mask[::-1]]
        bf = brute_force(g_t, torch.from_numpy(np.stack(pats)).cuda(),
                         torch.from_numpy(np.stack(msks)).cuda(), k)
        out |= {(ids[pi // 2], int(p), pi % 2, int(m)) for pi, p, m in bf}
    return out


def smoke_genome() -> str:
    """Random E. coli-size genome with one dispersed repeat family."""
    import numpy as np

    from bwtpu_torch.simulate import ECOLI_SCALE, random_genome

    g = bytearray(random_genome(ECOLI_SCALE, seed=SEED), "ascii")
    rng = np.random.default_rng(SEED + 4)
    for p in rng.choice(len(g) - len(REPEAT), size=N_REPEATS, replace=False):
        g[p:p + len(REPEAT)] = REPEAT.encode()
    return g.decode()


def read_list_reads(genome: str):
    """N_READS reads of 50-100 bp (each length simulated with <= 2
    mismatches), shuffled with the seed; returns (reads, truth)."""
    import numpy as np

    from bwtpu_torch.io import Read
    from bwtpu_torch.simulate import simulate_reads

    rng = np.random.default_rng(SEED + 5)
    counts = np.bincount(rng.integers(50, 101, size=N_READS), minlength=101)
    reads, truth = [], []
    for L in range(50, 101):
        r, t = simulate_reads(genome, int(counts[L]), read_len=L, max_mismatches=2,
                              seed=SEED + 100 + L)
        reads += r
        truth += t
    order = rng.permutation(N_READS)
    return ([Read(f"q{i}", reads[j].seq) for i, j in enumerate(order)],
            [truth[j] for j in order])


def run_phases(tmp: str, root: str, smi: str, genome: str, list_reads, list_truth, reads,
               truth, index_proc, int32_dir: str):
    """Phases 3-14 in order. Returns the kernel records, the launches of
    each path and the index builds' seconds."""
    from bwtpu_torch.io import write_fasta

    fa = os.path.join(tmp, "ecoli.fa")
    write_fasta(fa, [("ecoli_sim", genome)])
    records, sa1_dir = phase_kernels(tmp, genome, fa, list_reads, reads)
    phase_phix(tmp, root)
    idx_dir, launches, p5 = phase_main(tmp, genome, fa, reads, truth)
    list_launches = phase_read_list(tmp, genome, idx_dir, list_reads, list_truth)
    locv_launches = phase_locv(tmp, p5, sa1_dir)
    ab_launches, l2_rate = phase_gather_ab()
    chain1_l2(records["search_chain1"], l2_rate)
    rescore_launches = phase_rescore(tmp, genome, idx_dir, list_reads)
    paired_launches, paired_build_s, p10, records["search_multistep"]["wide"] = \
        phase_paired(tmp)
    fused_launches = phase_fused(p10)
    wide_launches = phase_wide(tmp)
    ring_launches = phase_ring(tmp, smi, idx_dir, p5["fq"], reads, p10)
    bench_launches, profile_launches = phase_bench(tmp, smi, root, idx_dir, p5)
    t0 = time.perf_counter()
    int32_launches, records["search_multistep"]["human"], bf_args, comp = phase_int32(
        index_proc, int32_dir)
    for name, rec in comp.items():
        records[name]["int32"] = rec
    script = start_scale_script(root, tmp)  # 14b runs beside 14a's brute force
    try:
        int32_brute_force(*bf_args)
        script_launches = phase_scale_script(root, tmp, script)
    finally:
        stop_session(script[0])
    sweep_launches = phase_sweeps(root, tmp)
    say(f"  phase 14: {time.perf_counter() - t0:.1f} s")
    paths = {"slice 1's path": launches, "the Read-list path": list_launches,
             "the sa_rate 1 path": locv_launches, "the --rescore path": rescore_launches,
             "paired-end on 2 shards": paired_launches,
             "the fused dispatch on 2 shards (10b)": fused_launches, "wide reads": wide_launches,
             "the ring (every rank)": ring_launches, "the gather A/B": ab_launches,
             "the bench (sections and probe ranks)": bench_launches,
             "align --profile": profile_launches, "the 268 Mbp shard (14a)": int32_launches,
             "torch_scale_human.py (14b)": script_launches,
             "the measurement programs (14c)": sweep_launches}
    builds = (f"the 2-shard build took {paired_build_s:.1f} s, the single-shard one "
              f"{records['search_multistep']['wide']['build_s']:.1f} s")
    return records, paths, builds


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import bwtpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    from bwtpu_torch.simulate import simulate_reads

    t_all = time.perf_counter()
    name, smi = phase_card()
    phase_build()
    genome = smoke_genome()
    t0 = time.perf_counter()
    list_reads, list_truth = read_list_reads(genome)
    reads, truth = simulate_reads(genome, N_READS, read_len=100, max_mismatches=2,
                                  seed=SEED + 1)
    say(f"  simulated the Read-list reads and phase 5's reads: "
        f"{time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory(prefix="bwtpu_torch_smoke_") as tmp:
        # phase 14a's index builds in a process of its own meanwhile
        index_proc, int32_dir = start_int32_index(root, tmp)
        try:
            records, paths, builds = run_phases(tmp, root, smi, genome, list_reads,
                                                list_truth, reads, truth, index_proc, int32_dir)
        finally:
            if index_proc.poll() is None:
                index_proc.kill()
                index_proc.wait()
    for what, counts in paths.items():
        say(f"  launches on {what}: {counts}")
    say(f"[15] all phases passed in {time.perf_counter() - t_all:.1f} s on {smi} ({builds})")
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(c[k] for c in paths.values()), "library_ms": None, **records[k]}
        for k, (src, rep) in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
