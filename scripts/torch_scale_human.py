"""The human-scale run of bwtpu_torch on one card: the port of
scripts/scale_human.py (the sharded build proof) and
scripts/scale_human_chip.py (every shard on one card), in one program.

Build half: a random genome of --bp bases (seed 5; above 2^31 by
default, so the genome must be sharded and global positions need 64
bits) -> build_sharded_index into 10 shards (overlap 256, --jobs worker
processes) -> save_index -> load_index -> Engine.align_all of --n-sample
simulated 100 bp reads at k = 2 on --device -> truth recovery, counting
the reads past 2^31 apart. Prints scale_human.py's JSON line.

Card half, after the build in the same process, or alone on the artifact
--index DIR: keep one start-table depth per shard; an Engine over every
shard at the exact loc_factor; HBM bytes resident; exact reads/s (an
autotune probe, one warm block, then the best of 2 passes over 2
distinct blocks of reads cut from shard text); the exact engine freed,
then one at k = 2 (hit_factor 3.0): truth on --n-truth reads regenerated
from the genome seed, every hit of it checked against the genome at its
global position and strand (within k substitutions, nm equal); k <= 2
and, with --tiered, tiered reads/s. Prints one line of its own (the
card's name and power limit, peak device memory, the depth kept and its
wide steps, search_multistep calls with and without a wide phase, one
such call's device ms against its bound, kernel launches, for each rate
one more pass of its 2 blocks under torch.profiler: wall, device busy
time and share, the kernels that took most, each kernel's launches and
device µs counted by kernel name (the fused form's replays included),
and per block of the timed
passes the dispatch_block wall split into packing the reads, their upload
(the wait for the card included) and the rest (issue), and the
finish_block wall split into the fetch (its device-to-host copies, the
wait for the card included) and the rest (host assembly), and with
--fuse each CUDA graph's warm-up and capture seconds), then
scale_human_chip.py's JSON line with its keys and these: sound_hits,
unsound_hits.

--fuse, as in scale_human_chip.py, runs the engines with
fuse_shards=True: each block is one CUDA graph replay for all shards.
A replay calls no wrapper, so on the card the line's search_multistep
calls read null, its launches count only the eager runs (each graph's
warm-up), and graph_replays counts the replays. --package DIR
imports bwtpu_torch from DIR instead (the A/B against an earlier tree,
unpacked with `git archive`).

Differences from the two scripts: the sample aligns through Engine (one
process, every shard in turn) where scale_human.py used a 10-device CPU
DistEngine; the artifact goes to the temp directory by default. Nothing
falls back to the CPU: without a card the run fails unless --device cpu.

Run (one card):  python3 scripts/torch_scale_human.py --tiered
     (smaller):  SCALE_HUMAN_ALLOW_SMALL=1 python3 scripts/torch_scale_human.py \\
                     --bp 40000000 --batch 8192 --k2-batch 8192 --n-truth 1024 --tiered
     (A/B):      python3 scripts/torch_scale_human.py --keep --out DIR ...; then
                 python3 scripts/torch_scale_human.py --index DIR --tiered [--fuse]
                 [--package _ab/parent]
     (CPU):      SCALE_HUMAN_ALLOW_SMALL=1 python3 scripts/torch_scale_human.py \\
                     --bp 2000000 --device cpu --batch 256 --k2-batch 256 --n-truth 128
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import gc
import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_SHARDS = 10


def rss_gb() -> float:
    self_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    child_kb = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss
    return round((self_kb + child_kb) / 1e6, 2)


def stage(what: str) -> None:
    """A progress line on stderr (a cut run shows how far it got)."""
    print(f"# {time.strftime('%H:%M:%S')} {what}", file=sys.stderr, flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"torch_scale_human: check failed: {what}")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    # the build half (scale_human.py's options)
    ap.add_argument("--bp", type=int, default=2_500_000_000)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "human_idx"))
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--n-sample", type=int, default=64)
    ap.add_argument("--keep", action="store_true", help="keep the on-disk index artifact")
    ap.add_argument("--sa-rate", type=int, default=32,
                    help="SA sampling rate (32: the marks cost n/32*4 bytes and the "
                         "LF walk is at most 32 steps)")
    # the card half (scale_human_chip.py's options)
    ap.add_argument("--index", default=None,
                    help="run the card half alone on this artifact (no build)")
    ap.add_argument("--batch", type=int, default=65536)
    ap.add_argument("--n-truth", type=int, default=8192)
    ap.add_argument("--kmer-d", type=int, default=11,
                    help="single start-table depth to keep resident (the deepest "
                         "table where the index lacks it)")
    ap.add_argument("--k2-batch", type=int, default=32768)
    ap.add_argument("--genome-seed", type=int, default=5,
                    help="seed of the build (truth regenerates the genome)")
    ap.add_argument("--skip-truth", action="store_true",
                    help="rates only: no genome regeneration, truth or soundness")
    ap.add_argument("--exact-lf", type=float, default=1.0)
    ap.add_argument("--k2-lf", type=float, default=6.0)
    ap.add_argument("--tiered", action="store_true",
                    help="also measure tiered k2 on the error-free window reads")
    ap.add_argument("--fuse", action="store_true",
                    help="fused one-dispatch program for all shards (Engine "
                         "fuse_shards=True: one CUDA graph replay a block)")
    ap.add_argument("--package", default=None,
                    help="import bwtpu_torch from this directory (an earlier tree)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


def build_half(args):
    """scale_human.py: build, save, load, align a sample. Returns the
    loaded (shards, manifest) and the load seconds."""
    import torch

    from bwtpu_torch.config import EngineConfig
    from bwtpu_torch.engine import Engine
    from bwtpu_torch.index import build_sharded_index, load_index, save_index
    from bwtpu_torch.kernels import _build
    from bwtpu_torch.simulate import random_genome, simulate_reads

    if not os.environ.get("SCALE_HUMAN_ALLOW_SMALL"):
        require(args.bp > 2**31, "the point is the forced-sharding regime (--bp > 2^31)")
    t0 = time.time()
    genome = random_genome(args.bp, seed=5)
    gen_s = time.time() - t0

    # sa_rate 32 at this scale: the full SA would be 4 B/base; rate-32
    # marks cost n/32*4 bytes with a <= 32-step bounded LF walk
    cfg = EngineConfig(sa_rate=args.sa_rate, max_hits=4, max_cand=8, read_len=100)
    t0 = time.time()
    shards, manifest = build_sharded_index(genome, N_SHARDS, config=cfg, overlap=256,
                                           jobs=args.jobs)
    build_s = time.time() - t0
    build_rss = rss_gb()
    stage(f"built {N_SHARDS} shards in {build_s:.1f} s")
    require(all(s.text_len < 2**31 for s in shards), "a shard reaches 2^31 bases")

    t0 = time.time()
    save_index(args.out, shards, manifest)
    save_s = time.time() - t0
    disk_bytes = sum(os.path.getsize(os.path.join(args.out, f)) for f in os.listdir(args.out))
    del shards

    t0 = time.time()
    shards2, manifest2 = load_index(args.out)
    load_s = time.time() - t0

    # truth recovery proves the int32-local / int64-global row math at
    # > 2^31 magnitudes
    t0 = time.time()
    reads, truth = simulate_reads(genome, args.n_sample, read_len=100, max_mismatches=2,
                                  seed=6)
    del genome
    _build.reset_launches()
    eng = Engine(shards2, device=args.device)
    hits = eng.align_all(reads, k=2, batch_size=args.n_sample)
    align_s = time.time() - t0
    launches = _build.launch_counts()
    del eng
    gc.collect()
    if args.device == "cuda":
        torch.cuda.empty_cache()
    recovered = sum(
        any(h.pos == t["pos"] and h.strand == t["strand"] and h.nm == t["nm"] for h in hs)
        for t, hs in zip(truth, hits))
    int32_bar = 2**31 if args.bp > 2**31 else args.bp // 2
    beyond_int32 = sum(1 for t in truth if t["pos"] > int32_bar)
    rec_beyond = sum(
        any(h.pos == t["pos"] and h.strand == t["strand"] for h in hs)
        for t, hs in zip(truth, hits) if t["pos"] > int32_bar)

    print(json.dumps({
        "config": "human-scale sharded build proof",
        "genome_bp": args.bp,
        "n_shards": N_SHARDS,
        "jobs": args.jobs,
        "genome_gen_s": round(gen_s, 1),
        "index_build_s": round(build_s, 1),
        "peak_rss_gb_after_build": build_rss,
        "save_s": round(save_s, 1),
        "artifact_gb": round(disk_bytes / 1e9, 2),
        "load_s": round(load_s, 1),
        "align_sample_s": round(align_s, 1),
        "sample_reads": args.n_sample,
        "truth_recovered": recovered,
        "truth_beyond_int32": beyond_int32,
        "recovered_beyond_int32": rec_beyond,
        "peak_rss_gb_final": rss_gb(),
        "device": args.device,
        "launches": launches,
    }), flush=True)
    require(recovered == args.n_sample, f"truth {recovered}/{args.n_sample}")
    # a small --n-sample may draw no read past 2^31 (P ~ 0.14 a read at
    # 2.5 Gbp): recovery is required of those drawn
    require(rec_beyond == beyond_int32, f"past 2^31: {rec_beyond}/{beyond_int32}")
    if not args.keep:
        shutil.rmtree(args.out)
    return shards2, manifest2, load_s


@contextlib.contextmanager
def counting_multistep(counts: dict, keep: list):
    """Count the search_multistep calls while the block runs, those with a
    wide phase (wide_steps > 0) apart, and keep the arguments of the first
    wide call (references, not copies). The calls go through; as
    chip_smoke.capturing does, the launches the wrapper counts on the
    name it was called by go back to the kernel's counter."""
    from bwtpu_torch.kernels import searchk

    orig = searchk.search_multistep

    def counted(*a):
        counts["calls"] += 1
        if a[15] > 0:
            counts["wide_calls"] += 1
            if not keep:
                keep.append(a)
        return orig(*a)

    counted.launches = 0
    searchk.search_multistep = counted
    try:
        yield
    finally:
        searchk.search_multistep = orig
        orig.launches += counted.launches


@contextlib.contextmanager
def timing_calls(acc: dict, what: str, targets):
    """Add to acc[what] the seconds spent in the functions or methods
    `targets` ((owner, name) pairs) while the block runs, whatever tree's
    engine calls them."""
    saved = [(owner, name, owner.__dict__.get(name)) for owner, name in targets]

    def timed(f):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return f(*a, **kw)
            finally:
                acc[what] += time.perf_counter() - t0
        return call

    for owner, name, _ in saved:
        setattr(owner, name, timed(getattr(owner, name)))
    try:
        yield
    finally:
        for owner, name, f in saved:
            if f is None:
                delattr(owner, name)
            else:
                setattr(owner, name, f)


def unsound_hits(codes: np.ndarray, reads, flat, k: int) -> tuple[int, int]:
    """(sound, unsound) hits of a FlatHits against the genome codes: a hit
    is sound when the read, on its strand, lies within the genome at the
    hit's global position with nm substitutions there (an ambiguous read
    base mismatches everything) and nm <= k."""
    from bwtpu_torch import dna

    n = len(flat.read_idx)
    if n == 0:
        return 0, 0
    L = len(reads[0].seq)
    enc = [dna.encode_with_mask(r.seq) for r in reads]
    fwd = np.stack([c for c, _ in enc]).astype(np.int16)
    amb = np.stack([m for _, m in enc])
    ridx = flat.read_idx.astype(np.int64)
    rev = flat.strand_rev.astype(bool)
    pat, msk = fwd[ridx], amb[ridx]
    # '-' hits: the read's reverse complement lies on the forward strand
    pat[rev] = 3 - pat[rev][:, ::-1]
    msk[rev] = msk[rev][:, ::-1]
    pos = flat.pos.astype(np.int64)
    inside = (pos >= 0) & (pos + L <= len(codes))
    win = codes[np.clip(pos, 0, len(codes) - L)[:, None] + np.arange(L)[None, :]]
    mism = ((win != pat) | msk).sum(1)
    ok = inside & (mism == flat.nm) & (flat.nm <= k)
    return int(ok.sum()), int(n - ok.sum())


def card_half(args, shards, manifest, load_s: float) -> None:
    """scale_human_chip.py on the port: every shard on one device."""
    import torch

    from bwtpu_torch import dna, readblock
    from bwtpu_torch.engine import Engine
    from bwtpu_torch.kernels import _build
    from bwtpu_torch.kernels.bounds import bound, cuda_ms, multistep_work
    from bwtpu_torch.readblock import ReadBlock
    from bwtpu_torch.results import hit_lists
    from bwtpu_torch.simulate import random_genome, simulate_reads

    cuda = args.device == "cuda"
    fused_card = args.fuse and cuda  # blocks are graph replays: no wrapper call counts them
    t_all = time.time()
    out = {"config": f"human-scale on one card (S={len(shards)})", "platform": args.device,
           "device": torch.cuda.get_device_name(0) if cuda else "cpu",
           "n_shards": len(shards), "genome_bp": int(sum(s.text_len for s in shards)),
           "load_s": round(load_s, 1)}
    # keep ONE start-table depth: the ladder x 10 shards is device memory
    # the batch pipelines never touch at a fixed read length
    for s in shards:
        keep = args.kmer_d if args.kmer_d in s.kmer_tables else max(s.kmer_tables)
        for dd in [d for d in list(s.kmer_tables) if d != keep]:
            del s.kmer_tables[dd]
    d_kept = max(shards[0].kmer_tables)
    cfg0 = shards[0].config
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    def engine_with(lf, hf=1.0):
        # hf: the k2 hit stream at this scale is duplicate-rich (3 seeds x
        # true loci), so hit_factor 1.0 would overflow the hit buffer and
        # heal in every batch
        sh = [dataclasses.replace(s, config=cfg0.replace(loc_factor=lf, hit_factor=hf))
              for s in shards]
        # an earlier tree's Engine (--package) has no fuse_shards
        return Engine(sh, device=args.device, **({"fuse_shards": True} if args.fuse else {}))

    t0 = time.time()
    eng = engine_with(args.exact_lf)
    resident = sum(t.numel() * t.element_size() for sh in eng.dev_shards
                   for t in [*(f for f in sh if isinstance(f, torch.Tensor)),
                             *sh.kmer_tables.values()])
    out["upload_s"] = round(time.time() - t0, 1)
    out["hbm_resident_gb"] = round(resident / 1e9, 2)
    wide_steps = eng._wide_steps(d_kept)
    stage(f"uploaded {resident} B in {out['upload_s']} s")

    def simulate_reads_fast(B, seed):
        """B reads of 100 bp cut from shard text (error-free windows): the
        rates need volume, not truth, and simulating from a 2.5 Gbp string
        is slow."""
        rng = np.random.default_rng(90 + seed)
        s0 = shards[seed % len(shards)]
        tp = s0.text_packed.view(np.uint8)
        starts = rng.integers(0, s0.text_len - 120, size=B)
        pos = starts[:, None] + np.arange(100)[None, :]
        codes = (tp[pos // 4] >> (2 * (pos % 4)).astype(np.uint8)) & 3
        seq = np.frombuffer(b"ACGT", np.uint8)[codes]
        id_strs = [f"q{seed}_{i}".encode() for i in range(B)]
        off = np.zeros(B + 1, np.int64)
        off[1:] = np.cumsum([len(x) for x in id_strs])
        return ReadBlock(n=B, L=100, id_blob=np.frombuffer(b"".join(id_strs), np.uint8),
                         id_off=off, seq=seq, qual=np.full((B, 100), ord("I"), np.uint8))

    # the host-to-device copies of a block (an earlier tree's Engine: _put)
    upload = "_upload" if hasattr(Engine, "_upload") else "_put"

    def measure(k, B, tiered=False):
        encs = [simulate_reads_fast(B, i) for i in range(2)]
        # warm at the ceiling, then size the caps to measured occupancy
        eng.autotune_caps(encs[0], k, pad_to=B)
        if tiered:  # tier 1 runs at the k=0 caps
            eng.autotune_caps(encs[0], 0, pad_to=B)
        eng.finish_block(eng.dispatch_block(encs[0], k, pad_to=B, tiered=tiered))
        h0 = eng.stats.heals
        best, walls = 0.0, collections.Counter()
        for _ in range(2):
            t0 = time.time()
            hs = []
            for e in encs:
                t1 = time.perf_counter()
                with timing_calls(walls, "pack", [(readblock, "pack_block")]), \
                        timing_calls(walls, "upload", [(Engine, upload)]):
                    hs.append(eng.dispatch_block(e, k, pad_to=B, tiered=tiered))
                walls["dispatch"] += time.perf_counter() - t1
            for h in hs:
                t1 = time.perf_counter()
                with timing_calls(walls, "fetch", [(torch.Tensor, "cpu"),
                                                   (torch.Tensor, "tolist")]):
                    eng.finish_block(h)
                walls["finish"] += time.perf_counter() - t1
            best = max(best, 2 * B / (time.time() - t0))
        # ms per block; issue = the rest of dispatch_block (the pipelines'
        # host issue, or the graph's input copy and replay), assembly = the
        # rest of finish_block
        ms = {n: v / (2 * len(encs)) * 1e3 for n, v in walls.items()}
        per_block["k2_tiered" if tiered else f"k{k}"] = {
            **{f"{n}_ms": ms[n] for n in ("dispatch", "pack", "upload", "finish", "fetch")},
            "issue_ms": ms["dispatch"] - ms["pack"] - ms["upload"],
            "assembly_ms": ms["finish"] - ms["fetch"]}
        out[f"k{k}_lf_tuned"] = eng._lf(k)
        out[f"k{k}_heals_timed"] = eng.stats.heals - h0
        if cuda:
            busy["k2_tiered" if tiered else f"k{k}"] = profiled_pass(
                lambda: [eng.finish_block(h) for h in
                         [eng.dispatch_block(e, k, pad_to=B, tiered=tiered) for e in encs]])
        return best

    def graph_captures() -> list:
        """Each CUDA graph of the engine (--fuse): its key's mode, k, heal
        level, rows and caps, and its warm-up and capture seconds."""
        return [dict(mode=key[0], k=key[1], level=key[4], rows=key[7], caps=key[5], **v)
                for key, v in getattr(eng, "captures", {}).items()]

    def profiled_pass(run) -> dict:
        """One more pass under torch.profiler (CUDA activity only), the
        engine's counters restored after it: the window's wall, its device
        events, their merged busy time and the names that took most."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        stats = dataclasses.replace(eng.stats)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        eng.stats = stats
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy_us, end = 0.0, float("-inf")
        for a, b in sorted((e.time_range.start, e.time_range.end) for e in dev):
            if b > end:
                busy_us += b - max(a, end)
                end = b
        by_name = collections.Counter()
        kernels: dict = {}
        for e in dev:
            by_name[e.name] += e.time_range.elapsed_us()
            for n, c in _build.launches_in_trace([e.name]).items():
                if c:
                    r = kernels.setdefault(n, {"launches": 0, "us": 0.0})
                    r["launches"] += 1
                    r["us"] += e.time_range.elapsed_us()
        return {"wall_ms": wall * 1e3, "device_events": len(dev), "busy_ms": busy_us / 1e3,
                "busy_share": busy_us / 1e6 / wall,
                "top_ms": {n: us / 1e3 for n, us in by_name.most_common(4)},
                "kernels": kernels}

    counts = {"calls": 0, "wide_calls": 0}
    wide_call: list = []
    busy: dict = {}
    per_block: dict = {}
    _build.reset_launches()
    t0 = time.time()
    with counting_multistep(counts, wide_call):
        out["exact_reads_per_s"] = round(measure(0, args.batch), 1)
    out["exact_measure_s"] = round(time.time() - t0, 1)
    out["exact_heals"] = eng.stats.heals
    # the timing below launches too: the launches of the run are counted apart
    launches = _build.launch_counts()
    multistep = {}
    if wide_call and cuda:
        from bwtpu_torch.kernels import searchk

        a = wide_call[0]
        nbytes, ops, what = multistep_work(a)
        multistep = dict(what=what, wide_steps=a[15], d=a[10],
                         ms=cuda_ms(lambda: searchk.search_multistep(*a)),
                         **bound(nbytes, ops))
    wide_call.clear()
    stage(f"exact: {out['exact_reads_per_s']} reads/s; search_multistep {multistep}")

    if not args.skip_truth:
        # truth on reads regenerated from the genome seed (global
        # positions, int64); the genome's codes stay for the soundness check
        t0 = time.time()
        # shards overlap, so the genome length is the manifest's
        bp = int(manifest.total_len)
        genome = random_genome(bp, seed=args.genome_seed)
        out["genome_regen_s"] = round(time.time() - t0, 1)
        reads, truth = simulate_reads(genome, args.n_truth, read_len=100, max_mismatches=2,
                                      seed=6)
        codes = dna.encode(genome)
        del genome
        stage(f"regenerated the genome and {args.n_truth} reads")

    # the k2 rate (and truth) on the k2-cap engine; the exact engine is
    # freed first: two resident indexes must never coexist on the card
    captures = graph_captures()
    replays = sum(getattr(eng, "graph_replays", {}).values())
    del eng
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    eng = engine_with(args.k2_lf, hf=3.0)
    _build.reset_launches()
    with counting_multistep(counts, wide_call):
        if not args.skip_truth:
            blk = ReadBlock.from_reads(reads)
            flat = eng.finish_block(eng.dispatch_block(blk, 2, pad_to=blk.n))
            lists = hit_lists(flat)
            rec = sum(any(h.pos == t["pos"] and h.strand == t["strand"] and h.nm == t["nm"]
                          for h in hs) for t, hs in zip(truth, lists))
            beyond = [i for i, t in enumerate(truth) if t["pos"] > 2**31]
            rec_beyond = sum(any(h.pos == truth[i]["pos"] and h.strand == truth[i]["strand"]
                                 for h in lists[i]) for i in beyond)
            out["truth_reads"] = args.n_truth
            out["truth_recovered"] = int(rec)
            out["truth_beyond_int32"] = len(beyond)
            out["recovered_beyond_int32"] = int(rec_beyond)
            out["sound_hits"], out["unsound_hits"] = unsound_hits(codes, reads, flat, 2)
            del codes
            stage(f"truth {rec}/{args.n_truth}, {len(beyond)} past 2^31")

        t0 = time.time()
        out["k2_reads_per_s"] = round(measure(2, args.k2_batch), 1)
        out["k2_measure_s"] = round(time.time() - t0, 1)
        if args.tiered:
            # tiered k2 on error-free windows: a read is exact on its own
            # shard, but every other shard escalates it (counted per shard)
            t0 = time.time()
            e0 = eng.stats.escalated
            out["k2_tiered_reads_per_s"] = round(measure(2, args.k2_batch, tiered=True), 1)
            out["k2_tiered_measure_s"] = round(time.time() - t0, 1)
            out["k2_tiered_escalated_frac"] = round(
                (eng.stats.escalated - e0) / (5 * args.k2_batch), 3)
    out["overflow_reads"] = eng.stats.overflow_reads
    out["heals"] = eng.stats.heals
    out["batch"] = args.batch
    out["k2_batch"] = args.k2_batch
    out["fused_dispatch"] = args.fuse
    out["total_s"] = round(time.time() - t_all, 1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip() if cuda else None
    print(json.dumps({
        "card": smi, "max_memory_allocated_gb":
            round(torch.cuda.max_memory_allocated() / 1e9, 2) if cuda else None,
        "kmer_d": d_kept, "wide_steps": wide_steps,
        "multistep_calls": None if fused_card else counts["calls"],
        "wide_multistep_calls": None if fused_card else counts["wide_calls"],
        "graph_replays": replays + sum(getattr(eng, "graph_replays", {}).values()),
        "max_memory_reserved_gb":
            round(torch.cuda.max_memory_reserved() / 1e9, 2) if cuda else None,
        "multistep_wide_call": multistep, "profiled_pass": busy, "per_block_ms": per_block,
        "graph_captures": captures + graph_captures(),
        "launches": {n: c + launches[n] for n, c in _build.launch_counts().items()}}),
        flush=True)
    print(json.dumps(out), flush=True)
    if not args.skip_truth:
        require(out["truth_recovered"] == args.n_truth,
                f"truth {out['truth_recovered']}/{args.n_truth}")
        require(out["recovered_beyond_int32"] == out["truth_beyond_int32"],
                f"past 2^31: {out['recovered_beyond_int32']}/{out['truth_beyond_int32']}")
        require(out["unsound_hits"] == 0, f"{out['unsound_hits']} unsound hits")


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.package:
        sys.path.insert(0, os.path.abspath(args.package))
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_scale_human: no CUDA device (torch.cuda.is_available() is false); "
              "--device cpu runs the plain versions", file=sys.stderr)
        return 2
    t_all = time.time()
    if args.index:
        from bwtpu_torch.index import load_index

        t0 = time.time()
        shards, manifest = load_index(args.index)
        load_s = time.time() - t0
    else:
        shards, manifest, load_s = build_half(args)
    card_half(args, shards, manifest, load_s)
    print(f"total {time.time() - t_all:.0f}s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
