#!/usr/bin/env python3
"""Smoke run of the bwtpu_torch port on one CUDA card.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, in order; any failure raises and the exit code is not 0:
  1. the card: nvidia-smi name + power limit, torch's device name;
  2. build the CUDA kernels (nvcc, sm_90a) from bwtpu_torch/csrc;
  3. each kernel against its plain-torch version on the card at
     main-path shapes (exact equality), with CUDA-event times of both;
  4. phiX174 through the port's CLI on the card, byte-equal to
     data/phiX174_golden.sam;
  5. the main path at E. coli scale: `build-index` with the CLI
     defaults, 131,072 simulated 100 bp reads (<= 2 mismatches), port
     CLI `align -k 0` and `-k 2` at batch 16,384; checks truth recovery,
     a brute-force Hamming scan of 256 sampled reads, SAM determinism,
     zero truncated reads and that both kernels ran on that path;
  6. the result line.

The JAX package is never imported: correctness comes from independent
oracles (the golden SAM, truth, brute force, the plain versions).
"""

from __future__ import annotations

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
BATCH = 16384
N_SAMPLED = 256
LANES = 65536  # compacted candidate lanes of one k = 2 batch (cap = 2 x 2B)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def say(*a) -> None:
    print(*a, flush=True)


def cuda_ms(fn, reps: int = 20) -> float:
    """Median of `reps` CUDA-event timings of fn() after 3 warm-up calls."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


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
    from bwtpu_torch.kernels import _build

    say("[2] kernel build (nvcc -gencode arch=compute_90a,code=sm_90a)")
    t0 = time.perf_counter()
    for name in ("locate", "verify"):
        _build.library(name)
        info = _build.build_info[name]
        say(f"  {name}.cu: built in {info['seconds']:.2f} s")
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                say("   ", line.strip())
    say(f"  build total {time.perf_counter() - t0:.2f} s")


def phase_kernels(genome: str):
    """Kernel vs plain at main-path shapes; returns the kernel records."""
    import numpy as np
    import torch

    from bwtpu.config import EngineConfig
    from bwtpu.index import build_fm_index
    from bwtpu_torch.engine import _len_mask_words
    from bwtpu_torch.kernels.locate import locate_rows, locate_walk
    from bwtpu_torch.kernels.verify2 import (build_text_rows, verify_nm,
                                             verify_packed)

    say("[3] kernels vs plain torch on the card (exact equality)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    records = {}

    for sa_rate in (8, 16):
        idx = build_fm_index(genome, EngineConfig(sa_rate=sa_rate))
        lat, ssa, C = put(idx.search_lattice), put(idx.ssa), put(idx.C)
        rows = rng.integers(0, idx.n, size=LANES).astype(np.int32)
        rows[:4] = [idx.dollar_row, idx.n - 1, 0, 1]  # '$' row, last row
        valid = rng.random(LANES) < 0.9
        valid[:4] = True
        rows_t, valid_t = put(rows), put(valid)
        err = 0
        # the index's own walk, then a walk too short for it: lanes not
        # found within the trips must report ssa[0] + 0 in both versions
        for trips in (sa_rate, sa_rate // 2):
            got = locate_walk(lat, ssa, C, idx.dollar_row, rows_t, valid_t, trips)
            ref = locate_rows(lat, ssa, C, idx.dollar_row, rows_t, valid_t, trips)
            torch.cuda.synchronize()
            err = max(err, int((got.long() - ref.long()).abs().max()))
            require(err == 0, f"locate_walk != locate_rows (sa_rate {sa_rate}, "
                              f"{trips} trips): max |diff| {err}")
        at_ssa0 = int(((ref == int(idx.ssa[0])) & valid_t).sum())
        ms = cuda_ms(lambda: locate_walk(lat, ssa, C, idx.dollar_row, rows_t,
                                         valid_t, sa_rate))
        plain = cuda_ms(lambda: locate_rows(lat, ssa, C, idx.dollar_row, rows_t,
                                            valid_t, sa_rate))
        say(f"  locate_walk  sa_rate {sa_rate:2d}, {LANES} lanes: equal; kernel "
            f"{ms:.4f} ms, plain {plain:.4f} ms; lanes at ssa[0] after the short "
            f"walk: {at_ssa0}")
        if sa_rate == 8:  # the CLI default: the main path's shapes
            records["locate_walk"] = dict(max_abs_err=err, ms=ms, plain_ms=plain)
            text_rows = put(build_text_rows(idx.text_packed, 100))
            text_len = idx.text_len

    L, W = 100, 7
    cand = rng.integers(-10, text_len + 10, size=LANES).astype(np.int32)
    cand[:5] = [-1, 0, 16 * 1000, text_len - L, text_len - L + 1]  # ob == 0, edges
    cvalid = rng.random(LANES) < 0.85
    cvalid[:5] = True
    words = rng.integers(-2**31, 2**31, size=(LANES, W), dtype=np.int64).astype(np.int32)
    amb = np.where(rng.random((LANES, W)) < 0.05,
                   1 << (2 * rng.integers(0, 16, size=(LANES, W))), 0).astype(np.int32)
    lm = np.broadcast_to(_len_mask_words(L), (LANES, W))
    args = (text_rows, text_len, put(cand), put(cvalid), put(words), put(amb),
            put(lm), put(np.full(LANES, L, np.int32)))
    got = verify_nm(*args)
    ref = verify_packed(*args)
    torch.cuda.synchronize()
    err = int((got - ref).abs().max())
    require(err == 0, f"verify_nm != verify_packed: max |diff| {err}")
    ms = cuda_ms(lambda: verify_nm(*args))
    plain = cuda_ms(lambda: verify_packed(*args))
    say(f"  verify_nm    L {L}, W {W}, {LANES} candidates: equal; kernel {ms:.4f} ms, "
        f"plain {plain:.4f} ms; in range {int((ref != 255).sum())}")
    records["verify_nm"] = dict(max_abs_err=err, ms=ms, plain_ms=plain)
    return records


def run_cli(argv):
    """Port CLI in-process; returns its summary dict."""
    from bwtpu_torch import cli as tcli

    return tcli.main(argv)


def phase_phix(tmp: str, root: str):
    from bwtpu.io import read_fasta, write_fastq
    from bwtpu.simulate import simulate_reads

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
    out = []
    for lo in range(0, patterns.shape[0], 64):
        P, M = patterns[lo:lo + 64], masks[lo:lo + 64]
        mism = torch.zeros((P.shape[0], N), dtype=torch.uint8, device=g_t.device)
        for i in range(L):
            mism += (g_t[i:i + N].unsqueeze(0) != P[:, i:i + 1]) | M[:, i:i + 1]
        pi, pos = torch.nonzero(mism <= k, as_tuple=True)
        out.append(torch.stack([pi + lo, pos, mism[pi, pos].long()], 1).cpu())
    return torch.cat(out).numpy()


def phase_main(tmp: str, genome: str):
    import numpy as np
    import torch

    from bwtpu import dna, sais
    from bwtpu.index import load_index
    from bwtpu.io import write_fasta, write_fastq
    from bwtpu.readblock import read_fastq_stream
    from bwtpu.results import ContigTable, select_primary_flat
    from bwtpu.sam import sam_header
    from bwtpu.samfast import emit_single
    from bwtpu.simulate import simulate_reads
    from bwtpu_torch.engine import Engine
    from bwtpu_torch.kernels.locate import locate_walk
    from bwtpu_torch.kernels.verify2 import verify_nm

    say(f"[5] main path at E. coli scale ({len(genome)} bp, {N_READS} reads x 100 bp)")
    fa, idx_dir, fq = (os.path.join(tmp, x) for x in ("ecoli.fa", "ecoli_idx", "reads.fq"))
    write_fasta(fa, [("ecoli_sim", genome)])
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as built:
        run_cli(["build-index", fa, idx_dir])  # CLI defaults: sa_rate 8, L 100
    say(f"  build-index: {time.perf_counter() - t0:.1f} s; SA-IS path: "
        f"{'native csrc/build/libbwtpu.so' if sais.native_available() else 'NumPy fallback'}; "
        f"{built.getvalue().strip()}")
    shards, manifest = load_index(idx_dir)
    cfg = shards[0].config
    say(f"  config: sa_rate {cfg.sa_rate}, kmer_d {cfg.kmer_d}, read_len {cfg.read_len}, "
        f"max_hits {cfg.max_hits}, max_cand {cfg.max_cand}, min_trips {cfg.min_trips}")

    t0 = time.perf_counter()
    reads, truth = simulate_reads(genome, N_READS, read_len=100, max_mismatches=2,
                                  seed=SEED + 1)
    write_fastq(fq, reads)
    say(f"  simulated + wrote FASTQ: {time.perf_counter() - t0:.1f} s")

    g_t = torch.from_numpy(dna.encode(genome)).cuda()
    sample = np.sort(np.random.default_rng(SEED + 2).choice(N_READS, N_SAMPLED, replace=False))
    pats, msks = [], []
    for i in sample:
        codes, mask = dna.encode_with_mask(reads[i].seq)
        pats += [codes, dna.revcomp_codes(codes, mask)[0]]
        msks += [mask, mask[::-1]]
    pats = torch.from_numpy(np.stack(pats)).cuda()
    msks = torch.from_numpy(np.stack(msks)).cuda()
    t_pos = np.array([t["pos"] for t in truth], np.int64)
    t_rev = np.array([t["strand"] == "-" for t in truth])
    t_nm = np.array([t["nm"] for t in truth], np.int64)
    ctable = ContigTable.build(manifest.contigs)
    stats = {}

    for k in (0, 2):
        # engine pass over the same FASTQ: hit sets for the checks
        eng = Engine(shards, device="cuda")
        _, _, stream = read_fastq_stream(fq, BATCH)
        parts, sam_parts = [], [sam_header(manifest.contigs).encode()]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        base = 0
        for blk in stream:
            flat = eng.finish_block(eng.dispatch_block(blk, k, pad_to=BATCH))
            parts.append((flat.read_idx.astype(np.int64) + base, flat.pos,
                          flat.strand_rev, flat.nm.astype(np.int64)))
            sam_parts.append(emit_single(blk, select_primary_flat(flat), ctable,
                                         truncated=flat.truncated))
            base += blk.n
        eng_s = time.perf_counter() - t0
        ridx, pos, rev, nm = (np.concatenate(c) for c in zip(*parts))

        key = lambda r, p, s, m: ((r * 4 + m) << 34) | (p << 1) | s  # noqa: E731
        have = key(ridx, pos, rev.astype(np.int64), nm)
        want_rows = np.flatnonzero(t_nm <= k)
        want = key(want_rows, t_pos[want_rows], t_rev[want_rows].astype(np.int64),
                   t_nm[want_rows])
        found = np.isin(want, have)
        require(found.all(), f"k={k}: truth missing for {int((~found).sum())} of "
                             f"{len(want)} reads")

        bf = brute_force(g_t, pats, msks, k)
        bf_set = {(int(sample[pi // 2]), int(p), pi % 2, int(m)) for pi, p, m in bf}
        in_sample = np.isin(ridx, sample)
        eng_set = {(int(r), int(p), int(s), int(m)) for r, p, s, m in
                   zip(ridx[in_sample], pos[in_sample], rev[in_sample], nm[in_sample])}
        require(bf_set == eng_set, f"k={k}: hit sets of the {N_SAMPLED} sampled reads "
                                   f"differ from brute force ({len(eng_set ^ bf_set)} hits)")

        # the main path through the CLI, kernel launches counted
        sam = os.path.join(tmp, f"k{k}.sam")
        locate_walk.launches = 0
        verify_nm.launches = 0
        summary = run_cli(["align", idx_dir, fq, "-o", sam, "-k", str(k),
                           "--batch-size", str(BATCH), "--device", "cuda"])
        launches = {"locate_walk": locate_walk.launches, "verify_nm": verify_nm.launches}
        require(all(v > 0 for v in launches.values()), f"k={k}: a kernel never ran: {launches}")
        with open(sam, "rb") as f:
            sam_bytes = f.read()
        require(sam_bytes == b"".join(sam_parts), f"k={k}: CLI SAM differs from the engine pass")
        require(summary["reads"] == N_READS, f"k={k}: CLI aligned {summary['reads']} reads")
        require(summary["truncated_reads"] == 0 and b"xo:i:1" not in sam_bytes,
                f"k={k}: truncated reads")
        say(f"  k={k}: truth {len(want)}/{len(want)} recovered; brute force equal on "
            f"{N_SAMPLED} reads ({len(bf_set)} hits); hits {len(have)}; "
            f"engine pass {N_READS / eng_s:.1f} reads/s ({eng_s:.3f} s); CLI FASTQ->SAM "
            f"{summary['reads_per_s']} reads/s ({summary['wall_s']} s); heals "
            f"{summary['heals']}, overflow_reads {summary['overflow_reads']}, "
            f"compact_overflows {summary['compact_overflows']}; launches {launches}")
        stats[k] = launches
    return {name: sum(s[name] for s in stats.values()) for name in stats[0]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import bwtpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    from bwtpu.simulate import ECOLI_SCALE, random_genome

    t_all = time.perf_counter()
    name, smi = phase_card()
    phase_build()
    genome = random_genome(ECOLI_SCALE, seed=SEED)
    records = phase_kernels(genome)
    with tempfile.TemporaryDirectory(prefix="bwtpu_torch_smoke_") as tmp:
        phase_phix(tmp, root)
        launches = phase_main(tmp, genome)
    say(f"[6] all phases passed in {time.perf_counter() - t_all:.1f} s on {smi}")
    sources = {"locate_walk": ("bwtpu_torch/csrc/locate.cu",
                               "bwtpu/kernels/pallas_step.py:256"),
               "verify_nm": ("bwtpu_torch/csrc/verify.cu",
                             "bwtpu/kernels/pallas_step.py:302")}
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": sources[k][0], "replaces": sources[k][1],
         "launches": launches[k], **records[k]} for k in ("locate_walk", "verify_nm")
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
