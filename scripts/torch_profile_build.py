"""One shard's index build, phase by phase: the port of
scripts/profile_build.py.

Runs the phases of bwtpu_torch.index.build_fm_index's NumPy path on a
random genome of --mbp million bases (seed 7) through the port's host
copies, each under its own wall clock: sanitize and encode
(bwtpu_torch.dna), the suffix array (sais.suffix_array), the BWT gather,
the native lattice pass (sais.build_lattice_native), the k-mer tables
(the key passes, their gather and the searchsorted of each depth of the
ladder {4, 8, --kmer-d}) and the multi-step lattice (the preceding-s-mer
gathers, the per-block bincount and the code packing), as index.py
does them. Prints the reference's JSON line: the peak RSS in GB, the
sum of the phases but the genome's generation (build_total_s), and each
phase's seconds.

The build never touches the card, but like every program of the port
this one refuses to run without a card unless given --device cpu.

Run: python3 scripts/torch_profile_build.py [--mbp 128] [--sa-rate 32]
"""

import argparse
import json
import os
import resource
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def rss_gb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mbp", type=float, default=128)
    ap.add_argument("--sa-rate", type=int, default=32)
    ap.add_argument("--kmer-d", type=int, default=11)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_profile_build: no CUDA device (torch.cuda.is_available() is "
                         "false); --device cpu runs without one")

    from bwtpu_torch import dna, sais
    from bwtpu_torch.config import EngineConfig
    from bwtpu_torch.index import OCCK_BLOCK
    from bwtpu_torch.simulate import random_genome

    n = int(args.mbp * 1e6)
    t = {}
    t0 = time.time()
    genome = random_genome(n, seed=7)
    t["genome_gen"] = time.time() - t0

    cfg = EngineConfig(sa_rate=args.sa_rate, kmer_d=args.kmer_d)

    t0 = time.time()
    genome_s = dna.sanitize_genome(genome)
    text_codes = dna.encode(genome_s)
    t["sanitize_encode"] = time.time() - t0

    text_len = len(text_codes)
    symbols = np.empty(text_len + 1, dtype=np.uint8)
    symbols[:text_len] = text_codes + 1
    symbols[text_len] = 0
    nn = text_len + 1

    t0 = time.time()
    sa = sais.suffix_array(symbols)
    t["sais"] = time.time() - t0

    t0 = time.time()
    bwt_sym = symbols[(sa - 1) % nn]
    t["bwt_gather"] = time.time() - t0

    t0 = time.time()
    native = sais.build_lattice_native(bwt_sym, sa, cfg.sa_rate, text_codes)
    if native is None:
        raise SystemExit("torch_profile_build: the native host library did not load")
    t["lattice_native"] = time.time() - t0

    # kmer tables (mirrors index.py)
    d = cfg.kmer_d
    depths = sorted({dd for dd in (4, 8, d) if 0 < dd <= d})
    dmax = depths[-1]
    t0 = time.time()
    sym_padded = np.zeros(nn + dmax, dtype=np.int64)
    sym_padded[:nn] = symbols
    tkey = np.zeros(nn, dtype=np.int64)
    for i in range(dmax):
        tkey += sym_padded[i : i + nn] * 5 ** (dmax - 1 - i)
    t["tkey_passes"] = time.time() - t0
    t0 = time.time()
    key = tkey[sa]
    t["key_gather"] = time.time() - t0
    t0 = time.time()
    for depth in depths:
        kd = key // (5 ** (dmax - depth)) if depth != dmax else key
        qk = np.zeros(4**depth, dtype=np.int64)
        for i in range(depth):
            digit = (
                np.arange(4**depth, dtype=np.int64) >> (2 * (depth - 1 - i))
            ) & 3
            qk = qk * 5 + digit + 1
        np.searchsorted(kd, qk, side="left")
        np.searchsorted(kd, qk, side="right")
    t["kmer_searchsorted"] = time.time() - t0

    # occk lattice (mirrors index.py)
    s = cfg.occ_step
    A = 4**s
    R = OCCK_BLOCK[s]
    t0 = time.time()
    tc = text_codes.astype(np.int64)
    t["tc_cast"] = time.time() - t0
    t0 = time.time()
    pre_code = np.zeros(nn, dtype=np.int64)
    v = sa >= s
    kpos = sa[v].astype(np.int64)
    acc = np.zeros(len(kpos), dtype=np.int64)
    for i in range(s):
        acc = acc * 4 + tc[kpos - s + i]
    pre_code[v] = acc
    t["precode_gathers"] = time.time() - t0
    t0 = time.time()
    n_blocksK = (nn + R - 1) // R
    paddedK = np.zeros(n_blocksK * R, dtype=np.int64)
    paddedK[:nn] = pre_code
    ok = np.zeros(n_blocksK * R, dtype=bool)
    ok[:nn] = v
    blk = np.arange(n_blocksK * R) // R
    per_block = np.bincount(
        (blk * A + paddedK)[ok], minlength=n_blocksK * A
    ).reshape(n_blocksK, A)
    ckK = np.zeros((n_blocksK + 1, A), dtype=np.int64)
    ckK[1:] = np.cumsum(per_block, axis=0)
    t["occk_bincount"] = time.time() - t0
    t0 = time.time()
    bytesK = paddedK.reshape(n_blocksK, R // 4, 4).astype(np.uint32)
    shifts = (8 * np.arange(4, dtype=np.uint32))[None, None, :]
    np.bitwise_or.reduce(bytesK << shifts, axis=2)
    t["occk_pack"] = time.time() - t0

    total = sum(t.values()) - t["genome_gen"]
    print(json.dumps({
        "mbp": args.mbp, "rss_gb": round(rss_gb(), 2),
        "build_total_s": round(total, 1),
        **{k: round(v, 2) for k, v in t.items()},
    }))


if __name__ == "__main__":
    main()
