"""bwtpu_torch's CUDA kernels against their plain-torch versions on the
card (marked `gpu`; each test skips without a CUDA device). This file
imports neither jax nor bwtpu, so it runs on a machine that has no jax:

    BWTPU_TEST_TPU=1 python -m pytest -o addopts="" -m gpu tests/test_torch_gpu.py

(BWTPU_TEST_TPU=1 keeps tests/conftest.py from importing jax.)
"""

import numpy as np
import pytest
import torch

from bwtpu_torch import dna
from bwtpu_torch.config import EngineConfig
from bwtpu_torch.index import build_fm_index
from bwtpu_torch.kernels import compact as compact_kernels
from bwtpu_torch.kernels import search2
from bwtpu_torch.kernels.locate import _locate_plain, locate_walk
from bwtpu_torch.kernels.verify2 import build_text_rows, pack_reads, verify_nm
from bwtpu_torch.simulate import random_genome, simulate_reads

GENOME = random_genome(200000, seed=71)
L = 100


@pytest.fixture(scope="module")
def idx8():
    return build_fm_index(GENOME, EngineConfig(sa_rate=8))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _t(a, dev):
    return torch.from_numpy(np.array(a)).to(dev)


def _sel(n_rows: int, cap: int, count: int, rng, dev):
    """(sel int32[cap], count int32 0-dim) as compact / compact_counts hand
    them over: `count` distinct rows first, 0 beyond."""
    sel = np.zeros(cap, np.int32)
    sel[:count] = rng.choice(n_rows, count, replace=False)
    return _t(sel, dev), torch.tensor(count, dtype=torch.int32, device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("sa_rate", [4, 8, 16])
@pytest.mark.parametrize("count", [0, 45000, 50000])
def test_locate_walk_kernel_matches_plain(cuda, sa_rate, count):
    """The compacted form: lanes j < count walk rows[sel[j]], the rest
    report -1 (count = 0, a partial count, count = cap)."""
    idx = build_fm_index(GENOME, EngineConfig(sa_rate=sa_rate))
    rng = np.random.default_rng(sa_rate + count)
    rows = rng.integers(0, idx.n, size=60000).astype(np.int32)
    rows[:4] = [idx.dollar_row, idx.n - 1, 0, 1]
    sel, cnt = _sel(len(rows), 50000, count, rng, cuda)
    args = [_t(a, cuda) for a in (idx.search_lattice, idx.ssa, idx.C)]
    for trips in (sa_rate, 3):  # 3 trips leaves lanes unfound: ssa[0] + 0
        got = locate_walk(*args, idx.dollar_row, _t(rows, cuda), sel, cnt, trips)
        want = _locate_plain(*args, idx.dollar_row, _t(rows, cuda), sel, cnt, trips)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert (got[count:] == -1).all() and (got[:count] >= 0).all()


def _verify_nm_args(idx, W: int, n_slots: int, count: int, dev, shared_mask: bool):
    """verify_nm's argument form at read width W (reads of 16 W - 5 bases,
    a fifth of them shorter, N bases; text rows built for that length, so
    both the 16 B row loads and the word-by-word ones run): n_slots seed
    offsets per read (some past the read's end), `count` of 40,000 slots in
    compact order located at true starts + offsets, random positions, -1,
    bit phase 0 and the last two starts; sel 0 and spos -1 past count.
    shared_mask: every read of full length with ONE length-mask row
    expanded over them (row stride 0), as the block path hands it over."""
    from bwtpu_torch.engine import _len_mask_words

    L, B2, cap, max_loc = 16 * W - 5, 3000, 40000, 16
    reads, truth = simulate_reads(GENOME, B2, read_len=L, max_mismatches=2,
                                  n_frac=0.3 / L, seed=W)
    codes = np.zeros((B2, L), np.int32)
    amb = np.zeros((B2, L), np.int32)
    for i, r in enumerate(reads):
        c, m = dna.encode_with_mask(r.seq)
        codes[i], amb[i] = dna.revcomp_codes(c, m) if truth[i]["strand"] == "-" else (c, m)
    rng = np.random.default_rng(W + 7 * n_slots + count)
    lens = np.full(B2, L, np.int32)
    if not shared_mask:
        lens[::5] = rng.integers(1, L, size=len(lens[::5]))
    rw, ab, lm = pack_reads(codes, amb, lens)
    seed_off = rng.integers(0, L, size=(B2, n_slots)).astype(np.int32)
    seed_off[::9, -1] = L + rng.integers(1, 20, size=len(seed_off[::9]))
    tl = idx.text_len
    sel = np.zeros(cap, np.int32)
    sel[:count] = np.sort(rng.choice(B2 * n_slots * max_loc, count, replace=False))
    b = sel // max_loc // n_slots
    start = np.array([t["pos"] for t in truth], np.int64)[b]
    start[1::3] = rng.integers(-20, tl + 20, size=len(start[1::3]))
    start[2::6] &= ~15  # bit phase 0
    start[3:5] = [tl - L, tl - L + 1]
    spos = (start + seed_off.reshape(-1)[sel // max_loc]).astype(np.int32)
    spos[5::13] = -1
    spos[count:] = -1
    lm_t = (_t(_len_mask_words(L), dev).unsqueeze(0).expand(B2, rw.shape[1]) if shared_mask
            else _t(lm, dev))
    return (_t(build_text_rows(idx.text_packed, L), dev), tl, _t(spos, dev), _t(sel, dev),
            torch.tensor(count, dtype=torch.int32, device=dev),
            _t(seed_off.reshape(-1), dev), _t(rw, dev), _t(ab, dev), lm_t, _t(lens, dev),
            max_loc, n_slots)


@pytest.mark.gpu
@pytest.mark.parametrize("W", list(range(1, 21)))
@pytest.mark.parametrize("n_slots,count,shared_mask", [
    (3, 25000, False), (1, 40000, False), (1, 0, False), (3, 40000, True)])
def test_verify_nm_kernel_matches_plain(cuda, idx8, W, n_slots, count, shared_mask):
    """Every instantiated read width; count 0, partial and = cap; one and
    three seed slots; slot for slot, the slots past count included."""
    from bwtpu_torch.kernels.verify2 import verify_nm_plain

    args = _verify_nm_args(idx8, W, n_slots, count, cuda, shared_mask)
    got = verify_nm(*args)
    want = verify_nm_plain(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    nm = want[1]
    assert (nm[count:] == 255).all()
    if count:
        assert (nm[:count] == 255).any() and (nm <= 2).sum() > count // 10


@pytest.mark.gpu
@pytest.mark.parametrize("W", [21, 25, 32])
@pytest.mark.parametrize("n_slots,count,shared_mask", [(3, 25000, False), (1, 40000, True)])
def test_verify_nm_wide_kernel_matches_plain(cuda, idx8, W, n_slots, count, shared_mask):
    """Reads over 320 bases take the run-time-W instance: slot for slot
    equal to the plain version, the slots past count included."""
    from bwtpu_torch.kernels.verify2 import verify_nm_plain

    args = _verify_nm_args(idx8, W, n_slots, count, cuda, shared_mask)
    got = verify_nm(*args)
    want = verify_nm_plain(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (want[1][count:] == 255).all() and (want[1] <= 2).sum() > count // 10


def _chain_inputs(idx, dev, d: int, B: int, seed: int, L: int = L):
    """Right-aligned mixed-length patterns as the Read-list path builds
    them (genome substrings of length 0 or >= d with a few substitutions
    and N bases, rows of L columns) and their start intervals."""
    from bwtpu_torch.io import Read
    from bwtpu_torch.engine import encode_batch
    from bwtpu_torch.kernels.search2 import start_intervals

    rng = np.random.default_rng(seed)
    reads = []
    for i, n in enumerate(rng.integers(max(d, 1), L + 1, size=B)):
        start = int(rng.integers(0, len(GENOME) - n))
        seq = list(GENOME[start:start + n] if rng.random() > 0.03 else "")
        for p in rng.integers(0, n, size=int(rng.integers(0, 3))) if seq else ():
            seq[p] = "ACGTN"[int(rng.integers(0, 5))]
        reads.append(Read(f"r{i}", "".join(seq)))
    enc, _ = encode_batch(EngineConfig(read_len=L), reads, 0)
    codes, amb, lens = (_t(a, dev) for a in (enc.ra_codes, enc.ra_amb, enc.lens))
    kt = _t(idx.kmer_tables[d], dev) if d else None
    return (codes, amb, lens, *start_intervals(kt, idx.n, codes, amb, lens, d))


@pytest.mark.gpu
@pytest.mark.parametrize("L,d", [(100, 0), (100, 4), (100, 8), (34, 4), (37, 8), (600, 8)])
def test_search_chain1_kernel_matches_plain(cuda, idx8, L, d):
    """Read-list shapes, rows of 34 and 37 columns (not 16 B aligned) and
    of 600 (restaged past 128 steps), and edge lanes: len 0, len == d, an
    ambiguous base at the first and at the last active step, a lane that
    straggles on its first step."""
    from bwtpu_torch.kernels.search2 import (_search_ra_chain, backward_search_ra,
                                             search_chain1)

    idx = idx8
    lat, C = _t(idx.search_lattice, cuda), _t(idx.C, cuda)
    codes, amb, lens, sp0, ep0 = _chain_inputs(idx, cuda, d, 3000 if L < 600 else 750,
                                               seed=d + L, L=L)
    lens[0], lens[1] = 0, d
    lens[2:5] = L  # full rows (a short read's zero padding becomes its head)
    amb[2, L - 1 - d] = 1  # the first active step
    amb[3, 0] = 1  # the last active step
    sp0[2:4], ep0[2:4] = 1000, 1001  # narrow: they reach those steps unflagged
    sp0[4], ep0[4] = 0, idx.n  # je > j + 1 before the first step
    args = (lat, C, idx.dollar_row, codes, amb, lens, sp0, ep0, d)
    sp, ep, strag = search_chain1(*args)
    psp, pep, pstrag = _search_ra_chain(*args)
    torch.cuda.synchronize()
    # a kernel thread stops at its first straggle: flagged lanes' sp and
    # ep are the fixup's to overwrite
    assert torch.equal(strag, pstrag)
    ok = ~strag
    assert torch.equal(sp[ok], psp[ok]) and torch.equal(ep[ok], pep[ok])
    assert bool(strag[4]) and not strag[:4].any()
    assert sp[3] == 0 == ep[3]  # an N base at the last step empties the interval
    assert sp[0] == sp0[0] and ep[0] == ep0[0] and sp[1] == sp0[1] and ep[1] == ep0[1]
    if L == 100:  # 200 kbp: 4-mer intervals (~800 rows) straggle, 8-mer ones (~3) not
        assert bool(strag[5:].any()) == (d < 8)
    kt = idx.kmer_tables[d] if d else None
    got = backward_search_ra(lat, C, idx.dollar_row, idx.n,
                             None if kt is None else _t(kt, cuda), codes, amb, lens, d)
    want = backward_search_ra(*(x.cpu() if isinstance(x, torch.Tensor) else x for x in (
        lat, C, idx.dollar_row, idx.n, None if kt is None else _t(kt, cuda), codes, amb,
        lens)), d)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def _wide_starts(idx, sp0, ep0, rng, dev):
    """A third of the lanes start from random wide intervals: any [sp, ep)
    within [0, n] is a valid start of the two-record chain."""
    B = sp0.shape[0]
    wide = torch.from_numpy(rng.random(B) < 0.3).to(dev)
    sp_w = _t(rng.integers(0, idx.n, size=B).astype(np.int32), dev)
    ep_w = torch.minimum(sp_w + _t(rng.integers(0, 5000, size=B).astype(np.int32), dev),
                         torch.tensor(idx.n, device=dev))
    return torch.where(wide, sp_w, sp0), torch.where(wide, ep_w, ep0).to(torch.int32)


def _finish_both(args, B, dev, rng):
    """search_chain2 and _chain2_plain on the same arguments, each writing
    into its own copy of the same garbage sp and ep; returns both (sp, ep)
    pairs."""
    garbage = [_t(rng.integers(0, 1 << 20, size=B).astype(np.int32), dev) for _ in "se"]
    got = [g.clone() for g in garbage]
    want = [g.clone() for g in garbage]
    lat, C, dr, pattern, sp0, ep0, sel, count, d = args
    search2.search_chain2(lat, C, dr, pattern, sp0, ep0, sel, count, *got, d)
    search2._chain2_plain(lat, C, dr, pattern, sp0, ep0, sel, count, *want, d)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.gpu
@pytest.mark.parametrize("d,count", [(0, 3000), (4, 1700), (8, 0)])
def test_search_chain2_planes_kernel_matches_plain(cuda, d, count):
    """The 1-step path's finisher: right-aligned int32 planes of mixed
    lengths (with N bases and empty lanes), lanes sel[j] for j < count,
    written in place; lanes not selected keep their values."""
    idx = build_fm_index(GENOME, EngineConfig(sa_rate=8))
    lat, C = _t(idx.search_lattice, cuda), _t(idx.C, cuda)
    codes, amb, lens, sp0, ep0 = _chain_inputs(idx, cuda, d, 3000, seed=d + 1)
    B = codes.shape[0]  # read-strand rows
    rng = np.random.default_rng(d)
    sp0, ep0 = _wide_starts(idx, sp0, ep0, rng, cuda)
    sel, cnt = _sel(B, B, count, rng, cuda)
    args = (lat, C, idx.dollar_row, search2.Planes(codes, amb, lens), sp0, ep0, sel, cnt, d)
    got, want = _finish_both(args, B, cuda, rng)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    if count:
        full = search2._two_gather_search(lat, C, idx.dollar_row, codes, amb, lens, sp0,
                                          ep0, d)
        lanes = sel[:count].long()
        assert torch.equal(got[0][lanes], full[0][lanes])


@pytest.mark.gpu
@pytest.mark.parametrize("L,off,slen,d,count", [
    (100, 0, 100, 8, 512),    # the k = 0 finisher: full reads, cap 512
    (100, 33, 34, 8, 300),    # a k = 2 seed slice at off > 0
    (60, 7, 37, 4, 100),      # L and slen not multiples of 16
    (300, 0, 300, 0, 64),     # past the 16-word register window
    (100, 0, 100, 8, 0),      # nothing flagged
])
def test_search_chain2_packed_kernel_matches_plain(cuda, L, off, slen, d, count):
    """The multi-step path's finisher: bases [off, off + slen) of 2-bit
    packed rows (with substitutions and N bases), read straight from the
    rows; narrow starts from the k-mer table and wide random ones."""
    idx = build_fm_index(GENOME, EngineConfig(sa_rate=8))
    lat, C = _t(idx.search_lattice, cuda), _t(idx.C, cuda)
    rng = np.random.default_rng(L + off + count)
    B = 4 * max(count, 128)
    g = dna.encode(GENOME)
    starts = rng.integers(0, len(g) - L, size=B)
    codes = g[starts[:, None] + np.arange(L)].astype(np.int32)
    flip = rng.random((B, L)) < 0.01
    codes[flip] = (codes[flip] + 1) % 4
    amb = (rng.random((B, L)) < 0.005).astype(np.int32)
    codes[amb == 1] = 0
    words, amb_bits, _ = pack_reads(codes, amb, np.full(B, L, np.int32))
    pattern = search2.Packed(_t(words, cuda), _t(amb_bits, cuda), off, slen)
    sl = slice(off, off + slen)
    ra = _t(codes[:, sl], cuda), _t(amb[:, sl], cuda), _t(np.full(B, slen, np.int32), cuda)
    kt = _t(idx.kmer_tables[d], cuda) if d else None
    sp0, ep0 = _wide_starts(idx, *search2.start_intervals(kt, idx.n, *ra, d), rng, cuda)
    sel, cnt = _sel(B, max(count, 1), count, rng, cuda)
    args = (lat, C, idx.dollar_row, pattern, sp0, ep0, sel, cnt, d)
    got, want = _finish_both(args, B, cuda, rng)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    if count:
        lanes = sel[:count].long()
        full = search2._two_gather_search(lat, C, idx.dollar_row, *ra, sp0, ep0, d)
        assert torch.equal(got[1][lanes], full[1][lanes])
    if count and slen <= 100:  # some selected lanes still match somewhere
        assert bool((want[1][lanes] > want[0][lanes]).any())


@pytest.mark.gpu
def test_verify_locv_kernel_matches_plain(cuda):
    """sa_rate 1: rows of the locv table, candidates at true starts, at
    random seed offsets, before the text start and past its end, invalid
    lanes, reads with N bases and some shorter than L."""
    from bwtpu_torch.kernels.verify2 import build_locv_rows, verify_locv, verify_locv_plain

    idx = build_fm_index(GENOME, EngineConfig(sa_rate=1))
    reads, truth = simulate_reads(GENOME, 4000, read_len=L, max_mismatches=2,
                                  n_frac=0.01, seed=5)
    codes = np.zeros((len(reads), L), np.int32)
    amb = np.zeros((len(reads), L), np.int32)
    for i, r in enumerate(reads):
        c, m = dna.encode_with_mask(r.seq)
        codes[i], amb[i] = dna.revcomp_codes(c, m) if truth[i]["strand"] == "-" else (c, m)
    rng = np.random.default_rng(6)
    lens = np.full(len(reads), L, np.int32)
    lens[::5] = rng.integers(30, L, size=len(lens[::5]))
    rw, ab, lm = pack_reads(codes, amb, lens)
    # rows whose SA value is each read's true start + a seed offset
    rank = np.empty(idx.n, np.int64)
    rank[idx.ssa] = np.arange(idx.n)
    off = rng.integers(0, L, size=len(reads)).astype(np.int32)
    start = np.array([t["pos"] for t in truth]) + off
    rows = rank[np.minimum(start, idx.text_len)].astype(np.int32)
    rows[1::3] = rng.integers(0, idx.n, size=len(rows[1::3]))
    rows[:3] = [idx.dollar_row, 0, idx.n - 1]
    off[2::7] = rng.integers(-20, 120, size=len(off[2::7]))
    valid = rng.random(len(rows)) < 0.9
    args = [_t(build_locv_rows(idx.text_packed, idx.ssa, L), cuda), idx.text_len]
    args += [_t(a, cuda) for a in (rows, valid, off, rw, ab, lm, lens)]
    got = verify_locv(*args)
    want = verify_locv_plain(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (want[1] == 255).any() and (want[1] <= 2).sum() > 1000


@pytest.mark.gpu
@pytest.mark.parametrize("Wr,unaligned", [(16, False), (128, False), (9, False),
                                          (16, True), (300, False)])
@pytest.mark.parametrize("inflight", [4, 8, 16])
def test_row_gather_sum_kernel_matches_plain(cuda, Wr, unaligned, inflight):
    """16 B loads (Wr % 4 == 0 on an aligned table), 4 B loads otherwise,
    several column chunks (Wr 300), a tail past the last block of G,
    values that wrap int32."""
    from bwtpu_torch.kernels.gather import row_gather_sum, row_gather_sum_plain

    rng = np.random.default_rng(Wr + inflight)
    N = 5000
    base = torch.from_numpy(rng.integers(-2**31, 2**31, size=N * Wr + 1,
                                         dtype=np.int64).astype(np.int32)).to(cuda)
    table = (base[1:] if unaligned else base[:-1]).view(N, Wr)
    assert (table.data_ptr() % 16 != 0) == unaligned
    idx = _t(rng.integers(0, N, size=3 * 1024 + 77).astype(np.int32), cuda)
    for G in (1024, 100):
        got = row_gather_sum(table, idx, G, inflight)
        want = row_gather_sum_plain(table, idx, G)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("band", [0, 4, 8, 16])
@pytest.mark.parametrize("B,Lt,L", [(5000, 116, 100), (300, 6, 30), (1, 0, 0), (700, 50, 45)])
def test_sw_band_kernel_matches_plain(cuda, band, B, Lt, L):
    """sw_band against sw_score_plain: random codes with N (4), windows
    that contain their read with substitutions, text shorter than the
    band, empty text, empty reads, read lengths 0..L, lane 0 full."""
    from bwtpu_torch.sw import sw_score_batch, sw_score_plain

    rng = np.random.default_rng(band + B + Lt)
    text = rng.integers(0, 5, size=(B, Lt)).astype(np.int32)
    reads = rng.integers(0, 5, size=(B, L)).astype(np.int32)
    tl = rng.integers(0, Lt + 1, size=B).astype(np.int32)
    rl = rng.integers(0, L + 1, size=B).astype(np.int32)
    tl[0], rl[0] = Lt, L
    n = min(L, Lt)
    reads[::2, :n] = np.where(rng.random((len(reads[::2]), n)) < 0.05, reads[::2, :n],
                              text[::2, :n])
    args = [_t(a, cuda) for a in (text, tl, reads, rl)]
    got = sw_score_batch(*args, band=band)
    want = sw_score_plain(*args, band=band)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if B > 1 and L and Lt > band:
        assert int(want.max()) > 2 * min(L, Lt) // 2


def _sw_edge_lanes(rng, B, band, Lt_max, L_max):
    """B lanes over sw_band's edge cases (the CPU tests' cases of
    tests/test_torch_sw.py): read_len 0, reads shorter than L by more than
    the band, text_len 0 and below the band, lanes of one warp that end at
    very different rows; the rest random, half of them windows that hold
    their read with substitutions. Codes 0-4, zero past each length."""
    text = rng.integers(0, 5, size=(B, Lt_max)).astype(np.int32)
    reads = rng.integers(0, 5, size=(B, L_max)).astype(np.int32)
    tl = rng.integers(0, Lt_max + 1, size=B).astype(np.int32)
    rl = rng.integers(0, L_max + 1, size=B).astype(np.int32)
    n = min(L_max, Lt_max)
    reads[::2, :n] = np.where(rng.random((len(reads[::2]), n)) < 0.05, reads[::2, :n],
                              text[::2, :n])
    tl[0], rl[0] = Lt_max, L_max
    rl[3], rl[4] = 0, max(0, L_max - band - 7)
    tl[5], tl[6] = 0, band // 2
    ends = np.array([1, 2, 5, L_max, 9, L_max - 1, 17, 3, L_max, 30, 11, L_max, 0, 44, 6, 25])
    rl[32:48] = np.clip(ends, 0, L_max)
    tl[32:48] = np.minimum(rl[32:48] + 2 * band, Lt_max)
    for b in range(B):
        reads[b, rl[b]:] = 0
        text[b, tl[b]:] = 0
    return text, tl, reads, rl


@pytest.mark.gpu
@pytest.mark.parametrize("band,match,mismatch,gap", [
    (0, 2, -3, -4), (16, 2, -3, -4), (8, 1, 1, 0), (5, 3, -1, 0), (3, 2, 1, -1), (8, 2, -3, -4)],
    ids=["band0", "band16", "positive_mismatch_gap0", "gap0", "positive_mismatch", "default"])
@pytest.mark.parametrize("B,Lt,L", [(3000, 116, 100), (200, 300, 280), (77, 40, 64)],
                         ids=["rescore", "long_rows", "short_rows"])
def test_sw_band_kernel_edge_cases(cuda, band, match, mismatch, gap, B, Lt, L):
    """sw_band against sw_score_plain on the edge lanes of the CPU tests,
    with scores other than the defaults; long rows (L 280, Lt 300),
    short ones, and lane counts that are no multiple of a CTA's 32."""
    from bwtpu_torch.sw import sw_score_batch, sw_score_plain

    rng = np.random.default_rng([band, match, mismatch + 10, gap + 10, B])
    text, tl, reads, rl = _sw_edge_lanes(rng, B, band, Lt, L)
    args = [_t(a, cuda) for a in (text, tl, reads, rl)]
    kw = dict(band=band, match=match, mismatch=mismatch, gap=gap)
    got = sw_score_batch(*args, **kw)
    want = sw_score_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert int(want[3]) == int(want[5]) == 0 and int(want.max()) > 20


@pytest.mark.gpu
@pytest.mark.parametrize("B,Lt,L,offset", [(70, 1100, 1000, 0), (501, 116, 100, 1), (64, 35, 33, 3)],
                         ids=["fewer_lanes_per_cta", "unaligned_rows", "odd_widths"])
def test_sw_band_kernel_row_blocks(cuda, B, Lt, L, offset):
    """The CTA's row blocks: rows too long for 32 lanes in one CTA's
    shared memory (fewer lanes per CTA), rows that start off the bulk
    copy's 16 B alignment (4 B copies instead) and widths whose blocks are
    no multiple of 16 B."""
    from bwtpu_torch.sw import sw_score_batch, sw_score_plain

    rng = np.random.default_rng(B + Lt + offset)
    text, tl, reads, rl = _sw_edge_lanes(rng, B, 8, Lt, L)

    def placed(a):  # a contiguous copy `offset` int32 words past an aligned start
        flat = torch.zeros(a.size + offset, dtype=torch.int32, device=cuda)
        flat[offset:] = _t(a.ravel(), cuda)
        return flat[offset:].view(a.shape)

    args = [placed(text), _t(tl, cuda), placed(reads), _t(rl, cuda)]
    assert (args[0].data_ptr() % 16 != 0) == (offset != 0)
    got = sw_score_batch(*args)
    want = sw_score_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert int(want.max()) > 20


@pytest.mark.gpu
@pytest.mark.parametrize("n_idx,G", [
    (5 * 1024, 1024),        # fewer G-blocks than SMs
    (700 * 1024 + 300, 1024),  # more blocks than the SMs hold at once, no multiple of it
    (3001, 1),               # G = 1: every index, n % 4 != 0
    (999, 1000),             # G > n: nothing to sum
    (40000, 37),             # odd G
])
@pytest.mark.parametrize("inflight", [4, 8, 16])
def test_row_gather_sum_kernel_blocks(cuda, n_idx, G, inflight):
    """The grid of G-blocks: fewer blocks than SMs, more than the SMs
    hold at once and no multiple of that, G = 1, G > n, an odd G; and
    indices that do not start 16 B aligned."""
    from bwtpu_torch.kernels.gather import row_gather_sum, row_gather_sum_plain

    rng = np.random.default_rng(n_idx + G + inflight)
    N, Wr = 20000, 16
    table = _t(rng.integers(-2**31, 2**31, size=(N, Wr), dtype=np.int64).astype(np.int32), cuda)
    base = _t(rng.integers(0, N, size=n_idx + 1).astype(np.int32), cuda)
    for idx in (base[:-1], base[1:]):  # aligned, then 4 B past alignment
        got = row_gather_sum(table, idx, G, inflight)
        want = row_gather_sum_plain(table, idx, G)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert bool(want[0].any()) == (n_idx >= G)


@pytest.mark.gpu
@pytest.mark.parametrize("Wr", [16, 128])
def test_bench_calibration_on_the_card(cuda, Wr):
    """The bench's roofline calibration: a positive ns per row on the
    card, and its gather sum (row_gather_sum's kernel) equal to the plain
    version's on the same index stream, at a locv row's width and at the
    multi-step lattice's."""
    from bwtpu_torch import bench
    from bwtpu_torch.kernels.gather import row_gather_sum_plain

    rng = np.random.default_rng(Wr)
    table = _t(rng.integers(-2**31, 2**31, size=(300000, Wr), dtype=np.int64).astype(np.int32),
               cuda)
    assert bench.calibrate_ns_per_row(table, 1 << 18) > 0
    for seed in (0, 1, 5):
        idx = bench.gather_index_stream(1 << 18, seed, table.shape[0], cuda)
        got = bench.gather_sum(table, idx)
        want = row_gather_sum_plain(table, idx, bench.GATHER_G)[0]
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.gpu
def test_sw_band_refuses_a_band_without_an_instance(cuda):
    from bwtpu_torch.sw import sw_score_batch

    z = torch.zeros((2, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="no kernel instance"):
        sw_score_batch(z, z[:, 0].contiguous(), z, z[:, 0].contiguous(), band=17)


@pytest.fixture(scope="module")
def multistep_world():
    """Indexes with the step-3 and step-4 lattices (a random genome and a
    tandem one, whose intervals straggle), and 2,500 reads of 100 bp per
    genome with substitutions and N bases, packed (numpy) with the
    forward rows first, as device_prep_packed stacks the strands."""
    from bwtpu_torch.simulate import adversarial_genome

    out = {}
    for kind, genome in (("random", GENOME), ("tandem", adversarial_genome(60000, "tandem",
                                                                           seed=5))):
        reads, _ = simulate_reads(genome, 2500, read_len=L, max_mismatches=2, n_frac=0.005,
                                  seed=41)
        c, m = dna.encode_with_mask("".join(r.seq for r in reads))
        codes, amb = c.reshape(-1, L).astype(np.int32), m.reshape(-1, L).astype(np.int32)
        codes = np.concatenate([codes, 3 - codes[:, ::-1]])
        amb = np.concatenate([amb, amb[:, ::-1]])
        rw, ab, _ = pack_reads(codes, amb, np.full(len(codes), L, np.int32))
        for step in (3, 4):
            out[kind, step] = (build_fm_index(genome, EngineConfig(sa_rate=8, occ_step=step)),
                               rw, ab)
    return out


def _multistep_args(world, kind, step, d, dev, off, slen, stop, min_trips, cap_scale, wide):
    idx, rw, ab = world[kind, step]
    d = min(d, max(idx.kmer_tables))
    return (_t(idx.search_lattice, dev), _t(idx.occk_lattice, dev), _t(idx.occk_invalid, dev),
            _t(idx.C, dev), idx.dollar_row, _t(idx.kmer_tables[d], dev), _t(rw, dev),
            _t(ab, dev), off, slen, d, step, stop, min_trips, cap_scale, wide)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["random", "tandem"])
@pytest.mark.parametrize("step", [3, 4])
@pytest.mark.parametrize("d,off,slen,stop,min_trips,cap_scale,wide", [
    (11, 0, 100, 16, 1, 1, 0),    # the CLI default's full-read search
    (11, 0, 100, 16, 0, 1, 0),    # min_trips 0: most lanes stop before a trip
    (8, 33, 34, 32, 3, 1, 0),     # a k = 2 seed slice at off > 0
    (11, 0, 100, 0, 0, 2, 0),     # only empty lanes stop: a late exit
    (8, 0, 100, 4, 1, 1, 2),      # the wide phase
    (8, 67, 33, 8, 1, 4, 1),      # the last seed, wide phase, cap_scale 4
    (8, 40, 10, 16, 1, 1, 1),     # T = 0 (10 - 8 - 1 < step)
    (8, 0, 100, 16, 200, 1, 0),   # min_trips past T: all T trips
])
def test_search_multistep_kernel_matches_plain(cuda, multistep_world, kind, step, d, off, slen,
                                               stop, min_trips, cap_scale, wide):
    """csrc/searchk.cu against search_multistep_plain on every output
    (sp0, ep0, sp, ep, rem, unfinished, trips, and the exit's compaction:
    sel, count, over_lane, n_unf), then the whole search_early_stop_packed
    against its plain version (finisher included, with_stats)."""
    from bwtpu_torch.kernels import searchk

    args = _multistep_args(multistep_world, kind, step, d, cuda, off, slen, stop, min_trips,
                           cap_scale, wide)
    before = searchk.search_multistep.launches
    got = searchk.search_multistep(*args)
    want = searchk.search_multistep_plain(*args)
    assert searchk.search_multistep.launches == before + 1
    for name, a, b in zip(MULTISTEP_OUTPUTS, got, want, strict=True):
        assert torch.equal(a, b), name
    got = searchk.search_early_stop_packed(*args, with_stats=True)
    want = searchk.search_early_stop_packed_plain(*args, with_stats=True)
    for name, a, b in zip(("sp", "ep", "rem", "overflow", "trips", "n_unf"), got, want):
        assert torch.equal(a, b), name


MULTISTEP_OUTPUTS = ("sp0", "ep0", "sp", "ep", "rem", "unfinished", "trips", "sel", "count",
                     "over_lane", "n_unf")


@pytest.mark.gpu
@pytest.mark.parametrize("step", [3, 4])
@pytest.mark.parametrize("wide", [0, 1])
def test_search_multistep_kernel_past_the_finisher_capacity(cuda, multistep_world, step, wide):
    """A batch whose unfinished lanes outnumber the finisher's capacity
    (the tandem genome at stop width 0): the lanes past it are forced
    empty and flagged by the exit kernel, equal to the plain version's
    compact + _force_over on every output, and the whole search equal."""
    from bwtpu_torch.kernels import searchk

    args = _multistep_args(multistep_world, "tandem", step, 11, cuda, 0, 100, 0, 0, 1, wide)
    got = searchk.search_multistep(*args)
    want = searchk.search_multistep_plain(*args)
    for name, a, b in zip(MULTISTEP_OUTPUTS, got, want, strict=True):
        assert torch.equal(a, b), name
    assert int(want[10]) > want[7].shape[0] and int(want[9].sum()) > 0
    for a, b in zip(searchk.search_early_stop_packed(*args, with_stats=True),
                    searchk.search_early_stop_packed_plain(*args, with_stats=True)):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_search_early_stop_packed_launches_at_most_four(cuda, multistep_world):
    """One search_early_stop_packed call puts at most 4 operations on the
    card (the workspace memset, the search, the exit with its compaction,
    search_chain2), counted by torch.profiler over 5 calls; the launch
    counters see one search_multistep and one search_chain2 a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bwtpu_torch.kernels import searchk

    args = _multistep_args(multistep_world, "tandem", 3, 11, cuda, 0, 100, 16, 1, 1, 0)
    searchk.search_early_stop_packed(*args, with_stats=True)  # warm: builds, allocator
    torch.cuda.synchronize()
    before = (searchk.search_multistep.launches, search2.search_chain2.launches)
    calls = 0
    for _ in range(3):  # a window with no device activity delivered is retried
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                searchk.search_early_stop_packed(*args, with_stats=True)
            torch.cuda.synchronize()
        calls += 5
        ops = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        if ops:
            break
    assert 3 * 5 <= len(ops) <= 4 * 5, ops
    assert (searchk.search_multistep.launches, search2.search_chain2.launches) == (
        before[0] + calls, before[1] + calls)


@pytest.mark.gpu
def test_search_multistep_edge_batches(cuda, multistep_world):
    """A batch of one lane and an empty batch (the exit alone: trips =
    min(T, min_trips) with no lane), and a batch not a multiple of the
    CTA's lanes."""
    from bwtpu_torch.kernels import searchk

    for n in (1, 0, 4097):
        args = list(_multistep_args(multistep_world, "random", 3, 11, cuda, 0, 100, 16, 2, 1,
                                    0))
        args[6], args[7] = args[6][:n].contiguous(), args[7][:n].contiguous()
        for name, a, b in zip(MULTISTEP_OUTPUTS, searchk.search_multistep(*args),
                              searchk.search_multistep_plain(*args), strict=True):
            assert torch.equal(a, b), (n, name)


@pytest.mark.gpu
def test_search_early_stop_packed_does_not_sync(cuda, multistep_world):
    """The search with its finisher (with_stats=False) queues its work
    without one host sync: it runs under sync debug mode "error"."""
    from bwtpu_torch.kernels import _build, searchk

    args = _multistep_args(multistep_world, "tandem", 3, 11, cuda, 0, 100, 16, 1, 1, 0)
    _build.build_all(["searchk", "search2"])
    want = searchk.search_early_stop_packed(*args)  # warm: allocator, libraries
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = searchk.search_early_stop_packed(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("k,tiered", [(0, False), (2, False), (2, True)])
def test_three_shard_engine_on_the_card_equals_the_cpu(cuda, k, tiered):
    """The several-shard dispatch on the card (every kernel of the block
    and Read-list paths, per shard) against the same Engine on the CPU
    (the plain versions): equal FlatHits, hit lists and BatchStats."""
    from bwtpu_torch.engine import Engine
    from bwtpu_torch.index import build_sharded_index
    from bwtpu_torch.readblock import ReadBlock

    cfg = EngineConfig(sa_rate=8, read_len=L)
    shards, _ = build_sharded_index(GENOME, 3, config=cfg, overlap=128)
    reads, _ = simulate_reads(GENOME, 2000, read_len=L, max_mismatches=2, n_frac=0.01,
                              seed=31)
    mixed = reads[:500] + simulate_reads(GENOME, 500, read_len=70, max_mismatches=2,
                                         seed=32)[0]
    out = {}
    for dev in ("cuda", "cpu"):
        eng = Engine(shards, device=dev)
        flat = eng.finish_block(eng.dispatch_block(ReadBlock.from_reads(reads), k,
                                                   pad_to=2048, tiered=tiered))
        lists = [[(h.nm, h.strand, h.pos) for h in hs] for hs in eng.align_batch(mixed, k)]
        out[dev] = (flat, lists, dict(vars(eng.stats), device_s=0, host_s=0))
    (fg, lg, sg), (fc, lc, sc) = out["cuda"], out["cpu"]
    for name in ("read_idx", "pos", "strand_rev", "nm"):
        assert np.array_equal(getattr(fg, name), getattr(fc, name)), name
    assert (fg.truncated is None) == (fc.truncated is None)
    assert lg == lc and sg == sc and len(fg.read_idx) > (200 if k == 0 else 1000)


def _dist_rank(rank: int, world: int, tmp: str, backend: str, S: int, reads: list) -> None:
    """One rank of the DistEngine card tests: its block of `reads` at
    k = 0 and 2 on cuda:0, hits and kernel launches to rank<r>.pkl."""
    import datetime
    import os
    import pickle

    import torch.distributed as dist

    from bwtpu_torch.dist import DistEngine
    from bwtpu_torch.index import build_sharded_index
    from bwtpu_torch.io import Read
    from bwtpu_torch.kernels.verify2 import verify_nm

    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        shards, manifest = build_sharded_index(GENOME, S, config=EngineConfig(sa_rate=8),
                                               overlap=128)
        eng = DistEngine(shards, manifest, device="cuda:0")
        b = -(-len(reads) // world)
        mine = [Read(rid, seq) for rid, seq in reads[rank * b:(rank + 1) * b]]
        out = {"transport": eng.transport}
        for k in (0, 2):
            fns = (locate_walk, verify_nm, search2.search_chain2)
            before = [f.launches for f in fns]
            out[k] = [[(h.nm, h.strand, h.pos) for h in hs] for hs in eng.align_batch(mine, k)]
            out[f"launches{k}"] = [f.launches - n for f, n in zip(fns, before)]
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


@pytest.mark.gpu
@pytest.mark.parametrize("backend,world,S", [("nccl", 1, 1), ("gloo", 2, 2)],
                         ids=["nccl-1rank-1shard", "gloo-2ranks-2shards-one-card"])
def test_dist_engine_on_the_card_equals_engine(cuda, tmp_path, backend, world, S):
    """DistEngine's ring on the card (NCCL at world 1; two gloo ranks on
    cuda:0, their hops through host memory) against the single-device
    Engine over the same shards and reads, at k = 0 and 2; each rank
    launched locate_walk, verify_nm and search_chain2."""
    import pickle

    from bwtpu_torch.engine import Engine
    from bwtpu_torch.index import build_sharded_index
    from test_torch_dist import run_ranks

    reads, _ = simulate_reads(GENOME, 3000, read_len=L, max_mismatches=2, n_frac=0.01, seed=33)
    run_ranks(_dist_rank, world, (world, str(tmp_path), backend, S,
                                  [(r.rid, r.seq) for r in reads]), timeout=300)
    ranks = []
    for r in range(world):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    shards, _ = build_sharded_index(GENOME, S, config=EngineConfig(sa_rate=8), overlap=128)
    eng = Engine(shards, device="cuda")
    for k in (0, 2):
        want = [[(h.nm, h.strand, h.pos) for h in hs] for hs in eng.align_batch(reads, k)]
        assert [x for r in ranks for x in r[k]] == want
        assert all(min(r[f"launches{k}"]) > 0 for r in ranks), [r[f"launches{k}"] for r in ranks]
    assert {r["transport"] for r in ranks} == {
        "nccl" if backend == "nccl" else "gloo via host memory"}


@pytest.fixture(scope="module")
def three_shards():
    """3 shards of GENOME (sa_rate 8, overlap 128) and 4,096 reads of 100 bp
    with up to 2 substitutions and N bases: four blocks of 1,024."""
    from bwtpu_torch.index import build_sharded_index
    from bwtpu_torch.readblock import ReadBlock

    shards, _ = build_sharded_index(GENOME, 3, config=EngineConfig(sa_rate=8, read_len=L),
                                    overlap=128)
    reads, _ = simulate_reads(GENOME, 4096, read_len=L, max_mismatches=2, n_frac=0.01, seed=34)
    return shards, [ReadBlock.from_reads(reads[i:i + 1024]) for i in range(0, 4096, 1024)]


def _flat_key(flat):
    return tuple(getattr(flat, n).tolist() for n in ("read_idx", "pos", "strand_rev", "nm")) + (
        None if flat.truncated is None else flat.truncated.tolist(),)


@pytest.mark.gpu
@pytest.mark.parametrize("k,tiered", [(0, False), (2, False), (2, True)])
def test_fused_dispatch_on_the_card_equals_the_loop(cuda, three_shards, k, tiered):
    """Engine(fuse_shards=True) on the card, one CUDA graph replay a
    dispatch (heals included), against the loop form on the same card:
    four blocks in flight, equal FlatHits and BatchStats."""
    from bwtpu_torch.engine import Engine

    shards, blks = three_shards
    out = {}
    for fuse in (False, True):
        eng = Engine(shards, device="cuda", fuse_shards=fuse)
        handles = [eng.dispatch_block(b, k, pad_to=1024, tiered=tiered) for b in blks]
        out[fuse] = ([_flat_key(eng.finish_block(h)) for h in handles],
                     dict(vars(eng.stats), device_s=0, host_s=0))
    assert out[True] == out[False]
    assert eng.graph_replays.total() == len(blks) + eng.stats.heals and eng._graphs


@pytest.mark.gpu
@pytest.mark.parametrize("fuse", [False, True], ids=["loop", "fused"])
@pytest.mark.parametrize("k,tiered", [(0, False), (2, False), (2, True)])
def test_block_dispatch_does_not_sync(cuda, three_shards, fuse, k, tiered):
    """Once the reads are on the card, a dispatch queues every shard's
    packed pipeline (hits_output or the tiered pipeline with its
    escalation compaction; fused: the copy into the graph's inputs, the
    replay and the copy out) without one host sync: it runs under sync
    debug mode "error", with the same FlatHits."""
    from bwtpu_torch.engine import Engine

    shards, blks = three_shards
    eng = Engine(shards, device="cuda", fuse_shards=fuse)
    want = eng.finish_block(eng.dispatch_block(blks[0], k, pad_to=1024, tiered=tiered))
    rw2, ab2, Bp = eng._upload_block(blks[0], 1024)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        handle = eng._dispatch_packed(blks[0], rw2, ab2, Bp, k, 0, tiered)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert handle[6] == ("tiered" if tiered else "hits")
    assert _flat_key(eng.finish_block(handle)) == _flat_key(want)


@pytest.mark.gpu
def test_fused_dispatch_is_one_graph_replay(cuda, three_shards):
    """A fused dispatch_block of a captured key is one replay: a
    torch.profiler window around it sees one cudaGraphLaunch and no kernel
    launch, no new graph is captured, no launch counter moves (a replay
    calls no wrapper), and the trace's device kernels are, by name, the
    launches the capture recorded (search_multistep among them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bwtpu_torch.engine import Engine
    from bwtpu_torch.kernels import _build

    shards, blks = three_shards
    eng = Engine(shards, device="cuda", fuse_shards=True)
    eng.finish_block(eng.dispatch_block(blks[0], 0, pad_to=1024))  # warm-up and capture
    assert eng.stats.heals == 0 and len(eng._graphs) == 1
    (graph,) = eng._graphs.values()
    assert graph.launches.get("search_multistep", 0) >= 3, graph.launches
    for _ in range(3):  # a window with no event delivered is retried
        before, replays = _build.launch_counts(), eng.graph_replays.total()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            handle = eng.dispatch_block(blks[1], 0, pad_to=1024)
            torch.cuda.synchronize()
        after = _build.launch_counts()
        eng.finish_block(handle)
        names = [e.name for e in prof.events()]
        if any("GraphLaunch" in n for n in names):
            break
    assert sum("GraphLaunch" in n for n in names) == 1, names
    assert not any("LaunchKernel" in n for n in names), names
    assert eng.graph_replays.total() == replays + 1 and len(eng._graphs) == 1
    assert after == before
    ran = _build.launches_in_trace(e.name for e in prof.events()
                                   if e.device_type == DeviceType.CUDA)
    assert ran == {n: graph.launches.get(n, 0) for n in ran}, (ran, graph.launches)


@pytest.mark.gpu
def test_fused_dispatch_with_finish_on_a_worker_thread(cuda):
    """As the CLI runs it: the main thread dispatches with up to four
    blocks in flight while one worker thread finishes them, and heals,
    which dispatch and capture new graphs, on the worker, at a shortened
    switch interval. A repeat-rich genome at binding caps heals every
    block; each block's hits equal the loop form's, and every dispatch
    replayed once."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    from bwtpu_torch.engine import Engine
    from bwtpu_torch.index import build_sharded_index
    from bwtpu_torch.readblock import ReadBlock

    rep = GENOME[:120] * 5 + GENOME[:3000]
    cfg = EngineConfig(sa_rate=4, max_hits=2, max_cand=2, read_len=50, loc_factor=0.5,
                       min_trips=1, max_heals=6)
    shards, _ = build_sharded_index(rep, 3, config=cfg, overlap=64)
    reads, _ = simulate_reads(rep, 64, read_len=50, max_mismatches=2, seed=23)
    blks = [ReadBlock.from_reads(reads), ReadBlock.from_reads(reads[::-1])]
    loop = Engine(shards, device="cuda")
    want = {k: [_flat_key(loop.finish_block(loop.dispatch_block(b, k, pad_to=64)))
                for b in blks] for k in (0, 2)}
    assert loop.stats.heals >= 2 * len(blks), loop.stats
    eng = Engine(shards, device="cuda", fuse_shards=True)
    jobs = [(i % len(blks), k) for i in range(12) for k in (0, 2)]
    got, inflight = [], []
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(max_workers=1) as ex:
            for i, k in jobs:
                handle = eng.dispatch_block(blks[i], k, pad_to=64)
                inflight.append(ex.submit(lambda h: _flat_key(eng.finish_block(h)), handle))
                if len(inflight) > 3:
                    got.append(inflight.pop(0).result(timeout=300))
            got += [f.result(timeout=300) for f in inflight]
    finally:
        sys.setswitchinterval(switch)
    for (i, k), g in zip(jobs, got, strict=True):
        assert g == want[k][i], (i, k)
    assert eng.graph_replays.total() == len(jobs) + eng.stats.heals, (eng.graph_replays,
                                                                      eng.stats)
    assert len(eng._graphs) > 2  # heal levels captured on the worker


# compact_mask's cases: (lanes, capacity, density of the mask; 0 or 1 =
# none or every lane; capacity None = the mask's own count); then the
# main path's calls (the hit compaction's 65,536 candidate lanes at k = 0
# and 2, phase 14a's 131,072 and the human-scale k = 2 block's 393,216)
# with capacities below, at and above the count, the two sides of one
# cluster's capacity (16 CTAs of 2,048 lanes: the edge between the forms),
# half of it, and the bench's size
CLUSTER = 16 * 2048
MASK_CASES = [(3000, 700, 0.3), (3000, 64, 0.0), (500, 1, 1.0), (3000, 1, 0.01),
              (2048, 2048, 1.0), (4097, 4097, 0.5), (6000, 2049, 0.6), (0, 16, 0.5),
              (65536, 32768, 0.08), (65536, 32768, 0.65), (131072, 65536, 0.3),
              (131072, None, 0.3), (393216, 262144, 0.5), (393216, 4096, 0.5),
              (393216, None, 0.01), (CLUSTER, 16384, 0.4), (CLUSTER + 1, 16384, 0.4),
              (CLUSTER // 2, 4096, 0.4), (CLUSTER - 1, 4096, 0.9), (1 << 20, 1 << 18, 0.3)]


@pytest.mark.gpu
@pytest.mark.parametrize("n,cap,p", MASK_CASES)
def test_compact_mask_kernel_matches_plain(cuda, n, cap, p):
    """compact (csrc/compact.cu's compact_mask) against compact_plain on
    every output: sel, count, overflow and the over flag (an empty mask,
    every lane past a capacity of 1, capacity = lanes, tiles cut by the
    capacity, no lanes, the main path's shapes, both forms)."""
    from bwtpu_torch.kernels import compact as tc

    rng = np.random.default_rng(n + (cap or 7))
    valid = _t(rng.random(n) < p, cuda)
    cap = int(valid.sum()) if cap is None else cap
    before = tc.compact.launches
    got = tc.compact(valid, cap)
    want = tc.compact_plain(valid, cap)
    assert tc.compact.launches == before + 1
    for name, a, b in zip(("sel", "count", "overflow", "over"), got, want, strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b), name


# compact_slots' cases: (lanes, H, capacity, counts low, counts high;
# capacity None = the clamped counts' total); then the main path's calls
# (phase 5's k = 0 and k = 2 blocks, phase 14a's and the human-scale
# blocks: H 16 / 32) with capacities below, at and above the total, the
# two sides of one cluster's capacity, half of it, and the bench's size
SLOT_CASES = [(400, 8, 700, -3, 16), (400, 8, 64, 0, 1), (300, 16, 5, 16, 17),
              (1000, 4, 1000, 0, 5), (500, 32, 1, 0, 3), (600, 16, 4500, 1, 17),
              (5000, 2, 3000, -1, 4), (0, 4, 16, 0, 5),
              (32768, 16, 65536, -1, 3), (32768, 16, 4096, -1, 3), (98304, 32, 65536, -1, 3),
              (98304, 32, None, -1, 40), (131072, 16, 262144, -1, 3),
              (131072, 16, None, 0, 2), (393216, 32, 131072, -1, 3),
              (393216, 32, 786432, 0, 5), (CLUSTER, 16, 8192, -1, 3),
              (CLUSTER + 1, 16, 8192, -1, 3), (CLUSTER // 2, 32, 1 << 18, -1, 40),
              (CLUSTER - 3, 32, 1000, 0, 33), (1 << 20, 16, 1 << 19, -1, 3)]


@pytest.mark.gpu
@pytest.mark.parametrize("n,H,cap,lo,hi", SLOT_CASES)
def test_compact_slots_kernel_matches_plain(cuda, n, H, cap, lo, hi):
    """compact_counts (csrc/compact.cu's compact_slots) against
    compact_counts_plain on every output: counts below 0 and above H,
    every lane past the capacity, capacity = lanes, capacity 1, a
    capacity inside a lane's slots, the main path's shapes, both forms
    (plain: n > 0)."""
    from bwtpu_torch.kernels import compact as tc

    rng = np.random.default_rng(n * H + (cap or 7))
    counts = _t(rng.integers(lo, hi, size=n).astype(np.int32), cuda)
    cap = int(counts.clamp(0, H).sum()) if cap is None else cap
    before = tc.compact_counts.launches
    got = tc.compact_counts(counts, H, cap)
    assert tc.compact_counts.launches == before + 1
    if n == 0:
        assert int(got[1]) == int(got[2]) == 0 and not got[0].any() and got[3].numel() == 0
        return
    want = tc.compact_counts_plain(counts, H, cap)
    for name, a, b in zip(("sel", "count", "overflow", "dropped"), got, want, strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def _direct(lib, kernel, x, H, cap, form, words):
    """One call of compact.cu's entry point in `form` (>= 1: the cluster
    form on that many CTAs, 0: the tiles form): (rc, sel, count,
    overflow, flag)."""
    from bwtpu_torch.kernels import _build

    ws = torch.empty(words, dtype=torch.int32, device=x.device)
    flag = torch.empty(x.shape[0], dtype=torch.bool, device=x.device)
    head = (x.data_ptr(), x.shape[0]) + ((H,) if kernel == "slots" else ())
    rc = _build.call(getattr(lib, f"bwtpu_compact_{kernel}"), x, *head, cap, form,
                     ws.data_ptr(), words, flag.data_ptr())
    return rc, ws[:cap], ws[cap], ws[cap + 1], flag


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["mask", "slots"])
def test_compact_both_forms_at_one_clusters_capacity(cuda, kernel):
    """At the lanes one cluster holds (the device's cluster size x 2,048)
    both forms equal the plain version; one lane more the cluster form
    refuses the call, and so it does an odd CTA count, a form below 0 and
    a workspace of the other form's size; the tiles form takes it."""
    from bwtpu_torch.kernels import compact as tc

    lib = tc._lib()
    ctas = tc._cluster_ctas(lib, cuda)
    assert ctas in (1, 2, 4, 8, 16)
    cap = 1 << 14
    rng = np.random.default_rng(ctas)
    for n in (ctas * lib.tile, ctas * lib.tile + 1):
        if kernel == "mask":
            x, H = _t(rng.random(n) < 0.3, cuda), 1
            want = tc.compact_plain(x, cap)
        else:
            x, H = _t(rng.integers(-1, 3, size=n).astype(np.int32), cuda), 16
            want = tc.compact_counts_plain(x, H, cap)
        runs = [(0, cap + 3 + -(-n // lib.tile))]
        if n == ctas * lib.tile:
            runs.append((ctas, cap + 2))
        else:
            rc = _direct(lib, kernel, x, H, cap, ctas, cap + 2)[0]
            assert rc != 0, "the cluster form took more lanes than it holds"
        if ctas > 1:
            assert _direct(lib, kernel, x, H, cap, 3, cap + 2)[0] != 0
        assert _direct(lib, kernel, x, H, cap, 1, cap + 3 + -(-n // lib.tile))[0] != 0
        assert _direct(lib, kernel, x, H, cap, 0, cap + 2)[0] != 0
        assert _direct(lib, kernel, x, H, cap, -1, cap + 3 + -(-n // lib.tile))[0] != 0
        for form, words in runs:
            rc, *got = _direct(lib, kernel, x, H, cap, form, words)
            torch.cuda.synchronize()
            assert rc == 0, (form, rc)
            for name, a, b in zip(("sel", "count", "overflow", "flag"), got, want, strict=True):
                assert torch.equal(a, b), (form, name)


@pytest.mark.gpu
def test_compaction_graph_capture_and_replay(cuda):
    """Both wrappers captured into one CUDA graph, in every form (phase 5's
    k = 0 candidate lanes and hit compaction, its k = 2 shapes, the bench's),
    then replayed on new inputs copied into the captured ones: every replay
    equals the plain versions on those inputs (nothing left over from a
    replay or the capture)."""
    from bwtpu_torch.kernels import compact as tc

    rng = np.random.default_rng(5)
    shapes = [(32768, 16384, 32768, 16, 65536), (65536, 32768, 98304, 32, 65536),
              (1 << 20, 1 << 18, 1 << 20, 16, 1 << 19)]
    ins = [(torch.zeros(nm, dtype=torch.bool, device=cuda),
            torch.zeros(ns, dtype=torch.int32, device=cuda)) for nm, _, ns, _, _ in shapes]

    def run():
        return [(tc.compact(v, cm), tc.compact_counts(c, H, cs))
                for (v, c), (_, cm, _, H, cs) in zip(ins, shapes, strict=True)]

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        outs = run()
    for rep in range(3):
        for (v, c), (nm, _, ns, _, _) in zip(ins, shapes, strict=True):
            v.copy_(_t(rng.random(nm) < 0.2 + 0.3 * rep, cuda))
            c.copy_(_t(rng.integers(-1, 2 + 2 * rep, size=ns).astype(np.int32), cuda))
        g.replay()
        torch.cuda.synchronize()
        for (v, c), (_, cm, _, H, cs), (gm, gs) in zip(ins, shapes, outs, strict=True):
            for a, b in zip(gm, tc.compact_plain(v, cm), strict=True):
                assert torch.equal(a, b), ("mask", rep)
            for a, b in zip(gs, tc.compact_counts_plain(c, H, cs), strict=True):
                assert torch.equal(a, b), ("slots", rep)


@pytest.mark.gpu
@pytest.mark.parametrize("instance", ["forward", "in_place", "unaligned"])
@pytest.mark.parametrize("B,L", [(1000, 100), (777, 16), (513, 64), (300, 385), (300, 400),
                                 (1, 1), (0, 100), (524288, 100), (65, 17), (129, 33),
                                 (200, 65), (191, 96), (64, 113), (63, 128), (257, 129)])
def test_revcomp_both_kernel_matches_plain(cuda, B, L, instance):
    """revcomp_both (csrc/prep.cu) against revcomp_both_plain: random words
    and ambiguity bits, L a multiple of 16 or not, every templated W (1-8)
    and the run-time-W instance (W 9 and 25), B x W not a multiple of a
    CTA's words, one read, no read, the bench's 524,288 reads. Instances:
    forward (separate rows, both halves written), in_place (the engine's
    call: the reads are rows [0, B) of the planes, only the reverse half
    written), unaligned (forward, with inputs and output planes that are
    views one row into their buffers)."""
    from bwtpu_torch.kernels import prep

    rng = np.random.default_rng(B + L)
    W = (L + 15) // 16
    words, amb = (_t(rng.integers(-2**31, 2**31, size=(B, W), dtype=np.int64)
                     .astype(np.int32), cuda) for _ in range(2))
    want = prep.revcomp_both_plain(words, amb, L)
    if instance == "forward":
        got = prep.revcomp_both(words, amb, L)
    elif instance == "in_place":
        planes = tuple(torch.full((2 * B, W), -7, dtype=torch.int32, device=cuda)
                       for _ in range(2))
        planes[0][:B] = words
        planes[1][:B] = amb
        got = prep.revcomp_both(planes[0][:B], planes[1][:B], L, planes)
        assert got[0] is planes[0] and got[1] is planes[1]
    else:
        def off(x, rows):
            buf = torch.full((rows + 1, W), -7, dtype=torch.int32, device=cuda)
            buf[1:] = x
            return buf[1:]

        planes = tuple(off(torch.zeros(2 * B, W, dtype=torch.int32, device=cuda), 2 * B)
                       for _ in range(2))
        got = prep.revcomp_both(off(words, B), off(amb, B), L, planes)
    torch.cuda.synchronize()
    for name, a, b in zip(("rw2", "ab2", "lens2"), got, want, strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b), name


@pytest.mark.gpu
def test_engine_on_the_second_card_with_the_first_current(cuda):
    """ROADMAP C.8: with cuda:0 the current device, chip_smoke phase 5's
    block (16,384 reads of 100 bp on the CLI-default index of an E.
    coli-size genome) through Engine(..., "cuda:1") at k = 0 and 2 gives
    the hits and truncation flags it gives on cuda:0, its kernels launched
    there (each launch made current on its tensors' card). Skips on a
    host with one card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from bwtpu_torch.engine import Engine
    from bwtpu_torch.kernels import _build
    from bwtpu_torch.readblock import ReadBlock
    from bwtpu_torch.simulate import ECOLI_SCALE

    genome = random_genome(ECOLI_SCALE, seed=20261016)
    idx = build_fm_index(genome, EngineConfig())
    reads, _ = simulate_reads(genome, 16384, read_len=L, max_mismatches=2, seed=20261017)
    blk = ReadBlock.from_reads(reads)
    torch.cuda.set_device(0)
    got = {}
    for dev in ("cuda:0", "cuda:1"):
        eng = Engine([idx], device=dev)
        for k in (0, 2):
            _build.reset_launches()
            flat = eng.finish_block(eng.dispatch_block(blk, k, pad_to=16384))
            ran = _build.launch_counts()
            assert all(ran[n] >= 1 for n in ("search_multistep", "revcomp_both",
                                             "compact_slots", "compact_mask")), (dev, k, ran)
            got[dev, k] = [getattr(flat, n).tobytes() for n in ("read_idx", "pos",
                                                                  "strand_rev", "nm")]
            got[dev, k].append(None if flat.truncated is None else flat.truncated.tobytes())
        assert torch.cuda.current_device() == 0
        assert eng.dev_shards[0].lattice.device == torch.device(dev)
    for k in (0, 2):
        assert got["cuda:1", k] == got["cuda:0", k], k
        assert got["cuda:0", k][0], k  # hits were found


@pytest.mark.gpu
def test_compaction_and_prep_dispatch_without_sync(cuda):
    """compact, compact_counts and engine.device_prep_packed on CUDA
    tensors each launch their kernel and queue their work without one host
    sync (sync debug mode "error"), equal to their plain versions."""
    from bwtpu_torch import engine
    from bwtpu_torch.kernels import _build
    from bwtpu_torch.kernels import compact as tc
    from bwtpu_torch.kernels import prep

    rng = np.random.default_rng(3)
    reads, _ = simulate_reads(GENOME, 4096, read_len=L, max_mismatches=2, n_frac=0.01, seed=35)
    words, amb_bits = (_t(a, cuda) for a in engine.pack_reads_for_bench(reads))
    valid = _t(rng.random(50000) < 0.4, cuda)
    counts = _t(rng.integers(-1, 9, size=50000).astype(np.int32), cuda)
    calls = {"compact_mask": lambda: tc.compact(valid, 8192),
             "compact_slots": lambda: tc.compact_counts(counts, 8, 60000),
             "revcomp_both": lambda: engine.device_prep_packed(words, amb_bits, L)}
    plains = {"compact_mask": lambda: tc.compact_plain(valid, 8192),
              "compact_slots": lambda: tc.compact_counts_plain(counts, 8, 60000),
              "revcomp_both": lambda: (*prep.revcomp_both_plain(words, amb_bits, L),
                                       engine._len_mask(L, cuda).expand(2 * len(reads), -1))}
    _build.build_all(["compact", "prep"])
    for fn in calls.values():  # warm: libraries, allocator, the length mask
        fn()
    torch.cuda.synchronize()
    before = _build.launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = {name: fn() for name, fn in calls.items()}
    finally:
        torch.cuda.set_sync_debug_mode(0)
    after = _build.launch_counts()
    for name in calls:
        assert after[name] == before[name] + 1, name
        for a, b in zip(got[name], plains[name](), strict=True):
            assert torch.equal(a, b), name
