"""The port's host assembly on one packed int64 key against bwtpu's
lexsort form: results.flatten_hits field- and dtype-equal to
bwtpu.results.flatten_hits, and results.flatten_hit_buffers (the block
path's "hits" mode, keys built from each shard's fetched (cand, hm)
buffer) equal to the columns route it replaced, compact_to_columns and
the reference flatten_hits; the width limit and the assemble_keys /
assemble_dupes counters."""

import os
import sys
import zlib

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from bwtpu import results as jresults  # noqa: E402
from bwtpu_torch import results as tresults  # noqa: E402
from bwtpu_torch import trace  # noqa: E402
from bwtpu_torch.engine import compact_to_columns  # noqa: E402

HUMAN_BP = 3_100_000_000


def _assert_flat_equal(got, want):
    assert got.n_reads == want.n_reads and got.truncated is None
    for name in ("read_idx", "pos", "strand_rev", "nm"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def _shards(rng, S: int, text_len: int, base: int = 0):
    """(text_lens, offsets) of S shards, with gaps between them."""
    tl = rng.integers(text_len // 2, text_len + 1, S)
    off = base + np.concatenate([[0], np.cumsum(tl)[:-1]]) + rng.integers(0, 50, S)
    return tl.tolist(), off.tolist()


def _columns(case: str):
    """(n_reads, read_lens, B, s_idx, row_idx, p, m, text_lens, offsets) of a case."""
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    n, B, S, text_len, N, max_nm, ragged = 60, 64, 3, 5000, 900, 3, True
    base = 0
    if case == "uniform_len":
        ragged = False
    elif case == "one_shard":
        S = 1
    elif case == "nm_to_7":
        max_nm = 8
    elif case == "empty":
        N = 0
    elif case == "single":
        N = 1
    elif case == "human_scale":
        n = B = 1_048_576
        S, text_len, N, base = 10, 310_000_000, 20_000, 0
    tl, off = _shards(rng, S, text_len, base)
    s = rng.integers(0, S, N)
    row = rng.integers(0, 2 * B, N)  # rows past n_reads where B > n
    p = rng.integers(-5, np.asarray(tl)[s] + 5) if N else np.zeros(0, np.int64)
    m = rng.integers(0, max_nm, N)
    if case == "dupes_both_strands":
        # one locus of one read found by many seed slots, each strand, nm in any order
        s[:40], p[:40] = 1, 777
        row[:40] = np.where(np.arange(40) % 2, 5, B + 5)
        m[:40] = rng.permutation(np.arange(40) % max_nm)
    if case == "single":
        s[:], row[:], p[:], m[:] = 0, 3, 10, 1
    lens = rng.integers(20, 101, n) if ragged else 100
    return n, lens, B, s, row, p.astype(np.int32), m.astype(np.int32), tl, off


@pytest.mark.parametrize("case", [
    "shards_ragged", "uniform_len", "one_shard", "dupes_both_strands", "nm_to_7",
    "empty", "single", "human_scale",
])
def test_flatten_hits_equal_reference(case):
    """Several shards with offsets, ragged or uniform lengths, positions
    before 0 and past a shard's end, rows past n_reads, one locus many
    times on both strands, nm up to 7, no hit, one hit, and a human-scale
    extent (offsets past 2^31, 1,048,576 reads)."""
    args = _columns(case)
    got = tresults.flatten_hits(*args)
    want = jresults.flatten_hits(*args)
    _assert_flat_equal(got, want)
    if case == "dupes_both_strands":  # the locus once a strand, at its smallest nm
        at = (want.read_idx == 5) & (want.pos == args[8][1] + 777)
        assert sorted(want.strand_rev[at].tolist()) == [False, True]
        assert (want.nm[at] == 0).all()
    if case == "human_scale":
        assert want.pos.max() > 2**31 and len(want.pos) > 1000


def _buffers(rng, S: int, B: int, n: int, Ct: int, cap: int, tl):
    """Per shard (cand int32[cap], hm int32[cap], count): hm = lane * 4 + nm,
    lanes in order; from count on, garbage (negative too)."""
    out = []
    for s in range(S):
        count = int(rng.integers(0, cap))
        lane = np.sort(rng.integers(0, 2 * B * Ct, count))
        lane[: count // 4] = lane[count // 4 : count // 4 + 1]  # many hits of one lane
        cand = rng.integers(-3, tl[s] + 3, count)
        dup = rng.random(count) < 0.5  # duplicates of the previous lane's locus
        dup[0:1] = False
        cand[dup] = cand[np.flatnonzero(dup) - 1]
        nm = rng.integers(0, 4, count)  # nm 3 > k: kept by no filter
        cand_b = rng.integers(-(2**31), 2**31, cap).astype(np.int32)
        hm_b = rng.integers(-(2**31), 2**31, cap).astype(np.int32)
        cand_b[:count], hm_b[:count] = cand, lane * 4 + nm
        out.append((cand_b, hm_b, count))
    return out


@pytest.mark.parametrize("S,n,B,k,mc,base", [
    (1, 50, 64, 2, 32, 0),
    (3, 64, 64, 2, 16, 0),
    (2, 40, 48, 1, 8, 2**33),
    (4, 30, 32, 0, 16, 0),  # k = 0: Ct = max_hits
])
def test_hit_buffers_equal_columns_route(S, n, B, k, mc, base):
    """flatten_hit_buffers == compact_to_columns (hm % 4, hm // 4) + the
    reference flatten_hits, on buffers that hold lanes past count, nm > k
    and several shards."""
    rng = np.random.default_rng(S * 1000 + n)
    Ct = (k + 1) * mc
    tl, off = _shards(rng, S, 4000, base)
    hits = _buffers(rng, S, B, n, Ct, 400, tl)
    comp = [(cand, hm % 4, hm // 4, c) for cand, hm, c in hits]
    cols = compact_to_columns(comp, k, Ct)
    want = jresults.flatten_hits(n, 100, B, *cols, tl, off)
    got = tresults.flatten_hit_buffers(n, 100, B, Ct, k, hits, tl, off)
    _assert_flat_equal(got, want)
    assert len(want.pos) > 50


@pytest.mark.parametrize("route", ["columns", "buffers"])
@pytest.mark.parametrize("n_reads,extent", [(1 << 20, 1 << 42), (1 << 42, 1 << 20)])
def test_key_width_limit_raises(route, n_reads, extent):
    """Fields past 63 bits raise ValueError naming the limit; the human
    genome with a block of 1,048,576 reads fits (20 + 1 + 32 + 2 bits)."""
    def call(n, tl):
        if route == "columns":
            z = np.zeros(1, np.int64)
            return tresults.flatten_hits(n, 100, n, z, z, z, z, [tl], [0])
        hits = [(np.zeros(1, np.int32), np.zeros(1, np.int32), 1)]
        return tresults.flatten_hit_buffers(n, 100, n, 16, 2, hits, [tl], [0])

    with pytest.raises(ValueError, match="63"):
        call(n_reads, extent)
    flat = call(1 << 20, HUMAN_BP)
    assert flat.read_idx.tolist() == [0] and flat.pos.tolist() == [0]


def test_negative_nm_raises():
    z = np.zeros(2, np.int64)
    with pytest.raises(ValueError, match="negative nm"):
        tresults.flatten_hits(1, 10, 1, z, z, z, np.array([0, -1]), [100], [0])


@pytest.mark.parametrize("route", ["columns", "buffers"])
def test_assemble_counters(route):
    """assemble_keys counts the hits that pass the filters and enter the
    first sort; assemble_dupes the (read, pos, strand) repeats it drops."""
    # B = 3, n_reads = 2: rows 0-2 the + strand, 3-5 the - strand. Read 0 +:
    # pos 5 three times, pos 9 once; read 1 -: pos 5 twice. Dropped before
    # the sort: row 2 (read 2, past n_reads), a position past the end.
    rows = np.array([0, 0, 0, 0, 4, 4, 2, 0])
    p = np.array([5, 5, 5, 9, 5, 5, 5, 95])
    m = np.array([2, 0, 1, 0, 1, 1, 0, 0])
    n_reads, B, Ct = 2, 3, 4
    before = trace.totals()[1]
    if route == "columns":
        flat = tresults.flatten_hits(n_reads, 10, B, np.zeros(len(rows), np.int64),
                                     rows, p, m, [100], [0])
    else:
        hm = (rows * Ct + np.arange(len(rows)) % Ct) * 4 + m
        hits = [(p.astype(np.int32), hm.astype(np.int32), len(rows))]
        flat = tresults.flatten_hit_buffers(n_reads, 10, B, Ct, 2, hits, [100], [0])
    after = trace.totals()[1]
    got = {c: after.get(c, 0) - before.get(c, 0) for c in ("assemble_keys", "assemble_dupes")}
    assert got == {"assemble_keys": 6, "assemble_dupes": 3}
    assert flat.read_idx.tolist() == [0, 0, 1]
    assert flat.pos.tolist() == [5, 9, 5] and flat.nm.tolist() == [0, 0, 1]
    assert flat.strand_rev.tolist() == [False, False, True]
