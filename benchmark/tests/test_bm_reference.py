"""The plain reference against a brute-force scan, and its SAM records
against the program's formatter on the same hits."""

import numpy as np
import pytest

from benchmark.reference import align as ra
from benchmark.reference import sam as rs


def _case(seed=0, n=30_000, m=200, L=100, sub=0.01, nrate=0.004):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, n, dtype=np.uint8)
    rep = rng.integers(0, 4, 250, dtype=np.uint8)
    for _ in range(40):  # a family whose copies give many hits
        p = int(rng.integers(0, n - 250))
        c = rep.copy()
        mm = rng.random(250) < 0.01
        c[mm] = (c[mm] + 1) % 4
        g[p:p + 250] = c if rng.random() < 0.5 else 3 - c[::-1]
    st = rng.integers(0, n - L + 1, m)
    codes = np.lib.stride_tricks.sliding_window_view(g, L)[st].copy()
    s = rng.random((m, L)) < sub
    codes[s] = (codes[s] + 1) % 4
    rev = rng.random(m) < 0.5
    codes[rev] = 3 - codes[rev, ::-1]
    amb = rng.random((m, L)) < nrate
    return g, codes, amb


def _brute(g, codes, amb, k):
    L = codes.shape[1]
    win = np.lib.stride_tricks.sliding_window_view(g, L)
    out = []
    for r in range(len(codes)):
        hits = []
        for rev, (c, a) in enumerate(((codes[r], amb[r]), (3 - codes[r][::-1], amb[r][::-1]))):
            nm = ((win != c) | a).sum(1)
            hits += [(int(nm[p]), rev, int(p)) for p in np.flatnonzero(nm <= k)]
        out.append(sorted(hits))
    return out


def _seed_counts(g, codes, amb, k):
    """Most exact occurrences of any seed on either strand, per read."""
    L = codes.shape[1]
    seeds = [(0, L)] if k == 0 else ra.seed_layout(L, k + 1)
    oc, oa = ra.oriented(codes, amb)
    best = np.zeros(len(codes), dtype=np.int64)
    for off, sl in seeds:
        win = np.lib.stride_tricks.sliding_window_view(g, sl)
        for r in range(len(oc)):
            if oa[r, off:off + sl].any():
                continue
            c = int((win == oc[r, off:off + sl]).all(1).sum())
            best[r % len(codes)] = max(best[r % len(codes)], c)
    return best


@pytest.mark.parametrize("k", [0, 1, 2])
def test_reference_equals_brute_force(k):
    g, codes, amb = _case(seed=k)
    cap = 6
    ans = ra.align(ra.Genome(g), codes, amb, k, cap)
    assert np.array_equal(ans.heavy, _seed_counts(g, codes, amb, k) > cap)
    assert ans.heavy.any() and not ans.heavy.all()
    want = _brute(g, codes, amb, k)
    for r in np.flatnonzero(~ans.heavy):
        got = [(int(x), int(y), int(z)) for x, y, z in
               zip(ans.nm[ans.read == r], ans.rev[ans.read == r], ans.pos[ans.read == r])]
        assert got == want[r], r
    assert not (ans.heavy[ans.read]).any()


def test_genome_nm_and_edges():
    g, codes, amb = _case(seed=5, m=20)
    G = ra.Genome(g)
    oc, oa = ra.oriented(codes, amb)
    rows = np.arange(40)
    pos = np.r_[np.zeros(20, np.int64), np.full(20, len(g) - 100)]
    want = ((np.lib.stride_tricks.sliding_window_view(g, 100)[pos] != oc) | oa).sum(1)
    assert np.array_equal(G.nm(oc, oa, rows, pos), want)
    assert (G.nm(oc, oa, rows[:2], np.array([-1, len(g) - 99])) == -1).all()


def test_codes_of():
    c, a = ra.codes_of(np.frombuffer(b"ACGTNacgx", np.uint8).reshape(1, -1))
    assert c.tolist() == [[0, 1, 2, 3, 0, 0, 0, 0, 0]]
    assert a.tolist() == [[False] * 4 + [True] * 5]


def test_sam_record_equals_the_programs_formatter():
    """The reference's record and bwtpu_torch.sam._record on the same hits:
    forward, reverse, multi-best (MAPQ 0), unmapped, truncated."""
    from bwtpu_torch.golden import Hit, select_primary
    from bwtpu_torch.io import Contig, Read
    from bwtpu_torch.sam import _record

    contigs = [Contig(name="chrZ", offset=0, length=10_000)]
    seq, qual = b"ACGTNACGTT", b"IIII#5AB?I"
    read = Read(rid="r000000007", seq=seq.decode(), qual=qual.decode())
    cases = [[(5, False, 0)], [(7, True, 1)], [(3, False, 1), (9, True, 1)],
             [(3, False, 0), (9, True, 1), (11, False, 2)], []]
    for hits in cases:
        h = [Hit(nm=nm, strand="-" if rev else "+", pos=p) for p, rev, nm in hits]
        prim, mapq = select_primary(h)
        want = _record(read, prim, mapq, contigs).encode()
        assert rs.record(b"r000000007", seq, qual, b"chrZ", hits, False) == want
        assert rs.record(b"r000000007", seq, qual, b"chrZ", hits, True) == want + b"\txo:i:1"


def test_parse_truncated():
    seq, qual = b"ACGTNACGTT", b"IIII#5AB?I"
    line = rs.record(b"r1", seq, qual, b"c", [(7, True, 1)], True)
    assert rs.parse_truncated(line, b"r1", seq, qual, b"c") == (7, True, 1)
    assert rs.parse_truncated(rs.record(b"r1", seq, qual, b"c", [], True),
                              b"r1", seq, qual, b"c") == ()
    assert rs.parse_truncated(line.replace(b"\txo:i:1", b""), b"r1", seq, qual, b"c") is None
    assert rs.parse_truncated(line.replace(b"\t16\t", b"\t0\t"), b"r1", seq, qual, b"c") is None
