"""bwtpu_torch's plain-torch device code against bwtpu's, lane by lane:
lattice decoding (common), packed prep, compaction, and the multi-step
early-stop search with its straggler finisher (the plain version runs
in the kernel's order: each lane to its own exit, then the whole-batch
exit trip from the histogram of those exits). Exact equality."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bwtpu.kernels.common as jcommon
import bwtpu.kernels.compact as jcompact
import bwtpu.kernels.prep as jprep
import bwtpu_torch.kernels.common as tcommon
import bwtpu_torch.kernels.compact as tcompact
import bwtpu_torch.kernels.prep as tprep
from bwtpu.config import EngineConfig
from bwtpu.engine import pack_reads_for_bench, upload_index
from bwtpu.index import build_fm_index
from bwtpu.kernels.search2 import _fixup_stragglers_packed as j_fixup_packed
from bwtpu.kernels.searchk import search_early_stop_packed as j_search
from bwtpu.simulate import adversarial_genome, random_genome, simulate_reads
from bwtpu_torch.kernels import searchk
from bwtpu_torch.kernels.search import interval_rows
from bwtpu_torch.kernels.searchk import search_early_stop_packed as t_search

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=msg)


@pytest.fixture(scope="module")
def world():
    idx = build_fm_index(random_genome(6000, seed=17), EngineConfig(sa_rate=8, read_len=60))
    shard = jax.tree.map(lambda x: x[0], upload_index([idx]).shard)
    return idx, shard


def test_common_decoding_matches_bwtpu(world):
    idx, shard = world
    rng = np.random.default_rng(1)
    B = 500
    i = rng.integers(0, idx.n + 1, size=B).astype(np.int32)
    i[:3] = [0, idx.dollar_row, idx.dollar_row + 1]
    c = rng.integers(0, 4, size=B).astype(np.int32)
    c[:3] = 0
    lat = _t(idx.search_lattice)
    _eq(tcommon.occ(lat, idx.dollar_row, _t(c), _t(i)),
        jcommon.occ(shard.lattice, shard.dollar_row, jnp.asarray(c), jnp.asarray(i)))
    sp = np.minimum(i, idx.n - 1).astype(np.int32)
    ep = np.minimum(sp + rng.integers(0, 300, size=B), idx.n).astype(np.int32)
    rec = idx.search_lattice[sp >> 7]
    for a, b in zip(tcommon.occ_pair_from_record(_t(rec), idx.dollar_row, _t(c), _t(sp), _t(ep)),
                    jcommon.occ_pair_from_record(jnp.asarray(rec), shard.dollar_row,
                                                 jnp.asarray(c), jnp.asarray(sp), jnp.asarray(ep))):
        _eq(a, b)
    m = (sp & 127).astype(np.int32)
    for a, b in zip(tcommon.mark_bit_and_rank(_t(rec), _t(m)),
                    jcommon.mark_bit_and_rank(jnp.asarray(rec), jnp.asarray(m))):
        _eq(a, b)
    _eq(tcommon.bwt_code_at(_t(rec), _t(m)), jcommon.bwt_code_at(jnp.asarray(rec), jnp.asarray(m)))
    words = rng.integers(-2**31, 2**31, size=(B, 8), dtype=np.int64).astype(np.int32)
    _eq(tcommon.block_rank(_t(words), _t(c), _t(m)),
        jcommon.block_rank(jnp.asarray(words), jnp.asarray(c), jnp.asarray(m)))
    _eq(tcommon.popcount32(_t(words)), jcommon.popcount32(jnp.asarray(words)))
    idx8 = rng.integers(-2, 10, size=B).astype(np.int32)  # includes out-of-range lanes
    _eq(tcommon.select_lane(_t(words), _t(idx8), 8),
        jcommon.select_lane(jnp.asarray(words), jnp.asarray(idx8), 8))
    _eq(tcommon.select_scalar_table(_t(idx.C), _t(idx8), 8),
        jcommon.select_scalar_table(jnp.asarray(idx.C), jnp.asarray(idx8), 8))


@pytest.mark.parametrize("L", [16, 50, 60, 100])
def test_prep_matches_bwtpu(L):
    rng = np.random.default_rng(L)
    B, W = 200, (L + 15) // 16
    words = rng.integers(-2**31, 2**31, size=(B, W), dtype=np.int64).astype(np.int32)
    amb = np.where(rng.random((B, W)) < 0.2,
                   1 << (2 * rng.integers(0, 16, size=(B, W))), 0).astype(np.int32)
    tw, ta, jw, ja = _t(words), _t(amb), jnp.asarray(words), jnp.asarray(amb)
    for a, b in zip(tprep.revcomp_packed_plain(tw, ta, L), jprep.revcomp_packed(jw, ja, L)):
        _eq(a, b)
    for j, nb in ((0, 2), (7, 26), (15, 4), (L - 13, 26), (L - 1, 2)):
        if 2 * j + nb > 32 * W:
            continue
        _eq(tprep.extract_bits(tw, j, nb), np.asarray(jprep.extract_bits(jw, j, nb)).astype(np.int64))
    for off, slen, d in ((0, L, min(L, 11)), (L // 3, L // 3, 4)):
        for a, b in zip(tprep.kmer_key_packed(tw, ta, off, slen, d),
                        jprep.kmer_key_packed(jw, ja, off, slen, d)):
            _eq(a, b)
    T = (L - 4) // 3
    for a, b in zip(tprep.smer_codes_packed(tw, ta, 1, T, 3),
                    jprep.smer_codes_packed(jw, ja, 1, T, 3)):
        _eq(a, b)
    _eq(tprep.unpack_slice(tw, 3, L - 3), jprep.unpack_slice(jw, 3, L - 3))


@pytest.mark.parametrize("capacity", [1, 64, 700, 5000])
def test_compaction_matches_bwtpu(capacity):
    rng = np.random.default_rng(capacity)
    valid = rng.random(3000) < 0.3
    for a, b in zip(tcompact.compact(_t(valid), capacity),
                    jcompact.compact(jnp.asarray(valid), capacity)):
        _eq(a, b)
    H = 8
    counts = rng.integers(-2, 12, size=400).astype(np.int32)
    counts[rng.random(400) < 0.5] = 0
    for a, b in zip(tcompact.compact_counts(_t(counts), H, capacity),
                    jcompact.compact_counts(jnp.asarray(counts), H, capacity)):
        _eq(a, b)
    sel, count, *_ = tcompact.compact(_t(valid), capacity)
    vals = rng.integers(0, 1000, size=capacity).astype(np.int32)
    _eq(tcompact.scatter_back(_t(vals), sel, count, 3000, -1),
        jcompact.scatter_back(jnp.asarray(vals), jnp.asarray(sel.numpy()),
                              jnp.asarray(count.numpy()), 3000, -1))
    sp = rng.integers(0, 500, size=300).astype(np.int32)
    ep = (sp + rng.integers(-1, 40, size=300)).astype(np.int32)
    from bwtpu.kernels.search import interval_rows as j_interval_rows

    for a, b in zip(interval_rows(_t(sp), _t(ep), 16),
                    j_interval_rows(jnp.asarray(sp), jnp.asarray(ep), 16)):
        _eq(a, b)


@pytest.fixture(scope="module")
def genomes():
    out = {}
    for kind in ("random", "tandem"):
        g = (random_genome(12000, seed=23) if kind == "random"
             else adversarial_genome(12000, "tandem", seed=7))
        idx = build_fm_index(g, EngineConfig(sa_rate=4, read_len=60))
        shard = jax.tree.map(lambda x: x[0], upload_index([idx]).shard)
        # 1500 reads = 3000 lanes: the tandem stragglers outgrow the
        # finisher's 256-lane capacity, so its overflow path runs too
        reads, _ = simulate_reads(g, 1500, read_len=60, max_mismatches=2,
                                  n_frac=0.005, seed=29)
        rw, ab = pack_reads_for_bench(reads)
        out[kind] = (idx, shard, rw, ab)
    return out


CASES = [
    ("random", 0, 0, 1, 0, 60),
    ("random", 1, 2, 2, 20, 20),
    ("tandem", 1, 0, 1, 0, 60),
    ("tandem", 0, 2, 2, 40, 20),
    ("tandem", 1, 0, 1, 0, 20),
    ("random", 2, 0, 1, 20, 40),
    ("tandem", 3, 1, 1, 0, 60),
]


@pytest.mark.parametrize("kind,min_trips,wide_steps,cap_scale,off,L", CASES)
def test_search_early_stop_packed_matches_bwtpu(genomes, kind, min_trips, wide_steps,
                                                cap_scale, off, L):
    """Every lane's (sp, ep, rem, overflow), and with_stats=True's trips
    and finisher lane count (the bench's roofline reads them)."""
    idx, shard, rw, ab = genomes[kind]
    d = max(idx.kmer_tables)  # auto depth of a 12 kbp genome: 6
    jargs = (shard.lattice, shard.latk, shard.latk_inv, shard.C, shard.dollar_row,
             shard.kmer_tables[d], jnp.asarray(rw), jnp.asarray(ab))
    stop = 16
    want = j_search(*jargs, off, L, d, 3, stop, min_trips, with_stats=True,
                    cap_scale=cap_scale, wide_steps=wide_steps)
    targs = (_t(idx.search_lattice), _t(idx.occk_lattice), _t(idx.occk_invalid),
             _t(idx.C), idx.dollar_row, _t(idx.kmer_tables[d]), _t(rw), _t(ab))
    got = t_search(*targs, off, L, d, 3, stop, min_trips, cap_scale=cap_scale,
                   wide_steps=wide_steps)
    for name, a, b in zip(("sp", "ep", "rem", "overflow"), got, want):
        _eq(a, b, f"{kind} lane {name}")
    stats = t_search(*targs, off, L, d, 3, stop, min_trips, cap_scale=cap_scale,
                     wide_steps=wide_steps, with_stats=True)
    for a, b in zip(stats, got):
        _eq(a, b)
    assert int(stats[4]) == int(want[4]) and int(stats[5]) == int(want[5]), (stats[4:], want[4:])
    sp, ep, rem, over = (x.numpy() for x in got)
    if kind == "tandem":
        # the finisher ran: still-wide lanes came back exact (rem == 0)
        assert ((rem == 0) & (ep - sp > stop)).any()
        if cap_scale == 1:
            assert over.sum() > 0, "finisher capacity was meant to bind"


@pytest.mark.parametrize("kind,min_trips,wide_steps,cap_scale,off,L", CASES)
def test_search_multistep_compaction_matches_bwtpu(genomes, kind, min_trips, wide_steps,
                                                   cap_scale, off, L):
    """search_multistep_plain's compaction and capacity cut, which the
    kernel's exit runs before the finisher's chain: sel[:count] and count
    against bwtpu's compact(unfinished, cap), over_lane (and the forced
    empty intervals) against bwtpu's _fixup_stragglers_packed on the same
    unfinished flags, n_unf against their sum. Exact (integers); in the
    tandem cases the 256-lane capacity binds."""
    idx, shard, rw, ab = genomes[kind]
    d = max(idx.kmer_tables)
    targs = (_t(idx.search_lattice), _t(idx.occk_lattice), _t(idx.occk_invalid),
             _t(idx.C), idx.dollar_row, _t(idx.kmer_tables[d]), _t(rw), _t(ab),
             off, L, d, 3, 16, min_trips, cap_scale, wide_steps)
    sp0, ep0, sp, ep, _, unf, _, sel, count, over, n_unf = searchk.search_multistep_plain(*targs)
    cap = searchk._shape(L, d, 3, wide_steps, rw.shape[0], cap_scale)[2]
    assert sel.shape == (cap,) and sel.dtype == count.dtype == n_unf.dtype == torch.int32
    jsel, jcount, _ = jcompact.compact(jnp.asarray(unf.numpy()), cap)
    n = int(jcount)
    assert int(count) == n and int(n_unf) == int(unf.sum())
    _eq(sel[:n], np.asarray(jsel)[:n], f"{kind} sel")
    _eq(sel[n:], np.zeros(cap - n, np.int32), f"{kind} sel past count")
    # the same intervals as the search left them, then bwtpu's finisher
    sp_in = torch.where(over.bool(), sp0 + 1, sp)  # anything: the cut empties them
    jsp, jep, jover = j_fixup_packed(
        shard.lattice, shard.C, shard.dollar_row, jnp.asarray(rw), jnp.asarray(ab), off, L,
        jnp.asarray(sp0.numpy()), jnp.asarray(ep0.numpy()), jnp.asarray(sp_in.numpy()),
        jnp.asarray(ep.numpy()), jnp.asarray(unf.numpy()), d, cap=cap)
    _eq(over, jover, f"{kind} over_lane")
    lanes = np.flatnonzero(np.asarray(jover))
    _eq(sp[lanes], np.asarray(jsp)[lanes], f"{kind} forced sp")
    _eq(ep[lanes], np.asarray(jep)[lanes], f"{kind} forced ep")
    if kind == "tandem" and cap_scale == 1:
        assert int(over.sum()) == int(unf.sum()) - cap > 0, "the capacity was meant to bind"


@pytest.fixture(scope="module")
def genomes4(genomes):
    """The genomes fixture's genomes and reads on a step-4 lattice."""
    out = {}
    for kind in ("random", "tandem"):
        g = (random_genome(12000, seed=23) if kind == "random"
             else adversarial_genome(12000, "tandem", seed=7))
        idx = build_fm_index(g, EngineConfig(sa_rate=4, read_len=60, occ_step=4))
        shard = jax.tree.map(lambda x: x[0], upload_index([idx]).shard)
        out[kind] = (idx, shard, *genomes[kind][2:])
    return out


@pytest.mark.parametrize("case,kind,step,d,min_trips,wide_steps,cap_scale,off,L,stop", [
    ("step 4", "random", 4, 4, 0, 0, 2, 0, 60, 0),
    ("step 4", "tandem", 4, 6, 1, 0, 1, 0, 60, 4),
    ("step 4", "tandem", 4, 4, 1, 1, 1, 0, 57, 2),
    ("step 4", "random", 4, 6, 1, 2, 1, 20, 40, 2),
    ("T = 0", "random", 3, 6, 0, 0, 1, 10, 8, 16),
    ("T = 0", "tandem", 3, 6, 1, 1, 1, 0, 9, 2),
    ("T = 0", "random", 4, 6, 0, 0, 1, 0, 6, 16),
    ("p = 0, lanes finish at T", "random", 3, 6, 18, 0, 1, 0, 60, 0),
    ("p = 0, lanes finish at T", "tandem", 4, 4, 14, 0, 1, 0, 60, 0),
    ("exit between min_trips and T", "random", 3, 6, 0, 0, 2, 0, 60, 0),
    ("exit between min_trips and T", "random", 3, 6, 2, 0, 1, 0, 60, 0),
    ("exit between min_trips and T", "random", 4, 4, 2, 0, 1, 0, 60, 0),
    ("exit between min_trips and T", "tandem", 4, 4, 2, 0, 1, 0, 60, 0),
])
def test_search_early_stop_packed_edge_cases_match_bwtpu(genomes, genomes4, case, kind, step,
                                                         d, min_trips, wide_steps, cap_scale,
                                                         off, L, stop):
    """The multi-step search's corners against bwtpu, trips and n_unf
    included: a step-4 lattice, no multi-step trip at all (T = 0), a
    chain that divides into trips (p = 0) with lanes that run all T trips
    and end finished, and a whole-batch exit strictly between min_trips
    and T. Each case asserts that it reaches its corner."""
    idx, shard, rw, ab = (genomes4 if step == 4 else genomes)[kind]
    jargs = (shard.lattice, shard.latk, shard.latk_inv, shard.C, shard.dollar_row,
             shard.kmer_tables[d], jnp.asarray(rw), jnp.asarray(ab))
    want = j_search(*jargs, off, L, d, step, stop, min_trips, with_stats=True,
                    cap_scale=cap_scale, wide_steps=wide_steps)
    targs = (_t(idx.search_lattice), _t(idx.occk_lattice), _t(idx.occk_invalid),
             _t(idx.C), idx.dollar_row, _t(idx.kmer_tables[d]), _t(rw), _t(ab),
             off, L, d, step, stop, min_trips, cap_scale, wide_steps)
    got = t_search(*targs, with_stats=True)
    for name, a, b in zip(("sp", "ep", "rem", "overflow", "trips", "n_unf"), got, want):
        _eq(a, b, f"{case}: {name}")
    for a, b in zip(searchk.search_early_stop_packed_plain(*targs, with_stats=True), got):
        _eq(a, b, case)
    T, p, _ = searchk._shape(L, d, step, wide_steps, rw.shape[0], cap_scale)
    trips = int(got[4])
    rem, unf = searchk.search_multistep_plain(*targs)[4:6]
    if case == "step 4":
        assert idx.occk_lattice.shape[1] == 512 and 0 < trips
    elif case == "T = 0":
        assert T == 0 and trips == 0
    elif case.startswith("p = 0"):
        assert p == 0 and trips == T and bool(((~unf) & (rem == 0)).any())
    else:
        assert min_trips < trips < T, (trips, T)


def test_exit_trip_matches_the_reference_loop():
    """exit_trip (the histogram of each lane's exit) against a loop over
    bwtpu's while_loop condition on random exits."""
    rng = np.random.default_rng(5)
    for _ in range(300):
        T = int(rng.integers(0, 25))
        B = int(rng.integers(0, 400))
        leave = rng.integers(0, T + 1, size=B)
        if rng.random() < 0.5:  # most lanes leave early, as on a genome
            leave = np.minimum(leave, rng.integers(0, 3, size=B))
        min_trips = int(rng.integers(0, T + 3))
        cap = int(rng.integers(0, B + 2))
        t = 0
        while t < T and ((leave > t).sum() > cap or t < min_trips):
            t += 1
        got = searchk.exit_trip(_t(leave.astype(np.int32)), T, min_trips, cap)
        assert got.dtype == torch.int32 and got.dim() == 0
        assert int(got) == t, (T, B, min_trips, cap)


def test_search_multistep_takes_the_plain_version_on_cpu(genomes):
    """On CPU tensors the wrapper runs search_multistep_plain and launches
    nothing; a tensor on another device raises."""
    idx, _, rw, ab = genomes["tandem"]
    args = (_t(idx.search_lattice), _t(idx.occk_lattice), _t(idx.occk_invalid), _t(idx.C),
            idx.dollar_row, _t(idx.kmer_tables[6]), _t(rw), _t(ab), 0, 60, 6, 3, 16, 1, 1, 0)
    before = searchk.search_multistep.launches
    got = searchk.search_multistep(*args)
    for a, b in zip(got, searchk.search_multistep_plain(*args)):
        _eq(a, b)
    assert searchk.search_multistep.launches == before
    assert got[5].dtype == torch.bool and got[6].dtype == torch.int32 and got[6].dim() == 0
    meta = tuple(a.to("meta") if isinstance(a, torch.Tensor) else a for a in args)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        searchk.search_multistep(*meta)
