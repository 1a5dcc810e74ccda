"""bwtpu_torch's plain-torch device code against bwtpu's, lane by lane:
lattice decoding (common), packed prep, compaction, and the multi-step
early-stop search with its straggler finisher. Exact equality."""

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
from bwtpu.kernels.searchk import search_early_stop_packed as j_search
from bwtpu.simulate import adversarial_genome, random_genome, simulate_reads
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
    for a, b in zip(tprep.revcomp_packed(tw, ta, L), jprep.revcomp_packed(jw, ja, L)):
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
    sel, count, _ = tcompact.compact(_t(valid), capacity)
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


@pytest.mark.parametrize("kind,min_trips,wide_steps,cap_scale,off,L", [
    ("random", 0, 0, 1, 0, 60),
    ("random", 1, 2, 2, 20, 20),
    ("tandem", 1, 0, 1, 0, 60),
    ("tandem", 0, 2, 2, 40, 20),
    ("tandem", 1, 0, 1, 0, 20),
    ("random", 2, 0, 1, 20, 40),
    ("tandem", 3, 1, 1, 0, 60),
])
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
