"""bwtpu_torch's 1-step backward search against bwtpu's, lane by lane:
the two search steps against the Pallas kernels (interpret mode off the
TPU), the two-record chain, and backward_search_ra with its straggler
fixup against both of bwtpu's backends ("jnp" and "pallas"). Exact
equality: everything is integer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bwtpu.kernels.search2 as jsearch2
import bwtpu_torch.kernels.compact as tcompact
import bwtpu_torch.kernels.search2 as tsearch2
import bwtpu_torch.kernels.searchk as tsearchk
from bwtpu import dna
from bwtpu.config import EngineConfig
from bwtpu.engine import upload_index
from bwtpu.index import build_fm_index
from bwtpu.kernels.pallas_step import search_step1_pallas, search_step_pallas
from bwtpu.simulate import adversarial_genome, random_genome

torch.set_num_threads(1)

L = 40  # right-aligned pattern width


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=msg)


@pytest.fixture(scope="module")
def genomes():
    out = {}
    for kind in ("random", "tandem"):
        g = (random_genome(12000, seed=41) if kind == "random"
             else adversarial_genome(12000, "tandem", seed=7))
        idx = build_fm_index(g, EngineConfig(sa_rate=4, read_len=60))
        shard = jax.tree.map(lambda x: x[0], upload_index([idx]).shard)
        out[kind] = (g, idx, shard)
    return out


def _patterns(genome: str, B: int, d: int, seed: int):
    """Right-aligned (codes, amb, lens): genome substrings with a few
    substitutions and ambiguous bases; lens in {0} or [max(d, 1), L]."""
    rng = np.random.default_rng(seed)
    g = dna.encode(genome)
    codes = np.zeros((B, L), np.int32)
    amb = np.zeros((B, L), np.int32)
    lens = rng.integers(max(d, 1), L + 1, size=B).astype(np.int32)
    lens[rng.random(B) < 0.05] = 0
    for i in range(B):
        n = lens[i]
        start = rng.integers(0, len(g) - n + 1)
        c = g[start:start + n].astype(np.int32)
        flip = rng.random(n) < 0.02
        c[flip] = (c[flip] + 1) % 4
        codes[i, L - n:] = c
        amb[i, L - n:] = rng.random(n) < 0.004
    return codes, amb, lens


def _step_inputs(idx, seed: int, B: int = 700):
    """Per-lane (c, amb, active, sp, ep) with sp <= ep <= n: narrow and
    wide intervals, lanes in the '$' block, ep == n, ambiguous and
    inactive lanes."""
    rng = np.random.default_rng(seed)
    n = idx.n
    sp = rng.integers(0, n, size=B).astype(np.int32)
    width = np.where(rng.random(B) < 0.5, rng.integers(0, 140, size=B),
                     rng.integers(0, 600, size=B))
    ep = np.minimum(sp + width, n).astype(np.int32)
    dollar_blk = (idx.dollar_row >> 7) << 7
    sp[:6] = [dollar_blk, idx.dollar_row, idx.dollar_row + 1, n - 3, 0, n]
    ep[:6] = [dollar_blk + 100, idx.dollar_row + 1, n, n, n, n]
    c = rng.integers(0, 4, size=B).astype(np.int32)
    c[:3] = 0
    amb = (rng.random(B) < 0.1).astype(np.int32)
    active = rng.random(B) < 0.8
    return c, amb, active, sp, ep


def test_search_step1_matches_pallas(genomes):
    _, idx, shard = genomes["random"]
    c, amb, active, sp, ep = _step_inputs(idx, seed=1)
    rec = idx.search_lattice[sp >> 7].copy()
    rng = np.random.default_rng(2)
    # random BWT words on a quarter of the lanes: every bit pattern ranks alike
    some = rng.random(len(sp)) < 0.25
    for lo, hi in ((4, 12), (21, 29)):
        rec[some, lo:hi] = rng.integers(-2**31, 2**31, size=(int(some.sum()), hi - lo),
                                        dtype=np.int64).astype(np.int32)
    want = search_step1_pallas(jnp.asarray(rec), jnp.asarray(c), jnp.asarray(amb),
                               jnp.asarray(active), jnp.asarray(sp), jnp.asarray(ep),
                               jnp.asarray(idx.C), jnp.int32(idx.dollar_row))
    got = tsearch2.search_step1(_t(rec), _t(c), _t(amb), _t(active), _t(sp), _t(ep),
                                _t(idx.C), idx.dollar_row)
    for name, a, b in zip(("sp", "ep", "strag"), got, want):
        _eq(a, b, name)
    assert got[2].dtype == torch.int32 and 0 < int(got[2].sum()) < int(active.sum())


def test_search_step_matches_pallas(genomes):
    _, idx, shard = genomes["tandem"]
    c, amb, active, sp, ep = _step_inputs(idx, seed=3)
    rec_sp, rec_ep = idx.search_lattice[sp >> 7], idx.search_lattice[ep >> 7]
    want = search_step_pallas(jnp.asarray(rec_sp), jnp.asarray(rec_ep), jnp.asarray(c),
                              jnp.asarray(amb), jnp.asarray(active), jnp.asarray(sp),
                              jnp.asarray(ep), jnp.asarray(idx.C),
                              jnp.int32(idx.dollar_row))
    got = tsearch2.search_step(_t(rec_sp), _t(rec_ep), _t(c), _t(amb), _t(active),
                               _t(sp), _t(ep), _t(idx.C), idx.dollar_row)
    for name, a, b in zip(("sp", "ep"), got, want):
        _eq(a, b, name)


@pytest.mark.parametrize("kind,d", [("random", 0), ("tandem", 4)])
def test_two_gather_search_matches_bwtpu(genomes, kind, d):
    g, idx, shard = genomes[kind]
    codes, amb, lens = _patterns(g, 300, d, seed=5 + d)
    rng = np.random.default_rng(d)
    sp0 = rng.integers(0, idx.n, size=300).astype(np.int32)
    ep0 = np.minimum(sp0 + rng.integers(0, 2000, size=300), idx.n).astype(np.int32)
    want = jsearch2._two_gather_search(shard.lattice, shard.C, shard.dollar_row,
                                       jnp.asarray(codes), jnp.asarray(amb),
                                       jnp.asarray(lens), jnp.asarray(sp0),
                                       jnp.asarray(ep0), d)
    args = (_t(idx.search_lattice), _t(idx.C), idx.dollar_row)
    got = tsearch2._two_gather_search(*args, _t(codes), _t(amb), _t(lens), _t(sp0),
                                      _t(ep0), d)
    for name, a, b in zip(("sp", "ep"), got, want):
        _eq(a, b, f"_two_gather_search {name}")
    # the wrapper over every lane, written in place
    sp, ep = _t(sp0), _t(ep0)
    tsearch2.search_chain2(*args, tsearch2.Planes(_t(codes), _t(amb), _t(lens)), _t(sp0),
                           _t(ep0), torch.arange(300, dtype=torch.int32),
                           torch.tensor(300, dtype=torch.int32), sp, ep, d)
    for name, a, b in zip(("sp", "ep"), (sp, ep), want):
        _eq(a, b, f"search_chain2 {name}")


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("kind,d,cap_scale,B", [
    ("random", 0, 1, 300),
    ("random", 4, 1, 600),
    ("random", "max", 1, 600),
    ("tandem", 0, 2, 300),
    ("tandem", 4, 1, 1000),
    ("tandem", 4, 2, 1000),
    ("tandem", "max", 1, 600),
])
def test_backward_search_ra_matches_bwtpu(genomes, backend, kind, d, cap_scale, B):
    g, idx, shard = genomes[kind]
    d = max(idx.kmer_tables) if d == "max" else d
    codes, amb, lens = _patterns(g, B, d, seed=B + d)
    kt = shard.kmer_tables[d] if d else jnp.zeros((1, 2), jnp.int32)
    want = jsearch2.backward_search_ra(shard.lattice, shard.C, shard.dollar_row,
                                       shard.n, kt, jnp.asarray(codes), jnp.asarray(amb),
                                       jnp.asarray(lens), d, backend=backend,
                                       cap_scale=cap_scale)
    got = tsearch2.backward_search_ra(
        _t(idx.search_lattice), _t(idx.C), idx.dollar_row, idx.n,
        _t(idx.kmer_tables[d]) if d else None, _t(codes), _t(amb), _t(lens), d,
        cap_scale=cap_scale)
    for name, a, b in zip(("sp", "ep", "over_lane"), got, want):
        _eq(a, b, name)
    sp, ep, over = (x.numpy() for x in got)
    assert (ep[lens == 0] == sp[lens == 0]).all()
    cap = min(B, max(256, B // 8) * cap_scale)
    strag = tsearch2.search_chain1(_t(idx.search_lattice), _t(idx.C), idx.dollar_row,
                                   _t(codes), _t(amb), _t(lens), *_starts(idx, d, codes,
                                                                          amb, lens), d)[2]
    n_strag = int(strag.sum())
    # a random genome's d-mer intervals never span three blocks; d = 0 and
    # the tandem arrays make lanes straggle
    assert (n_strag > 0) == (kind == "tandem" or d == 0)
    # the fixup cap binds exactly when the stragglers outnumber it
    assert (over.sum() > 0) == (n_strag > cap)
    if (kind, d) == ("tandem", 4):
        assert (n_strag > cap) == (cap_scale == 1)


def _packed_rows(genome: str, B: int, L: int, seed: int):
    """2-bit packed rows (words, ambiguity bits) of genome substrings of
    length L with a few substitutions and ambiguous bases (prep.py's
    layout, as device_prep_packed holds them)."""
    from bwtpu_torch.kernels.verify2 import pack_reads

    rng = np.random.default_rng(seed)
    g = dna.encode(genome)
    codes = np.zeros((B, L), np.int32)
    for i in range(B):
        start = rng.integers(0, len(g) - L + 1)
        codes[i] = g[start:start + L]
    flip = rng.random((B, L)) < 0.01
    codes[flip] = (codes[flip] + 1) % 4
    amb = (rng.random((B, L)) < 0.004).astype(np.int32)
    words, amb_bits, _ = pack_reads(codes, amb, np.full(B, L, np.int32))
    return words, amb_bits


# the finisher's count against its cap: none flagged, exactly cap flagged,
# more than cap flagged (those past the cap are forced empty and flagged)
FLAGGED = {"count0": lambda cap: 0, "count_cap": lambda cap: cap,
           "over_cap": lambda cap: cap + 37}


@pytest.mark.parametrize("case", sorted(FLAGGED))
@pytest.mark.parametrize("off,slen,d", [(0, 60, 4), (7, 37, 4), (23, 19, 0)])
def test_packed_finisher_matches_bwtpu(genomes, case, off, slen, d):
    """The packed finisher as search_early_stop_packed runs it (compact and
    _force_over, which the kernel path runs in search_multistep's exit,
    then searchk._finisher: search_chain2 on Packed rows, sel and a device
    count) against bwtpu's _fixup_stragglers_packed: slices at off > 0 and
    of lengths that are not multiples of 16, ambiguous bases, wide and
    narrow starts."""
    g, idx, shard = genomes["tandem"]
    B, L, cap = 400, 60, 128
    words, amb_bits = _packed_rows(g, B, L, seed=off + slen)
    rng = np.random.default_rng(slen)
    sp0 = rng.integers(0, idx.n, size=B).astype(np.int32)
    ep0 = np.minimum(sp0 + rng.integers(0, 3000, size=B), idx.n).astype(np.int32)
    sp = rng.integers(0, idx.n, size=B).astype(np.int32)  # the loop's garbage
    ep = rng.integers(0, idx.n, size=B).astype(np.int32)
    strag = np.zeros(B, bool)
    strag[rng.choice(B, FLAGGED[case](cap), replace=False)] = True
    want = jsearch2._fixup_stragglers_packed(
        shard.lattice, shard.C, shard.dollar_row, jnp.asarray(words), jnp.asarray(amb_bits),
        off, slen, jnp.asarray(sp0), jnp.asarray(ep0), jnp.asarray(sp), jnp.asarray(ep),
        jnp.asarray(strag), d, cap=cap)
    sel, count, _, over = tcompact.compact(_t(strag), cap)
    got = tsearch2._force_over(_t(sp), _t(ep), over)
    tsearchk._finisher(_t(idx.search_lattice), _t(idx.C), idx.dollar_row, _t(words),
                       _t(amb_bits), off, slen, _t(sp0), _t(ep0), sel, count, got[0], got[1],
                       d)
    for name, a, b in zip(("sp", "ep", "over_lane"), got, want):
        _eq(a, b, name)
    assert int(got[2].sum()) == max(0, int(strag.sum()) - cap)


@pytest.mark.parametrize("case", sorted(FLAGGED))
def test_planes_finisher_matches_bwtpu(genomes, case):
    """_fixup_stragglers (search_chain2 on right-aligned Planes of mixed
    lengths, L = 40) against bwtpu's."""
    g, idx, shard = genomes["random"]
    B, cap, d = 300, 96, 4
    codes, amb, lens = _patterns(g, B, d, seed=cap)
    rng = np.random.default_rng(cap)
    sp0, ep0 = (x.numpy() for x in _starts(idx, d, codes, amb, lens))
    sp = rng.integers(0, idx.n, size=B).astype(np.int32)
    ep = rng.integers(0, idx.n, size=B).astype(np.int32)
    strag = np.zeros(B, bool)
    strag[rng.choice(B, FLAGGED[case](cap), replace=False)] = True
    want = jsearch2._fixup_stragglers(
        shard.lattice, shard.C, shard.dollar_row, None, jnp.asarray(codes),
        jnp.asarray(amb), jnp.asarray(lens), jnp.asarray(sp0), jnp.asarray(ep0),
        jnp.asarray(sp), jnp.asarray(ep), jnp.asarray(strag), d, cap=cap)
    got = tsearch2._fixup_stragglers(
        _t(idx.search_lattice), _t(idx.C), idx.dollar_row, _t(codes), _t(amb), _t(lens),
        _t(sp0), _t(ep0), _t(sp), _t(ep), _t(strag), d, cap)
    for name, a, b in zip(("sp", "ep", "over_lane"), got, want):
        _eq(a, b, name)


def _starts(idx, d, codes, amb, lens):
    """(sp0, ep0) as backward_search_ra computes them."""
    return tsearch2.start_intervals(_t(idx.kmer_tables[d]) if d else None, idx.n,
                                    _t(codes), _t(amb), _t(lens), d)


def test_chain_wrappers_take_the_plain_version_on_cpu(genomes):
    g, idx, _ = genomes["random"]
    codes, amb, lens = _patterns(g, 200, 4, seed=9)
    args = (_t(idx.search_lattice), _t(idx.C), idx.dollar_row, _t(codes), _t(amb), _t(lens),
            *_starts(idx, 4, codes, amb, lens), 4)
    before = (tsearch2.search_chain1.launches, tsearch2.search_chain2.launches)
    for a, b in zip(tsearch2.search_chain1(*args), tsearch2._search_ra_chain(*args)):
        _eq(a, b)
    sel = torch.arange(0, 200, 3, dtype=torch.int32)
    count = torch.tensor(50, dtype=torch.int32)
    fin = (args[:3], tsearch2.Planes(*args[3:6]), *args[6:8], sel, count)
    got, want = [args[6].clone(), args[7].clone()], [args[6].clone(), args[7].clone()]
    tsearch2.search_chain2(*fin[0], *fin[1:], *got, 4)
    tsearch2._chain2_plain(*fin[0], *fin[1:], *want, 4)
    for a, b in zip(got, want):
        _eq(a, b)
    assert (tsearch2.search_chain1.launches, tsearch2.search_chain2.launches) == before
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tsearch2.search_chain2(*fin[0], *fin[1:], *(x.to("meta") for x in got), 4)


@pytest.mark.parametrize("L,k", [(16, 0), (37, 2), (60, 1)])
def test_device_prep_uniform_matches_bwtpu(L, k):
    from bwtpu.engine import device_prep_uniform as j_prep
    from bwtpu_torch.engine import device_prep_uniform as t_prep

    rng = np.random.default_rng(L)
    W = (L + 15) // 16
    words = rng.integers(-2**31, 2**31, size=(50, W), dtype=np.int64).astype(np.int32)
    amb = np.where(rng.random((50, W)) < 0.2,
                   1 << (2 * rng.integers(0, 16, size=(50, W))), 0).astype(np.int32)
    got = t_prep(_t(words), _t(amb), L, k)
    want = j_prep(jnp.asarray(words), jnp.asarray(amb), L, k)
    for name, a, b in zip(("codes", "amb", "lens", "rw", "ab", "lm"), got[:6], want[:6]):
        _eq(a, b, name)
    assert (got[6] is None) == (want[6] is None) == (k == 0)
    if k:
        for name, a, b in zip(("seed_ra", "seed_amb", "seed_lens", "seed_off"),
                              got[6], want[6]):
            _eq(a, b, name)
