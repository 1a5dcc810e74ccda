"""sa_rate 1 in bwtpu_torch against bwtpu: the fused locate+verify
("locv") rows and the plain versions of verify_locv, the packed
pipelines with the table on and off, the Engine on the Read-list and
block paths (heals included), and upload_index's locv rule. Exact
equality: everything is integer."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bwtpu.engine as je
import bwtpu_torch.engine as te
from bwtpu import dna
from bwtpu.config import EngineConfig
from bwtpu.index import build_fm_index, pack_2bit
from bwtpu.io import Read
from bwtpu.kernels import verify2 as jv2
from bwtpu.readblock import ReadBlock
from bwtpu.simulate import random_genome, simulate_reads
from bwtpu_torch.kernels import verify2 as tv2

torch.set_num_threads(1)


def _hits(lists):
    """Per-read hit lists as (nm, strand, pos) tuples: each package has
    its own Hit class, so the lists compare by value."""
    return [[(h.nm, h.strand, h.pos) for h in hs] for hs in lists]


def _t(a):
    return torch.from_numpy(np.array(a))


def _verify_inputs(L, seed):
    """A fake SA over a 4 kbp text (any value in [0, text_len]), rows,
    seed offsets and packed reads, with invalid lanes and candidates
    before the text start and past its end."""
    genome = random_genome(4000, seed=5)
    text_packed = pack_2bit(dna.encode(genome))
    rng = np.random.default_rng(seed)
    n = len(genome) + 1
    ssa_full = rng.integers(0, len(genome) + 1, size=n).astype(np.int32)
    ssa_full[:3] = [0, 1, len(genome)]  # the clip edges of ws
    B = 256
    reads, truth = simulate_reads(genome, B, read_len=L, max_mismatches=2, n_frac=0.02,
                                  seed=seed)
    codes = np.zeros((B, L), np.int32)
    amb = np.zeros((B, L), np.int32)
    for i, r in enumerate(reads):
        c, m = dna.encode_with_mask(r.seq)
        codes[i], amb[i] = dna.revcomp_codes(c, m) if truth[i]["strand"] == "-" else (c, m)
    lens = np.full(B, L, np.int32)
    lens[::9] = rng.integers(10, L, size=len(lens[::9]))
    rw, ab, lm = tv2.pack_reads(codes, amb, lens)
    rows = rng.integers(0, n, size=B).astype(np.int32)
    rows[:3] = [0, 1, 2]
    off = rng.integers(0, L, size=B).astype(np.int32)
    # every third lane points at its read's true start: SA[row] - off
    true = np.arange(3, B, 3)
    rows[true] = true
    ssa_full[true] = np.array([truth[i]["pos"] for i in true]) + off[true]
    valid = rng.random(B) < 0.9
    valid[:3] = True
    locv = tv2.build_locv_rows(text_packed, ssa_full, L)
    return text_packed, ssa_full, locv, len(genome), rows, valid, off, rw, ab, lm, lens


@pytest.mark.parametrize("L", [50, 100])
def test_verify_packed_locv_matches_bwtpu(L):
    (text_packed, ssa_full, locv, tl, rows, valid, off, rw, ab, lm,
     lens) = _verify_inputs(L, seed=L)
    np.testing.assert_array_equal(locv, jv2.build_locv_rows(text_packed, ssa_full, L))
    rec = locv[rows]
    spos = np.where(valid, rec[:, 0], -1)
    cand = spos - off
    cvalid = valid & (spos >= 0)
    want = np.asarray(jax.jit(jv2.verify_packed_locv)(
        jnp.asarray(rec), jnp.int32(tl), jnp.asarray(cand), jnp.asarray(cvalid),
        jnp.asarray(rw), jnp.asarray(ab), jnp.asarray(lm), jnp.asarray(lens)))
    got = tv2.verify_packed_locv(_t(rec), tl, _t(cand), _t(cvalid), _t(rw), _t(ab),
                                 _t(lm), _t(lens)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 255).any() and (got <= 2).any()
    # the composed plain version (row take + SA mask + verify), which the
    # verify_locv wrapper runs on CPU tensors, launching nothing
    args = (_t(locv), tl, _t(rows), _t(valid), _t(off), _t(rw), _t(ab), _t(lm), _t(lens))
    before = tv2.verify_locv.launches
    pos, nm = tv2.verify_locv(*args)
    assert tv2.verify_locv.launches == before
    np.testing.assert_array_equal(pos.numpy(), spos)
    np.testing.assert_array_equal(nm.numpy(), want)
    for a, b in zip(tv2.verify_locv_plain(*args), (pos, nm)):
        assert torch.equal(a, b)
    # in-range candidates agree with the stride-8 text-row verify
    text_rows = tv2.build_text_rows(text_packed, L)
    nm_rows = tv2.verify_packed(_t(text_rows), tl, _t(cand), _t(cvalid), _t(rw),
                                _t(ab), _t(lm), _t(lens)).numpy()
    np.testing.assert_array_equal(nm_rows, got)


GENOME = random_genome(30000, seed=7)


@pytest.fixture(scope="module")
def index1():
    return build_fm_index(GENOME, EngineConfig(sa_rate=1, max_hits=4, max_cand=8,
                                               read_len=60))


def test_pipeline_locv_on_off_identical(index1):
    """The packed pipelines give the same live prefixes with the locv table
    on (verify_locv) and off (ssa gather + verify_nm), and equal
    bwtpu's."""
    L, cfg = 60, index1.config
    on, off = te.upload_index([index1], "cpu", locv=True)[0], te.upload_index(
        [index1], "cpu", locv=False)[0]
    assert on.locv.shape[-1] == tv2.locv_row_width(L) and off.locv.shape == (1, 1)
    depths = sorted(index1.kmer_tables)
    d, d_seed = te.pick_kmer_depth(depths, L), te.pick_kmer_depth(depths, L // 3)
    reads, _ = simulate_reads(GENOME, 256, read_len=L, max_mismatches=2, n_frac=0.01,
                              seed=8)
    rw, ab = je.pack_reads_for_bench(reads)
    jshard = jax.tree.map(lambda x: x[0], je.upload_index([index1]).shard)
    for tf, jf in (
            (functools.partial(te.exact_pipeline_packed, L=L, d=d, max_hits=cfg.max_hits,
                               sa_rate=1, loc_factor=1),
             functools.partial(je.exact_pipeline_packed, L=L, d=d, max_hits=cfg.max_hits,
                               sa_rate=1, loc_factor=1, compact_output=True)),
            (functools.partial(te.inexact_pipeline_packed, L=L, k=2, d=d_seed,
                               max_loc=cfg.max_cand, sa_rate=1, loc_factor=cfg.loc_factor),
             functools.partial(je.inexact_pipeline_packed, L=L, k=2, d=d_seed,
                               max_loc=cfg.max_cand, sa_rate=1, loc_factor=cfg.loc_factor,
                               compact_output=True))):
        a, b = tf(on, _t(rw), _t(ab)), tf(off, _t(rw), _t(ab))
        w = jax.jit(jf)(jshard, rw, ab)
        cnt = int(w[3])
        assert cnt == int(a[3]) == int(b[3]) > 0
        for i in (0, 1, 2):  # cand, nm, sel (live prefix)
            np.testing.assert_array_equal(a[i][:cnt].numpy(), b[i][:cnt].numpy())
            np.testing.assert_array_equal(a[i][:cnt].numpy(), np.asarray(w[i])[:cnt])
        for i in (4, 5):  # per-row overflow, compaction overflow
            np.testing.assert_array_equal(a[i].numpy(), np.asarray(w[i]))


def _assert_flat_equal(got, want):
    assert got.n_reads == want.n_reads
    for name in ("read_idx", "pos", "strand_rev", "nm"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    if want.truncated is None:
        assert got.truncated is None
    else:
        np.testing.assert_array_equal(got.truncated, want.truncated)


def _stats(engine):
    st = engine.stats
    return (st.reads, st.hits, st.overflow_reads, st.compact_overflows, st.heals,
            st.truncated_reads)


@pytest.mark.parametrize("k", [0, 2])
def test_engine_sa_rate_1_matches_bwtpu(index1, k):
    """Read lists (uniform: packed pipelines; mixed lengths: 1-step
    pipelines, dense) and blocks, with the locv table on."""
    ej, et = je.Engine([index1]), te.Engine([index1], device="cpu")
    assert et.dev_shards[0].locv.shape[-1] > 1  # auto-on at sa_rate 1
    uniform, _ = simulate_reads(GENOME, 80, read_len=60, max_mismatches=2, n_frac=0.01,
                                seed=k + 20)
    mixed = uniform[:40] + simulate_reads(GENOME, 40, read_len=37, max_mismatches=2,
                                          seed=k + 21)[0]
    for reads in (uniform, mixed):
        want = ej.align_batch(reads, k)
        assert _hits(et.align_batch(reads, k)) == _hits(want)
        assert sum(map(len, want)) > len(reads) // 5
    assert (_hits(et.align_all(mixed, k, batch_size=32))
            == _hits(ej.align_all(mixed, k, batch_size=32)))
    blk = ReadBlock.from_reads(uniform)
    _assert_flat_equal(et.finish_block(et.dispatch_block(blk, k, pad_to=96)),
                       ej.finish_block(ej.dispatch_block(blk, k, pad_to=96)))
    assert _stats(et) == _stats(ej)


def _repeat_genome():
    """A 12 bp motif repeated 30 times inside random flanks: reads over
    the array carry ~30 true hits each."""
    motif = "ACGTGGTCAAGT"
    left, right = random_genome(800, seed=9), random_genome(800, seed=10)
    return left + motif * 30 + right, len(left)


@pytest.mark.parametrize("k,max_heals", [(0, 4), (2, 4), (2, 0)])
def test_sa_rate_1_heals_and_truncation_match_bwtpu(k, max_heals):
    genome, off = _repeat_genome()
    cfg = EngineConfig(sa_rate=1, max_hits=4, max_cand=4, loc_factor=1, read_len=36,
                       max_heals=max_heals)
    idx = build_fm_index(genome, cfg)
    reads, _ = simulate_reads(genome, 40, read_len=36, max_mismatches=k, seed=3)
    reads[0] = Read("rep0", genome[off:off + 36], "I" * 36)
    blk = ReadBlock.from_reads(reads)
    ej, et = je.Engine([idx]), te.Engine([idx], device="cpu")
    _assert_flat_equal(et.finish_block(et.dispatch_block(blk, k)),
                       ej.finish_block(ej.dispatch_block(blk, k)))
    assert _hits(et.align_batch(reads, k)) == _hits(ej.align_batch(reads, k))
    assert _stats(et) == _stats(ej)
    if max_heals:
        assert et.stats.heals >= 2  # the block and the Read list both healed
    else:
        assert et.stats.truncated_reads > 0


def test_upload_index_locv_rule(index1, monkeypatch):
    """Auto: on at sa_rate 1 with the multi-step lattice and within
    LOCV_MAX_BYTES, as bwtpu decides; requested at sa_rate != 1: an
    error."""
    ref = jax.tree.map(lambda x: x[0], je.upload_index([index1]).shard)
    got = te.upload_index([index1], "cpu")[0]
    np.testing.assert_array_equal(got.locv.numpy(), np.asarray(ref.locv))
    assert te.LOCV_MAX_BYTES == je.LOCV_MAX_BYTES
    g = random_genome(3000, seed=1)
    for cfg in (EngineConfig(sa_rate=1, occ_step=0), EngineConfig(sa_rate=4)):
        idx = build_fm_index(g, cfg)
        assert te.upload_index([idx], "cpu")[0].locv.shape == (1, 1)
        assert np.asarray(je.upload_index([idx]).shard.locv).shape[-2:] == (1, 1)
    with pytest.raises(ValueError, match="sa_rate == 1"):
        te.upload_index([build_fm_index(g, EngineConfig(sa_rate=4))], "cpu", locv=True)
    monkeypatch.setattr(te, "LOCV_MAX_BYTES", index1.n * 4)
    assert te.upload_index([index1], "cpu")[0].locv.shape == (1, 1)
