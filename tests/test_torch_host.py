"""bwtpu_torch's copies of bwtpu's numpy helpers are equal to the
originals, and its device Shard holds the same arrays as bwtpu's."""

import jax
import numpy as np
import pytest
import torch

import bwtpu.engine as je
import bwtpu.kernels.verify as jverify
import bwtpu.kernels.search2 as jsearch2
import bwtpu.kernels.verify2 as jverify2
import bwtpu_torch.engine as te
import bwtpu_torch.kernels.search2 as tsearch2
import bwtpu_torch.kernels.verify as tverify
import bwtpu_torch.kernels.verify2 as tverify2
from bwtpu.config import EngineConfig
from bwtpu.index import build_fm_index, build_sharded_index
from bwtpu.io import Read
from bwtpu.simulate import random_genome

torch.set_num_threads(1)


def _hits(lists):
    """Per-read hit lists as (nm, strand, pos) tuples: each package has
    its own Hit class, so the lists compare by value."""
    return [[(h.nm, h.strand, h.pos) for h in hs] for hs in lists]


def test_constants_equal():
    assert tverify2.NM_INVALID == jverify2.NM_INVALID
    assert tverify2.TEXT_ROW_STRIDE == jverify2.TEXT_ROW_STRIDE
    for L in range(1, 260):
        assert tverify2.window_row_width(L) == jverify2.window_row_width(L)
        assert tverify2.locv_row_width(L) == jverify2.locv_row_width(L)
    assert te.LOCV_MAX_BYTES == je.LOCV_MAX_BYTES
    assert te.Engine.LF_LADDER == je.Engine.LF_LADDER


@pytest.mark.parametrize("read_len", [36, 50, 100, 150])
def test_build_locv_rows_equal(read_len):
    rng = np.random.default_rng(read_len)
    for n_words in (1, 7, 300, 1003):
        text = rng.integers(-2**31, 2**31, size=n_words, dtype=np.int64).astype(np.int32)
        n = 16 * n_words
        ssa = rng.integers(0, n + 1, size=n).astype(np.int32)
        ssa[:2] = [0, n]
        got = tverify2.build_locv_rows(text, ssa, read_len)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, jverify2.build_locv_rows(text, ssa, read_len))


def test_tiered_to_columns_equal():
    """Random tiered outputs, duplicated (row, pos) pairs across both
    tiers included: the same deduped columns and counts."""
    rng = np.random.default_rng(8)
    B, k, mh, mc = 50, 2, 4, 8
    esc_cap, cap1, cap2 = 30, 200, 400
    cand1 = rng.integers(-3, 400, size=cap1).astype(np.int32)
    cand2 = np.concatenate([cand1[:100], rng.integers(-3, 400, size=cap2 - 100)]).astype(np.int32)
    out = (cand1, rng.integers(0, 4, size=cap1).astype(np.int32),
           rng.integers(0, 2 * B * mh, size=cap1).astype(np.int32), np.int32(150),
           cand2, rng.integers(0, 5, size=cap2).astype(np.int32),
           rng.integers(0, 2 * esc_cap * (k + 1) * mc, size=cap2).astype(np.int32),
           np.int32(333), rng.permutation(B)[:esc_cap].astype(np.int32), np.int32(21),
           rng.integers(0, 2, size=2 * B).astype(np.int32), np.int32(3))
    got, want = te.tiered_to_columns(out, mh, mc, k, B), je.tiered_to_columns(out, mh, mc, k, B)
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[3:] == want[3:]


@pytest.mark.parametrize("read_len", [36, 50, 100, 150])
def test_build_text_rows_equal(read_len):
    rng = np.random.default_rng(read_len)
    for n_words in (1, 7, 8, 9, 1000, 1003):
        text = rng.integers(-2**31, 2**31, size=n_words, dtype=np.int64).astype(np.int32)
        np.testing.assert_array_equal(tverify2.build_text_rows(text, read_len),
                                      jverify2.build_text_rows(text, read_len))


@pytest.mark.parametrize("L", [1, 16, 50, 100, 101])
def test_pack_reads_equal(L):
    rng = np.random.default_rng(L)
    B = 40
    codes = rng.integers(0, 4, size=(B, L)).astype(np.int32)
    amb = (rng.random((B, L)) < 0.1).astype(np.int32)
    lens = rng.integers(0, L + 1, size=B).astype(np.int32)
    for got, want in zip(tverify2.pack_reads(codes, amb, lens),
                         jverify2.pack_reads(codes, amb, lens)):
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_seed_layout_pick_depth_compact_cap_equal():
    for L in range(1, 160):
        for nS in (1, 2, 3, 4):
            assert tverify.seed_layout(L, nS) == jverify.seed_layout(L, nS)
    for avail in ([], [4], [4, 8, 11], [4, 8, 12]):
        for m in range(0, 20):
            assert te.pick_kmer_depth(avail, m) == je.pick_kmer_depth(avail, m)
    for n in (0, 100, 32768, 262144):
        for lf in (0.25, 0.45, 1, 2, 6.0):
            for scale in (1, 2, 8):
                assert te.compact_cap(n, lf, scale) == je.compact_cap(n, lf, scale)


@pytest.mark.parametrize("k", [0, 1, 2])
def test_encode_batch_equal(k):
    rng = np.random.default_rng(k)
    cfg = EngineConfig(read_len=40)
    reads = [Read(f"r{i}", "".join(rng.choice(list("ACGTN"), p=[.24, .24, .24, .24, .04],
                                              size=int(rng.integers(1, 50)))))
             for i in range(30)]
    for batch, pad_to in ((reads, None), (reads, 37), (reads[:1], None), ([], 4),
                          ([Read("u", "ACGT" * 10)] * 3, None)):
        got, gB = te.encode_batch(cfg, batch, k, pad_to=pad_to)
        want, wB = je.encode_batch(cfg, batch, k, pad_to=pad_to)
        assert gB == wB
        for name in want._fields:
            a, b = getattr(got, name), getattr(want, name)
            if b is None or np.isscalar(b):
                assert a == b, name
            else:
                assert a.dtype == b.dtype, name
                np.testing.assert_array_equal(a, b, err_msg=name)


def test_right_align_equal():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=(50, 30)).astype(np.int32)
    amb = (rng.random((50, 30)) < 0.1).astype(np.int32)
    lens = rng.integers(0, 31, size=50).astype(np.int32)
    for got, want in zip(tsearch2.right_align(codes, amb, lens),
                         jsearch2.right_align(codes, amb, lens)):
        np.testing.assert_array_equal(got, want)


def test_dense_assembly_equal():
    rng = np.random.default_rng(5)
    B, H = 20, 6
    reads = [Read(f"r{i}", "A" * int(rng.integers(10, 40))) for i in range(B - 3)]
    pos = rng.integers(-5, 2000, size=(1, 2 * B, H)).astype(np.int32)
    nm = rng.integers(0, 4, size=(1, 2 * B, H)).astype(np.int32)
    valid = rng.random((1, 2 * B, H)) < 0.3
    for m in (nm, None):
        for got, want in zip(te.dense_to_columns(pos, m, valid),
                             je.dense_to_columns(pos, m, valid)):
            np.testing.assert_array_equal(got, want)
        assert (_hits(te.assemble_hits(reads, B, pos, m, valid, [2000], [7]))
                == _hits(je.assemble_hits(reads, B, pos, m, valid, [2000], [7])))
    comp = [(pos.reshape(-1), nm.reshape(-1), np.arange(2 * B * H, dtype=np.int32), 150)]
    assert (_hits(te.assemble_hits_compact(reads, B, comp, 2, H, [2000], [0]))
            == _hits(je.assemble_hits_compact(reads, B, comp, 2, H, [2000], [0])))


def test_compact_to_columns_equal():
    rng = np.random.default_rng(3)
    Ct, k = 48, 2
    comp = []
    for _ in range(2):
        cap = 300
        cand = rng.integers(-5, 10**6, size=cap).astype(np.int32)
        nm = rng.integers(0, 256, size=cap).astype(np.int32)
        nm[nm > 4] = rng.integers(0, 3, size=int((nm > 4).sum()))
        sel = rng.integers(0, 200 * Ct, size=cap).astype(np.int32)
        comp.append((cand, nm, sel, int(rng.integers(0, cap))))
    for got, want in zip(te.compact_to_columns(comp, k, Ct),
                         je.compact_to_columns(comp, k, Ct)):
        np.testing.assert_array_equal(got, want)


def _assert_shard_equal(got, ref):
    """One port Shard against one of bwtpu's per-shard trees (bwtpu's
    list form pads the row-indexed tables to the largest shard's rows:
    the port's are the unpadded prefix, the padding is zeros)."""
    for name in ("lattice", "latk", "latk_inv", "ssa", "C", "text_rows", "locv"):
        want = np.asarray(getattr(ref, name))
        have = getattr(got, name).numpy()
        assert have.dtype == want.dtype, name
        np.testing.assert_array_equal(have, want[:len(have)], err_msg=name)
        assert not want[len(have):].any(), name
    for name in ("dollar_row", "n", "text_len"):
        assert getattr(got, name) == int(getattr(ref, name)), name
    assert sorted(got.kmer_tables) == sorted(ref.kmer_tables)
    for dd, t in got.kmer_tables.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(ref.kmer_tables[dd]))


@pytest.mark.parametrize("sa_rate", [1, 4, 8])
def test_shard_equal_to_bwtpu_upload(sa_rate):
    idx = build_fm_index(random_genome(5000, seed=sa_rate),
                         EngineConfig(sa_rate=sa_rate, read_len=60))
    ref = jax.tree.map(lambda x: x[0], je.upload_index([idx]).shard)
    got = te.upload_index([idx], torch.device("cpu"))
    assert len(got) == 1
    _assert_shard_equal(got[0], ref)


def test_upload_refuses_uncovered_indexes():
    """An sa_rate == 1 index uploads with bwtpu's locv table; an index
    without the multi-step lattice uploads with bwtpu's (1, 1) dummy,
    which sends the pipelines to the 1-step path; several shards (refused
    until the port covered them) upload as one Shard each, equal to
    bwtpu's list form (upload_index(stacked=False)), at sa_rate 1 with
    the locv table of each."""
    g = random_genome(3000, seed=1)
    idx1 = build_fm_index(g, EngineConfig(sa_rate=1))
    np.testing.assert_array_equal(
        te.upload_index([idx1], "cpu")[0].locv.numpy(),
        np.asarray(jax.tree.map(lambda x: x[0], je.upload_index([idx1]).shard).locv))
    idx0 = build_fm_index(g, EngineConfig(sa_rate=4, occ_step=0))
    got = te.upload_index([idx0], "cpu")[0]
    ref = jax.tree.map(lambda x: x[0], je.upload_index([idx0]).shard)
    for name in ("latk", "latk_inv"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)))
    assert te.shard_occ_step(got) == je._shard_occ_step(ref) == 0
    idx = build_fm_index(g, EngineConfig(sa_rate=4))
    assert te.shard_occ_step(te.upload_index([idx], "cpu")[0]) == 3
    for sa_rate in (1, 4):
        shards, _ = build_sharded_index(g, 3, config=EngineConfig(sa_rate=sa_rate),
                                        overlap=64)
        got = te.upload_index(shards, "cpu")
        ref = je.upload_index(shards, stacked=False).shard
        assert len(got) == len(ref) == 3
        for a, b in zip(got, ref):
            _assert_shard_equal(a, b)
        assert (got[0].locv.shape[-1] > 1) == (sa_rate == 1)


def test_engine_cuda_has_no_cpu_fallback():
    idx = build_fm_index(random_genome(3000, seed=2), EngineConfig(sa_rate=4))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        te.Engine([idx], device="cuda")
