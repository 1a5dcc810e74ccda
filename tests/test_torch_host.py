"""bwtpu_torch's copies of bwtpu's numpy helpers are equal to the
originals, and its device Shard holds the same arrays as bwtpu's."""

import jax
import numpy as np
import pytest
import torch

import bwtpu.engine as je
import bwtpu.kernels.verify as jverify
import bwtpu.kernels.verify2 as jverify2
import bwtpu_torch.engine as te
import bwtpu_torch.kernels.verify as tverify
import bwtpu_torch.kernels.verify2 as tverify2
from bwtpu.config import EngineConfig
from bwtpu.index import build_fm_index
from bwtpu.simulate import random_genome

torch.set_num_threads(1)


def test_constants_equal():
    assert tverify2.NM_INVALID == jverify2.NM_INVALID
    assert tverify2.TEXT_ROW_STRIDE == jverify2.TEXT_ROW_STRIDE
    for L in range(1, 260):
        assert tverify2.window_row_width(L) == jverify2.window_row_width(L)


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


@pytest.mark.parametrize("sa_rate", [4, 8])
def test_shard_equal_to_bwtpu_upload(sa_rate):
    idx = build_fm_index(random_genome(5000, seed=sa_rate),
                         EngineConfig(sa_rate=sa_rate, read_len=60))
    ref = jax.tree.map(lambda x: x[0], je.upload_index([idx]).shard)
    got = te.upload_index([idx], torch.device("cpu"))
    for name in ("lattice", "latk", "latk_inv", "ssa", "C", "text_rows"):
        want = np.asarray(getattr(ref, name))
        have = getattr(got, name).numpy()
        assert have.dtype == want.dtype, name
        np.testing.assert_array_equal(have, want, err_msg=name)
    for name in ("dollar_row", "n", "text_len"):
        assert getattr(got, name) == int(getattr(ref, name)), name
    assert sorted(got.kmer_tables) == sorted(ref.kmer_tables)
    for dd, t in got.kmer_tables.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(ref.kmer_tables[dd]))


def test_upload_refuses_uncovered_indexes():
    g = random_genome(3000, seed=1)
    with pytest.raises(NotImplementedError, match="slice 2"):
        te.upload_index([build_fm_index(g, EngineConfig(sa_rate=1))], "cpu")
    with pytest.raises(NotImplementedError, match="slice 6"):
        te.upload_index([build_fm_index(g, EngineConfig(sa_rate=4, occ_step=0))], "cpu")
    idx = build_fm_index(g, EngineConfig(sa_rate=4))
    with pytest.raises(NotImplementedError, match="slice 5"):
        te.upload_index([idx, idx], "cpu")


def test_engine_cuda_has_no_cpu_fallback():
    idx = build_fm_index(random_genome(3000, seed=2), EngineConfig(sa_rate=4))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        te.Engine([idx], device="cuda")
