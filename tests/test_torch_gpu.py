"""bwtpu_torch's CUDA kernels against their plain-torch versions on the
card (marked `gpu`; each test skips without a CUDA device). This file
imports no jax, so it runs on a machine that has none:

    BWTPU_TEST_TPU=1 python -m pytest -o addopts="" -m gpu tests/test_torch_gpu.py

(BWTPU_TEST_TPU=1 keeps tests/conftest.py from importing jax.)
"""

import numpy as np
import pytest
import torch

from bwtpu import dna
from bwtpu.config import EngineConfig
from bwtpu.index import build_fm_index
from bwtpu.simulate import random_genome, simulate_reads
from bwtpu_torch.kernels.locate import locate_rows, locate_walk
from bwtpu_torch.kernels.verify2 import (build_text_rows, pack_reads, verify_nm,
                                         verify_packed)

GENOME = random_genome(200000, seed=71)
L = 100


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _t(a, dev):
    return torch.from_numpy(np.array(a)).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("sa_rate", [4, 8, 16])
def test_locate_walk_kernel_matches_plain(cuda, sa_rate):
    idx = build_fm_index(GENOME, EngineConfig(sa_rate=sa_rate))
    rng = np.random.default_rng(sa_rate)
    rows = rng.integers(0, idx.n, size=50000).astype(np.int32)
    rows[:4] = [idx.dollar_row, idx.n - 1, 0, 1]
    valid = rng.random(rows.size) < 0.9
    args = [_t(a, cuda) for a in (idx.search_lattice, idx.ssa, idx.C)]
    for trips in (sa_rate, 3):  # 3 trips leaves lanes unfound: ssa[0] + 0
        got = locate_walk(*args, idx.dollar_row, _t(rows, cuda), _t(valid, cuda), trips)
        want = locate_rows(*args, idx.dollar_row, _t(rows, cuda), _t(valid, cuda), trips)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.gpu
def test_verify_nm_kernel_matches_plain(cuda):
    idx = build_fm_index(GENOME, EngineConfig(sa_rate=8))
    reads, truth = simulate_reads(GENOME, 4000, read_len=L, max_mismatches=2,
                                  n_frac=0.01, seed=3)
    codes = np.zeros((len(reads), L), np.int32)
    amb = np.zeros((len(reads), L), np.int32)
    for i, r in enumerate(reads):
        codes[i], amb[i] = dna.encode_with_mask(r.seq)
    rng = np.random.default_rng(4)
    lens = np.full(len(reads), L, np.int32)
    lens[::5] = rng.integers(30, L, size=len(lens[::5]))
    rw, ab, lm = pack_reads(codes, amb, lens)
    tl = idx.text_len
    cand = np.array([t["pos"] for t in truth], np.int32)
    cand[1::3] = rng.integers(-20, tl + 20, size=len(cand[1::3]))
    cand[2::6] &= ~15  # bit phase 0
    cand[:4] = [-1, tl - L, tl - L + 1, tl]
    cvalid = rng.random(len(cand)) < 0.9
    args = [_t(build_text_rows(idx.text_packed, L), cuda), tl]
    args += [_t(a, cuda) for a in (cand, cvalid, rw, ab, lm, lens)]
    got = verify_nm(*args)
    want = verify_packed(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert (want != 255).any() and (want <= 2).any()
