"""The two kernel modules of bwtpu_torch against bwtpu, lane by lane.

CPU: the plain-torch versions (`locate_rows`, `verify_packed`, which the
wrappers run on CPU tensors) equal bwtpu's functions under both of its
backends — "pallas" (the Pallas kernels, in interpret mode off the TPU)
and "jnp" (their jnp twins). Exact equality: everything is integer.

The CUDA kernels against their plain versions on the card are in
tests/test_torch_gpu.py (no jax there: the card machine has none).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bwtpu.config import EngineConfig
from bwtpu.engine import upload_index
from bwtpu.index import build_fm_index
from bwtpu.kernels.locate import locate_rows as j_locate_rows
from bwtpu.kernels.verify2 import verify_packed as j_verify_packed
from bwtpu.simulate import random_genome, simulate_reads
from bwtpu_torch.kernels.locate import locate_rows, locate_walk
from bwtpu_torch.kernels.verify2 import pack_reads, verify_nm, verify_packed
from bwtpu import dna

torch.set_num_threads(1)

GENOME = random_genome(4000, seed=61)
READ_LEN = 60


@pytest.fixture(scope="module")
def indexes():
    out = {}
    for sa in (4, 8, 16):
        idx = build_fm_index(GENOME, EngineConfig(sa_rate=sa, read_len=READ_LEN))
        shard = jax.tree.map(lambda x: x[0], upload_index([idx]).shard)
        out[sa] = (idx, shard)
    return out


def _t(a):
    return torch.from_numpy(np.array(a))


def _locate_inputs(idx, n=300, seed=0):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, idx.n, size=n).astype(np.int32)
    rows[:4] = [idx.dollar_row, idx.n - 1, 0, 1]  # '$' row, last row
    valid = rng.random(n) < 0.85
    valid[:4] = True
    valid[4] = False
    return rows, valid


def _locate_args(idx):
    return (_t(idx.search_lattice), _t(idx.ssa), _t(idx.C), idx.dollar_row)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("sa_rate", [4, 8, 16])
def test_locate_rows_matches_bwtpu(indexes, sa_rate, backend):
    idx, shard = indexes[sa_rate]
    rows, valid = _locate_inputs(idx, seed=sa_rate)
    want = np.asarray(j_locate_rows(shard.lattice, shard.ssa, shard.C,
                                    shard.dollar_row, jnp.asarray(rows),
                                    jnp.asarray(valid), sa_rate, backend=backend))
    got = locate_rows(*_locate_args(idx), _t(rows), _t(valid), sa_rate).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[~valid] == -1).all()
    assert ((got[valid] >= 0) & (got[valid] <= idx.text_len)).all()


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_locate_rows_unfound_lanes_match_bwtpu(indexes, backend):
    """A walk shorter than the index's sampling leaves lanes unfound:
    both packages report ssa[0] + 0 for them."""
    idx, shard = indexes[16]
    rows, valid = _locate_inputs(idx, seed=5)
    want = np.asarray(j_locate_rows(shard.lattice, shard.ssa, shard.C,
                                    shard.dollar_row, jnp.asarray(rows),
                                    jnp.asarray(valid), 3, backend=backend))
    got = locate_rows(*_locate_args(idx), _t(rows), _t(valid), 3).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[valid] == idx.ssa[0]).sum() > 10


def _verify_inputs(idx, seed=0):
    """Candidates: true starts (small nm), random starts, < 0, past the
    text end, ob == 0 (multiples of 16) and the last valid start; reads
    with N bases and some shorter than L."""
    rng = np.random.default_rng(seed)
    reads, truth = simulate_reads(GENOME, 120, read_len=READ_LEN,
                                  max_mismatches=2, n_frac=0.02, seed=seed)
    codes = np.zeros((len(reads), READ_LEN), np.int32)
    amb = np.zeros((len(reads), READ_LEN), np.int32)
    for i, r in enumerate(reads):
        c, m = dna.encode_with_mask(r.seq)
        if truth[i]["strand"] == "-":
            c, m = dna.revcomp_codes(c, m)
        codes[i], amb[i] = c, m
    lens = np.full(len(reads), READ_LEN, np.int32)
    lens[::7] = rng.integers(20, READ_LEN, size=len(lens[::7]))
    rw, ab, lm = pack_reads(codes, amb, lens)
    n = len(reads)
    tl = idx.text_len
    cand = np.array([t["pos"] for t in truth], np.int32)
    cand[1::4] = rng.integers(-10, tl + 10, size=len(cand[1::4]))
    cand[2::8] = 16 * rng.integers(0, tl // 16, size=len(cand[2::8]))  # ob == 0
    cand[:5] = [-1, -16, tl - READ_LEN, tl - READ_LEN + 1, tl]
    cvalid = rng.random(n) < 0.9
    cvalid[:5] = True
    return cand, cvalid, rw, ab, lm, lens


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("sa_rate", [4, 16])
def test_verify_packed_matches_bwtpu(indexes, sa_rate, backend):
    idx, shard = indexes[sa_rate]
    cand, cvalid, rw, ab, lm, lens = _verify_inputs(idx, seed=sa_rate)
    want = np.asarray(jax.jit(j_verify_packed, static_argnames="backend")(
        shard.text_rows, shard.text_len, jnp.asarray(cand), jnp.asarray(cvalid),
        jnp.asarray(rw), jnp.asarray(ab), jnp.asarray(lm), jnp.asarray(lens),
        backend=backend))
    got = verify_packed(_t(np.asarray(shard.text_rows)), idx.text_len, _t(cand),
                        _t(cvalid), _t(rw), _t(ab), _t(lm), _t(lens)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 255).any() and (got <= 2).any() and (got[2::8] != 255).any()


def test_wrappers_take_the_plain_version_on_cpu(indexes):
    idx, _ = indexes[8]
    rows, valid = _locate_inputs(idx)
    before = locate_walk.launches
    np.testing.assert_array_equal(
        locate_walk(*_locate_args(idx), _t(rows), _t(valid), 8).numpy(),
        locate_rows(*_locate_args(idx), _t(rows), _t(valid), 8).numpy())
    assert locate_walk.launches == before
    cand, cvalid, rw, ab, lm, lens = _verify_inputs(idx)
    from bwtpu_torch.kernels.verify2 import build_text_rows

    args = (_t(build_text_rows(idx.text_packed, READ_LEN)), idx.text_len,
            _t(cand), _t(cvalid), _t(rw), _t(ab), _t(lm), _t(lens))
    before = verify_nm.launches
    np.testing.assert_array_equal(verify_nm(*args).numpy(), verify_packed(*args).numpy())
    assert verify_nm.launches == before
    with pytest.raises(NotImplementedError, match="slice 2"):
        locate_walk(*_locate_args(idx), _t(rows), _t(valid), 1)
