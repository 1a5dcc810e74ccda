"""The two kernel modules of bwtpu_torch against bwtpu, lane by lane.

CPU: the plain-torch versions (`locate_rows`, `verify_packed`,
`verify_nm_plain`, which the wrappers run on CPU tensors) equal bwtpu's
functions under both of its backends — "pallas" (the Pallas kernels, in interpret mode off the TPU)
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
from bwtpu.kernels.common import select_lane as j_select_lane
from bwtpu.kernels.verify2 import verify_packed as j_verify_packed
from bwtpu.simulate import random_genome, simulate_reads
from bwtpu_torch.kernels.locate import locate_rows, locate_walk
from bwtpu_torch.kernels.verify2 import (build_text_rows, pack_reads, verify_nm,
                                         verify_nm_plain, verify_packed)
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


def _sel_count(n_rows, cap, count, seed):
    """(sel int32[cap], count): distinct rows for the first `count` slots
    and row 0 beyond, as compact_counts hands them over."""
    rng = np.random.default_rng(seed)
    sel = np.zeros(cap, np.int32)
    sel[:count] = rng.choice(n_rows, count, replace=False)
    return _t(sel), torch.tensor(count, dtype=torch.int32)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("count", [0, 150, 300])
def test_locate_walk_matches_bwtpu(indexes, backend, count):
    """locate_walk's argument form (the flat rows, sel and a device count)
    against bwtpu's locate_rows on the gathered rows: count = 0, a
    partial count and count = cap."""
    idx, shard = indexes[8]
    rows, _ = _locate_inputs(idx, n=500, seed=count)
    sel, cnt = _sel_count(len(rows), 300, count, seed=count)
    valid = np.arange(300) < count
    want = np.asarray(j_locate_rows(shard.lattice, shard.ssa, shard.C, shard.dollar_row,
                                    jnp.asarray(rows[sel.numpy()]), jnp.asarray(valid), 8,
                                    backend=backend))
    got = locate_walk(*_locate_args(idx), _t(rows), sel, cnt, 8).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[count:] == -1).all()


MAX_LOC = 4


def _compacted_candidates(idx, n_slots: int, count: int, seed: int):
    """verify_nm's argument form: read-level rows of B2 reads (N bases,
    some shorter than L), n_slots seed offsets per read (some past the
    read's end), and `count` compacted candidate slots in compact order
    over lanes' MAX_LOC slots, located at: the read's true start + its
    seed offset (small nm), random positions, -1 (lost in locate), bit
    phase 0, and the last two starts text_len - L and text_len - L + 1.
    Slots past count hold sel 0 and spos -1, as compact_counts and
    locate_walk leave them."""
    rng = np.random.default_rng(seed)
    cand, _, rw, ab, lm, lens = _verify_inputs(idx, seed=seed)
    B2, tl = len(lens), idx.text_len
    seed_off = rng.integers(0, READ_LEN, size=(B2, n_slots)).astype(np.int32)
    seed_off[::9, -1] = READ_LEN + rng.integers(1, 20, size=len(seed_off[::9]))
    cap = 300
    sel = np.zeros(cap, np.int32)
    sel[:count] = np.sort(rng.choice(B2 * n_slots * MAX_LOC, count, replace=False))
    b = sel // MAX_LOC // n_slots
    off = seed_off.reshape(-1)[sel // MAX_LOC]
    start = cand[b].astype(np.int64)
    start[1::4] = rng.integers(-10, tl + 10, size=len(start[1::4]))
    start[2::8] = 16 * rng.integers(0, tl // 16, size=len(start[2::8]))  # ob == 0
    start[3:5] = [tl - READ_LEN, tl - READ_LEN + 1]
    spos = (start + off).astype(np.int32)
    spos[5::13] = -1
    spos[count:] = -1
    return (_t(build_text_rows(idx.text_packed, READ_LEN)), tl, _t(spos), _t(sel),
            torch.tensor(count, dtype=torch.int32), _t(seed_off.reshape(-1)), _t(rw),
            _t(ab), _t(lm), _t(lens), MAX_LOC, n_slots)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("n_slots", [1, 3])
@pytest.mark.parametrize("count", [0, 170, 300])
def test_verify_nm_matches_bwtpu(indexes, backend, n_slots, count):
    """verify_nm's argument form (positions, sel, a device count, seed
    offsets and the read-level rows) against bwtpu's candidate stage
    (engine.py:523-541, 560-566): the fused read row taken by b_idx, the
    seed offset by one-hot, then verify_packed; slot for slot, the slots
    past count included."""
    idx, shard = indexes[8]
    args = _compacted_candidates(idx, n_slots, count, seed=count + n_slots)
    _, tl, spos, sel, cnt, seed_off, rw, ab, lm, lens, max_loc, nS = args
    W = rw.shape[1]
    lane = sel.numpy() // max_loc
    b_idx = lane // nS
    fused = jnp.concatenate([jnp.asarray(rw), jnp.asarray(ab), jnp.asarray(lm),
                             jnp.asarray(lens)[:, None],
                             jnp.asarray(seed_off).reshape(-1, nS)], axis=1)
    fc = jnp.take(fused, jnp.asarray(b_idx), axis=0)
    off_l = (j_select_lane(fc[:, 3 * W + 1:], jnp.asarray(lane - b_idx * nS), nS)
             if nS > 1 else fc[:, 3 * W + 1])
    want_cand = jnp.asarray(spos) - off_l
    sel_valid = jnp.arange(sel.shape[0]) < count
    want_nm = jax.jit(j_verify_packed, static_argnames="backend")(
        shard.text_rows, shard.text_len, want_cand, sel_valid & (jnp.asarray(spos) >= 0),
        fc[:, :W], fc[:, W:2 * W], fc[:, 2 * W:3 * W], fc[:, 3 * W], backend=backend)
    before = verify_nm.launches
    cand, nm = verify_nm(*args)
    assert verify_nm.launches == before
    np.testing.assert_array_equal(cand.numpy(), np.asarray(want_cand))
    np.testing.assert_array_equal(nm.numpy(), np.asarray(want_nm))
    assert (nm.numpy()[count:] == 255).all()
    if count:
        assert (nm.numpy() <= 2).any() and (nm.numpy()[:count] == 255).any()


def test_wrappers_take_the_plain_version_on_cpu(indexes):
    idx, _ = indexes[8]
    rows, _ = _locate_inputs(idx)
    sel, cnt = _sel_count(len(rows), 200, 170, seed=1)
    before = locate_walk.launches
    np.testing.assert_array_equal(
        locate_walk(*_locate_args(idx), _t(rows), sel, cnt, 8).numpy(),
        locate_rows(*_locate_args(idx), _t(rows).index_select(0, sel),
                    torch.arange(200) < 170, 8).numpy())
    assert locate_walk.launches == before
    args = _compacted_candidates(idx, 3, 170, seed=1)
    before = verify_nm.launches
    for a, b in zip(verify_nm(*args), verify_nm_plain(*args)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert verify_nm.launches == before
    with pytest.raises(ValueError, match="no kernel for device meta"):
        verify_nm(*(a.to("meta") if isinstance(a, torch.Tensor) else a for a in args))
    # sa_rate 1: one ssa gather on any device, as in bwtpu; no kernel
    idx1 = build_fm_index(GENOME, EngineConfig(sa_rate=1, read_len=READ_LEN))
    shard1 = jax.tree.map(lambda x: x[0], upload_index([idx1]).shard)
    before = locate_walk.launches
    got = locate_walk(*_locate_args(idx1), _t(rows), sel, cnt, 1).numpy()
    assert locate_walk.launches == before
    np.testing.assert_array_equal(got, np.where(np.arange(200) < 170,
                                                idx1.ssa[rows[sel.numpy()]], -1))
    np.testing.assert_array_equal(got, np.asarray(j_locate_rows(
        shard1.lattice, shard1.ssa, shard1.C, shard1.dollar_row,
        jnp.asarray(rows[sel.numpy()]), jnp.asarray(np.arange(200) < 170), 1)))


# entry points of the kernel libraries that launch nothing (sizes, queries,
# the error name); l2_fetch_granularity is documented to act on the
# current device
NOT_LAUNCHES = {"bwtpu_compact_tile", "bwtpu_compact_cluster_query", "bwtpu_searchk_exit_tile",
                "bwtpu_sw_max_band", "bwtpu_l2_fetch_granularity",
                "bwtpu_cuda_error_name"}


def _kernel_modules():
    """(path, source) of every module of the port that loads a kernel
    library (`_build.library`)."""
    import glob
    import os

    from bwtpu_torch.kernels import _build

    pkg = os.path.dirname(os.path.dirname(os.path.abspath(_build.__file__)))
    for path in sorted(glob.glob(os.path.join(pkg, "**", "*.py"), recursive=True)):
        with open(path) as f:
            src = f.read()
        if "_build.library(" in src or path.endswith("_build.py"):
            yield path, src


def test_every_kernel_launch_goes_through_the_device_guard():
    """C.8: every kernel launch of the port goes through _build.call,
    which makes the tensor's device current around the ctypes call and
    passes that device's current stream. No other code reads a CUDA
    stream handle, and in the modules that load a kernel library no entry
    point that launches is called directly: it is passed to
    _build.launch / _build.call."""
    import ast

    from bwtpu_torch.kernels import _build

    modules = dict(_kernel_modules())
    assert len(modules) >= 9, sorted(modules)
    for path, src in modules.items():
        tree = ast.parse(src)
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) and node.attr == "cuda_stream":
                assert path == _build.__file__, f"{path}:{node.lineno} reads a stream handle"
        for scope in [tree] + [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)]:
            bound = {}  # the scope's names of entry points: f = lib.bwtpu_x
            for node in ast.walk(scope):
                if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Attribute)
                        and node.value.attr.startswith("bwtpu_")):
                    bound.update((t.id, node.value.attr) for t in node.targets
                                 if isinstance(t, ast.Name))
            for node in ast.walk(scope):
                if not isinstance(node, ast.Call):
                    continue
                fn = node.func
                name = (fn.attr if isinstance(fn, ast.Attribute)
                        and fn.attr.startswith("bwtpu_")
                        else bound.get(fn.id) if isinstance(fn, ast.Name) and scope is not tree
                        else None)
                assert name is None or name in NOT_LAUNCHES, \
                    f"{path}:{node.lineno}: {name} called outside _build.launch"
    guard = ast.parse(modules[_build.__file__])
    call = next(n for n in guard.body if isinstance(n, ast.FunctionDef) and n.name == "call")
    reads = [n for n in ast.walk(guard) if isinstance(n, ast.Attribute)
             and n.attr == "cuda_stream"]
    assert reads and all(call.lineno <= n.lineno <= call.end_lineno for n in reads)
    with_device = [n for n in ast.walk(call) if isinstance(n, ast.With)]
    assert with_device and "torch.cuda.device" in ast.unparse(with_device[0].items[0])
