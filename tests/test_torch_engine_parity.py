"""bwtpu_torch.engine.Engine against bwtpu.engine.Engine on the block
path (dispatch_block -> finish_block): equal FlatHits — hit sets in
report order, truncation flags — and equal healing. Exact equality."""

import numpy as np
import pytest
import torch

import bwtpu.engine as je
import bwtpu_torch.engine as te
from bwtpu.config import EngineConfig
from bwtpu.index import build_fm_index
from bwtpu.readblock import ReadBlock
from bwtpu.simulate import adversarial_genome, random_genome, simulate_reads

torch.set_num_threads(1)


def _assert_flat_equal(got, want):
    assert got.n_reads == want.n_reads
    for name in ("read_idx", "pos", "strand_rev", "nm"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    if want.truncated is None:
        assert got.truncated is None
    else:
        np.testing.assert_array_equal(got.truncated, want.truncated)


def _run(engine, blk, k, pad_to=None):
    return engine.finish_block(engine.dispatch_block(blk, k, pad_to=pad_to))


@pytest.mark.parametrize("sa_rate", [4, 8])
def test_block_path_matches_bwtpu(sa_rate):
    genome = random_genome(30000, seed=sa_rate)
    cfg = EngineConfig(sa_rate=sa_rate, read_len=60, max_hits=8, max_cand=8)
    idx = build_fm_index(genome, cfg)
    reads, truth = simulate_reads(genome, 250, read_len=60, max_mismatches=2,
                                  n_frac=0.01, seed=sa_rate + 1)
    blk = ReadBlock.from_reads(reads)
    ej, et = je.Engine([idx]), te.Engine([idx], device="cpu")
    for k in (0, 2):
        want = _run(ej, blk, k, pad_to=300)
        got = _run(et, blk, k, pad_to=300)
        _assert_flat_equal(got, want)
        assert len(got.read_idx) > 0
    assert et.stats.reads == ej.stats.reads == 500
    assert et.stats.hits == ej.stats.hits


def _repeat_genome():
    """A 12 bp motif repeated 30 times inside random flanks: reads over
    the array carry ~30 true hits each."""
    motif = "ACGTGGTCAAGT"
    left, right = random_genome(800, seed=9), random_genome(800, seed=10)
    return left + motif * 30 + right, len(left)


@pytest.mark.parametrize("k", [0, 2])
def test_heals_match_bwtpu(k):
    genome, off = _repeat_genome()
    cfg = EngineConfig(sa_rate=4, max_hits=4, max_cand=4, loc_factor=1,
                       read_len=36, max_heals=4)
    idx = build_fm_index(genome, cfg)
    reads, _ = simulate_reads(genome, 40, read_len=36, max_mismatches=k, seed=3)
    reads[0] = reads[0].__class__("rep0", genome[off:off + 36], "I" * 36)
    blk = ReadBlock.from_reads(reads)
    ej, et = je.Engine([idx]), te.Engine([idx], device="cpu")
    want, got = _run(ej, blk, k), _run(et, blk, k)
    _assert_flat_equal(got, want)
    assert et.stats.heals == ej.stats.heals >= 1
    assert et.stats.overflow_reads == ej.stats.overflow_reads


def test_truncation_marks_match_bwtpu():
    """max_heals=0 on a repeat-heavy genome: the reads left capacity-cut
    carry the same truncation flags in both packages."""
    genome = adversarial_genome(12000, "tandem", seed=7)
    cfg = EngineConfig(sa_rate=4, max_hits=4, max_cand=4, loc_factor=1,
                       read_len=40, max_heals=0)
    idx = build_fm_index(genome, cfg)
    reads, _ = simulate_reads(genome, 120, read_len=40, max_mismatches=2, seed=8)
    blk = ReadBlock.from_reads(reads)
    ej, et = je.Engine([idx]), te.Engine([idx], device="cpu")
    for k in (0, 2):
        want, got = _run(ej, blk, k), _run(et, blk, k)
        _assert_flat_equal(got, want)
        assert got.truncated is not None and got.truncated.any()
    assert et.stats.heals == ej.stats.heals == 0
    assert et.stats.truncated_reads == ej.stats.truncated_reads > 0
    assert et.stats.compact_overflows == ej.stats.compact_overflows


@pytest.mark.parametrize("k,max_heals", [(0, 0), (2, 0), (2, 2)])
def test_finisher_capacity_matches_bwtpu(k, max_heals, monkeypatch):
    """A tandem-repeat genome leaves more unfinished lanes than the
    finisher's cap (max(256, B2 // 64) lanes of B2 = 800 read-strand
    rows): the lanes past it are forced empty and flagged, and the block
    heals or marks the reads truncated, as in bwtpu. 60 bp reads (not a
    multiple of 16) with N bases; at k = 2 seed slices at off > 0."""
    from bwtpu_torch.kernels import searchk

    flagged = []
    multistep = searchk.search_multistep

    def counting(*args):
        out = multistep(*args)
        flagged.append((int(out[10]), out[7].shape[0]))  # unfinished lanes, cap
        return out

    monkeypatch.setattr(searchk, "search_multistep", counting)
    genome = adversarial_genome(20000, "tandem", seed=11)
    cfg = EngineConfig(sa_rate=4, max_hits=8, max_cand=8, read_len=60, max_heals=max_heals)
    idx = build_fm_index(genome, cfg)
    reads, _ = simulate_reads(genome, 400, read_len=60, max_mismatches=k, n_frac=0.01,
                              seed=12)
    blk = ReadBlock.from_reads(reads)
    ej, et = je.Engine([idx]), te.Engine([idx], device="cpu")
    _assert_flat_equal(_run(et, blk, k), _run(ej, blk, k))
    assert et.stats.heals == ej.stats.heals
    assert et.stats.truncated_reads == ej.stats.truncated_reads
    assert any(n > cap for n, cap in flagged)
    assert et.stats.heals > 0 if max_heals else et.stats.truncated_reads > 0


def test_engine_refuses_uncovered_options():
    """What the port still refuses: block reads longer than read_len (as
    bwtpu does). Patterns shorter than every k-mer table
    (tests/test_torch_batch_parity.py), sa_rate == 1
    (tests/test_torch_locv.py) and several shards
    (tests/test_torch_shards.py) are covered now: an Engine over two
    shards holds one device Shard each."""
    g = random_genome(3000, seed=4)
    idx = build_fm_index(g, EngineConfig(sa_rate=4, read_len=40))
    long, _ = simulate_reads(g, 4, read_len=41)
    et = te.Engine([idx], device="cpu")
    with pytest.raises(ValueError, match="not in"):
        et.dispatch_block(ReadBlock.from_reads(long), 2)
    e1 = te.Engine([build_fm_index(g, EngineConfig(sa_rate=1))], device="cpu")
    assert e1.dev_shards[0].locv.shape[-1] > 1
    assert len(te.Engine([idx, idx], device="cpu").dev_shards) == 2
