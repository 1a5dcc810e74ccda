"""bwtpu_torch's fused multi-shard dispatch (Engine(fuse_shards=True): every
shard's pipeline as one program, its outputs in one int32 buffer) against
bwtpu's fused list form (Engine(vmap_shards=False, fuse_shards=True)) on
tests/test_unstacked.py's setup (9,000 bp, 3 shards, overlap 64, sa_rate
4, read_len 50): equal FlatHits (hit sets and truncation flags) and
BatchStats at k = 0 and 2, tiered, a heal at binding caps, autotune_caps
through it, and four blocks in flight. On the CPU the fused program runs
eagerly; its CUDA graph is held against the loop form on the card
(tests/test_torch_gpu.py)."""

import dataclasses

import numpy as np
import pytest
import torch

import bwtpu.engine as je
import bwtpu_torch.engine as te
from bwtpu.config import EngineConfig
from bwtpu.index import build_sharded_index
from bwtpu.readblock import ReadBlock
from bwtpu.simulate import random_genome, simulate_reads

torch.set_num_threads(1)

CFG = EngineConfig(sa_rate=4, max_hits=8, max_cand=8, read_len=50, min_trips=1)
GENOME = random_genome(9000, seed=21)


def _shards(genome=GENOME, cfg=CFG):
    return build_sharded_index(genome, 3, config=cfg, overlap=64)[0]


def _engines(shards):
    return (je.Engine(shards, vmap_shards=False, fuse_shards=True),
            te.Engine(shards, device="cpu", fuse_shards=True))


def _stats(engine):
    st = engine.stats
    return (st.reads, st.hits, st.overflow_reads, st.compact_overflows, st.heals,
            st.truncated_reads, st.escalated)


def _assert_flat_equal(got, want):
    assert got.n_reads == want.n_reads
    for name in ("read_idx", "pos", "strand_rev", "nm"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    if want.truncated is None:
        assert got.truncated is None
    else:
        np.testing.assert_array_equal(got.truncated, want.truncated)


def _fused_handle(engine, blk, k, **kw):
    """dispatch_block, asserting that the fused form is what ran."""
    handle = engine.dispatch_block(blk, k, **kw)
    assert isinstance(handle[4], tuple) and handle[4][0] == "fused"
    assert handle[4][1].dtype == torch.int32 and handle[4][1].dim() == 1
    assert len(handle[4][2]) == 3  # one shape list per shard
    return handle


def _run(engine, blk, k, **kw):
    return engine.finish_block(engine.dispatch_block(blk, k, **kw))


@pytest.fixture(scope="module")
def reads():
    """12 exact reads and 12 with up to 2 substitutions and N bases."""
    exact = simulate_reads(GENOME, 12, read_len=50, seed=22)[0]
    return exact + simulate_reads(GENOME, 12, read_len=50, max_mismatches=2, n_frac=0.01,
                                  seed=25)[0]


@pytest.mark.parametrize("k", [0, 2])
def test_fused_hits_match_bwtpu_fused(reads, k):
    """"hits" mode over 3 shards through the fused program."""
    ej, et = _engines(_shards())
    blk = ReadBlock.from_reads(reads)
    handle = _fused_handle(et, blk, k, pad_to=32)
    assert handle[6] == "hits"
    got, want = et.finish_block(handle), _run(ej, blk, k, pad_to=32)
    _assert_flat_equal(got, want)
    assert len(got.read_idx) >= (20 if k else 10)
    assert _stats(et) == _stats(ej)
    assert et._cand_live_frac == pytest.approx(ej._cand_live_frac)
    assert et._hit_live_frac == pytest.approx(ej._hit_live_frac)


def test_fused_tiered_matches_bwtpu_fused(reads):
    """The tiered dispatch through the fused program: `escalated` counts
    per shard (C.2), as in bwtpu."""
    ej, et = _engines(_shards())
    blk = ReadBlock.from_reads(reads)
    handle = _fused_handle(et, blk, 2, pad_to=32, tiered=True)
    assert handle[6] == "tiered"
    _assert_flat_equal(et.finish_block(handle), _run(ej, blk, 2, pad_to=32, tiered=True))
    assert _stats(et) == _stats(ej) and et.stats.escalated > len(reads)


@pytest.mark.parametrize("k,tiered,max_heals", [(0, False, 6), (2, False, 6), (2, True, 6),
                                                (2, False, 0)])
def test_fused_heals_match_bwtpu_fused(k, tiered, max_heals):
    """test_unstacked_fused_healing's repeat genome at binding caps: the
    fused program overflows and heals through the fused form at the
    doubled level, as bwtpu's does; without heals the truncation flags
    agree."""
    rep = GENOME[:120] * 5 + GENOME[:3000]
    cfg = EngineConfig(sa_rate=4, max_hits=2, max_cand=2, read_len=50, loc_factor=0.5,
                       min_trips=1, max_heals=max_heals)
    ej, et = _engines(_shards(rep, cfg))
    reads, _ = simulate_reads(rep, 12, read_len=50, max_mismatches=k, seed=23)
    blk = ReadBlock.from_reads(reads)
    got = et.finish_block(_fused_handle(et, blk, k, pad_to=16, tiered=tiered))
    _assert_flat_equal(got, _run(ej, blk, k, pad_to=16, tiered=tiered))
    assert _stats(et) == _stats(ej)
    if max_heals:
        assert et.stats.heals >= 1
    else:
        assert et.stats.truncated_reads > 0 and et.stats.heals == 0


def test_fused_autotune_matches_bwtpu_fused(reads):
    """autotune_caps through the fused form: the occupancy channel rides
    the one packed fetch; the tuned caps equal bwtpu's."""
    loose = [dataclasses.replace(s, config=s.config.replace(loc_factor=6)) for s in _shards()]
    ej, et = _engines(loose)
    blk = ReadBlock.from_reads(reads)
    lf = et.autotune_caps(blk, 2, pad_to=32)
    assert lf == ej.autotune_caps(blk, 2, pad_to=32) < 6
    assert et._hf(2) == ej._hf(2)
    got = et.finish_block(_fused_handle(et, blk, 2, pad_to=32))
    _assert_flat_equal(got, _run(ej, blk, 2, pad_to=32))
    assert _stats(et) == _stats(ej)


@pytest.mark.parametrize("k,tiered", [(0, False), (2, False), (2, True)])
def test_four_fused_blocks_in_flight(k, tiered):
    """Four handles dispatched before the first finish_block (the CLI keeps
    up to four in flight): each equals bwtpu's block, and the stats add up
    to bwtpu's."""
    ej, et = _engines(_shards())
    blks = [ReadBlock.from_reads(simulate_reads(GENOME, 20, read_len=50, max_mismatches=2,
                                                n_frac=0.01, seed=40 + i)[0])
            for i in range(4)]
    handles = [_fused_handle(et, b, k, pad_to=32, tiered=tiered) for b in blks]
    for b, h in zip(blks, handles):
        _assert_flat_equal(et.finish_block(h), _run(ej, b, k, pad_to=32, tiered=tiered))
    assert _stats(et) == _stats(ej)


@pytest.mark.parametrize("k,tiered", [(0, False), (2, False), (2, True)])
def test_fused_equals_the_loop_form(reads, k, tiered):
    """The same Engine with and without fuse_shards: equal FlatHits, stats
    and occupancy channel; the loop form keeps one list per shard."""
    shards = _shards()
    blk = ReadBlock.from_reads(reads)
    loop, fused = te.Engine(shards, device="cpu"), te.Engine(shards, device="cpu",
                                                             fuse_shards=True)
    handle = loop.dispatch_block(blk, k, pad_to=32, tiered=tiered)
    assert isinstance(handle[4], list) and len(handle[4]) == 3
    _assert_flat_equal(loop.finish_block(handle), _run(fused, blk, k, pad_to=32,
                                                       tiered=tiered))
    assert _stats(loop) == _stats(fused)
    assert loop._cand_live_frac == fused._cand_live_frac


HEAL_CFG = EngineConfig(sa_rate=4, max_hits=2, max_cand=2, read_len=50, loc_factor=0.5,
                        min_trips=1)


@pytest.mark.parametrize("caps", ["defaults", "binding"])
@pytest.mark.parametrize("fuse", [False, True], ids=["loop", "fused"])
@pytest.mark.parametrize("k,tiered", [(0, False), (2, False), (2, True)],
                         ids=["hits_k0", "hits_k2", "tiered"])
def test_prep_runs_once_a_block(reads, monkeypatch, k, tiered, fuse, caps):
    """A 3-shard engine preps a block once for every shard: one
    device_prep_packed call a dispatched block (counted by monkeypatch; a
    heal dispatches the block again), the in-place call on the block's
    stacked planes (the reads in rows [0, Bp)), in the loop and the fused
    form; hits, truncation flags and BatchStats equal bwtpu's list form
    (at binding caps, with heals)."""
    genome, cfg = (GENOME, CFG) if caps == "defaults" else (GENOME[:120] * 5 + GENOME[:3000],
                                                            HEAL_CFG)
    shards = _shards(genome, cfg)
    if caps == "binding":
        reads = simulate_reads(genome, 12, read_len=50, max_mismatches=k, seed=23)[0]
    ej = je.Engine(shards, vmap_shards=False, fuse_shards=fuse)
    et = te.Engine(shards, device="cpu", fuse_shards=fuse)
    calls = []
    prep = te.device_prep_packed

    def counted(*args):
        rw2, ab2 = args[3]
        Bp = rw2.shape[0] // 2
        calls.append(args[0].data_ptr() == rw2.data_ptr() and args[1].data_ptr()
                     == ab2.data_ptr() and args[0].shape[0] == Bp)
        return prep(*args)

    monkeypatch.setattr(te, "device_prep_packed", counted)
    blk = ReadBlock.from_reads(reads)
    handle = et.dispatch_block(blk, k, pad_to=32, tiered=tiered)
    assert isinstance(handle[4], tuple) == fuse
    _assert_flat_equal(et.finish_block(handle), _run(ej, blk, k, pad_to=32, tiered=tiered))
    assert _stats(et) == _stats(ej)
    assert calls == [True] * (1 + et.stats.heals)
    assert caps == "defaults" or et.stats.heals >= 1


def test_one_shard_takes_the_loop_form(reads):
    """As in bwtpu, the fused form applies only with more than one shard."""
    eng = te.Engine(_shards()[:1], device="cpu", fuse_shards=True)
    handle = eng.dispatch_block(ReadBlock.from_reads(reads), 0, pad_to=32)
    assert isinstance(handle[4], list) and len(handle[4]) == 1


@pytest.mark.parametrize("L", [1, 16, 50, 100, 101])
def test_cached_length_mask(L):
    """The length mask is made once per (L, device) and equals
    _len_mask_words; device_prep_packed's rows carry it."""
    mask = te._len_mask(L, torch.device("cpu"))
    np.testing.assert_array_equal(mask.numpy(), te._len_mask_words(L))
    assert te._len_mask(L, torch.device("cpu")) is mask
    W = -(-L // 16)
    rw = torch.zeros((3, W), dtype=torch.int32)
    lm2 = te.device_prep_packed(rw, rw, L)[3]
    assert lm2.shape == (6, W) and (lm2 == mask).all()


@pytest.mark.parametrize("n", [1, 31, 32, 33, 100, 2048])
def test_overflow_bitmap_round_trip(n):
    """The per-row overflow flags ride the packed buffer as a bitmap."""
    flags = torch.from_numpy(np.random.default_rng(n).random(n) < 0.3)
    words = te._bitmap(flags)
    assert words.dtype == torch.int32 and words.shape == (-(-n // 32),)
    np.testing.assert_array_equal(te._unbits(words.numpy(), n), flags.numpy())


def test_launches_recorded_into_a_graph_are_tallied_not_counted():
    """A launch made while a CUDA graph is captured (_build.recording) is
    recorded into the graph, not run: it is tallied by kernel name and no
    counter moves; a launch after the capture counts again."""
    from bwtpu_torch.kernels import _build
    from bwtpu_torch.kernels.locate import locate_walk

    before = locate_walk.launches
    with _build.recording() as tally:
        _build.count_launch(locate_walk)
        _build.count_launch(locate_walk)
    assert tally == {"locate_walk": 2} and locate_walk.launches == before
    _build.count_launch(locate_walk)
    assert locate_walk.launches == before + 1


@pytest.mark.parametrize("kernel,names,want", [
    ("search_multistep", ["void (anonymous namespace)::multistep_kernel<3, 4>(int4 const*)",
                          "(anonymous namespace)::exit_kernel(int const*, int)"], 1),
    ("verify_nm", ["void verify_nm_kernel<20, true>(int const*)", "verify_nm_wide_kernel(int)",
                   "at::native::vectorized_elementwise_kernel<4>"], 2),
    ("search_chain2", ["chain2_packed_kernel(int4 const*)", "chain2_planes_kernel(int)",
                       "my_chain2_packed_kernel_x"], 2),
    ("compact_slots", ["(anonymous namespace)::compact_slots_kernel(int const*, int, int*)",
                       "(anonymous namespace)::compact_slots_tiles_kernel(int const*, int)",
                       "Memset (Device)"], 2),
    ("compact_mask", ["(anonymous namespace)::compact_mask_kernel(bool const*, int, bool*)",
                      "(anonymous namespace)::compact_mask_tiles_kernel(bool const*, int)",
                      "my_compact_mask_kernel_x"], 2),
    ("revcomp_both", ["void (anonymous namespace)::revcomp_both_kernel<7, false>(unsigned "
                      "int const*, unsigned int const*, int, int, int, int, int)",
                      "void (anonymous namespace)::revcomp_both_kernel<0, true>(int)",
                      "(anonymous namespace)::revcomp_both_kernel(unsigned int const*)",
                      "at::native::revcomp_both_kernel_x"], 3),
])
def test_launches_in_trace_by_kernel_name(kernel, names, want):
    """A trace's device kernel names map to the wrapper that launches them,
    one event for each launch; other kernels are not counted."""
    from bwtpu_torch.kernels import _build

    got = _build.launches_in_trace(names)
    assert got[kernel] == want and sum(got.values()) == want
