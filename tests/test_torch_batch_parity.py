"""bwtpu_torch.engine.Engine against bwtpu.engine.Engine on the Read-list
path (align_batch, align_all: equal list[list[Hit]] and BatchStats
counts) and on the block path's "compact" and "dense" output modes
(equal FlatHits and truncation flags). Exact equality."""

import numpy as np
import pytest
import torch

import bwtpu.engine as je
import bwtpu_torch.engine as te
from bwtpu.config import EngineConfig
from bwtpu.index import build_fm_index
from bwtpu.io import Read
from bwtpu.readblock import ReadBlock
from bwtpu.simulate import random_genome, simulate_reads

torch.set_num_threads(1)


def _hits(lists):
    """Per-read hit lists as (nm, strand, pos) tuples: each package has
    its own Hit class, so the lists compare by value."""
    return [[(h.nm, h.strand, h.pos) for h in hs] for hs in lists]


GENOME = random_genome(30000, seed=13)
CFG = EngineConfig(sa_rate=4, read_len=60, max_hits=8, max_cand=8)


@pytest.fixture(scope="module")
def index():
    return build_fm_index(GENOME, CFG)


def _mixed_reads(genome, lengths, n_each, seed, **kw):
    """Reads of several lengths, shuffled with the seed."""
    reads = []
    for L in lengths:
        reads += simulate_reads(genome, n_each, read_len=L, seed=seed + L, **kw)[0]
    order = np.random.default_rng(seed).permutation(len(reads))
    return [Read(f"m{i}", reads[j].seq, reads[j].qual) for i, j in enumerate(order)]


def _stats(engine):
    st = engine.stats
    return (st.reads, st.hits, st.overflow_reads, st.compact_overflows, st.heals)


def _assert_flat_equal(got, want):
    assert got.n_reads == want.n_reads
    for name in ("read_idx", "pos", "strand_rev", "nm"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    if want.truncated is None:
        assert got.truncated is None
    else:
        np.testing.assert_array_equal(got.truncated, want.truncated)


@pytest.mark.parametrize("k", [0, 2])
@pytest.mark.parametrize("lengths", [(30, 41, 60), (60,)], ids=["mixed", "uniform"])
def test_align_batch_and_align_all_match_bwtpu(index, k, lengths):
    """Mixed lengths run encode_batch + the 1-step pipelines (dense);
    uniform ones the packed pipelines (compact)."""
    reads = _mixed_reads(GENOME, lengths, 90 // len(lengths), seed=k + 3,
                         max_mismatches=2, n_frac=0.01)
    ej, et = je.Engine([index]), te.Engine([index], device="cpu")
    want = ej.align_batch(reads, k)
    assert _hits(et.align_batch(reads, k)) == _hits(want)
    assert sum(map(len, want)) > len(reads) // 8
    assert (_hits(et.align_all(reads, k, batch_size=45))
            == _hits(ej.align_all(reads, k, batch_size=45)))
    assert _stats(et) == _stats(ej)


def _repeat_genome():
    """A 12 bp motif repeated 30 times inside random flanks: reads over
    the array carry ~30 true hits each."""
    motif = "ACGTGGTCAAGT"
    left, right = random_genome(800, seed=9), random_genome(800, seed=10)
    return left + motif * 30 + right, len(left)


@pytest.mark.parametrize("k,max_heals", [(0, 4), (2, 4), (2, 0)])
def test_read_list_heals_match_bwtpu(k, max_heals):
    genome, off = _repeat_genome()
    cfg = EngineConfig(sa_rate=4, max_hits=4, max_cand=4, loc_factor=1, read_len=36,
                       max_heals=max_heals)
    idx = build_fm_index(genome, cfg)
    reads = _mixed_reads(genome, (28, 36), 20, seed=5, max_mismatches=k)
    reads[0] = Read("rep0", genome[off:off + 30], "I" * 30)
    ej, et = je.Engine([idx]), te.Engine([idx], device="cpu")
    assert _hits(et.align_batch(reads, k)) == _hits(ej.align_batch(reads, k))
    assert _stats(et) == _stats(ej)
    if max_heals:
        assert et.stats.heals >= 1
    else:
        assert et.stats.heals == 0 and et.stats.overflow_reads > 0


def _run(engine, blk, k, pad_to=None):
    return engine.finish_block(engine.dispatch_block(blk, k, pad_to=pad_to))


@pytest.mark.parametrize("k", [0, 2])
def test_dense_block_mode_without_multistep_lattice(k):
    """An index built with occ_step=0 has no multi-step lattice: the block
    path runs the 1-step fallback (device_prep_uniform) in "dense" mode."""
    idx = build_fm_index(GENOME, CFG.replace(occ_step=0))
    assert te.shard_occ_step(te.upload_index([idx], "cpu")[0]) == 0
    reads, _ = simulate_reads(GENOME, 100, read_len=60, max_mismatches=2,
                              n_frac=0.01, seed=k + 7)
    blk = ReadBlock.from_reads(reads)
    ej, et = je.Engine([idx]), te.Engine([idx], device="cpu")
    handle = et.dispatch_block(blk, k, pad_to=128)
    assert handle[6] == "dense"
    got, want = et.finish_block(handle), _run(ej, blk, k, pad_to=128)
    _assert_flat_equal(got, want)
    assert len(got.read_idx) > 10
    assert _stats(et) == _stats(ej)


@pytest.mark.parametrize("k,L", [(0, 3), (2, 10)])
def test_dense_block_mode_for_patterns_shorter_than_every_table(index, k, L):
    """d = 0: every lane starts at [0, n) and straggles on step 0; the
    capped fixup, the heals and the truncation marks match bwtpu."""
    reads, _ = simulate_reads(GENOME, 40, read_len=L, seed=L)
    blk = ReadBlock.from_reads(reads)
    ej, et = je.Engine([index]), te.Engine([index], device="cpu")
    got, want = _run(et, blk, k), _run(ej, blk, k)
    _assert_flat_equal(got, want)
    assert got.truncated is not None and got.truncated.any()
    assert _stats(et) == _stats(ej)
    assert et.stats.truncated_reads == ej.stats.truncated_reads > 0


@pytest.mark.parametrize("k", [0, 2])
def test_compact_block_mode_matches_bwtpu(index, monkeypatch, k):
    """When sel * 4 + nm would overflow int32 the block path falls to
    "compact" mode, as bwtpu does; its FlatHits equal bwtpu's."""
    reads, _ = simulate_reads(GENOME, 100, read_len=60, max_mismatches=2,
                              n_frac=0.01, seed=k + 11)
    blk = ReadBlock.from_reads(reads)
    ej, et = je.Engine([index]), te.Engine([index], device="cpu")
    monkeypatch.setattr(te, "HIT_PAYLOAD_MAX", 1)
    handle = et.dispatch_block(blk, k, pad_to=128)
    assert handle[6] == "compact"
    _assert_flat_equal(et.finish_block(handle), _run(ej, blk, k, pad_to=128))
    assert _stats(et) == _stats(ej)


@pytest.mark.parametrize("L", [60, 80, 100])
def test_reads_longer_than_read_len_lose_hits_as_in_bwtpu(L):
    """Reference fault C.5, kept: Read-list reads longer than the index's
    read_len are verified against text windows built for read_len, so
    at k > 0 some lose their true hit past ~read_len + 28 bases. The
    found counts (and the hit lists) equal bwtpu's at each length; the
    loss shows at 100 bp against an index built for 40."""
    idx = build_fm_index(GENOME, CFG.replace(read_len=40))
    reads, truth = simulate_reads(GENOME, 60, read_len=L, seed=L + 1)
    ej, et = je.Engine([idx]), te.Engine([idx], device="cpu")
    got, want = et.align_batch(reads, 2), ej.align_batch(reads, 2)
    assert _hits(got) == _hits(want)

    def found(lists):
        return sum(any(h.pos == t["pos"] and h.strand == t["strand"] for h in hs)
                   for t, hs in zip(truth, lists))

    assert found(got) == found(want)
    assert found(got) == 60 if L == 60 else (L < 100 or found(got) < 60)
    assert _stats(et) == _stats(ej)


def test_read_list_writes_no_truncation_mark_as_in_bwtpu():
    """Reference fault C.6, kept: with healing off, a capacity-cut input
    gets xo:i:1 marks through the block path (FlatHits.truncated ->
    samfast.emit_single) and none through the Read-list path
    (finish_batch counts the reads as overflow_reads; emit_sam has no
    mark). Each SAM equals bwtpu's byte for byte."""
    import io as sio

    from bwtpu.results import ContigTable, select_primary_flat
    from bwtpu.samfast import emit_single as j_emit_single
    from bwtpu.sam import emit_sam as j_emit_sam
    from bwtpu_torch.results import ContigTable as TContigTable
    from bwtpu_torch.results import select_primary_flat as t_select_primary_flat
    from bwtpu_torch.sam import emit_sam as t_emit_sam
    from bwtpu_torch.samfast import emit_single as t_emit_single

    genome, off = _repeat_genome()
    cfg = EngineConfig(sa_rate=4, max_hits=4, max_cand=4, loc_factor=1, read_len=36,
                       max_heals=0)
    idx = build_fm_index(genome, cfg)
    reads, _ = simulate_reads(genome, 24, read_len=36, max_mismatches=2, seed=6)
    reads[0] = Read("rep0", genome[off:off + 36], "I" * 36)
    contigs = idx.contigs
    blk = ReadBlock.from_reads(reads)
    ej, et = je.Engine([idx]), te.Engine([idx], device="cpu")
    sams = {}
    for name, eng, emit_single, select, table, emit_sam in (
            ("bwtpu", ej, j_emit_single, select_primary_flat, ContigTable, j_emit_sam),
            ("port", et, t_emit_single, t_select_primary_flat, TContigTable, t_emit_sam)):
        flat = _run(eng, blk, 2)
        block_sam = emit_single(blk, select(flat), table.build(contigs),
                                truncated=flat.truncated)
        buf = sio.StringIO()
        emit_sam(reads, eng.align_batch(reads, 2), contigs, buf, header=False)
        sams[name] = (block_sam, buf.getvalue().encode())
    assert sams["port"] == sams["bwtpu"]
    block_sam, list_sam = sams["port"]
    assert block_sam.count(b"xo:i:1") > 0 and b"xo:i:1" not in list_sam
    assert et.stats.truncated_reads > 0 and et.stats.heals == 0
    assert _stats(et) == _stats(ej)
