"""bwtpu_torch's Engine over several index shards against bwtpu's list form
(Engine(vmap_shards=False, fuse_shards=False): one dispatch per shard),
on tests/test_unstacked.py's setup (9,000 bp, 3 shards, overlap 64,
sa_rate 4, read_len 50): the block path in its "hits", "compact" and
"dense" modes, Read lists, tiered, heals at tiny caps; equal hit sets,
truncation marks and BatchStats. Each also with every shard_offset moved
past 2^31 in both packages' copies (global positions are int64 from the
offset on), and the CLI on a `--shards 3` index SAM-byte-equal to
cli.py's."""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import bwtpu.engine as je
import bwtpu_torch.engine as te
from bwtpu.config import EngineConfig
from bwtpu.index import build_sharded_index
from bwtpu.io import Read
from bwtpu.readblock import ReadBlock
from bwtpu.simulate import random_genome, simulate_reads

torch.set_num_threads(1)

CFG = EngineConfig(sa_rate=4, max_hits=8, max_cand=8, read_len=50, min_trips=1)
GENOME = random_genome(9000, seed=21)
FAR = 3 << 31  # moves every shard's offset past 2^31 (and past 2^32)


def _shards(genome=GENOME, cfg=CFG, shift=0):
    shards, _ = build_sharded_index(genome, 3, config=cfg, overlap=64)
    return [dataclasses.replace(s, shard_offset=s.shard_offset + shift) for s in shards]


def _engines(shards):
    return (je.Engine(shards, vmap_shards=False, fuse_shards=False),
            te.Engine(shards, device="cpu"))


def _stats(engine):
    st = engine.stats
    return (st.reads, st.hits, st.overflow_reads, st.compact_overflows, st.heals,
            st.truncated_reads, st.escalated)


def _hits(lists):
    return [[(h.nm, h.strand, h.pos) for h in hs] for hs in lists]


def _assert_flat_equal(got, want):
    assert got.n_reads == want.n_reads
    for name in ("read_idx", "pos", "strand_rev", "nm"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    if want.truncated is None:
        assert got.truncated is None
    else:
        np.testing.assert_array_equal(got.truncated, want.truncated)


def _run(engine, blk, k, **kw):
    return engine.finish_block(engine.dispatch_block(blk, k, **kw))


@pytest.fixture(scope="module")
def reads():
    """12 exact reads and 12 with up to 2 substitutions and N bases."""
    exact = simulate_reads(GENOME, 12, read_len=50, seed=22)[0]
    return exact + simulate_reads(GENOME, 12, read_len=50, max_mismatches=2, n_frac=0.01,
                                  seed=25)[0]


@pytest.mark.parametrize("shift", [0, FAR], ids=["offsets", "offsets_past_2^31"])
@pytest.mark.parametrize("k", [0, 2])
@pytest.mark.parametrize("mode", ["hits", "compact", "dense"])
def test_block_modes_match_bwtpu_list_form(reads, monkeypatch, mode, k, shift):
    """dispatch_block/finish_block over 3 shards. "compact": the port's
    hit payload bound forced down (bwtpu keeps "hits": the FlatHits agree
    either way); "dense": an index without the multi-step lattice."""
    cfg = CFG.replace(occ_step=0) if mode == "dense" else CFG
    ej, et = _engines(_shards(cfg=cfg, shift=shift))
    if mode == "compact":
        monkeypatch.setattr(te, "HIT_PAYLOAD_MAX", 1)
    blk = ReadBlock.from_reads(reads)
    handle = et.dispatch_block(blk, k, pad_to=32)
    assert handle[6] == mode and len(handle[4]) == 3
    got, want = et.finish_block(handle), _run(ej, blk, k, pad_to=32)
    _assert_flat_equal(got, want)
    assert len(got.read_idx) >= (20 if k else 10)
    assert (got.pos.min() >= FAR) == bool(shift)
    assert _stats(et) == _stats(ej)


@pytest.mark.parametrize("shift", [0, FAR], ids=["offsets", "offsets_past_2^31"])
@pytest.mark.parametrize("k", [0, 2])
def test_align_batch_matches_bwtpu_list_form(reads, k, shift):
    """Read lists over 3 shards: uniform lengths (packed pipelines,
    compacted) and mixed lengths (1-step pipelines, dense), align_batch
    and align_all."""
    ej, et = _engines(_shards(shift=shift))
    mixed = reads[:12] + simulate_reads(GENOME, 12, read_len=37, max_mismatches=2,
                                        seed=23)[0]
    for batch in (reads, mixed):
        want = ej.align_batch(batch, k)
        assert _hits(et.align_batch(batch, k)) == _hits(want)
        assert sum(map(len, want)) >= len(batch) * (3 if k else 1) // 4
    assert _hits(et.align_all(mixed, k, batch_size=10)) == _hits(ej.align_all(mixed, k,
                                                                              batch_size=10))
    assert _stats(et) == _stats(ej)


@pytest.mark.parametrize("shift", [0, FAR], ids=["offsets", "offsets_past_2^31"])
def test_tiered_matches_bwtpu_list_form(reads, shift):
    """The tiered dispatch per shard (bwtpu's per-shard branch): every
    shard escalates its own reads with no exact hit there, and
    `escalated` counts per shard (C.2)."""
    ej, et = _engines(_shards(shift=shift))
    blk = ReadBlock.from_reads(reads)
    handle = et.dispatch_block(blk, 2, pad_to=32, tiered=True)
    assert handle[6] == "tiered" and len(handle[4]) == 3
    _assert_flat_equal(et.finish_block(handle), _run(ej, blk, 2, pad_to=32, tiered=True))
    assert _stats(et) == _stats(ej) and et.stats.escalated > len(reads)


@pytest.mark.parametrize("shift", [0, FAR], ids=["offsets", "offsets_past_2^31"])
@pytest.mark.parametrize("k,max_heals", [(0, 6), (2, 6), (2, 0)])
def test_heals_at_tiny_caps_match_bwtpu_list_form(k, max_heals, shift):
    """tests/test_unstacked.py's repeat-rich genome at binding caps: the
    block (plain and tiered) and the Read list re-run on every shard at
    doubled caps, as in bwtpu; without heals the truncation marks agree."""
    rep = GENOME[:120] * 5 + GENOME[:3000]
    cfg = EngineConfig(sa_rate=4, max_hits=2, max_cand=2, read_len=50, loc_factor=0.5,
                       min_trips=1, max_heals=max_heals)
    ej, et = _engines(_shards(rep, cfg, shift))
    reads, _ = simulate_reads(rep, 12, read_len=50, max_mismatches=k, seed=23)
    reads[0] = Read("rep0", rep[130:180], "I" * 50)
    blk = ReadBlock.from_reads(reads)
    _assert_flat_equal(_run(et, blk, k, pad_to=16), _run(ej, blk, k, pad_to=16))
    if k:
        _assert_flat_equal(_run(et, blk, k, pad_to=16, tiered=True),
                           _run(ej, blk, k, pad_to=16, tiered=True))
    assert _hits(et.align_batch(reads, k)) == _hits(ej.align_batch(reads, k))
    assert _stats(et) == _stats(ej)
    if max_heals:
        assert et.stats.heals >= 2
    else:
        assert et.stats.truncated_reads > 0 and et.stats.heals == 0


def test_autotune_over_shards_matches_bwtpu_list_form(reads):
    """autotune_caps probes the first block on every shard and tunes from
    the largest shard's live fraction, as bwtpu's list form does."""
    loose = [dataclasses.replace(s, config=s.config.replace(loc_factor=6)) for s in _shards()]
    ej, et = _engines(loose)
    blk = ReadBlock.from_reads(reads)
    lf = et.autotune_caps(blk, 2, pad_to=32)
    assert lf == ej.autotune_caps(blk, 2, pad_to=32) < 6
    assert et._hf(2) == ej._hf(2)
    _assert_flat_equal(_run(et, blk, 2, pad_to=32), _run(ej, blk, 2, pad_to=32))


@pytest.mark.parametrize("flags", [["-k", "0"], ["-k", "2"], ["-k", "2", "--tiered"]],
                         ids=["k0", "k2", "tiered_k2"])
def test_cli_align_on_three_shards_byte_equal_to_cli(tmp_path, flags):
    """`build-index --shards 3` (two contigs, one crossing a shard
    boundary), then align through both CLIs: the same SAM bytes."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import cli
    from bwtpu.io import write_fasta, write_fastq
    from bwtpu_torch import cli as tcli

    fa, idx, fq = tmp_path / "ref.fa", tmp_path / "idx", tmp_path / "reads.fq"
    write_fasta(str(fa), [("chrA", GENOME[:4000]), ("chrB", GENOME[4000:])])
    tcli.main(["build-index", str(fa), str(idx), "--shards", "3", "--overlap", "64",
               "--sa-rate", "4", "--read-len", "50", "--max-hits", "8", "--max-cand", "8"])
    reads, _ = simulate_reads(GENOME, 90, read_len=50, max_mismatches=2, n_frac=0.01, seed=24)
    write_fastq(str(fq), reads)
    want, got = tmp_path / "cli.sam", tmp_path / "port.sam"
    cli.main(["align", str(idx), str(fq), "-o", str(want), "--batch-size", "32", *flags])
    summary = tcli.main(["align", str(idx), str(fq), "-o", str(got), "--batch-size", "32",
                         "--device", "cpu", *flags])
    assert got.read_bytes() == want.read_bytes()
    assert summary["reads"] == 90 and got.read_bytes().count(b"\tNM:i:") > 10
