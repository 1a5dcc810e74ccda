"""Tiered k <= 2 dispatch and autotuned caps in bwtpu_torch against bwtpu:
tiered_pipeline_packed's 12 outputs, dispatch_block(tiered=True) +
finish_block (FlatHits, escalated, heals), autotune_caps' chosen factors
and live fractions, the two reference faults the port keeps (C.2, C.3),
and the CLI's --tiered / --esc-factor / --autotune-caps SAM bytes.
Exact equality: everything is integer."""

import os
import sys

import jax
import numpy as np
import pytest
import torch

import bwtpu.engine as je
import bwtpu_torch.engine as te
from bwtpu.config import EngineConfig
from bwtpu.index import build_fm_index
from bwtpu.readblock import ReadBlock
from bwtpu.simulate import random_genome, simulate_reads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import cli  # noqa: E402
from bwtpu.io import read_fasta, write_fastq  # noqa: E402
from bwtpu_torch import cli as tcli  # noqa: E402

torch.set_num_threads(1)

GENOME = random_genome(30000, seed=41)


def _t(a):
    return torch.from_numpy(np.array(a))


def _pipelines_equal(idx, reads, k, L, **kw):
    """Both packages' tiered_pipeline_packed on the same packed reads: the
    live prefixes of both candidate lists and of esc_sel, the counts,
    ov_rows and comp_over. Returns the port's outputs."""
    depths = sorted(idx.kmer_tables)
    opts = dict(L=L, k=k, d=te.pick_kmer_depth(depths, L),
                d_seed=te.pick_kmer_depth(depths, L // (k + 1)),
                max_hits=idx.config.max_hits, max_cand=idx.config.max_cand,
                sa_rate=idx.config.sa_rate, loc_factor=idx.config.loc_factor,
                k2_loc_factor=idx.config.loc_factor, min_trips=idx.config.min_trips, **kw)
    rw, ab = je.pack_reads_for_bench(reads)
    jshard = jax.tree.map(lambda x: x[0], je.upload_index([idx]).shard)
    want = [np.asarray(o) for o in je.tiered_pipeline_packed(jshard, rw, ab, **opts)]
    got = te.tiered_pipeline_packed(te.upload_index([idx], "cpu")[0], _t(rw), _t(ab), **opts)
    got = [o.numpy() for o in got]
    for cnt_i, lists in ((3, (0, 1, 2)), (7, (4, 5, 6)), (9, (8,))):
        cnt = int(want[cnt_i])
        assert int(got[cnt_i]) == cnt, cnt_i
        for i in lists:
            np.testing.assert_array_equal(got[i][:cnt], want[i][:cnt], err_msg=str(i))
    for i in (10, 11):
        np.testing.assert_array_equal(got[i], want[i], err_msg=str(i))
    return got


@pytest.mark.parametrize("sa_rate", [1, 4])
def test_tiered_pipeline_matches_bwtpu(sa_rate):
    cfg = EngineConfig(sa_rate=sa_rate, max_hits=4, max_cand=8, read_len=60,
                       loc_factor=2, min_trips=1)
    idx = build_fm_index(GENOME, cfg)
    reads, _ = simulate_reads(GENOME, 96, read_len=60, max_mismatches=2, n_frac=0.01,
                              seed=sa_rate)
    got = _pipelines_equal(idx, reads, 2, 60, esc_factor=0.5)
    assert 0 < int(got[9]) < 96 and int(got[3]) > 0 and int(got[7]) > 0


def test_tiered_wide_steps_of_the_full_read_depth():
    """Reference fault C.3, kept: tier 2 gets the wide-step count of the
    full-read depth d, not of the seed depth. kmer_d 8 at 30 kbp and 23 bp
    reads: d = 8 (0 wide steps), d_seed = 4 (2 of its own); both packages
    run tier 2 with 0 and give the same outputs."""
    cfg = EngineConfig(sa_rate=4, kmer_d=8, max_hits=4, max_cand=8, read_len=30,
                       loc_factor=2, min_trips=1)
    idx = build_fm_index(GENOME, cfg)
    et = te.Engine([idx], device="cpu")
    assert et._wide_steps(8) == 0 and et._wide_steps(4) == 2
    reads, _ = simulate_reads(GENOME, 64, read_len=23, max_mismatches=2, seed=5)
    _pipelines_equal(idx, reads, 2, 23, wide_steps=et._wide_steps(8))
    ej = je.Engine([idx])
    blk = ReadBlock.from_reads(reads)
    _assert_flat_equal(et.finish_block(et.dispatch_block(blk, 2, tiered=True)),
                       ej.finish_block(ej.dispatch_block(blk, 2, tiered=True)))
    assert et.stats.escalated == ej.stats.escalated > 0


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
            st.truncated_reads, st.escalated)


@pytest.mark.parametrize("sa_rate", [1, 4])
def test_tiered_dispatch_matches_bwtpu(sa_rate):
    cfg = EngineConfig(sa_rate=sa_rate, max_hits=8, max_cand=8, read_len=60,
                       loc_factor=2, min_trips=1)
    idx = build_fm_index(GENOME, cfg)
    reads, _ = simulate_reads(GENOME, 32, read_len=60, max_mismatches=2, seed=42)
    blk = ReadBlock.from_reads(reads)
    ej, et = je.Engine([idx]), te.Engine([idx], device="cpu")
    handle = et.dispatch_block(blk, 2, pad_to=40, tiered=True)
    assert handle[6] == "tiered"
    _assert_flat_equal(et.finish_block(handle),
                       ej.finish_block(ej.dispatch_block(blk, 2, pad_to=40, tiered=True)))
    assert _stats(et) == _stats(ej) and et.stats.escalated > 0


def test_tiered_healing_and_escalated_count_match_bwtpu():
    """Binding caps on a repeat-rich genome: the tiered dispatch heals
    through the tiered path, as in bwtpu. Reference fault C.2, kept:
    `escalated` is added again at every heal level."""
    base = random_genome(3000, seed=43)
    rep = base[:120] * 5 + base
    cfg = EngineConfig(sa_rate=4, max_hits=2, max_cand=2, read_len=50,
                       loc_factor=0.5, min_trips=1, max_heals=6)
    idx = build_fm_index(rep, cfg)
    reads, _ = simulate_reads(rep, 16, read_len=50, max_mismatches=1, seed=44)
    blk = ReadBlock.from_reads(reads)
    ej, et = je.Engine([idx]), te.Engine([idx], device="cpu")
    _assert_flat_equal(et.finish_block(et.dispatch_block(blk, 2, pad_to=16, tiered=True)),
                       ej.finish_block(ej.dispatch_block(blk, 2, pad_to=16, tiered=True)))
    assert _stats(et) == _stats(ej)
    assert et.stats.heals >= 1
    # one level's escalated count, times the levels run
    one = te.Engine([idx], device="cpu")
    out = one.dispatch_block(blk, 2, pad_to=16, tiered=True)[4][0]  # the one shard's
    assert et.stats.escalated == (et.stats.heals + 1) * int(out[9]) > blk.n


def test_tiered_without_multistep_lattice_runs_the_full_pipeline():
    idx = build_fm_index(GENOME, EngineConfig(sa_rate=4, read_len=60, occ_step=0))
    reads, _ = simulate_reads(GENOME, 24, read_len=60, max_mismatches=2, seed=6)
    blk = ReadBlock.from_reads(reads)
    ej, et = je.Engine([idx]), te.Engine([idx], device="cpu")
    handle = et.dispatch_block(blk, 2, tiered=True)
    assert handle[6] == "dense"
    _assert_flat_equal(et.finish_block(handle),
                       ej.finish_block(ej.dispatch_block(blk, 2, tiered=True)))
    assert _stats(et) == _stats(ej) and et.stats.escalated == 0


@pytest.mark.parametrize("loc_factor", [4, 0.25])
def test_autotune_caps_matches_bwtpu(loc_factor):
    """The same loc_factor and hit_factor per k from the same live
    fractions; the configured loc_factor stays the ceiling (0.25 is below
    what k = 2 wants)."""
    genome = random_genome(4000, seed=42)
    cfg = EngineConfig(sa_rate=1, max_hits=8, max_cand=8, read_len=60,
                       loc_factor=loc_factor, min_trips=1)
    idx = build_fm_index(genome, cfg)
    reads, _ = simulate_reads(genome, 64, read_len=60, max_mismatches=2, seed=9)
    blk = ReadBlock.from_reads(reads)
    ej, et = je.Engine([idx]), te.Engine([idx], device="cpu")
    for k in (0, 2):
        lf = et.autotune_caps(blk, k)
        assert lf == ej.autotune_caps(blk, k) <= loc_factor
        assert et._hf(k) == ej._hf(k)
        _assert_flat_equal(et.finish_block(et.dispatch_block(blk, k)),
                           ej.finish_block(ej.dispatch_block(blk, k)))
    assert et._cand_live_frac == ej._cand_live_frac
    assert et._hit_live_frac == ej._hit_live_frac
    assert et._lf_override == ej._lf_override and et._hf_override == ej._hf_override
    if loc_factor == 4:
        assert et._lf_override[0] < 4 and et._lf_override[0] != et._lf_override[2]
    else:
        assert et._lf_override[2] == 0.25
    assert _stats(et) == _stats(ej)


def _event_lines(text):
    return [ln for ln in text.splitlines() if '"event": "autotune"' in ln]


@pytest.mark.parametrize("fmt", ["uniform", "mixed"])
def test_cli_tiered_autotune_sam_byte_equal_to_cli(tmp_path, capsys, fmt):
    """--tiered --autotune-caps --esc-factor 0.5 at an sa_rate 1 index:
    the port's SAM equals cli.py's; so does the autotune event (uniform
    FASTQ; mixed lengths take the length-bucketed stream, untuned)."""
    fa, idx = os.path.join(ROOT, "data", "phiX174.fa"), tmp_path / "idx"
    genome, _ = read_fasta(fa)
    tcli.main(["build-index", fa, str(idx), "--sa-rate", "1", "--read-len", "60"])
    reads = simulate_reads(genome, 90, read_len=60, max_mismatches=2, n_frac=0.01,
                           seed=7)[0]
    if fmt == "mixed":
        reads = reads[:50] + simulate_reads(genome, 40, read_len=45, max_mismatches=2,
                                            seed=8)[0]
    fq = tmp_path / "reads.fq"
    write_fastq(str(fq), reads)
    want, got = tmp_path / "bwtpu.sam", tmp_path / "port.sam"
    flags = ["-k", "2", "--batch-size", "32", "--tiered", "--autotune-caps",
             "--esc-factor", "0.5"]
    capsys.readouterr()
    cli.main(["align", str(idx), str(fq), "-o", str(want), *flags])
    want_events = _event_lines(capsys.readouterr().err)
    summary = tcli.main(["align", str(idx), str(fq), "-o", str(got), *flags,
                         "--device", "cpu"])
    got_events = _event_lines(capsys.readouterr().err)
    assert got.read_bytes() == want.read_bytes()
    assert got.read_bytes().count(b"\tNM:i:") > 40
    assert got_events == want_events and len(got_events) == (fmt == "uniform")
    assert summary["reads"] == 90 and summary["escalated"] > 0


def test_cli_autotune_probe_does_not_hide_a_kernel_failure(tmp_path, monkeypatch):
    """cli.py skips tuning on any exception of the probe; the port lets a
    kernel build or launch failure (RuntimeError from kernels/_build.py)
    reach the caller, so no fallback hides the device."""
    fa, idx = os.path.join(ROOT, "data", "phiX174.fa"), tmp_path / "idx"
    genome, _ = read_fasta(fa)
    tcli.main(["build-index", fa, str(idx), "--sa-rate", "1", "--read-len", "60"])
    fq = tmp_path / "reads.fq"
    write_fastq(str(fq), simulate_reads(genome, 40, read_len=60, seed=3)[0])

    real, calls = te.verify_locv, []

    def fails_once(*a, **kw):  # only the probe's launch fails
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("verify_locv: CUDA error cudaErrorLaunchFailure")
        return real(*a, **kw)

    monkeypatch.setattr(te, "verify_locv", fails_once)
    with pytest.raises(RuntimeError, match="cudaErrorLaunchFailure"):
        tcli.main(["align", str(idx), str(fq), "-o", str(tmp_path / "out.sam"), "-k", "2",
                   "--autotune-caps", "--device", "cpu"])
