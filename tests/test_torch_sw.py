"""bwtpu_torch.sw against bwtpu.sw: the banded Smith-Waterman scores
(`sw_score_plain`, the CPU side of `sw_score_batch`, against the jnp
`sw_score_batch` and the Python oracle) and `rescore_candidates` on a
3-shard index. Everything is int32, so every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bwtpu.sw as jsw
import bwtpu_torch.sw as tsw
from bwtpu import dna
from bwtpu.config import EngineConfig
from bwtpu.index import build_sharded_index
from bwtpu.io import Read
from bwtpu.simulate import random_genome, simulate_reads

torch.set_num_threads(1)


def _lanes(rng, B, Lt_max, L_max, n_frac=0.0):
    """Random windows and reads as int32 codes (code 4 = N where n_frac >
    0), left-aligned and zero-padded past each lane's length; a third of
    the reads are substrings of their window with substitutions, so high
    scores occur too."""
    text = np.zeros((B, Lt_max), np.int32)
    reads = np.zeros((B, L_max), np.int32)
    tl = rng.integers(0, Lt_max + 1, size=B).astype(np.int32)
    rl = rng.integers(0, L_max + 1, size=B).astype(np.int32)
    tl[:3], rl[:3] = [0, 5, Lt_max], [L_max, 0, L_max]  # no text, no read, both full
    for b in range(B):
        t = rng.integers(0, 4, size=tl[b])
        r = rng.integers(0, 4, size=rl[b])
        if b % 3 == 0 and tl[b] > 4 and rl[b]:
            start = int(rng.integers(0, max(1, tl[b] - rl[b])))
            seg = t[start:start + rl[b]]
            r[:len(seg)] = seg
            flip = rng.random(rl[b]) < 0.05
            r[flip] = (r[flip] + 1) % 4
        if n_frac:
            t[rng.random(tl[b]) < n_frac] = 4
            r[rng.random(rl[b]) < n_frac] = 4
        text[b, :tl[b]], reads[b, :rl[b]] = t, r
    return text, tl, reads, rl


@pytest.mark.parametrize("band", [4, 8])
@pytest.mark.parametrize("Lt_max,L_max,n_frac", [(60, 40, 0.0), (6, 30, 0.0), (50, 45, 0.05)],
                         ids=["windows", "text_shorter_than_band", "n_bases"])
def test_sw_score_plain_matches_bwtpu(band, Lt_max, L_max, n_frac):
    """Random reads and windows, text shorter than the band, read lengths
    0..L (the loop runs over all L rows), N bases."""
    rng = np.random.default_rng(band * 100 + Lt_max + L_max)
    text, tl, reads, rl = _lanes(rng, 48, Lt_max, L_max, n_frac)
    want = np.asarray(jsw.sw_score_batch(jnp.asarray(text), jnp.asarray(tl),
                                         jnp.asarray(reads), jnp.asarray(rl), band=band))
    got = tsw.sw_score_batch(*(torch.from_numpy(a) for a in (text, tl, reads, rl)), band=band)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.max() > min(20, Lt_max)  # some lanes align well
    letters = np.array(list("ACGTN"))
    for b in range(len(tl)):
        t = "".join(letters[text[b, :tl[b]]])
        r = "".join(letters[reads[b, :rl[b]]])
        assert tsw.sw_score_reference(t, r, band=band) == want[b] == jsw.sw_score_reference(
            t, r, band=band)


def _edge_lanes(rng, band, Lt_max=70, L_max=60):
    """64 lanes (two warps of the kernel) over the kernel's edge cases:
    read_len 0, reads shorter than L by more than the band, text_len 0,
    text_len below the band, and lanes of one warp that end at very
    different rows (read lengths 1 .. L); the rest random, a third of
    them substrings of their window."""
    text, tl, reads, rl = _lanes(rng, 64, Lt_max, L_max, n_frac=0.03)
    rl[3], rl[4] = 0, max(0, L_max - band - 7)  # no read; short by more than the band
    tl[5], tl[6] = 0, band // 2  # no text; text shorter than the band
    rl[32:48] = [1, 2, 5, L_max, 9, L_max - 1, 17, 3, L_max, 30, 11, L_max, 0, 44, 6, 25]
    tl[32:48] = np.minimum(rl[32:48] + 2 * band, Lt_max)
    for b in range(64):  # codes past a lane's length stay zero, as the port pads them
        reads[b, rl[b]:] = 0
        text[b, tl[b]:] = 0
    return text, tl, reads, rl


@pytest.mark.parametrize("band,match,mismatch,gap", [
    (0, 2, -3, -4), (16, 2, -3, -4), (8, 1, 1, 0), (5, 3, -1, 0), (3, 2, 1, -1)],
    ids=["band0", "band16", "positive_mismatch_gap0", "gap0", "positive_mismatch"])
def test_sw_score_plain_in_kernel_order_matches_bwtpu(band, match, mismatch, gap):
    """sw_score_plain (the kernel's order: rows end at min(L, read_len,
    text_len + band), edge-row masks by [lo, hi], the scan without its
    clamp at 0) against the jnp sw_score_batch and both oracles, at bands
    0 and 16 and scores other than the defaults."""
    rng = np.random.default_rng([band, match, mismatch + 10, gap + 10])
    text, tl, reads, rl = _edge_lanes(rng, band)
    kw = dict(band=band, match=match, mismatch=mismatch, gap=gap)
    want = np.asarray(jsw.sw_score_batch(jnp.asarray(text), jnp.asarray(tl),
                                         jnp.asarray(reads), jnp.asarray(rl), **kw))
    got = tsw.sw_score_plain(*(torch.from_numpy(a) for a in (text, tl, reads, rl)), **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[3] == want[5] == 0 and want.max() > 20
    letters = np.array(list("ACGTN"))
    for b in range(len(tl)):
        t = "".join(letters[text[b, :tl[b]]])
        r = "".join(letters[reads[b, :rl[b]]])
        assert tsw.sw_score_reference(t, r, **kw) == want[b] == jsw.sw_score_reference(t, r, **kw)


def test_sw_score_plain_exact_and_indel():
    """tests/test_sw.py's cases: a perfect match scores 2 per base, one
    deleted base costs one gap."""
    t = "ACGTACGTACGTACGTACGT"
    read = t[4:9] + t[10:15]
    text = torch.from_numpy(np.stack([dna.encode(t)] * 2).astype(np.int32))
    reads = torch.from_numpy(np.stack([dna.encode(t[4:14]), dna.encode(read)]).astype(np.int32))
    lens = torch.tensor([20, 20], dtype=torch.int32)
    got = tsw.sw_score_batch(text, lens, reads, torch.tensor([10, 10], dtype=torch.int32))
    assert got.tolist() == [20, 16] == [tsw.sw_score_reference(t, t[4:14]),
                                        tsw.sw_score_reference(t, read)]


def test_sw_wrapper_refuses_other_devices():
    meta = torch.zeros((2, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        tsw.sw_score_batch(meta, meta[:, 0], meta, meta[:, 0])


@pytest.mark.parametrize("band,flank", [(4, 6), (8, 8)])
def test_rescore_candidates_matches_bwtpu_on_three_shards(band, flank):
    """tests/test_sw.py's setup: a 3-shard index, 2-mismatch reads and a
    shorter read; the port's Engine on the CPU and bwtpu's give the same
    hits, and both rescore_candidates give the same score per hit (across
    shard boundaries, both strands)."""
    from bwtpu.engine import Engine as JEngine
    from bwtpu_torch.engine import Engine as TEngine

    genome = random_genome(6000, seed=61)
    cfg = EngineConfig(sa_rate=8, max_hits=8, max_cand=8, read_len=40)
    shards, manifest = build_sharded_index(genome, 3, config=cfg, overlap=64)
    reads, _ = simulate_reads(genome, 24, read_len=40, max_mismatches=2, seed=62)
    reads.append(Read(rid="short", seq=genome[100:130], qual="I" * 30))
    ej, et = JEngine(shards, manifest), TEngine(shards, device="cpu")
    hits = ej.align_batch(reads, k=2)
    assert ([[(h.nm, h.strand, h.pos) for h in hs] for hs in et.align_batch(reads, k=2)]
            == [[(h.nm, h.strand, h.pos) for h in hs] for hs in hits])
    want = jsw.rescore_candidates(ej, reads, hits, band=band, flank=flank)
    got = tsw.rescore_candidates(et, reads, hits, band=band, flank=flank)
    assert got == want and len(got) >= 24
    assert any(h.strand == "-" for hs in hits for h in hs)
    assert tsw.rescore_candidates(et, reads, [[] for _ in reads]) == {}
