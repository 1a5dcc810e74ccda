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
