"""The generators: deterministic, at the configurations' lengths and repeat
shares, and reads with the traffic's sizes and rates."""

import json
import os

import numpy as np
import pytest

from benchmark.gen.genome import make_genome, write_fasta
from benchmark.gen.reads import make_pool, sample_reads

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)


def _config(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        return json.load(f)


def _traffic(name, **kw):
    with open(os.path.join(BENCH, "workloads", name + ".json")) as f:
        return {**json.load(f), **kw}


@pytest.mark.parametrize("name", ["ecoli-k12-mg1655", "chr21-grch38"])
def test_genome_length_shares_and_determinism(name):
    cfg = _config(name)
    g, info = make_genome(cfg)
    assert g.dtype == np.uint8 and len(g) == cfg["length"] and g.max() <= 3
    for group in cfg["repeats"]:
        got = info[group["name"]]
        if "share" in group:  # the share filled, to within one copy
            assert abs(got["share"] - group["share"]) < group["length"][1] / cfg["length"]
        else:
            lo, hi = (group["copies"], group["copies"]) if isinstance(group["copies"], int) \
                else group["copies"]
            assert group["families"] * lo <= got["copies"] <= group["families"] * hi
    # uniform background: each base about a quarter
    assert np.allclose(np.bincount(g, minlength=4) / len(g), 0.25, atol=0.01)
    g2, _ = make_genome(cfg)
    assert np.array_equal(g, g2)


def test_repeat_copies_are_near_their_consensus():
    """A family of identical copies appears that many times, exactly."""
    cfg = {"length": 50_000, "genome_seed": 3, "repeats": [
        {"name": "r", "families": 1, "length": [200, 200], "copies": 12,
         "divergence": [0.0, 0.0], "reverse_share": 0.0}]}
    g, info = make_genome(cfg)
    assert info["r"] == {"copies": 12, "share": 12 * 200 / 50_000}
    win = np.lib.stride_tricks.sliding_window_view(g, 200)
    # the copies: the windows equal to the most common 200-mer
    keys = win[:, :32] @ (4 ** np.arange(32, dtype=np.uint64)[::-1] % (2**61 - 1))
    vals, counts = np.unique(keys, return_counts=True)
    assert counts.max() == 12


def test_write_fasta(tmp_path):
    g = np.array([0, 1, 2, 3] * 45 + [1], dtype=np.uint8)
    p = tmp_path / "g.fa"
    write_fasta(str(p), "chrT", g, width=80)
    lines = p.read_text().splitlines()
    assert lines[0] == ">chrT" and [len(x) for x in lines[1:]] == [80, 80, 21]
    assert "".join(lines[1:]) == "ACGT" * 45 + "C"


def _pool(seed, **kw):
    rng = np.random.default_rng(0)
    genome = rng.integers(0, 4, 200_000, dtype=np.uint8)
    tr = _traffic("k2.align", block_reads=4096, pool_blocks=3, **kw)
    return genome, tr, make_pool(genome, tr, seed)


@pytest.mark.parametrize("seed", [0, 2**31 + 7, -5])
def test_pool_sizes_and_determinism(seed):
    genome, tr, p = _pool(seed)
    assert p.seq.shape == (3 * 4096, 100) and p.qual.shape == p.seq.shape
    assert set(np.unique(p.seq).tobytes()) <= set(b"ACGTN")
    _, _, q = _pool(seed)
    assert np.array_equal(p.seq, q.seq) and np.array_equal(p.qual, q.qual)
    _, _, other = _pool(seed + 1)
    assert not np.array_equal(p.seq, other.seq)
    s = sample_reads(tr, seed)
    assert s.shape == (3, tr["sample_reads"]) and (np.diff(s, axis=1) > 0).all()
    assert np.array_equal(s, sample_reads(tr, seed))


def test_pool_rates_and_truth():
    """Substitutions Binomial(100, 0.005), N at 0.1 %, half the reads from
    the - strand: each read against the window it came from."""
    genome, tr, p = _pool(11, n_rate=0.0)
    lut = np.zeros(256, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    codes = lut[p.seq]
    codes[p.reverse] = 3 - codes[p.reverse, ::-1]
    win = np.lib.stride_tricks.sliding_window_view(genome, 100)[p.start]
    nm = (codes != win).sum(1)
    assert abs(nm.mean() - 0.5) < 0.03
    assert abs(p.reverse.mean() - 0.5) < 0.02
    _, _, pn = _pool(11)
    assert abs((pn.seq == ord("N")).mean() - 0.001) < 0.0003


def test_fastq_is_read_by_the_programs_parser():
    from bwtpu_torch.readblock import _native_parse, read_fastq_block

    _, _, p = _pool(4)
    data = p.fastq(100, 164)
    blk = _native_parse(np.frombuffer(data, np.uint8)) or None
    if blk is None:  # no toolchain: the NumPy reader
        import tempfile
        with tempfile.NamedTemporaryFile(suffix=".fq") as f:
            f.write(data)
            f.flush()
            blk = read_fastq_block(f.name)
    assert blk.n == 64 and np.array_equal(blk.seq, p.seq[100:164])
    assert np.array_equal(blk.qual, p.qual[100:164])
    assert blk.ids()[:2] == ["r000000100", "r000000101"]
