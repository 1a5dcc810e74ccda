"""bwtpu_torch's host layer (its copies of bwtpu's config, dna, io, index,
sais, results, readblock, sam, samfast, simulate and golden modules)
against bwtpu's own: the same inputs, made from a seed with numpy, give
equal arrays, equal index artifacts and equal SAM bytes."""

import dataclasses
import io
import json
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import cli  # noqa: E402
from bwtpu import config as jconfig  # noqa: E402
from bwtpu import golden as jgolden  # noqa: E402
from bwtpu import index as jindex  # noqa: E402
from bwtpu import io as jio  # noqa: E402
from bwtpu import readblock as jreadblock  # noqa: E402
from bwtpu import results as jresults  # noqa: E402
from bwtpu import sais as jsais  # noqa: E402
from bwtpu import sam as jsam  # noqa: E402
from bwtpu import samfast as jsamfast  # noqa: E402
from bwtpu import simulate as jsimulate  # noqa: E402
from bwtpu_torch import cli as tcli  # noqa: E402
from bwtpu_torch import config as tconfig  # noqa: E402
from bwtpu_torch import golden as tgolden  # noqa: E402
from bwtpu_torch import index as tindex  # noqa: E402
from bwtpu_torch import io as tio  # noqa: E402
from bwtpu_torch import readblock as treadblock  # noqa: E402
from bwtpu_torch import results as tresults  # noqa: E402
from bwtpu_torch import sais as tsais  # noqa: E402
from bwtpu_torch import sam as tsam  # noqa: E402
from bwtpu_torch import samfast as tsamfast  # noqa: E402
from bwtpu_torch import simulate as tsimulate  # noqa: E402


def _genome(n: int, seed: int) -> str:
    """A random genome with N runs (single bases and a long run)."""
    g = list(jsimulate.random_genome(n, seed=seed))
    rng = np.random.default_rng(seed)
    for p, run in zip(rng.integers(0, n - 40, size=6), rng.integers(1, 30, size=6)):
        g[p:p + run] = "N" * run
    return "".join(g)


def _contigs(genome: str):
    """Three contigs over the genome, as read_fasta reports them."""
    cuts = [0, len(genome) // 3, 2 * len(genome) // 3, len(genome)]
    return [(f"chr{i}", a, b - a) for i, (a, b) in enumerate(zip(cuts, cuts[1:]))]


def _assert_same(a, b, where=""):
    """Equal values: arrays by content and dtype, containers element-wise,
    dataclasses and NamedTuples field by field (the two packages' classes
    differ, so they compare by their fields)."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(a, tuple) and hasattr(a, "_fields"):
        assert a._fields == b._fields, where
        for name in a._fields:
            _assert_same(getattr(a, name), getattr(b, name), f"{where}.{name}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}[{k}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def test_native_host_library_builds_and_matches_the_fallback():
    """The port's g++ build of csrc/host/*.cc loads here, and its SA-IS
    equals the numpy fallback and bwtpu's suffix array."""
    assert tsais.native_available()
    assert os.path.basename(tsais.build_info["so"]).startswith("libbwtpu_host_")
    rng = np.random.default_rng(3)
    s = np.append(rng.integers(1, 5, size=5000), 0).astype(np.uint8)
    want = jsais.suffix_array(s)
    np.testing.assert_array_equal(tsais.suffix_array(s), want)
    np.testing.assert_array_equal(tsais.suffix_array(s, force_fallback=True), want)
    np.testing.assert_array_equal(tgolden.suffix_array(s.astype(np.int64)),
                                  jgolden.suffix_array(s.astype(np.int64)))


@pytest.mark.parametrize("sa_rate", [1, 8])
@pytest.mark.parametrize("seed", [1, 2])
def test_build_fm_index_equal(sa_rate, seed):
    genome = _genome(9000, seed)
    contigs = _contigs(genome)
    kw = dict(sa_rate=sa_rate, read_len=60, max_hits=8, max_cand=8)
    want = jindex.build_fm_index(genome, jconfig.EngineConfig(**kw),
                                 contigs=[jio.Contig(*c) for c in contigs])
    got = tindex.build_fm_index(genome, tconfig.EngineConfig(**kw),
                                contigs=[tio.Contig(*c) for c in contigs])
    _assert_same(got, want, "FMIndex")


@pytest.mark.parametrize("writer", ["bwtpu", "bwtpu_torch"])
def test_index_artifact_read_by_the_other_package(tmp_path, writer):
    """save_index by one package, load_index by the other; a sharded
    build with overlap, so several shards and contigs are stored."""
    genome = _genome(12000, 5)
    contigs = _contigs(genome)
    mods = {"bwtpu": (jindex, jconfig, jio), "bwtpu_torch": (tindex, tconfig, tio)}
    built = {}
    for name, (index, config, io_) in mods.items():
        built[name] = index.build_sharded_index(
            genome, 2, config=config.EngineConfig(sa_rate=4, read_len=60),
            contigs=[io_.Contig(*c) for c in contigs], overlap=64)
    _assert_same(built["bwtpu_torch"], built["bwtpu"], "build_sharded_index")
    mods[writer][0].save_index(str(tmp_path), *built[writer])
    reader = "bwtpu" if writer == "bwtpu_torch" else "bwtpu_torch"
    _assert_same(mods[reader][0].load_index(str(tmp_path)), built[reader], "load_index")


def _fastq(tmp_path, lengths, seed: int) -> str:
    genome = jsimulate.random_genome(20000, seed=seed)
    reads = []
    for L in lengths:
        reads += jsimulate.simulate_reads(genome, 37, read_len=L, max_mismatches=2,
                                          n_frac=0.02, seed=L + seed)[0]
    for i, r in enumerate(reads):
        r.seq = r.seq.lower() if i % 5 == 0 else r.seq
    path = str(tmp_path / "reads.fq")
    jio.write_fastq(path, reads)
    return path


@pytest.mark.parametrize("chunk,start", [(16, 0), (16, 2), (1000, 0)])
def test_read_fastq_stream_equal(tmp_path, chunk, start):
    path = _fastq(tmp_path, [60], seed=1)
    want = jreadblock.read_fastq_stream(path, chunk, start)
    got = treadblock.read_fastq_stream(path, chunk, start)
    assert got[:2] == want[:2]
    _assert_same(list(got[2]), list(want[2]), "blocks")


@pytest.mark.parametrize("chunk,start", [(16, 0), (40, 1)])
def test_read_fastq_stream_ragged_equal(tmp_path, chunk, start):
    path = _fastq(tmp_path, [35, 60, 48], seed=2)
    want = jreadblock.read_fastq_stream_ragged(path, chunk, start)
    got = treadblock.read_fastq_stream_ragged(path, chunk, start)
    assert got[:2] == want[:2]
    _assert_same(list(got[2]), list(want[2]), "groups")


@pytest.mark.parametrize("n_frac,error_rate", [(0.0, None), (0.02, None), (0.01, 0.005)])
def test_simulate_equal(n_frac, error_rate):
    assert (tsimulate.random_genome(5000, seed=4)
            == jsimulate.random_genome(5000, seed=4))
    genome = jsimulate.random_genome(5000, seed=4)
    kw = dict(read_len=50, max_mismatches=2, n_frac=n_frac, seed=6, error_rate=error_rate)
    got, gt = tsimulate.simulate_reads(genome, 60, **kw)
    want, wt = jsimulate.simulate_reads(genome, 60, **kw)
    assert gt == wt
    assert [(r.rid, r.seq, r.qual) for r in got] == [(r.rid, r.seq, r.qual) for r in want]


def _hits(rng, n_reads: int, text_len: int):
    """Random flat hits: several per read, duplicates and both strands."""
    n = 6 * n_reads
    return dict(
        s_idx=np.zeros(n, np.int32),
        row_idx=rng.integers(0, 2 * n_reads, size=n).astype(np.int32),
        p=rng.integers(-5, text_len, size=n).astype(np.int32),
        m=rng.integers(0, 3, size=n).astype(np.int32),
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flatten_hits_and_select_primary_flat_equal(seed):
    rng = np.random.default_rng(seed)
    n_reads, text_len = 50, 3000
    args = _hits(rng, n_reads, text_len)
    lens = rng.integers(30, 61, size=n_reads)
    flat = {}
    for name, results in (("bwtpu", jresults), ("bwtpu_torch", tresults)):
        flat[name] = results.flatten_hits(n_reads, lens, n_reads, args["s_idx"],
                                          args["row_idx"], args["p"], args["m"],
                                          [text_len], [0])
    _assert_same(flat["bwtpu_torch"], flat["bwtpu"], "flatten_hits")
    _assert_same(tresults.select_primary_flat(flat["bwtpu_torch"]),
                 jresults.select_primary_flat(flat["bwtpu"]), "select_primary_flat")


@pytest.mark.parametrize("truncate", [False, True])
def test_sam_bytes_equal(tmp_path, truncate):
    """sam_header, emit_single (the C formatter and its Python twin) and
    emit_sam give the same bytes from the same hits."""
    path = _fastq(tmp_path, [60], seed=3)
    blk_j = jreadblock.read_fastq_block(path)
    blk_t = treadblock.read_fastq_block(path)
    rng = np.random.default_rng(7)
    contigs_j = [jio.Contig("chrA", 0, 12000), jio.Contig("chrB", 12000, 8000)]
    contigs_t = [tio.Contig(c.name, c.offset, c.length) for c in contigs_j]
    assert tsam.sam_header(contigs_t) == jsam.sam_header(contigs_j)
    args = _hits(rng, blk_j.n, 20000)
    flat_j = jresults.flatten_hits(blk_j.n, blk_j.L, blk_j.n, args["s_idx"],
                                   args["row_idx"], args["p"], args["m"], [20000], [0])
    flat_t = tresults.flatten_hits(blk_t.n, blk_t.L, blk_t.n, args["s_idx"],
                                   args["row_idx"], args["p"], args["m"], [20000], [0])
    trunc = rng.random(blk_j.n) < 0.2 if truncate else None
    for force_python in (False, True):
        want = jsamfast.emit_single(blk_j, jresults.select_primary_flat(flat_j),
                                    jresults.ContigTable.build(contigs_j),
                                    force_python=force_python, truncated=trunc)
        got = tsamfast.emit_single(blk_t, tresults.select_primary_flat(flat_t),
                                   tresults.ContigTable.build(contigs_t),
                                   force_python=force_python, truncated=trunc)
        assert got == want and len(want) > 0
    outs = []
    for sam, results, io_, blk, flat, contigs in (
            (jsam, jresults, jio, blk_j, flat_j, contigs_j),
            (tsam, tresults, tio, blk_t, flat_t, contigs_t)):
        buf = io.StringIO()
        sam.emit_sam(blk.to_reads(), results.hit_lists(flat), contigs, buf)
        outs.append(buf.getvalue())
    assert outs[1] == outs[0]


def _build_index_args(mod, monkeypatch, argv):
    """The namespace a CLI's build-index parser makes of argv."""
    seen = {}
    monkeypatch.setattr(mod, "cmd_build_index", lambda args: seen.update(vars(args)))
    mod.main(["build-index", *argv])
    return {k: v for k, v in seen.items() if k != "fn"}


@pytest.mark.parametrize("argv", [[], ["--sa-rate", "4", "--kmer-d", "6", "--read-len",
                                       "60", "--max-hits", "8", "--max-cand", "12",
                                       "--overlap", "128", "--shards", "2", "--jobs", "2"]])
def test_build_index_parses_as_cli_py(monkeypatch, argv):
    assert (_build_index_args(tcli, monkeypatch, ["ref.fa", "out", *argv])
            == _build_index_args(cli, monkeypatch, ["ref.fa", "out", *argv]))


@pytest.mark.parametrize("flags", [[], ["--sa-rate", "1", "--read-len", "60"],
                                   ["--shards", "2", "--overlap", "128", "--kmer-d", "6"]])
def test_build_index_artifact_equal_to_cli_py(tmp_path, flags):
    """The port's build-index against cli.py build-index on the same
    FASTA (N runs, three contigs) and flags: meta.json byte-equal, every
    array equal once loaded (the .npz zip headers carry write times)."""
    genome = _genome(15000, 9)
    fa = str(tmp_path / "ref.fa")
    jio.write_fasta(fa, [(name, genome[a:a + n]) for name, a, n in _contigs(genome)])
    want, got = str(tmp_path / "want"), str(tmp_path / "got")
    cli.main(["build-index", fa, want, *flags])
    tcli.main(["build-index", fa, got, *flags])
    meta = [open(os.path.join(d, "meta.json"), "rb").read() for d in (want, got)]
    assert meta[1] == meta[0]
    n_shards = json.loads(meta[0])["n_shards"]
    assert n_shards == (2 if "--shards" in flags else 1)
    for i in range(n_shards):
        zw, zg = (np.load(os.path.join(d, f"shard{i}.npz")) for d in (want, got))
        assert sorted(zg.files) == sorted(zw.files)
        for name in zw.files:
            _assert_same(zg[name], zw[name], f"shard{i}.{name}")


@pytest.mark.parametrize("k", [0, 2])
def test_golden_align_read_equal(k):
    """The port's GoldenFMIndex (the bench's CPU reference) gives bwtpu's
    hit lists on sampled reads with N bases, on a genome with N runs."""
    genome = _genome(4000, seed=61 + k)
    reads, _ = jsimulate.simulate_reads(genome, 30, read_len=40, max_mismatches=2,
                                        n_frac=0.01, seed=62 + k)
    reads += [jio.Read(rid="n", seq="N" * 40), jio.Read(rid="rep", seq=genome[100:140])]
    got_idx, want_idx = tgolden.GoldenFMIndex(genome), jgolden.GoldenFMIndex(genome)
    for r in reads:
        got = [(h.nm, h.strand, h.pos) for h in got_idx.align_read(r.seq, k=k)]
        want = [(h.nm, h.strand, h.pos) for h in want_idx.align_read(r.seq, k=k)]
        assert got == want, r.rid
