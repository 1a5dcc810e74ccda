"""bwtpu_torch's CLI against the repository's cli.py on paired-end input,
--rescore and simulate: byte-equal SAM (and files). Both run in-process
on the same index (two shards, so every paired run takes the several-shard
dispatch); the port on the CPU (--device cpu)."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import cli  # noqa: E402
from bwtpu import dna  # noqa: E402
from bwtpu import readblock as jreadblock  # noqa: E402
from bwtpu.io import Read, write_fasta, write_fastq  # noqa: E402
from bwtpu.simulate import random_genome, simulate_pairs  # noqa: E402
from bwtpu_torch import cli as tcli  # noqa: E402
from bwtpu_torch import readblock as treadblock  # noqa: E402

torch.set_num_threads(1)

L = 60
# (mate-1 locus, its exact copy in the same shard): the copy is made exact
# and the locus carries one substitution at the mate's last base, so mate 1
# has an nm 0 hit at the copy and an nm 1 hit at its true, properly paired
# locus that the exact tier never verifies (the backward search starts at
# the last base; in another shard the nm 1 hit would come back: the tiered
# escalation is per shard, and that shard has no exact hit)
TWINS = ((1000, 8000), (4000, 11000), (17000, 26000))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A 30 kbp genome with TWINS, a 2-shard index (sa_rate 4, read_len
    60, overlap 64) built by the port's build-index, and 150 simulated
    pairs (insert 200 +- 20, <= 2 mismatches a mate) plus one pair at each
    twin locus; returns the directory."""
    d = tmp_path_factory.mktemp("paired")
    g = list(random_genome(30000, seed=13))
    twin_pairs = []
    for i, (a, copy) in enumerate(TWINS):
        g[copy:copy + L] = g[a:a + L]
        m1 = "".join(g[a:a + L])
        g[a + L - 1] = "ACGT"[("ACGT".index(g[a + L - 1]) + 1) % 4]
        m2 = dna.revcomp_str("".join(g[a + 200 - L:a + 200]))
        twin_pairs.append((Read(f"twin{i}", m1, "I" * L), Read(f"twin{i}", m2, "I" * L)))
    genome = "".join(g)
    write_fasta(str(d / "ref.fa"), [("chrA", genome[:17000]), ("chrB", genome[17000:])])
    tcli.main(["build-index", str(d / "ref.fa"), str(d / "idx"), "--shards", "2",
               "--overlap", "64", "--sa-rate", "4", "--read-len", str(L)])
    pairs, _ = simulate_pairs(genome, 150, read_len=L, insert_mean=200, insert_sd=20,
                              max_mismatches=2, seed=14)
    pairs += twin_pairs
    write_fastq(str(d / "r1.fq"), [p[0] for p in pairs])
    write_fastq(str(d / "r2.fq"), [p[1] for p in pairs])
    return d


def _align(mod, d, out, *flags):
    argv = ["align", str(d / "idx"), str(d / "r1.fq"), "--paired", str(d / "r2.fq"),
            "-o", str(out), "--batch-size", "64", *flags]
    return mod.main(argv + (["--device", "cpu"] if mod is tcli else []))


def _records(sam: bytes) -> list[bytes]:
    return [ln for ln in sam.splitlines() if not ln.startswith(b"@")]


@pytest.mark.parametrize("k", [0, 1, 2])
def test_paired_columnar_sam_byte_equal_to_cli(data, tmp_path, monkeypatch, k):
    """Uniform FASTQ mates take the columnar paired path in both CLIs:
    one stacked dispatch per chunk, vectorised pairing, SAM bytes equal."""
    seen = []
    orig = tcli._align_paired_block_stream
    monkeypatch.setattr(tcli, "_align_paired_block_stream",
                        lambda *a: seen.append(1) or orig(*a))
    want, got = tmp_path / "cli.sam", tmp_path / "port.sam"
    _align(cli, data, want, "-k", str(k))
    summary = _align(tcli, data, got, "-k", str(k))
    assert seen and got.read_bytes() == want.read_bytes()
    recs = _records(got.read_bytes())
    assert summary["reads"] == len(recs) == 2 * 153 and summary["truncated_reads"] == 0
    proper = sum(int(r.split(b"\t")[1]) & 2 != 0 for r in recs)
    assert proper > {0: 20, 1: 100, 2: 200}[k]  # mates carry 0-2 substitutions each


@pytest.mark.parametrize("k", [0, 1, 2])
def test_paired_read_list_route_byte_equal_to_cli(data, tmp_path, monkeypatch, k):
    """With the columnar reader refusing the input (patched, as
    tests/test_fastpath.py does), both CLIs take the paired Read-list loop
    (align_batch per mate, sam.pair_and_emit_sam): equal to each other and
    to the columnar path's bytes."""
    columnar = tmp_path / "columnar.sam"
    _align(tcli, data, columnar, "-k", str(k))
    for mod in (jreadblock, treadblock):
        monkeypatch.setattr(mod, "read_fastq_stream", lambda p, c, start=0: None)
    want, got = tmp_path / "cli.sam", tmp_path / "port.sam"
    _align(cli, data, want, "-k", str(k))
    _align(tcli, data, got, "-k", str(k))
    assert got.read_bytes() == want.read_bytes() == columnar.read_bytes()


def test_paired_insert_bounds_byte_equal_to_cli(data, tmp_path):
    """--min-insert / --max-insert narrower than the simulated inserts:
    fewer proper pairs, the same bytes in both CLIs."""
    flags = ("-k", "2", "--min-insert", "190", "--max-insert", "210")
    want, got, wide = tmp_path / "cli.sam", tmp_path / "port.sam", tmp_path / "wide.sam"
    _align(cli, data, want, *flags)
    _align(tcli, data, got, *flags)
    _align(tcli, data, wide, "-k", "2")
    assert got.read_bytes() == want.read_bytes() != wide.read_bytes()


@pytest.mark.parametrize("k", [1, 2])
def test_paired_tiered_divergence_matches_bwtpu(data, tmp_path, k):
    """Reference fault C.1, kept: --tiered is passed through on the paired
    path, so a mate with an exact hit elsewhere loses its nm >= 1 hit at
    the properly paired locus and the pair falls back to two primaries.
    The tiered and the full SAM each equal cli.py's, and they differ in
    the same records in both packages (the twin pairs among them)."""
    out = {}
    for mod in (cli, tcli):
        for tiered in (False, True):
            path = tmp_path / f"{mod.__name__}_{tiered}.sam"
            _align(mod, data, path, "-k", str(k), *(["--tiered"] if tiered else []))
            out[mod, tiered] = path.read_bytes()
    assert out[tcli, True] == out[cli, True] and out[tcli, False] == out[cli, False]
    full, tiered = _records(out[tcli, False]), _records(out[tcli, True])
    differ = {a.split(b"\t")[0] for a, b in zip(full, tiered) if a != b}
    assert {f"twin{i}".encode() for i in range(len(TWINS))} <= differ


@pytest.mark.parametrize("paired", [False, True])
def test_rescore_byte_equal_to_cli(data, tmp_path, paired):
    """--rescore: single-end input takes the Read-list path and each
    mapped read gets an AS:i tag (the port's sw_score_plain on the CPU
    against bwtpu's jnp sw_score_batch); with --paired, the paired
    Read-list loop runs and writes no AS tag, as in cli.py."""
    want, got = tmp_path / "cli.sam", tmp_path / "port.sam"
    for mod, path in ((cli, want), (tcli, got)):
        argv = ["align", str(data / "idx"), str(data / "r1.fq"), "-o", str(path), "-k", "2",
                "--batch-size", "64", "--rescore"]
        argv += ["--paired", str(data / "r2.fq")] if paired else []
        mod.main(argv + (["--device", "cpu"] if mod is tcli else []))
    sam = got.read_bytes()
    assert sam == want.read_bytes()
    n_as = sam.count(b"\tAS:i:")
    assert n_as == 0 if paired else n_as > 140


def test_paired_files_differing_in_read_count_exit(data, tmp_path, monkeypatch):
    short = tmp_path / "short.fq"
    short.write_bytes(b"".join((data / "r2.fq").read_bytes().splitlines(True)[:-4]))
    argv = ["align", str(data / "idx"), str(data / "r1.fq"), "--paired", str(short),
            "-o", str(tmp_path / "x.sam"), "--batch-size", "64", "--device", "cpu"]
    with pytest.raises(SystemExit, match="differ in read count"):
        tcli.main(argv)  # Read-list route: the columnar readers see two lengths
    with pytest.raises(SystemExit, match="differ in read count"):
        tcli.main(argv[:-4] + ["--batch-size", "200", "--device", "cpu"])  # one chunk each


def test_simulate_files_byte_equal_to_cli(tmp_path):
    """simulate with reads, N bases and pairs: the six files byte-equal."""
    flags = ["--scale", "6000", "--n-reads", "40", "--read-len", "50", "--mismatches", "1",
             "--n-frac", "0.02", "--pairs", "25", "--seed", "5"]
    cli.main(["simulate", "-o", str(tmp_path / "cli"), *flags])
    tcli.main(["simulate", "-o", str(tmp_path / "port"), *flags])
    names = ("ref.fa", "reads.fq", "truth.json", "reads_1.fq", "reads_2.fq",
             "truth_pairs.json")
    assert sorted(os.listdir(tmp_path / "port")) == sorted(names)
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "cli" / name).read_bytes()
