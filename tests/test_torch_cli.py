"""bwtpu_torch's CLI against the repository's cli.py: byte-equal SAM.
Both run in-process; the port on the CPU (--device cpu)."""

import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import cli  # noqa: E402
from bwtpu.io import read_fasta, write_fasta, write_fastq  # noqa: E402
from bwtpu.simulate import simulate_reads  # noqa: E402
from bwtpu_torch import cli as tcli  # noqa: E402

torch.set_num_threads(1)

PHIX = os.path.join(ROOT, "data", "phiX174.fa")
PHIX_SAM = os.path.join(ROOT, "data", "phiX174_golden.sam")


@pytest.mark.parametrize("k", [0, 2])
def test_align_sam_byte_equal_to_cli(tmp_path, k):
    sim, idx = tmp_path / "sim", tmp_path / "idx"
    cli.main(["simulate", "--scale", "20000", "-o", str(sim), "--n-reads", "70",
              "--read-len", "60", "--mismatches", "2", "--n-frac", "0.01",
              "--seed", "11"])
    tcli.main(["build-index", str(sim / "ref.fa"), str(idx)])  # CLI defaults
    want, got = tmp_path / "bwtpu.sam", tmp_path / "port.sam"
    cli.main(["align", str(idx), str(sim / "reads.fq"), "-o", str(want),
              "-k", str(k), "--batch-size", "32"])
    summary = tcli.main(["align", str(idx), str(sim / "reads.fq"), "-o", str(got),
                         "-k", str(k), "--batch-size", "32", "--device", "cpu"])
    assert got.read_bytes() == want.read_bytes()
    assert summary["reads"] == 70 and summary["truncated_reads"] == 0


@pytest.mark.parametrize("k", [0, 2])
@pytest.mark.parametrize("fmt", ["fasta", "mixed_fastq"])
def test_read_list_and_ragged_sam_byte_equal_to_cli(tmp_path, fmt, k):
    """FASTA reads go to the Read-list path, mixed-length FASTQ to the
    length-bucketed block stream, in both CLIs."""
    sim, idx = tmp_path / "sim", tmp_path / "idx"
    cli.main(["simulate", "--scale", "20000", "-o", str(sim), "--n-reads", "10",
              "--seed", "12"])
    genome, _ = read_fasta(str(sim / "ref.fa"))
    tcli.main(["build-index", str(sim / "ref.fa"), str(idx), "--read-len", "60"])
    reads = []
    for L in (35, 60):
        reads += simulate_reads(genome, 40, read_len=L, max_mismatches=2, n_frac=0.01,
                                seed=L)[0]
    reads = [reads[j] for j in np.random.default_rng(k).permutation(len(reads))]
    for i, r in enumerate(reads):
        r.rid = f"q{i}"
    path = tmp_path / ("reads.fa" if fmt == "fasta" else "reads.fq")
    if fmt == "fasta":
        write_fasta(str(path), [(r.rid, r.seq) for r in reads])
    else:
        write_fastq(str(path), reads)
    want, got = tmp_path / "bwtpu.sam", tmp_path / "port.sam"
    cli.main(["align", str(idx), str(path), "-o", str(want), "-k", str(k),
              "--batch-size", "40"])
    summary = tcli.main(["align", str(idx), str(path), "-o", str(got), "-k", str(k),
                         "--batch-size", "40", "--device", "cpu"])
    assert got.read_bytes() == want.read_bytes()
    assert summary["reads"] == 80 and summary["overflow_reads"] == 0
    assert got.read_bytes().count(b"\tNM:i:") > 10


def test_phix_golden_sam(tmp_path):
    """The port's block path over data/phiX174.fa with the fixture's
    reads (tests/test_data_fixtures.py) is byte-equal to the golden SAM."""
    seq, _ = read_fasta(PHIX)
    reads = simulate_reads(seq, 64, read_len=50, max_mismatches=2, n_frac=0.01,
                           seed=174)[0]
    fq, idx, out = tmp_path / "r.fq", tmp_path / "idx", tmp_path / "out.sam"
    write_fastq(str(fq), reads)
    tcli.main(["build-index", PHIX, str(idx), "--sa-rate", "4", "--read-len", "50",
               "--max-hits", "8", "--max-cand", "8"])
    tcli.main(["align", str(idx), str(fq), "-o", str(out), "-k", "2",
               "--batch-size", "48", "--device", "cpu"])
    with open(PHIX_SAM, "rb") as f:
        assert out.read_bytes() == f.read()


def test_resume_and_uncovered_options(tmp_path):
    seq, _ = read_fasta(PHIX)
    reads = simulate_reads(seq, 40, read_len=50, max_mismatches=1, seed=5)[0]
    fq, idx, out = tmp_path / "r.fq", tmp_path / "idx", tmp_path / "out.sam"
    write_fastq(str(fq), reads)
    tcli.main(["build-index", PHIX, str(idx), "--sa-rate", "4", "--read-len", "50"])
    base = ["align", str(idx), str(fq), "-o", str(out), "-k", "1",
            "--batch-size", "10", "--device", "cpu"]
    tcli.main(base)
    full = out.read_bytes()
    lines = full.decode().splitlines(keepends=True)
    header = [x for x in lines if x.startswith("@")]
    body = [x for x in lines if not x.startswith("@")]
    out.write_text("".join(header + body[:20]))
    (tmp_path / "out.sam.cursor").write_text('{"next_batch": 2}')
    tcli.main(base + ["--resume"])
    assert out.read_bytes() == full
    # --tiered, --esc-factor and --autotune-caps (tests/test_torch_tiered.py),
    # --paired, --rescore and simulate (tests/test_torch_paired.py) are
    # covered elsewhere. --profile DIR (slice 9) takes the Read-list route
    # inside a torch.profiler window: a Chrome trace in DIR, created if
    # needed, and the SAM bytes of the run without it
    prof = tmp_path / "prof" / "run1"
    tcli.main(base + ["--profile", str(prof)])
    assert out.read_bytes() == full
    traces = list(prof.glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    # bench (slice 9) parses its own options: an unknown one fails in argparse
    with pytest.raises(SystemExit) as e:
        tcli.main(["bench", "--no-such-option"])
    assert e.value.code == 2
    # scaling is ported (slice 8): one process is a gloo world of one
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        tcli.main(["scaling", "--shards", "1", "--genome-bp", "20000", "--n-reads", "256",
                   "--device", "cpu"])
    line = json.loads(printed.getvalue().strip().splitlines()[-1])
    assert line["event"] == "scaling" and [r["n_data"] for r in line["rows"]] == [1]
