"""bwtpu_torch's CLI against the repository's cli.py: byte-equal SAM.
Both run in-process; the port on the CPU (--device cpu)."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import cli  # noqa: E402
from bwtpu.io import read_fasta, write_fastq  # noqa: E402
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
    for flag, slice_no in ((["--tiered"], 4), (["--autotune-caps"], 4),
                           (["--rescore"], 7), (["--paired", str(fq)], 7)):
        with pytest.raises(NotImplementedError, match=f"slice {slice_no}"):
            tcli.main(base + flag)
