"""On the card (gpu marker; skips without one): the harness on the tiny
configuration with the CUDA kernels, traced; and the faults."""

import logging

import pytest

from benchmark.control import readings
from benchmark.run import Session, run
from benchmark.tests.test_bm_harness import make_root

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def card_bench(tmp_path_factory):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    logging.disable(logging.WARNING)
    yield make_root(str(tmp_path_factory.mktemp("root")))
    logging.disable(logging.NOTSET)


def test_traced_run_on_the_card(card_bench):
    res, info = run(card_bench, "tiny.align", 2**31 + 11, 3.0, True, device="cuda")
    assert res["correct"] is True, (res, info)
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
    assert info["trace_anchored"] is True
    assert 0 < res["metrics"]["idle_share.align"]["value"] < 100
    assert res["metrics"]["kernel_ms_per_mread.align"]["value"] > 0


def test_sam_run_on_the_card(card_bench):
    res, info = run(card_bench, "tiny.sam", 12, 3.0, False, device="cuda")
    assert res["correct"] is True, (res, info)


@pytest.mark.parametrize("fault", ["stale", "half", "altered", "tiered"])
def test_faults_on_the_card(card_bench, fault):
    sess = Session(card_bench, "tiny.align", "cuda")
    (rec,) = readings(sess, [13], [fault], 1.0)
    assert rec["correct"] is False and rec["wrong_reads"] > 0, rec
