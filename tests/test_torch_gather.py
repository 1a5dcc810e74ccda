"""bwtpu_torch.kernels.gather.row_gather_sum_plain against the Pallas
row gather of scripts/pallas_gather_ab.py (build_dma_gather, interpret
mode on the CPU): row 0 = the int32 column sum of table[idx[:n_blocks *
G]], wrapping mod 2^32; rows 1-7 zero. Exact equality."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bwtpu_torch.kernels.gather import row_gather_sum, row_gather_sum_plain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pallas_ab():
    spec = importlib.util.spec_from_file_location(
        "pallas_gather_ab", os.path.join(ROOT, "scripts", "pallas_gather_ab.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("Wr,N,G,n_idx,K", [
    (16, 4096, 1024, 2 * 1024 + 300, 8),  # a locv row at L 100; the default G
    (128, 300, 64, 5 * 64 + 17, 4),  # a multi-step lattice record
])
def test_row_gather_sum_plain_matches_pallas(pallas_ab, Wr, N, G, n_idx, K):
    rng = np.random.default_rng(Wr)
    # values near +-2^31: the column sums wrap
    table = rng.integers(-2**31, 2**31, size=(N, Wr), dtype=np.int64).astype(np.int32)
    idx = rng.integers(0, N, size=n_idx).astype(np.int32)
    want = np.asarray(pallas_ab.build_dma_gather(N, Wr, n_idx, G=G, K=K, interpret=True)(
        jnp.asarray(idx), jnp.asarray(table)))
    got = row_gather_sum_plain(torch.from_numpy(table), torch.from_numpy(idx), G).numpy()
    assert got.dtype == np.int32 and got.shape == (8, Wr)
    np.testing.assert_array_equal(got, want)
    exact = table[idx[: (n_idx // G) * G]].astype(np.int64).sum(0)
    assert (np.abs(exact) >= 2**31).any()  # the sum did wrap
    assert (got[1:] == 0).all()
    # the wrapper runs the plain version on CPU tensors, launching nothing
    before = row_gather_sum.launches
    np.testing.assert_array_equal(
        row_gather_sum(torch.from_numpy(table), torch.from_numpy(idx), G).numpy(), got)
    assert row_gather_sum.launches == before


def test_row_gather_sum_fewer_indices_than_a_block():
    table = torch.arange(40, dtype=torch.int32).reshape(10, 4)
    out = row_gather_sum_plain(table, torch.tensor([1, 2, 3], dtype=torch.int32), 4)
    assert torch.equal(out, torch.zeros((8, 4), dtype=torch.int32))
