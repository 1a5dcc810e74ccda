"""Row gather with a column sum (counterpart of
scripts/pallas_gather_ab.py::build_dma_gather, the hand-built Pallas
gather of the TPU's gather-cost A/B).

`row_gather_sum` is the entry point: on CUDA tensors it launches the
hand-written kernel csrc/gather.cu (one CTA per G indices, row groups
with coalesced 16 B loads and `inflight` rows in flight each); on CPU
tensors it runs `row_gather_sum_plain`. Both return int32[8, Wr] with the
column sum of table[idx[:(n // G) * G]] in row 0, wrapping mod 2^32, and
rows 1-7 zero, as the TPU kernel's (8, Wr) accumulator block does.

The engine does not call it (the reference's engine has no such stage):
scripts/torch_gather_ab.py and chip_smoke.py measure it, and
`l2_fetch_granularity` reads and sets the card's L2 fetch granularity hint
for the A/B's probe.
"""

from __future__ import annotations

import ctypes

import torch

from bwtpu_torch.kernels import _build
from bwtpu_torch.kernels.common import i32

INFLIGHT = (4, 8, 16)  # rows in flight per row group (kernel variants)


def row_gather_sum_plain(table, idx, G: int = 1024):
    """Plain torch: index_select of the first (n // G) * G indices, an
    int32 column sum wrapping mod 2^32, in row 0 of a zero int32[8, Wr]."""
    n = (idx.shape[0] // G) * G
    out = torch.zeros((8, table.shape[1]), dtype=torch.int32, device=table.device)
    if n:
        out[0] = i32(table.index_select(0, idx[:n]).sum(0, dtype=torch.int64))
    return out


def row_gather_sum(table, idx, G: int = 1024, inflight: int = 8):
    """int32[8, Wr] (row 0 = the wrapped column sum of table[idx[:(n // G)
    * G]]): the CUDA kernel on CUDA tensors, `row_gather_sum_plain` on CPU
    tensors, else an error. Indices must lie in [0, N)."""
    if not _build.on_cuda("row_gather_sum", table):
        return row_gather_sum_plain(table, idx, G)
    dev = table.device
    _build.check_tensor("row_gather_sum", "table", table, torch.int32, 2, dev)
    _build.check_tensor("row_gather_sum", "idx", idx, torch.int32, 1, dev)
    if G < 1 or inflight not in INFLIGHT:
        raise ValueError(f"row_gather_sum: G = {G} must be >= 1 and inflight "
                         f"= {inflight} one of {INFLIGHT}")
    Wr = table.shape[1]
    vec = 4 if Wr % 4 == 0 and table.data_ptr() % 16 == 0 else 1
    out = torch.zeros((8, Wr), dtype=torch.int32, device=dev)
    n_blocks = idx.shape[0] // G
    if n_blocks == 0 or Wr == 0:
        return out
    lib = _lib()
    _build.launch(lib, lib.bwtpu_row_gather_sum, "row_gather_sum", table,
                  table.data_ptr(), Wr, vec, idx.data_ptr(), n_blocks, G, inflight,
                  out.data_ptr())
    _build.count_launch(row_gather_sum)
    return out


row_gather_sum.launches = 0  # kernel launches since the last reset


def l2_fetch_granularity(nbytes: int = 0) -> int:
    """The current CUDA device's L2 fetch granularity hint
    (cudaLimitMaxL2FetchGranularity) in bytes; when nbytes > 0 it is set
    to nbytes, and the value it had is returned. Raises on a CUDA error."""
    f = _lib().bwtpu_l2_fetch_granularity
    if f.argtypes is None:
        f.restype = ctypes.c_int
        f.argtypes = [ctypes.c_int]
    was = f(int(nbytes))
    if was < 0:
        raise RuntimeError(f"l2_fetch_granularity: cudaDeviceSetLimit({nbytes}) failed")
    return was


def _lib():
    lib = _build.library("gather")
    f = lib.bwtpu_row_gather_sum
    if f.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        f.restype = ctypes.c_int
        f.argtypes = [p, i, i, p, i, i, i, p, p]
    return lib
