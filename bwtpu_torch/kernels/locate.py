"""Batched locate (counterpart of bwtpu/kernels/locate.py).

`locate_walk` is the entry point: it locates the compacted rows
rows[sel[j]], j < count. At sa_rate > 1, on CUDA tensors it launches
the hand-written kernel csrc/locate.cu (one thread per lane gathers its
row, walks up to sa_rate dependent records and exits at its mark bit);
on CPU tensors it runs `_locate_plain`, the row gather and
`locate_rows`, the plain-torch version of the walk, which the tests
hold against bwtpu and chip_smoke.py holds the kernel against. At
sa_rate == 1 every row is sampled and ssa is the suffix array, so
locate is one masked element gather on any device, as in the
reference: no walk and no kernel.

Index ranges: valid rows lie in [0, n), so every record index r >> 7 is
a lattice row; a found lane's rank is < len(ssa); a lane not found in
sa_rate trips keeps rank 0 and reports ssa[0] + 0, as the reference does.
"""

from __future__ import annotations

import ctypes

import torch

from bwtpu_torch.kernels import _build, common


def locate_rows(lattice, ssa, C, dollar_row: int, rows, valid, sa_rate: int):
    """Plain torch: positions int32[B] of SA rows, -1 where not valid.

    The reference's fixed sa_rate-trip masked loop: done lanes gather
    block 0, found lanes latch (rank, steps). At sa_rate == 1, one ssa
    gather (lanes not valid gather row 0)."""
    if sa_rate == 1:
        return torch.where(valid, ssa.index_select(0, torch.where(valid, rows, 0)), -1)
    B = rows.shape[0]
    dev = rows.device
    r = torch.where(valid, rows, 0)
    done = ~valid
    rank_out = torch.zeros(B, dtype=torch.int32, device=dev)
    steps_out = torch.zeros(B, dtype=torch.int32, device=dev)
    for t in range(sa_rate):
        j = torch.where(done, 0, r >> common.LOG2_BLOCK)
        m = r & (common.BLOCK - 1)
        rec = lattice.index_select(0, j)
        bit, inrank = common.mark_bit_and_rank(rec, m)
        found = (bit == 1) & ~done
        rank_out = torch.where(found, rec[:, common.MARK_RANK_WORD] + inrank, rank_out)
        steps_out = torch.where(found, t, steps_out)
        done = done | found
        c = common.bwt_code_at(rec, m)
        ck = common.select_lane(rec[:, 0:4], c, 4)
        inblk = common.block_rank(rec[:, common.BWT_WORD0 : common.BWT_WORD0 + 8], c, m)
        corr = ((c == 0) & ((dollar_row >> common.LOG2_BLOCK) == j)
                & (dollar_row < r)).to(torch.int32)
        lf = common.select_scalar_table(C, c + 1, 8) + ck + inblk - corr
        r = torch.where(done, r, lf)
    pos = ssa.index_select(0, rank_out) + steps_out
    return torch.where(valid, pos, -1)


def _locate_plain(lattice, ssa, C, dollar_row: int, rows, sel, count, sa_rate: int):
    """Plain version of locate_walk: the row gather, then locate_rows."""
    valid = torch.arange(sel.shape[0], dtype=torch.int32, device=sel.device) < count
    # sel indexes rows everywhere (0 beyond count), so the gather is in range
    return locate_rows(lattice, ssa, C, dollar_row, rows.index_select(0, sel), valid,
                       sa_rate)


def locate_walk(lattice, ssa, C, dollar_row: int, rows, sel, count, sa_rate: int):
    """Positions int32[len(sel)] of the SA rows rows[sel[j]], j < count
    (`compact_counts`' outputs; count stays on the device), -1 beyond
    count: the CUDA kernel on CUDA tensors, `_locate_plain` on CPU
    tensors, else an error.

    The kernel replaces bwtpu/kernels/pallas_step.py::locate_step_pallas,
    the sa_rate-trip loop around it and the row gather before it. On the
    H100 it is bound by the latency of up to sa_rate dependent record
    loads per lane (the lattice sits in L2 at bacterial scale); each
    thread stops at its mark bit. At sa_rate == 1 no kernel runs (one
    ssa gather)."""
    if sa_rate == 1 or not _build.on_cuda("locate_walk", rows):
        return _locate_plain(lattice, ssa, C, dollar_row, rows, sel, count, sa_rate)
    dev = rows.device
    for name, t, ndim in (("lattice", lattice, 2), ("ssa", ssa, 1), ("C", C, 1),
                          ("rows", rows, 1), ("sel", sel, 1), ("count", count, 0)):
        _build.check_tensor("locate_walk", name, t, torch.int32, ndim, dev)
    if lattice.shape[1] != 32 or C.shape[0] < 5:
        raise ValueError("locate_walk: lattice must be [n_blocks+1, 32] and C [>=5]")
    if lattice.data_ptr() % 16:
        raise ValueError("locate_walk: lattice must be 16-byte aligned")
    pos = torch.empty_like(sel)
    lib = _lib()
    _build.launch(lib, lib.bwtpu_locate_walk, "locate_walk", rows,
                  lattice.data_ptr(), ssa.data_ptr(), C.data_ptr(), rows.data_ptr(),
                  sel.data_ptr(), count.data_ptr(), sel.shape[0], sa_rate, int(dollar_row),
                  pos.data_ptr())
    _build.count_launch(locate_walk)
    return pos


locate_walk.launches = 0  # kernel launches since the last reset


def _lib():
    lib = _build.library("locate")
    f = lib.bwtpu_locate_walk
    if f.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        f.restype = ctypes.c_int
        f.argtypes = [p, p, p, p, p, p, i, i, i, p, p]
    return lib
