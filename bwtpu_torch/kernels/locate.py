"""Batched LF-walk locate at sa_rate > 1 (counterpart of
bwtpu/kernels/locate.py).

`locate_walk` is the entry point: on CUDA tensors it launches the
hand-written kernel csrc/locate.cu (one thread per lane walks up to
sa_rate dependent records and exits at its mark bit); on CPU tensors it
runs `locate_rows`, the plain-torch version of the same function, which
the tests hold against bwtpu and chip_smoke.py holds the kernel against.

Index ranges: valid rows lie in [0, n), so every record index r >> 7 is
a lattice row; a found lane's rank is < len(ssa); a lane not found in
sa_rate trips keeps rank 0 and reports ssa[0] + 0, as the reference does.
"""

from __future__ import annotations

import ctypes

import torch

from bwtpu_torch.kernels import _build, common


def _not_covered(sa_rate: int):
    if sa_rate == 1:
        raise NotImplementedError(
            "sa_rate == 1 (one ssa gather / fused locate+verify rows) is "
            "ROADMAP slice 2 of the port")


def locate_rows(lattice, ssa, C, dollar_row: int, rows, valid, sa_rate: int):
    """Plain torch: positions int32[B] of SA rows, -1 where not valid.

    The reference's fixed sa_rate-trip masked loop: done lanes gather
    block 0, found lanes latch (rank, steps)."""
    _not_covered(sa_rate)
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


def locate_walk(lattice, ssa, C, dollar_row: int, rows, valid, sa_rate: int):
    """Positions int32[B] of SA rows (-1 where not valid): the CUDA kernel
    on CUDA tensors, `locate_rows` on CPU tensors, else an error.

    The kernel replaces bwtpu/kernels/pallas_step.py::locate_step_pallas
    and the sa_rate-trip loop around it. On the H100 it is bound by the
    latency of up to sa_rate dependent 128 B record loads per lane (the
    lattice sits in L2 at bacterial scale); each thread stops at its
    mark bit."""
    _not_covered(sa_rate)
    dev = rows.device
    if dev.type == "cpu":
        return locate_rows(lattice, ssa, C, dollar_row, rows, valid, sa_rate)
    if dev.type != "cuda":
        raise ValueError(f"locate_walk: no kernel for device {dev}")
    for name, t, dtype, ndim in (("lattice", lattice, torch.int32, 2),
                                 ("ssa", ssa, torch.int32, 1),
                                 ("C", C, torch.int32, 1),
                                 ("rows", rows, torch.int32, 1),
                                 ("valid", valid, torch.bool, 1)):
        _build.check_tensor("locate_walk", name, t, dtype, ndim, dev)
    if lattice.shape[1] != 32 or C.shape[0] < 5 or valid.shape != rows.shape:
        raise ValueError("locate_walk: lattice must be [n_blocks+1, 32], C "
                         "[>=5] and valid shaped like rows")
    if lattice.data_ptr() % 16:
        raise ValueError("locate_walk: lattice must be 16-byte aligned")
    pos = torch.empty_like(rows)
    lib = _lib()
    rc = lib.bwtpu_locate_walk(
        lattice.data_ptr(), ssa.data_ptr(), C.data_ptr(), rows.data_ptr(),
        valid.data_ptr(), rows.shape[0], sa_rate, int(dollar_row),
        pos.data_ptr(), _build.stream_of(rows),
    )
    _build.check(lib, rc, "locate_walk")
    _build.count_launch(locate_walk)
    return pos


locate_walk.launches = 0  # kernel launches since the last reset


def _lib():
    lib = _build.library("locate")
    f = lib.bwtpu_locate_walk
    if f.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        f.restype = ctypes.c_int
        f.argtypes = [p, p, p, p, p, i, i, i, p, p]
    return lib
