"""1-step backward search on torch tensors (counterpart of
bwtpu/kernels/search2.py and of the two search steps in
bwtpu/kernels/pallas_step.py).

Plain versions: `search_step1` (one step of both bounds from ONE record,
the one of block sp >> 7, flagging stragglers) and `search_step` (one
step from the two records of sp's and ep's blocks, valid at any width),
and the chains built on them, `_search_ra_chain` and `_two_gather_search`.

Kernel wrappers: `search_chain1` (csrc/search1.cu) and `search_chain2`
(csrc/search2.cu) launch a kernel on CUDA tensors and run the plain
chain on CPU tensors; anything else raises, and nothing falls back.
`backward_search_ra` with its straggler fixup, and the packed search's
finisher (searchk.py), run on them. The reference's `lax.cond` on the
straggler count has no counterpart: the count stays on the device and
the kernel's threads past it exit, so the finishers do not sync.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from bwtpu_torch.kernels import _build, common
from bwtpu_torch.kernels.compact import compact
from bwtpu_torch.kernels.prep import unpack_slice


def _update(c, amb, active, sp, ep, o_sp, o_ep, C):
    """New (sp, ep) of the active lanes; an ambiguous base empties them."""
    cbase = common.select_scalar_table(C, c + 1, 8)
    sp_new = torch.where(amb == 1, 0, cbase + o_sp)
    ep_new = torch.where(amb == 1, 0, cbase + o_ep)
    return torch.where(active, sp_new, sp), torch.where(active, ep_new, ep)


def search_step1(rec, c, amb, active, sp, ep, C, dollar_row: int):
    """One search step from the record of block sp >> 7 (counterpart of
    pallas_step.search_step1_pallas). Returns (sp, ep, strag int32):
    strag flags active lanes whose ep lies past block j + 1 (their new
    ep is stale)."""
    o_sp, o_ep, s2 = common.occ_pair_from_record(rec, dollar_row, c, sp, ep)
    sp, ep = _update(c, amb, active, sp, ep, o_sp, o_ep, C)
    return sp, ep, (active & s2).to(torch.int32)


def search_step(rec_sp, rec_ep, c, amb, active, sp, ep, C, dollar_row: int):
    """One search step from the records of blocks sp >> 7 and ep >> 7
    (counterpart of pallas_step.search_step_pallas). Returns (sp, ep)."""
    o_sp = common.occ_from_records(rec_sp, dollar_row, c, sp)
    o_ep = common.occ_from_records(rec_ep, dollar_row, c, ep)
    return _update(c, amb, active, sp, ep, o_sp, o_ep, C)


def _steps(ra_codes, ra_amb, lens, d: int):
    """Per step t of a chain: (base codes, ambiguity, active lanes) at the
    uniform right-aligned position L - 1 - d - t."""
    L = ra_codes.shape[1]
    for t in range(L - d):
        pos = L - 1 - d - t
        yield ra_codes[:, pos], ra_amb[:, pos], pos >= (L - lens)


def _search_ra_chain(lattice, C, dollar_row: int, ra_codes, ra_amb, lens,
                     sp0, ep0, d: int):
    """Plain mainline of backward_search_ra: L - d one-record steps.
    Returns (sp, ep, strag bool); a straggler's ep (and so its sp and ep
    after later steps) is garbage. sp stays in [0, n] on every lane, so
    sp >> 7 is a lattice row (n_blocks + 1 rows)."""
    sp, ep = sp0, ep0
    strag = torch.zeros(sp0.shape[0], dtype=torch.bool, device=sp0.device)
    for c, a, active in _steps(ra_codes, ra_amb, lens, d):
        rec = lattice.index_select(0, sp >> common.LOG2_BLOCK)
        sp, ep, s2 = search_step1(rec, c, a, active, sp, ep, C, dollar_row)
        strag = strag | (s2 == 1)
    return sp, ep, strag


def _two_gather_search(lattice, C, dollar_row: int, ra_codes, ra_amb, lens,
                       sp0, ep0, d: int):
    """Plain always-correct chain (two record gathers per step, any
    interval width) over right-aligned codes; lanes with lens == 0 stay
    put. Returns (sp, ep), which stay in [0, n], so both gathers are
    lattice rows."""
    sp, ep = sp0, ep0
    for c, a, active in _steps(ra_codes, ra_amb, lens, d):
        rec_sp = lattice.index_select(0, sp >> common.LOG2_BLOCK)
        rec_ep = lattice.index_select(0, ep >> common.LOG2_BLOCK)
        sp, ep = search_step(rec_sp, rec_ep, c, a, active, sp, ep, C, dollar_row)
    return sp, ep


def _check_chain_args(kernel, lattice, C, ra_codes, ra_amb, lens, sp0, ep0, d):
    dev = ra_codes.device
    for name, t, ndim in (("lattice", lattice, 2), ("C", C, 1),
                          ("ra_codes", ra_codes, 2), ("ra_amb", ra_amb, 2),
                          ("lens", lens, 1), ("sp0", sp0, 1), ("ep0", ep0, 1)):
        _build.check_tensor(kernel, name, t, torch.int32, ndim, dev)
    B, L = ra_codes.shape
    if lattice.shape[1] != 32 or C.shape[0] < 5:
        raise ValueError(f"{kernel}: lattice must be [n_blocks+1, 32] and C [>=5]")
    if ra_amb.shape != (B, L) or not (lens.shape == sp0.shape == ep0.shape == (B,)):
        raise ValueError(f"{kernel}: per-lane inputs disagree in shape")
    if not 0 <= d <= L:
        raise ValueError(f"{kernel}: d = {d} not in [0, {L}]")
    if lattice.data_ptr() % 16:
        raise ValueError(f"{kernel}: lattice must be 16-byte aligned")


def search_chain1(lattice, C, dollar_row: int, ra_codes, ra_amb, lens, sp0, ep0,
                  d: int):
    """The mainline of backward_search_ra: (sp, ep, strag bool). The CUDA
    kernel on CUDA tensors, `_search_ra_chain` on CPU tensors, else an
    error. A kernel thread stages its lane's pattern in registers, then
    runs its chain with nothing but record loads on it (any L: rows are
    restaged every 128 steps), and stops at its lane's first straggle, so
    a flagged lane's sp and ep may differ from the plain version's (both
    are garbage there and overwritten by the fixup); flags and every
    other lane are equal."""
    if not _build.on_cuda("search_chain1", ra_codes):
        return _search_ra_chain(lattice, C, dollar_row, ra_codes, ra_amb, lens,
                                sp0, ep0, d)
    _check_chain_args("search_chain1", lattice, C, ra_codes, ra_amb, lens, sp0, ep0, d)
    B, L = ra_codes.shape
    sp, ep = torch.empty_like(sp0), torch.empty_like(ep0)
    strag = torch.empty(B, dtype=torch.bool, device=sp0.device)
    lib = _build.library("search1")
    f = lib.bwtpu_search_chain1
    if f.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        f.restype = i
        f.argtypes = [p, p, i, p, p, p, p, p, i, i, i, p, p, p, p]
    _build.launch(lib, f, "search_chain1", sp0,
                  lattice.data_ptr(), C.data_ptr(), int(dollar_row), ra_codes.data_ptr(),
                  ra_amb.data_ptr(), lens.data_ptr(), sp0.data_ptr(), ep0.data_ptr(), B, L, d,
                  sp.data_ptr(), ep.data_ptr(), strag.data_ptr())
    _build.count_launch(search_chain1)
    return sp, ep, strag


search_chain1.launches = 0  # kernel launches since the last reset


class Packed(NamedTuple):
    """A finisher's patterns as the packed pipelines hold them: bases
    [off, off + slen) of each 2-bit packed row (int32[B, W] words and
    ambiguity bits, prep.py's layout)."""

    words: torch.Tensor
    amb_bits: torch.Tensor
    off: int
    slen: int


class Planes(NamedTuple):
    """A finisher's patterns as the 1-step path holds them: right-aligned
    int32[B, L] code and ambiguity planes and int32[B] lengths."""

    codes: torch.Tensor
    amb: torch.Tensor
    lens: torch.Tensor


def lane_planes(pattern, lanes):
    """(codes, amb, lens) of the given lanes (int64) of a `Packed` or
    `Planes` pattern, as `_two_gather_search` takes them."""
    if isinstance(pattern, Packed):
        codes = unpack_slice(pattern.words.index_select(0, lanes), pattern.off, pattern.slen)
        amb = unpack_slice(pattern.amb_bits.index_select(0, lanes), pattern.off,
                           pattern.slen)
        return codes, amb, torch.full_like(lanes, pattern.slen, dtype=torch.int32)
    return tuple(x.index_select(0, lanes) for x in pattern)


def _chain2_plain(lattice, C, dollar_row: int, pattern, sp0, ep0, sel, count, sp, ep,
                  d: int) -> None:
    """Plain version of search_chain2: gathers (and unpacks) the lanes
    sel[:count], runs `_two_gather_search` on them and writes their (sp,
    ep) into sp and ep in place."""
    lanes = sel[: int(count)].to(torch.int64)
    codes, amb, lens = lane_planes(pattern, lanes)
    msp, mep = _two_gather_search(lattice, C, dollar_row, codes, amb, lens,
                                  sp0.index_select(0, lanes), ep0.index_select(0, lanes), d)
    sp[lanes] = msp
    ep[lanes] = mep


def search_chain2(lattice, C, dollar_row: int, pattern, sp0, ep0, sel, count, sp, ep,
                  d: int) -> None:
    """The always-correct chain over the compacted lanes sel[j], j <
    count (`compact`'s outputs; count stays on the device): each such
    lane's chain from (sp0, ep0)[lane] over its pattern (`Packed` or
    `Planes`), written into sp[lane] and ep[lane] IN PLACE; no other
    lane is touched. The CUDA kernel on CUDA tensors, `_chain2_plain` on
    CPU tensors, else an error."""
    if not _build.on_cuda("search_chain2", sp):
        return _chain2_plain(lattice, C, dollar_row, pattern, sp0, ep0, sel, count, sp, ep,
                             d)
    dev = sp.device
    named = [("lattice", lattice, 2), ("C", C, 1), ("sp0", sp0, 1), ("ep0", ep0, 1),
             ("sel", sel, 1), ("count", count, 0), ("sp", sp, 1), ("ep", ep, 1)]
    named += [(f"pattern.{k}", v, 2 if k != "lens" else 1)
              for k, v in pattern._asdict().items() if isinstance(v, torch.Tensor)]
    for name, t, ndim in named:
        _build.check_tensor("search_chain2", name, t, torch.int32, ndim, dev)
    B = sp.shape[0]
    if lattice.shape[1] != 32 or C.shape[0] < 5 or lattice.data_ptr() % 16:
        raise ValueError("search_chain2: lattice must be a 16-byte aligned "
                         "[n_blocks+1, 32] and C [>=5]")
    if not (sp0.shape == ep0.shape == ep.shape == (B,)):
        raise ValueError("search_chain2: per-lane inputs disagree in shape")
    packed = isinstance(pattern, Packed)
    if packed:
        W = pattern.words.shape[1]
        if not (pattern.words.shape == pattern.amb_bits.shape == (B, W)
                and 0 <= d <= pattern.slen and pattern.off >= 0
                and pattern.off + pattern.slen <= 16 * W):
            raise ValueError("search_chain2: packed rows, slice and d disagree")
        ptrs = (pattern.words.data_ptr(), pattern.amb_bits.data_ptr(), W,
                int(pattern.off), int(pattern.slen))
    else:
        L = pattern.codes.shape[1]
        if not (pattern.codes.shape == pattern.amb.shape == (B, L)
                and pattern.lens.shape == (B,) and 0 <= d <= L):
            raise ValueError("search_chain2: planes and d disagree")
        ptrs = (pattern.codes.data_ptr(), pattern.amb.data_ptr(), pattern.lens.data_ptr(), L)
    lib, f = _chain2_entry(packed)
    _build.launch(lib, f, "search_chain2", sp,
                  lattice.data_ptr(), C.data_ptr(), int(dollar_row), *ptrs, sp0.data_ptr(),
                  ep0.data_ptr(), sel.data_ptr(), count.data_ptr(), sel.shape[0], d,
                  sp.data_ptr(), ep.data_ptr())
    _build.count_launch(search_chain2)


search_chain2.launches = 0  # kernel launches since the last reset


def _chain2_entry(packed: bool):
    """(library, entry point) of search2.cu for Packed or Planes patterns."""
    lib = _build.library("search2")
    f = lib.bwtpu_search_chain2_packed if packed else lib.bwtpu_search_chain2_planes
    if f.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        head = [p, p, i, p, p] + ([i] * 3 if packed else [p, i])
        f.restype = i
        f.argtypes = head + [p] * 4 + [i] * 2 + [p] * 3
    return lib, f


# ---------------------------------------------------------------------------
# backward search over right-aligned patterns, and its straggler fixup
# ---------------------------------------------------------------------------


def start_intervals(kmer_table, n: int, ra_codes, ra_amb, lens, d: int):
    """(sp0, ep0) of right-aligned patterns: the k-mer table row of the
    last d bases ([0, 0) when one of them is ambiguous or the lane is
    empty); for d = 0, [0, n) ([0, 0) for empty lanes)."""
    B, L = ra_codes.shape
    dev = ra_codes.device
    if d == 0:
        return (torch.zeros(B, dtype=torch.int32, device=dev),
                torch.where(lens == 0, 0, n).to(torch.int32))
    weights = torch.from_numpy(4 ** np.arange(d - 1, -1, -1, dtype=np.int32)).to(dev)
    # codes are in [0, 4), so key < 4^d is a row of the table
    key = (ra_codes[:, L - d:] * weights).sum(1, dtype=torch.int32)
    start = kmer_table.index_select(0, key)
    empty = (ra_amb[:, L - d:].sum(1) > 0) | (lens == 0)
    return torch.where(empty, 0, start[:, 0]), torch.where(empty, 0, start[:, 1])


def backward_search_ra(lattice, C, dollar_row: int, n: int, kmer_table, ra_codes,
                       ra_amb, lens, d: int, cap_scale: int = 1):
    """Exact backward search of right-aligned patterns (lens >= d or 0):
    start_intervals, the one-record mainline, then the two-record fixup
    of the stragglers on min(B, max(256, B // 8) * cap_scale) lanes.
    Returns (sp, ep, over_lane int32[B]): lanes past the fixup capacity
    are forced empty and flagged."""
    B = ra_codes.shape[0]
    sp0, ep0 = start_intervals(kmer_table, n, ra_codes, ra_amb, lens, d)
    sp, ep, strag = search_chain1(lattice, C, dollar_row, ra_codes, ra_amb, lens,
                                  sp0, ep0, d)
    return _fixup_stragglers(lattice, C, dollar_row, ra_codes, ra_amb, lens,
                             sp0, ep0, sp, ep, strag, d,
                             cap=min(B, max(256, B // 8) * cap_scale))


def _force_over(sp, ep, over):
    """Force the flagged lanes past the fixup capacity (`compact`'s over
    flag) empty; returns (sp, ep, over_lane int32)."""
    sp = torch.where(over, 0, sp)
    ep = torch.where(over, 0, ep)
    return sp, ep, over.to(torch.int32)


def _fixup_stragglers(lattice, C, dollar_row: int, ra_codes, ra_amb, lens,
                      sp0, ep0, sp, ep, strag, d: int, cap: int):
    """Re-run the flagged lanes' whole chain from (sp0, ep0) on the
    two-record chain, compacted to `cap` lanes; sp and ep are updated in
    place. Returns (sp, ep, over_lane int32[B]): lanes past the capacity
    are forced empty and flagged, never silently wrong."""
    sel, count, _, over = compact(strag, cap)
    search_chain2(lattice, C, dollar_row, Planes(ra_codes, ra_amb, lens), sp0, ep0, sel,
                  count, sp, ep, d)
    return _force_over(sp, ep, over)


def right_align(codes: np.ndarray, amb: np.ndarray, lens: np.ndarray):
    """Host-side: shift each row right so it ends at column L-1 (NumPy)."""
    B, L = codes.shape
    idx = np.arange(L)[None, :] - (L - lens)[:, None]
    safe = np.clip(idx, 0, L - 1)
    ra_c = np.take_along_axis(codes, safe, axis=1)
    ra_a = np.take_along_axis(amb, safe, axis=1)
    pad = idx < 0
    ra_c[pad] = 0
    ra_a[pad] = 0
    return ra_c, ra_a
