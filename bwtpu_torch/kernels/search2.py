"""Straggler finisher on torch tensors (counterpart of
bwtpu/kernels/search2.py::_two_gather_search, _fixup_stragglers_packed).

Plain torch in this slice; a hand-written kernel for it is ROADMAP
queue B2. The reference's `lax.cond` on the straggler count becomes a
Python `if` (one device sync)."""

from __future__ import annotations

import torch

from bwtpu_torch.kernels import common
from bwtpu_torch.kernels.compact import compact
from bwtpu_torch.kernels.prep import unpack_slice


def _two_gather_search(lattice, C, dollar_row: int, ra_codes, ra_amb, lens,
                       sp0, ep0, d: int):
    """Always-correct 1-step chain (two record gathers per step, any
    interval width) over right-aligned codes; lanes with lens == 0 stay
    put. Returns (sp, ep)."""
    B, L = ra_codes.shape
    sp, ep = sp0, ep0
    for t in range(L - d):
        pos = L - 1 - d - t
        c = ra_codes[:, pos]
        a = ra_amb[:, pos]
        active = pos >= (L - lens)
        o = common.occ(lattice, dollar_row, torch.cat([c, c]), torch.cat([sp, ep]))
        cbase = common.select_scalar_table(C, c + 1, 8)
        sp_new = torch.where(a == 1, 0, cbase + o[:B])
        ep_new = torch.where(a == 1, 0, cbase + o[B:])
        sp = torch.where(active, sp_new, sp)
        ep = torch.where(active, ep_new, ep)
    return sp, ep


def _fixup_stragglers_packed(lattice, C, dollar_row: int, words, amb_bits,
                             off: int, slen: int, sp0, ep0, sp, ep, strag,
                             d: int, cap: int):
    """Re-run the flagged lanes' whole chain over bases [off, off+slen)
    on the two-gather path, compacted to `cap` lanes. Returns (sp, ep,
    over_lane int32[B]): lanes past the capacity are forced empty and
    flagged, never silently wrong."""
    B = words.shape[0]
    sel, count, _ = compact(strag, cap)
    if int(strag.sum()) > 0:
        mini_ra = unpack_slice(words.index_select(0, sel), off, slen)
        mini_amb = unpack_slice(amb_bits.index_select(0, sel), off, slen)
        in_sel = torch.arange(cap, dtype=torch.int32, device=sel.device) < count
        mini_lens = torch.where(in_sel, slen, 0)
        msp0 = sp0.index_select(0, sel)
        mep0 = torch.where(in_sel, ep0.index_select(0, sel), 0)
        msp, mep = _two_gather_search(lattice, C, dollar_row, mini_ra,
                                      mini_amb, mini_lens, msp0, mep0, d)
        slot = torch.where(in_sel, sel, B).to(torch.int64)  # B = spill slot
        spill = sp.new_zeros(1)
        sp = torch.cat([sp, spill]).scatter(0, slot, msp)[:B]
        ep = torch.cat([ep, spill]).scatter(0, slot, mep)[:B]
    over_lane = strag & (torch.cumsum(strag.to(torch.int32), 0) > cap)
    sp = torch.where(over_lane, 0, sp)
    ep = torch.where(over_lane, 0, ep)
    return sp, ep, over_lane.to(torch.int32)
