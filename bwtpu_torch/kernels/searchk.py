"""Multi-step early-stop backward search on torch tensors (counterpart of
bwtpu/kernels/searchk.py::occk_pair_from_record, search_early_stop_packed).

Plain torch in this slice (a hand-written kernel is ROADMAP queue B2).
Per-lane (sp, ep, rem, overflow) equal the reference's, so the
whole-batch exit test of its while_loop is kept as written:
`(t < T) & ((n_pool > cap) | (t < min_trips))` — one `.item()` sync
per trip once min_trips is past.
"""

from __future__ import annotations

import torch

from bwtpu_torch.index import OCCK_BLOCK
from bwtpu_torch.kernels import common, prep
from bwtpu_torch.kernels.search2 import _fixup_stragglers_packed


def occk_pair_from_record(rec, t, sp, ep, inv, A: int, R: int):
    """Ks[t] + OccS(t, .) at sp and ep from the record of block sp // R.

    rec: (B, W) int32 records; t: (B,) s-mer codes; inv: (4,) int32
    rows with SA[r] < step (-1 pad). Returns (sp', ep', strag): strag
    flags lanes whose ep lies past the record's R-row window.
    """
    B = rec.shape[0]
    log2r = R.bit_length() - 1
    fold = common.select_lane(rec[:, :A], t, A)
    shifts = torch.arange(0, 32, 8, dtype=torch.int32, device=rec.device)
    codes = ((rec[:, A : A + R // 4].unsqueeze(-1) >> shifts) & 0xFF).reshape(B, R)
    match = codes == t.unsqueeze(1)
    idx = torch.arange(R, dtype=torch.int32, device=rec.device).unsqueeze(0)
    base = (sp >> log2r) << log2r
    msp = sp - base
    mep = ep - base
    cnt_sp = (match & (idx < msp.unsqueeze(1))).sum(1, dtype=torch.int32)
    cnt_ep = (match & (idx < mep.unsqueeze(1))).sum(1, dtype=torch.int32)
    # invalid rows (stored code 0, excluded from fold): subtract when the
    # query s-mer is 0 and the row falls inside the counted prefix
    t0 = t == 0
    for q in range(4):
        r = inv[q]
        in_blk = (r >= base) & (r >= 0)
        off = r - base
        cnt_sp = cnt_sp - (t0 & in_blk & (off < msp)).to(torch.int32)
        cnt_ep = cnt_ep - (t0 & in_blk & (off < mep)).to(torch.int32)
    return fold + cnt_sp, fold + cnt_ep, mep > R


def search_early_stop_packed(lattice, latk, latk_inv, C, dollar_row: int,
                             kmer_table, words, amb_bits, off: int, L: int,
                             d: int, step: int, stop_width: int,
                             min_trips: int = 0, cap_scale: int = 1,
                             wide_steps: int = 0, with_stats: bool = False):
    """Backward search of the pattern bases [off, off+L) of each packed
    row that stops each lane once ep - sp <= stop_width.

    Returns (sp, ep, remaining, overflow): the interval matches the
    pattern SUFFIX P[remaining:]; lanes that stay wide or straggle finish
    on the compacted two-gather chain with remaining == 0; overflow flags
    (int32[B]) the lanes past that finisher's capacity. Index ranges of
    the gathers: key < 4^d, and sp // R <= n // R for active lanes.

    with_stats: also return the multi-step trips taken (int) and the
    number of lanes handed to the finisher (int32 0-dim), as bwtpu's
    (sp, ep, rem, overflow, trips, n_unf); the bench's roofline reads them.
    """
    assert d >= 1 and L >= d and step in (3, 4), (L, d, step)
    assert 0 <= wide_steps <= L - d, (wide_steps, L, d)
    A = 4**step
    R = OCCK_BLOCK[step]
    B = words.shape[0]
    dev = words.device

    key, amb_tail = prep.kmer_key_packed(words, amb_bits, off, L, d)
    start = kmer_table.index_select(0, key)
    sp0 = torch.where(amb_tail, 0, start[:, 0])
    ep0 = torch.where(amb_tail, 0, start[:, 1])

    chain = L - d
    rem = torch.full((B,), chain, dtype=torch.int32, device=dev)
    strag = torch.zeros(B, dtype=torch.bool, device=dev)
    width0 = ep0 - sp0
    stopped = (width0 <= 0) if min_trips > 0 else (width0 <= stop_width)
    sp, ep = sp0, ep0

    # wide phase: always-correct two-gather 1-step narrowings
    for ws in range(wide_steps):
        posn = off + chain - 1 - ws
        c = prep.extract_bits(words, posn, 2).to(torch.int32)
        a = prep.extract_bits(amb_bits, posn, 2) != 0
        act = ~stopped
        spm = torch.where(act, sp, 0)
        epm = torch.where(act, ep, 0)
        o = common.occ(lattice, dollar_row, torch.cat([c, c]), torch.cat([spm, epm]))
        cbase = common.select_scalar_table(C, c + 1, 8)
        spn = torch.where(a, 0, cbase + o[:B])
        epn = torch.where(a, 0, cbase + o[B:])
        sp = torch.where(act, spn, sp)
        ep = torch.where(act, epn, ep)
        rem = torch.where(act, rem - 1, rem)
        stopped = stopped | (act & ((ep - sp) <= 0))

    chain = chain - wide_steps
    p = chain % step
    T = chain // step

    cap = min(B, max(256, B // 64) * cap_scale)
    t = 0
    if T > 0:
        t_all, a_all = prep.smer_codes_packed(words, amb_bits, off + p, T, step)
        while t < T:
            if t >= min_trips and int((~stopped & ~strag).sum()) <= cap:
                break
            g = T - 1 - t
            tS = t_all[:, g]
            aS = a_all[:, g]
            active = ~stopped & ~strag
            # inactive lanes gather record 0, as the reference does
            rec = latk.index_select(0, torch.where(active, sp // R, 0))
            sp_n, ep_n, sK = occk_pair_from_record(rec, tS, sp, ep, latk_inv, A, R)
            sp_n = torch.where(aS, 0, sp_n)
            ep_n = torch.where(aS, 0, ep_n)
            sp = torch.where(active, sp_n, sp)
            ep = torch.where(active, ep_n, ep)
            rem = torch.where(active, rem - step, rem)
            strag = strag | (active & sK)
            width = ep - sp
            may_stop = (width <= stop_width) & ((t + 1 >= min_trips) | (width <= 0))
            stopped = stopped | (active & ~sK & may_stop)
            t += 1

    unfinished = (~stopped & (rem > 0)) | strag
    sp, ep, overflow = _fixup_stragglers_packed(
        lattice, C, dollar_row, words, amb_bits, off, L,
        sp0, ep0, sp, ep, unfinished, d, cap=cap,
    )
    rem = torch.where(unfinished, 0, rem)
    if with_stats:
        return sp, ep, rem, overflow, t, unfinished.sum(dtype=torch.int32)
    return sp, ep, rem, overflow
