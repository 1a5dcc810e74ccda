"""Multi-step early-stop backward search on torch tensors (counterpart of
bwtpu/kernels/searchk.py::occk_pair_from_record, search_early_stop_packed).

`search_early_stop_packed` runs `search_multistep` (the prologue, the
wide phase and the multi-step trips of every lane, the whole-batch exit,
and the finisher's compaction and capacity cut) and then the finisher's
two-record chain (`search_chain2`) on the compacted lanes.
`search_multistep` launches the hand-written kernel csrc/searchk.cu on
CUDA tensors and runs `search_multistep_plain` on CPU tensors; anything
else raises, and nothing falls back. The kernel path never syncs with
the host: one call is a memset, the search kernel, the exit kernel and
search_chain2.

The reference's while_loop tests `(t < T) & ((n_pool > cap) | (t <
min_trips))` before every trip, so the whole batch leaves at one trip.
Here every lane runs its trips until it leaves the pool (`leave`, the
trip count at which it stopped or straggled; T if never), and the exit
trip comes afterwards from the histogram of `leave` (`exit_trip`): the
pool at trip t is #{leave > t}. A lane with leave <= t* ends as the
reference leaves it; a lane with leave > t* was in the reference's pool
at its exit, so it is unfinished there and the finisher restarts it
from (sp0, ep0) or forces it empty: its own later state is never read.
So one pass gives the reference's outputs, trips and n_unf included.
The finisher's compaction (`compact`) and its cut (`_force_over`) need
only the unfinished flags, so they run before its chain, in the exit.
"""

from __future__ import annotations

import ctypes

import torch

from bwtpu_torch.index import OCCK_BLOCK, OCCK_WIDTH
from bwtpu_torch.kernels import _build, common, prep, search2
from bwtpu_torch.kernels.compact import compact_plain


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


def _shape(L: int, d: int, step: int, wide_steps: int, B: int, cap_scale: int):
    """(T, p, cap): the multi-step trips, the bases left over below them,
    and the finisher's capacity."""
    assert d >= 1 and L >= d and step in (3, 4), (L, d, step)
    assert 0 <= wide_steps <= L - d, (wide_steps, L, d)
    chain = L - d - wide_steps
    return chain // step, chain % step, min(B, max(256, B // 64) * cap_scale)


def exit_trip(leave, T: int, min_trips: int, cap: int):
    """The reference's exit trip (int32 0-dim) from each lane's `leave`:
    the first t in [min_trips, T) whose pool #{leave > t} is <= cap, else
    T; min(T, min_trips) when nothing qualifies earlier."""
    hist = torch.bincount(leave.to(torch.int64), minlength=T + 1)
    suffix = hist.flip(0).cumsum(0).flip(0)  # suffix[t] = #{leave >= t}
    pool = torch.cat([suffix[1:], suffix.new_zeros(1)])  # #{leave > t}
    t = torch.arange(T + 1, device=leave.device)
    ok = ((t >= min_trips) & (pool <= cap)) | (t == T)
    return torch.argmax(ok.to(torch.int32)).to(torch.int32)


def lanes_plain(lattice, latk, latk_inv, C, dollar_row: int, kmer_table, words,
                amb_bits, off: int, L: int, d: int, step: int, stop_width: int,
                min_trips: int = 0, cap_scale: int = 1, wide_steps: int = 0):
    """Every lane of search_multistep_plain to its own exit, with masked
    trips and no exit test. Returns (sp0, ep0, sp, ep, rem, own bool[B],
    leave int32[B]): own flags the lanes unfinished by their own state
    (still wide with bases left, or straggled), leave the trip count at
    which each lane left the pool (T if never)."""
    T, p, _ = _shape(L, d, step, wide_steps, words.shape[0], cap_scale)
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

    leave = torch.where(stopped, 0, T).to(torch.int32)
    if T > 0:
        t_all, a_all = prep.smer_codes_packed(words, amb_bits, off + p, T, step)
        for t in range(T):
            g = T - 1 - t
            active = ~stopped & ~strag
            # inactive lanes gather record 0, as the reference does
            rec = latk.index_select(0, torch.where(active, sp // R, 0))
            sp_n, ep_n, sK = occk_pair_from_record(rec, t_all[:, g], sp, ep, latk_inv, A, R)
            aS = a_all[:, g]
            sp = torch.where(active, torch.where(aS, 0, sp_n), sp)
            ep = torch.where(active, torch.where(aS, 0, ep_n), ep)
            rem = torch.where(active, rem - step, rem)
            strag = strag | (active & sK)
            width = ep - sp
            may_stop = (width <= stop_width) & ((t + 1 >= min_trips) | (width <= 0))
            stopped = stopped | (active & ~sK & may_stop)
            leave = torch.where(active & (stopped | strag), t + 1, leave)
    return sp0, ep0, sp, ep, rem, (~stopped & (rem > 0)) | strag, leave


def search_multistep_plain(lattice, latk, latk_inv, C, dollar_row: int, kmer_table,
                           words, amb_bits, off: int, L: int, d: int, step: int,
                           stop_width: int, min_trips: int = 0, cap_scale: int = 1,
                           wide_steps: int = 0):
    """Plain version of search_multistep, in the kernel's order:
    `lanes_plain`, then `exit_trip`, the unfinished rule, `compact_plain`
    and `_force_over`. Same outputs as the kernel."""
    T, _, cap = _shape(L, d, step, wide_steps, words.shape[0], cap_scale)
    sp0, ep0, sp, ep, rem, own, leave = lanes_plain(
        lattice, latk, latk_inv, C, dollar_row, kmer_table, words, amb_bits, off, L, d, step,
        stop_width, min_trips, cap_scale, wide_steps)
    trips = exit_trip(leave, T, min_trips, cap)
    unfinished = own | (leave > trips)
    rem = torch.where(unfinished, 0, rem)
    sel, count, _, over = compact_plain(unfinished, cap)
    sp, ep, over_lane = search2._force_over(sp, ep, over)
    return (sp0, ep0, sp, ep, rem, unfinished, trips, sel, count, over_lane,
            unfinished.sum(dtype=torch.int32))


def search_multistep(lattice, latk, latk_inv, C, dollar_row: int, kmer_table, words,
                     amb_bits, off: int, L: int, d: int, step: int, stop_width: int,
                     min_trips: int = 0, cap_scale: int = 1, wide_steps: int = 0):
    """Everything of search_early_stop_packed but the finisher's chain,
    for the pattern bases [off, off+L) of each 2-bit packed row (int32[B,
    W] words and ambiguity bits). Returns (sp0, ep0, sp, ep, rem,
    unfinished bool[B], trips, sel int32[cap], count, over_lane int32[B],
    n_unf): the start intervals; each lane's interval (0, 0 where
    over_lane) and remaining bases (0 on unfinished lanes); the lanes the
    finisher must run, compacted in lane order (`compact`'s sel and
    count); the unfinished lanes past the finisher's capacity, forced
    empty (`_force_over`); the reference's multi-step trips and the number
    of unfinished lanes (0-dim int32). The CUDA kernel on CUDA tensors,
    `search_multistep_plain` on CPU tensors, else an error; the two are
    equal on every output.

    The kernel (csrc/searchk.cu) replaces the prologue, wide phase and
    while_loop of bwtpu/kernels/searchk.py::search_early_stop_packed and
    the compaction and cut of its finisher: a memset of one int32
    workspace (histogram, scalars, look-back words, sel), the search (a
    group of G threads per lane runs the lane's trips, each thread
    counting its R / G code bytes of a record; each lane adds its `leave`
    to the histogram), then an exit kernel that finds the exit trip, sets
    the unfinished flags and compacts them with a single-pass scan, all on
    the device."""
    if not _build.on_cuda("search_multistep", words):
        return search_multistep_plain(lattice, latk, latk_inv, C, dollar_row, kmer_table,
                                      words, amb_bits, off, L, d, step, stop_width,
                                      min_trips, cap_scale, wide_steps)
    dev = words.device
    for name, t, ndim in (("lattice", lattice, 2), ("latk", latk, 2),
                          ("latk_inv", latk_inv, 1), ("C", C, 1),
                          ("kmer_table", kmer_table, 2), ("words", words, 2),
                          ("amb_bits", amb_bits, 2)):
        _build.check_tensor("search_multistep", name, t, torch.int32, ndim, dev)
    B, W = words.shape
    T, _, cap = _shape(L, d, step, wide_steps, B, cap_scale)
    if lattice.shape[1] != 32 or C.shape[0] < 5 or latk_inv.shape[0] != 4:
        raise ValueError("search_multistep: lattice must be [n_blocks+1, 32], C [>=5] "
                         "and latk_inv [4]")
    if latk.shape[1] != OCCK_WIDTH[step] or kmer_table.shape != (4**d, 2):
        raise ValueError(f"search_multistep: latk must be [n_blocksK+1, {OCCK_WIDTH[step]}] "
                         f"and kmer_table [{4**d}, 2] for step {step}, d {d}")
    if amb_bits.shape != (B, W) or off < 0 or off + L > 16 * W or d > 13:
        raise ValueError("search_multistep: packed rows, slice and d disagree")
    if lattice.data_ptr() % 16 or latk.data_ptr() % 16:
        raise ValueError("search_multistep: lattice and latk must be 16-byte aligned")
    lib, f = _multistep_entry()
    nb = max(1, -(-B // f.exit_tile))  # exit CTAs: one look-back word each
    ws = torch.empty(T + 5 + nb + cap, dtype=torch.int32, device=dev)
    out = [torch.empty(B, dtype=torch.int32, device=dev) for _ in range(7)]
    sp0, ep0, sp, ep, rem, leave, over_lane = out
    unfinished = torch.empty(B, dtype=torch.bool, device=dev)
    _build.launch(lib, f, "search_multistep", words,
                  lattice.data_ptr(), latk.data_ptr(), latk_inv.data_ptr(), C.data_ptr(),
                  int(dollar_row), kmer_table.data_ptr(), words.data_ptr(), amb_bits.data_ptr(),
                  B, W, off, L, d, step, stop_width, min_trips, wide_steps, T, cap,
                  *(t.data_ptr() for t in out[:6]), unfinished.data_ptr(),
                  over_lane.data_ptr(), ws.data_ptr(), ws.numel())
    _build.count_launch(search_multistep)
    return (sp0, ep0, sp, ep, rem, unfinished, ws[T + 1], ws[T + 5 + nb:], ws[T + 2],
            over_lane, ws[T + 3])


search_multistep.launches = 0  # kernel launches since the last reset


def _multistep_entry():
    """(library, entry point) of searchk.cu; the entry point carries the
    exit kernel's lanes per CTA as `exit_tile`."""
    lib = _build.library("searchk")
    f = lib.bwtpu_search_multistep
    if not hasattr(f, "exit_tile"):
        p, i = ctypes.c_void_p, ctypes.c_int
        f.restype = i
        f.argtypes = [p, p, p, p, i, p, p, p] + [i] * 11 + [p] * 9 + [i, p]
        lib.bwtpu_searchk_exit_tile.restype = i
        f.exit_tile = lib.bwtpu_searchk_exit_tile()
    return lib, f


def _finisher(lattice, C, dollar_row: int, words, amb_bits, off: int, L: int, sp0, ep0,
              sel, count, sp, ep, d: int) -> None:
    """The finisher's chain: the compacted unfinished lanes sel[:count]
    restart from (sp0, ep0) on the two-record chain (`search_chain2`),
    written into sp and ep in place."""
    search2.search_chain2(lattice, C, dollar_row, search2.Packed(words, amb_bits, off, L),
                          sp0, ep0, sel, count, sp, ep, d)


def _early_stop(multistep, lattice, latk, latk_inv, C, dollar_row, kmer_table, words,
                amb_bits, off, L, d, step, stop_width, min_trips, cap_scale, wide_steps,
                with_stats):
    sp0, ep0, sp, ep, rem, _, trips, sel, count, over_lane, n_unf = multistep(
        lattice, latk, latk_inv, C, dollar_row, kmer_table, words, amb_bits, off, L, d,
        step, stop_width, min_trips, cap_scale, wide_steps)
    _finisher(lattice, C, dollar_row, words, amb_bits, off, L, sp0, ep0, sel, count, sp, ep,
              d)
    if with_stats:
        return sp, ep, rem, over_lane, trips, n_unf
    return sp, ep, rem, over_lane


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

    with_stats: also return the multi-step trips taken and the number of
    lanes handed to the finisher, both int32 0-dim device tensors, as
    bwtpu's (sp, ep, rem, overflow, trips, n_unf); the bench's roofline
    reads them. Nothing here syncs with the host.
    """
    return _early_stop(search_multistep, lattice, latk, latk_inv, C, dollar_row, kmer_table,
                       words, amb_bits, off, L, d, step, stop_width, min_trips, cap_scale,
                       wide_steps, with_stats)


def search_early_stop_packed_plain(lattice, latk, latk_inv, C, dollar_row: int,
                                   kmer_table, words, amb_bits, off: int, L: int,
                                   d: int, step: int, stop_width: int,
                                   min_trips: int = 0, cap_scale: int = 1,
                                   wide_steps: int = 0, with_stats: bool = False):
    """search_early_stop_packed with search_multistep_plain in place of
    the kernel, on any device (the finisher as in search_early_stop_packed):
    what chip_smoke.py and the card tests hold the kernel path against."""
    return _early_stop(search_multistep_plain, lattice, latk, latk_inv, C, dollar_row,
                       kmer_table, words, amb_bits, off, L, d, step, stop_width, min_trips,
                       cap_scale, wide_steps, with_stats)
