"""The least time the card could take for a kernel call: the bytes it
must move over the memory rate or the operations it does over the ALU
rate, whichever is larger, and the work of a search_multistep,
compact_counts, compact or revcomp_both call counted from its own
inputs. Used by chip_smoke.py and the scripts that time kernels; nothing
on the alignment path imports it."""

from __future__ import annotations

import torch

from bwtpu_torch.index import OCCK_BLOCK
from bwtpu_torch.kernels import common, prep, searchk

# H100 SXM peaks (NVIDIA's published figures): HBM3 bytes/s,
# and the float32 rate outside the tensor cores, which stands here for the
# kernels' 32-bit integer ALU work (an upper rate, so the bound stays a
# lower bound)
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the ALU rate, whichever is larger."""
    tb, to = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
    return dict(bound_ms=max(tb, to), bound_by="bytes" if tb >= to else "operations",
                bound_bytes=int(nbytes), bound_ops=int(ops))


def n_unique(t) -> int:
    """Distinct values of tensor t."""
    return int(torch.unique(t).numel()) if t.numel() else 0


def cuda_ms(fn, reps: int = 50) -> float:
    """Device time of one fn() call: CUDA events around `reps`
    back-to-back calls, divided by `reps`, after warm-up calls. The
    calls are queued behind a ~30 ms device sleep, so the host's
    per-call overhead overlaps the device's work instead of leaving the
    card idle between launches."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def multistep_work(args):
    """(bytes, ops, what) of a search_multistep call, counted in 32 B
    sectors from the plain version's trips replayed: each lane's pattern
    words (both planes), its start-table entry (8 B, none on an ambiguous
    tail), the two sectors (checkpoint and BWT words) of each search
    lattice record the wide phase reads, and of each s-mer record a trip
    reads the fold word's sector and the code-byte sectors below the
    lane's clamped interval end; each sector once. Outputs: six int32
    (sp0, ep0, sp, ep, rem, over_lane) and one flag a lane, sel (cap
    int32), the histogram and four scalars. Operations: 2 per counted code
    byte (compare, add), 60 per lane-trip, 40 per lane."""
    lat, latk, inv, C, dr, kt, words, amb, off, L, d, step, stop, mt, cs, wide = args
    B, W = words.shape
    dev = words.device
    T, p, cap = searchk._shape(L, d, step, wide, B, cs)
    R, A = OCCK_BLOCK[step], 4**step
    rec_sectors = latk.shape[1] * 4 // 32
    lo, hi = off >> 4, (off + L - 1) >> 4
    lanes = torch.arange(B, device=dev, dtype=torch.int64)
    wi = (lanes[:, None] * W + torch.arange(lo, hi + 1, device=dev)[None, :]).reshape(-1)
    row_sectors = 2 * n_unique(wi // 8)
    key, amb_tail = prep.kmer_key_packed(words, amb, off, L, d)
    kt_sectors = n_unique(key[~amb_tail].long() // 4)
    sp = torch.where(amb_tail, 0, kt[key.long(), 0])
    ep = torch.where(amb_tail, 0, kt[key.long(), 1])
    chain = L - d
    stopped = (ep - sp <= 0) if mt > 0 else (ep - sp <= stop)
    wide_recs = []
    for ws in range(wide):
        c = prep.extract_bits(words, off + chain - 1 - ws, 2).to(torch.int32)
        a = prep.extract_bits(amb, off + chain - 1 - ws, 2) != 0
        act = ~stopped
        wide_recs += [(sp >> 7)[act & ~a], (ep >> 7)[act & ~a]]
        o_sp = common.occ(lat, dr, c, torch.where(act, sp, 0))
        o_ep = common.occ(lat, dr, c, torch.where(act, ep, 0))
        cb = common.select_scalar_table(C, c + 1, 8)
        sp = torch.where(act, torch.where(a, 0, cb + o_sp), sp)
        ep = torch.where(act, torch.where(a, 0, cb + o_ep), ep)
        stopped = stopped | (act & (ep - sp <= 0))
    secs, lane_trips, counted = [], 0, 0
    strag = torch.zeros_like(stopped)
    if T > 0:
        t_all, a_all = prep.smer_codes_packed(words, amb, off + p, T, step)
        for t in range(T):
            g = T - 1 - t
            active = ~stopped & ~strag
            blk = (sp // R).long()
            lim = (ep - blk * R).clamp(0, R)
            live = active & ~a_all[:, g]
            lane_trips += int(active.sum())
            counted += int(lim[live].sum())
            first = blk * rec_sectors + A * 4 // 32
            n_sec = (lim + 31) // 32
            span = torch.arange(R // 32, device=dev)
            sec = first[:, None] + span[None, :]
            secs += [sec[live[:, None] & (span[None, :] < n_sec[:, None])],
                     (blk * rec_sectors + t_all[:, g] // 8)[live]]
            rec = latk.index_select(0, torch.where(active, sp // R, 0))
            sp_n, ep_n, sK = searchk.occk_pair_from_record(rec, t_all[:, g], sp, ep, inv, A, R)
            aS = a_all[:, g]
            sp = torch.where(active, torch.where(aS, 0, sp_n), sp)
            ep = torch.where(active, torch.where(aS, 0, ep_n), ep)
            strag = strag | (active & sK)
            width = ep - sp
            stopped = stopped | (active & ~sK & (width <= stop) & ((t + 1 >= mt) | (width <= 0)))
    nbytes = 32 * (row_sectors + kt_sectors + 2 * (n_unique(torch.cat(wide_recs)) if wide_recs
                                                     else 0)
                   + (n_unique(torch.cat(secs)) if secs else 0)) + B * 25 + (cap + T + 5) * 4
    ops = 2 * counted + 60 * lane_trips + 40 * B
    return nbytes, ops, f"{B} lanes x L {L}, d {d}, T {T}, {lane_trips} lane-trips"


def compact_slots_work(args):
    """(bytes, ops, what) of a compact_counts call (counts, H, cap): each
    lane's int32 count read and its dropped flag written, sel (cap int32)
    and the two scalars written; 10 operations a lane (clamp, scan, flag)
    and 2 a slot written (this call's clamped total up to cap)."""
    counts, H, cap = args
    n = counts.shape[0]
    slots = min(int(counts.clamp(0, H).sum()), cap)
    return (5 * n + 4 * cap + 8, 10 * n + 2 * slots,
            f"{n} lanes, H {H}, cap {cap}, {slots} slots written")


def compact_mask_work(args):
    """(bytes, ops, what) of a compact call (valid, cap): each lane's mask
    byte read and its over flag written, sel (cap int32) and the two
    scalars written; 10 operations a lane."""
    valid, cap = args
    n = valid.shape[0]
    return 2 * n + 4 * cap + 8, 10 * n, f"{n} lanes, {int(valid.sum())} set, cap {cap}"


def revcomp_both_work(args):
    """(bytes, ops, what) of a revcomp_both call (words, amb, L[, out]):
    both int32[B, W] planes read once, the reverse half of both int32[2B,
    W] planes and lens2 written (16 B a word, 8 a read), and the forward
    half too unless words and amb are its rows [0, B) (the in-place call:
    24 B a word then); 20 operations a reverse-complement word (NOT, bit
    reverse, field swap, funnel shift) of each plane."""
    words, amb, L = args[:3]
    out = args[3] if len(args) > 3 else None
    B, W = words.shape
    forward = out is None or prep._planes(words, amb, L, out)[2]
    return ((24 if forward else 16) * B * W + 8 * B, 40 * B * W,
            f"{B} reads x L {L} (W {W}), {'forward' if forward else 'in place'}")
