"""Candidate verification by word-aligned XOR + popcount (counterpart of
bwtpu/kernels/verify2.py).

Host part: numpy copies of the reference's helpers, which live in a
jax-importing module (tests hold each copy equal to the original).

Device part: two entry points, each launching a hand-written kernel of
csrc/verify.cu on CUDA tensors and running its plain-torch version on
CPU tensors:

  verify_nm    sa_rate > 1 (or locv off): the compacted candidates as
               locate leaves them (positions, sel, a device count) and
               the read-level rows; one thread per candidate finds its
               read row, seed offset and validity, loads its text row
               and counts the mismatches; plain version
               `verify_nm_plain` (the per-candidate gathers, then
               `verify_packed`). Index range of the text-row gather: an
               in-range candidate has cand + len <= text_len, so row
               (cand >> 4) >> 3 exists; other lanes use position 0.
  verify_locv  sa_rate == 1 with the fused locate+verify table: one
               thread per candidate loads its locv row (SA value + text
               window) and returns the position and the mismatch count;
               plain version `verify_locv_plain` (row gather +
               `verify_packed_locv`). Valid rows lie in [0, n); other
               lanes gather row 0.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from bwtpu_torch.kernels import _build
from bwtpu_torch.kernels.common import EVEN, MASK32, popcount32, u32

NM_INVALID = 255
TEXT_ROW_STRIDE = 8


def window_row_width(read_len: int) -> int:
    """Words per text window so any read_len window at any phase fits."""
    return (2 * read_len + 30 + 31) // 32 + 1


def build_text_rows(text_packed: np.ndarray, read_len: int) -> np.ndarray:
    """Host: stride-8 overlap rows over the packed text words (row i
    carries words [8i, 8i + 7 + window_row_width))."""
    R = window_row_width(read_len) + TEXT_ROW_STRIDE - 1
    w = text_packed.view(np.int32)
    n_rows = -(-len(w) // TEXT_ROW_STRIDE)
    padded = np.concatenate(
        [w, np.zeros(n_rows * TEXT_ROW_STRIDE + R - len(w), dtype=np.int32)]
    )
    return np.lib.stride_tricks.sliding_window_view(padded, R)[
        ::TEXT_ROW_STRIDE
    ][:n_rows].copy()


def pack_reads(codes: np.ndarray, amb: np.ndarray, lens: np.ndarray):
    """Host: per-read packed words + ambiguity bits + length mask, each
    int32[B, ceil(L/16)], one even bit per base (bit 2p of word p//16)."""
    B, L = codes.shape
    W = (L + 15) // 16
    shifts = (2 * (np.arange(W * 16) % 16)).astype(np.uint32)

    def pack(vals):
        padded = np.zeros((B, W * 16), dtype=np.uint32)
        padded[:, : vals.shape[1]] = vals.astype(np.uint32)
        return np.bitwise_or.reduce(
            (padded << shifts[None, :]).reshape(B, W, 16), axis=2
        ).view(np.int32)

    in_len = np.arange(W * 16)[None, :] < lens[:, None]
    return pack(codes), pack(amb), pack(in_len)


def locv_row_width(read_len: int) -> int:
    """Words per fused locate+verify row: SA value + a text window wide
    enough for any candidate start in [SA-read_len, SA] at any phase."""
    W = (read_len + 15) // 16
    return 1 + 2 * W + 1


def build_locv_rows(text_packed: np.ndarray, ssa_full: np.ndarray,
                    read_len: int) -> np.ndarray:
    """Host: fused locate+verify rows for sa_rate == 1 indexes. Row r =
    [SA[r], text words [ws(r), ws(r) + 2W+1)] with ws(r) =
    clip((SA[r] >> 4) - W, 0, n_words-1)."""
    W = (read_len + 15) // 16
    R2 = 2 * W + 1
    w = text_packed.view(np.int32)
    nw = len(w)
    padded = np.concatenate([w, np.zeros(R2, dtype=np.int32)])
    sw = np.lib.stride_tricks.sliding_window_view(padded, R2)
    ws = np.clip((ssa_full.astype(np.int64) >> 4) - W, 0, max(nw - 1, 0))
    out = np.empty((len(ssa_full), 1 + R2), dtype=np.int32)
    out[:, 0] = ssa_full
    out[:, 1:] = sw[ws]
    return out


def _window_nm(lo, hi, pos, read_words, amb_bits, len_mask):
    """Mismatch count of each candidate from its aligned text words:
    lo/hi are int64 u32 words [w, w+W) and [w+1, w+W+1) of the window
    that starts at word pos >> 4."""
    ob = ((pos & 15) * 2).to(torch.int64).unsqueeze(1)  # bit phase
    window = (lo >> ob) | torch.where(ob == 0, 0, (hi << (32 - ob)) & MASK32)
    x = window ^ u32(read_words)
    pair = (x | (x >> 1)) & EVEN
    pair = (pair | u32(amb_bits)) & u32(len_mask)
    return popcount32(pair).sum(1, dtype=torch.int32)


def _funnel(raw, shift, n_bits: int):
    """Shift each row of raw left by `shift` words (zero fill), one
    log-step select per bit b < 2**n_bits; bits above are ignored."""
    b = 1
    for _ in range(n_bits):
        shifted = torch.cat([raw[:, b:], torch.zeros_like(raw[:, :b])], dim=1)
        raw = torch.where(((shift & b) != 0).unsqueeze(1), shifted, raw)
        b <<= 1
    return raw


def verify_packed(text_rows, text_len: int, cand, cvalid, read_words,
                  amb_bits, len_mask, lens):
    """Plain torch: nm int32[Cc]; NM_INVALID where invalid/out of range."""
    W = read_words.shape[1]
    in_range = cvalid & (cand >= 0) & (cand + lens <= text_len)
    pos = torch.where(in_range, cand, 0)
    w_idx = pos >> 4
    raw = text_rows.index_select(0, w_idx >> 3)
    # align the window to word w_idx: funnel-select by w_idx & 7
    raw = _funnel(raw, w_idx & (TEXT_ROW_STRIDE - 1), TEXT_ROW_STRIDE.bit_length() - 1)
    nm = _window_nm(u32(raw[:, :W]), u32(raw[:, 1 : W + 1]), pos, read_words,
                    amb_bits, len_mask)
    return torch.where(in_range, nm, NM_INVALID)


def verify_packed_locv(rec, text_len: int, cand, cvalid, read_words, amb_bits,
                       len_mask, lens):
    """Plain torch verify from pre-gathered locv rows (build_locv_rows):
    nm int32[Cc], NM_INVALID where invalid/out of range. The candidate's
    window is aligned out of the row by a log-step word funnel (q <= W
    word shifts), then the usual bit-phase shift + XOR/popcount."""
    W = read_words.shape[1]
    in_range = cvalid & (cand >= 0) & (cand + lens <= text_len)
    nw = (text_len + 15) >> 4
    ws = ((rec[:, 0] >> 4) - W).clamp(0, max(nw - 1, 0))
    q = torch.where(in_range, (cand >> 4) - ws, 0)
    win = _funnel(rec[:, 1:], q, W.bit_length())
    pos = torch.where(in_range, cand, 0)
    nm = _window_nm(u32(win[:, :W]), u32(win[:, 1 : W + 1]), pos, read_words,
                    amb_bits, len_mask)
    return torch.where(in_range, nm, NM_INVALID)


def verify_locv_plain(locv, text_len: int, rows, valid, off, read_words,
                      amb_bits, len_mask, lens):
    """Plain torch locate + verify at sa_rate == 1: (pos, nm) int32[Cc].
    pos = SA[row] (-1 where not valid); nm of the candidate pos - off."""
    rec = locv.index_select(0, torch.where(valid, rows, 0))
    spos = torch.where(valid, rec[:, 0], -1)
    nm = verify_packed_locv(rec, text_len, spos - off, valid & (spos >= 0),
                            read_words, amb_bits, len_mask, lens)
    return spos, nm


def verify_nm_plain(text_rows, text_len: int, spos, sel, count, seed_off, read_words,
                    amb_bits, len_mask, lens, max_loc: int, n_slots: int):
    """Plain torch version of verify_nm: the per-candidate gathers of the
    read rows and seed offsets, then `verify_packed`. Returns (cand, nm)
    int32[len(sel)]."""
    sel_valid = torch.arange(sel.shape[0], dtype=torch.int32, device=sel.device) < count
    # sel names a lane on every slot (0 past count), so every gather is in range
    lane = sel // max_loc
    b_idx = lane // n_slots
    cand = spos - seed_off.index_select(0, lane)
    nm = verify_packed(text_rows, text_len, cand, sel_valid & (spos >= 0),
                       read_words.index_select(0, b_idx), amb_bits.index_select(0, b_idx),
                       len_mask.index_select(0, b_idx), lens.index_select(0, b_idx))
    return cand, nm


def verify_nm(text_rows, text_len: int, spos, sel, count, seed_off, read_words, amb_bits,
              len_mask, lens, max_loc: int, n_slots: int):
    """Candidate starts and mismatch counts of the compacted candidates.

    Slot j (of len(sel)) holds lane sel[j] // max_loc, a seed lane of read
    row b = lane // n_slots, located at spos[j] (`locate_walk`'s output,
    -1 past count; `compact_counts` gives sel and the 0-dim device count).
    Returns (cand, nm) int32[len(sel)]: cand[j] = spos[j] -
    seed_off[lane], and nm[j] the mismatch count of read row b (read-level
    int32[B2, W] planes read_words, amb_bits, len_mask, any row stride;
    lens int32[B2]) at cand[j], NM_INVALID unless j < count, spos[j] >= 0
    and the candidate lies in the text. The CUDA kernel on CUDA tensors,
    `verify_nm_plain` on CPU tensors, else an error.

    The kernel replaces bwtpu/kernels/pallas_step.py::verify_nm_pallas,
    the text-row gather and word funnel before it and the per-candidate
    row take of bwtpu/engine.py:523-541; one thread per candidate, W a
    template parameter up to 20 words (320 bases) and a run-time argument
    of one more instance for any wider read."""
    if not _build.on_cuda("verify_nm", spos):
        return verify_nm_plain(text_rows, text_len, spos, sel, count, seed_off, read_words,
                               amb_bits, len_mask, lens, max_loc, n_slots)
    dev = spos.device
    check = _build.check_tensor
    check("verify_nm", "text_rows", text_rows, torch.int32, 2, dev)
    for name, t in (("spos", spos), ("sel", sel), ("seed_off", seed_off), ("lens", lens)):
        check("verify_nm", name, t, torch.int32, 1, dev)
    check("verify_nm", "count", count, torch.int32, 0, dev)
    B2, W = read_words.shape
    for name, t in (("read_words", read_words), ("amb_bits", amb_bits),
                    ("len_mask", len_mask)):
        if (t.dtype != torch.int32 or t.device != dev or tuple(t.shape) != (B2, W)
                or (W > 1 and t.stride(1) != 1)):
            raise ValueError(f"verify_nm: {name} must be an int32 [{B2}, {W}] tensor on "
                             f"{dev} with unit column stride, got {t.dtype} "
                             f"{tuple(t.shape)} strides {t.stride()} on {t.device}")
    cap = sel.shape[0]
    if not (spos.shape == (cap,) and lens.shape == (B2,)
            and seed_off.shape == (B2 * n_slots,) and max_loc >= 1 and n_slots >= 1):
        raise ValueError("verify_nm: spos, sel, seed_off, lens, max_loc and n_slots "
                         "disagree in shape")
    if -(-int(text_len) // 16) > text_rows.shape[0] * TEXT_ROW_STRIDE:
        raise ValueError("verify_nm: text_rows are too few for text_len")
    if W < 1:
        raise ValueError("verify_nm: the read planes have no words")
    lib = _lib()
    vec_rows = text_rows.shape[1] % 4 == 0 and text_rows.data_ptr() % 16 == 0
    cand, nm = torch.empty_like(spos), torch.empty_like(spos)
    planes = [x for t in (read_words, amb_bits, len_mask) for x in (t.data_ptr(), t.stride(0))]
    _build.launch(lib, lib.bwtpu_verify_nm, "verify_nm", spos,
                  text_rows.data_ptr(), text_rows.shape[1], int(text_len), spos.data_ptr(),
                  sel.data_ptr(), count.data_ptr(), seed_off.data_ptr(), *planes,
                  lens.data_ptr(), W, int(max_loc), int(n_slots), cap, int(vec_rows),
                  cand.data_ptr(), nm.data_ptr())
    _build.count_launch(verify_nm)
    return cand, nm


verify_nm.launches = 0  # kernel launches since the last reset


def verify_locv(locv, text_len: int, rows, valid, off, read_words, amb_bits,
                len_mask, lens):
    """(pos, nm) int32[Cc] at sa_rate == 1 from the fused locate+verify
    table: pos = SA[row] (-1 where not valid), nm the mismatch count of
    the candidate pos - off (NM_INVALID where out of range). The CUDA
    kernel on CUDA tensors, `verify_locv_plain` on CPU tensors, else an
    error.

    The kernel replaces the row take, the funnel and the popcount of
    bwtpu/engine.py:548-554 (verify2.py:129, verify_packed_locv): the jnp
    code XLA fused there, not a Pallas kernel. On the H100 it is bound by
    one dependent 64 B row load per candidate (L 100) from a table of
    ~300 MB at E. coli scale, plus 3 x W read-side words."""
    if not _build.on_cuda("verify_locv", rows):
        return verify_locv_plain(locv, text_len, rows, valid, off, read_words,
                                 amb_bits, len_mask, lens)
    dev = rows.device
    check = _build.check_tensor
    check("verify_locv", "locv", locv, torch.int32, 2, dev)
    for name, t in (("rows", rows), ("off", off), ("lens", lens)):
        check("verify_locv", name, t, torch.int32, 1, dev)
    check("verify_locv", "valid", valid, torch.bool, 1, dev)
    for name, t in (("read_words", read_words), ("amb_bits", amb_bits),
                    ("len_mask", len_mask)):
        check("verify_locv", name, t, torch.int32, 2, dev)
    Cc, W = read_words.shape
    if not (valid.shape == off.shape == lens.shape == rows.shape == (Cc,)
            and amb_bits.shape == len_mask.shape == (Cc, W)):
        raise ValueError("verify_locv: per-candidate inputs disagree in shape")
    if locv.shape[1] != 2 * W + 2:
        raise ValueError(f"verify_locv: locv rows are {locv.shape[1]} words, "
                         f"reads of {W} words need {2 * W + 2}")
    pos, nm = torch.empty_like(rows), torch.empty_like(rows)
    lib = _lib()
    _build.launch(lib, lib.bwtpu_verify_locv, "verify_locv", rows,
                  locv.data_ptr(), int(text_len), rows.data_ptr(),
                  valid.data_ptr(), off.data_ptr(), read_words.data_ptr(),
                  amb_bits.data_ptr(), len_mask.data_ptr(), lens.data_ptr(), Cc, W,
                  pos.data_ptr(), nm.data_ptr())
    _build.count_launch(verify_locv)
    return pos, nm


verify_locv.launches = 0  # kernel launches since the last reset


def _lib():
    lib = _build.library("verify")
    f = lib.bwtpu_verify_nm
    if f.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        f.restype = i
        f.argtypes = [p, i, ll, p, p, p, p, p, ll, p, ll, p, ll, p] + [i] * 5 + [p] * 3
        g = lib.bwtpu_verify_locv
        g.restype = i
        g.argtypes = [p, ll, p, p, p, p, p, p, p, i, i, p, p, p]
    return lib
