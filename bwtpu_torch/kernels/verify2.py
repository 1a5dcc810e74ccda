"""Candidate verification by word-aligned XOR + popcount (counterpart of
bwtpu/kernels/verify2.py).

Host part: numpy copies of the reference's helpers, which live in a
jax-importing module (tests hold each copy equal to the original).

Device part: `verify_nm` is the entry point. On CUDA tensors it launches
the hand-written kernel csrc/verify.cu (one thread per candidate fuses
the stride-8 text-row load, the bit-phase funnel and the popcount); on
CPU tensors it runs `verify_packed`, the plain-torch version of the same
function. Index range of the row gather: an in-range candidate has
cand + len <= text_len, so row (cand >> 4) >> 3 exists; other lanes use
position 0.
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


def verify_packed(text_rows, text_len: int, cand, cvalid, read_words,
                  amb_bits, len_mask, lens):
    """Plain torch: nm int32[Cc]; NM_INVALID where invalid/out of range."""
    W = read_words.shape[1]
    in_range = cvalid & (cand >= 0) & (cand + lens <= text_len)
    pos = torch.where(in_range, cand, 0)
    w_idx = pos >> 4
    raw = text_rows.index_select(0, w_idx >> 3)
    # align the window to word w_idx: funnel-select by w_idx & 7
    sub = w_idx & (TEXT_ROW_STRIDE - 1)
    b = 1
    while b < TEXT_ROW_STRIDE:
        shifted = torch.cat([raw[:, b:], torch.zeros_like(raw[:, :b])], dim=1)
        raw = torch.where(((sub & b) != 0).unsqueeze(1), shifted, raw)
        b <<= 1
    ob = ((pos & 15) * 2).to(torch.int64).unsqueeze(1)  # bit phase
    lo = u32(raw[:, :W])
    hi = u32(raw[:, 1 : W + 1])
    window = (lo >> ob) | torch.where(ob == 0, 0, (hi << (32 - ob)) & MASK32)
    x = window ^ u32(read_words)
    pair = (x | (x >> 1)) & EVEN
    pair = (pair | u32(amb_bits)) & u32(len_mask)
    nm = popcount32(pair).sum(1, dtype=torch.int32)
    return torch.where(in_range, nm, NM_INVALID)


def verify_nm(text_rows, text_len: int, cand, cvalid, read_words, amb_bits,
              len_mask, lens):
    """nm int32[Cc] (NM_INVALID where invalid/out of range): the CUDA
    kernel on CUDA tensors, `verify_packed` on CPU tensors, else an error.

    The kernel replaces bwtpu/kernels/pallas_step.py::verify_nm_pallas
    plus the text-row gather and word funnel before it. On the H100 it
    is bound by one dependent text-row load per candidate and the 3 x W
    read-side words it streams; the arithmetic is a few dozen integer
    ops per word."""
    dev = cand.device
    if dev.type == "cpu":
        return verify_packed(text_rows, text_len, cand, cvalid, read_words,
                             amb_bits, len_mask, lens)
    if dev.type != "cuda":
        raise ValueError(f"verify_nm: no kernel for device {dev}")
    check = _build.check_tensor
    check("verify_nm", "text_rows", text_rows, torch.int32, 2, dev)
    for name, t in (("cand", cand), ("lens", lens)):
        check("verify_nm", name, t, torch.int32, 1, dev)
    check("verify_nm", "cvalid", cvalid, torch.bool, 1, dev)
    for name, t in (("read_words", read_words), ("amb_bits", amb_bits),
                    ("len_mask", len_mask)):
        check("verify_nm", name, t, torch.int32, 2, dev)
    Cc, W = read_words.shape
    if not (cvalid.shape == lens.shape == cand.shape == (Cc,)
            and amb_bits.shape == len_mask.shape == (Cc, W)):
        raise ValueError("verify_nm: per-candidate inputs disagree in shape")
    if -(-int(text_len) // 16) > text_rows.shape[0] * TEXT_ROW_STRIDE:
        raise ValueError("verify_nm: text_rows are too few for text_len")
    nm = torch.empty_like(cand)
    lib = _lib()
    rc = lib.bwtpu_verify_nm(
        text_rows.data_ptr(), text_rows.shape[1], int(text_len),
        cand.data_ptr(), cvalid.data_ptr(), read_words.data_ptr(),
        amb_bits.data_ptr(), len_mask.data_ptr(), lens.data_ptr(), Cc, W,
        nm.data_ptr(), _build.stream_of(cand),
    )
    _build.check(lib, rc, "verify_nm")
    _build.count_launch(verify_nm)
    return nm


verify_nm.launches = 0  # kernel launches since the last reset


def _lib():
    lib = _build.library("verify")
    f = lib.bwtpu_verify_nm
    if f.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        f.restype = ctypes.c_int
        f.argtypes = [p, i, ctypes.c_longlong, p, p, p, p, p, p, i, i, p, p]
    return lib
