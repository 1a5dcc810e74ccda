"""Packed-word batch prep on torch tensors (counterpart of
bwtpu/kernels/prep.py): SWAR bit ops straight on the 2-bit packed read
words (int32[B, W], base b at word b//16, bits 2*(b%16)), so no (B, L)
code plane is ever built. Shifts run on `common.u32` values.

`revcomp_both` (both strands of a block, for engine.device_prep_packed)
launches the hand-written kernel csrc/prep.cu on CUDA tensors and runs
`revcomp_both_plain` on CPU tensors; anything else raises, and nothing
falls back."""

from __future__ import annotations

import ctypes

import torch

from bwtpu_torch.kernels import _build
from bwtpu_torch.kernels.common import MASK32, i32, u32


def _rev_fields(x: torch.Tensor) -> torch.Tensor:
    """Reverse the 16 2-bit fields of each 32-bit lane (u32 values)."""
    x = ((x >> 2) & 0x33333333) | ((x & 0x33333333) << 2)
    x = ((x >> 4) & 0x0F0F0F0F) | ((x & 0x0F0F0F0F) << 4)
    x = ((x >> 8) & 0x00FF00FF) | ((x & 0x00FF00FF) << 8)
    return ((x >> 16) | (x << 16)) & MASK32


def _funnel_right(x: torch.Tensor, slots: int) -> torch.Tensor:
    """Shift a (B, W) packed stream right by `slots` 2-bit fields,
    zero-filling from beyond the last word."""
    if slots == 0:
        return x
    sh = 2 * slots
    nxt = torch.cat([x[:, 1:], torch.zeros_like(x[:, :1])], dim=1)
    return ((x >> sh) | (nxt << (32 - sh))) & MASK32


def revcomp_packed_plain(words: torch.Tensor, amb: torch.Tensor, L: int):
    """Packed reverse complement of uniform length-L reads: int32[B, W]
    (rc_words, rc_amb), slots >= L zero."""
    W = words.shape[1]
    S = 16 * W - L  # dead slots at the stream's right end
    ru = _rev_fields(~u32(words) & MASK32).flip(1)
    ra = _rev_fields(u32(amb)).flip(1)
    return i32(_funnel_right(ru, S)), i32(_funnel_right(ra, S))


def _planes(words: torch.Tensor, amb: torch.Tensor, L: int, out):
    """(rw2, ab2, forward) of a `revcomp_both` call: the output planes
    (`out`, else new ones) and whether their forward half is to be written
    (False when words and amb are their rows [0, B), as the engine's
    upload leaves them). Raises on shapes the call does not take, and on
    any other overlap of the inputs and the outputs."""
    B, W = words.shape
    if amb.shape != (B, W) or not 16 * (W - 1) < L <= 16 * W:
        raise ValueError(f"revcomp_both: words {tuple(words.shape)} and amb "
                         f"{tuple(amb.shape)} must be [B, ceil(L / 16)] for L = {L}")
    if out is None:
        return (torch.empty((2 * B, W), dtype=words.dtype, device=words.device),
                torch.empty((2 * B, W), dtype=amb.dtype, device=amb.device), True)
    rw2, ab2 = out
    for name, t in (("rw2", rw2), ("ab2", ab2)):
        if (t.shape != (2 * B, W) or t.dtype != words.dtype or t.device != words.device
                or not t.is_contiguous()):
            raise ValueError(f"revcomp_both: {name} must be a contiguous {words.dtype} "
                             f"[{2 * B}, {W}] tensor on {words.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if B == 0:
        return rw2, ab2, True
    in_place = (words.data_ptr() == rw2.data_ptr() and amb.data_ptr() == ab2.data_ptr()
                and words.is_contiguous() and amb.is_contiguous())
    pairs = [(rw2, ab2)] + ([] if in_place else
                            [(words, rw2), (words, ab2), (amb, rw2), (amb, ab2)])
    if any(_overlap(a, b) for a, b in pairs):
        raise ValueError("revcomp_both: the inputs overlap the outputs other than as "
                         "their rows [0, B)")
    return rw2, ab2, not in_place


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether the memory spans of two tensors intersect."""
    def span(t):
        if t.numel() == 0:
            return 0, 0
        n = 1 + sum((d - 1) * st for d, st in zip(t.shape, t.stride()))
        return t.data_ptr(), t.data_ptr() + n * t.element_size()

    (a0, a1), (b0, b1) = span(a), span(b)
    return a0 < b1 and b0 < a1


def revcomp_both_plain(words: torch.Tensor, amb: torch.Tensor, L: int, out=None):
    """Plain version of `revcomp_both`."""
    rw2, ab2, forward = _planes(words, amb, L, out)
    B = words.shape[0]
    rc_w, rc_a = revcomp_packed_plain(words, amb, L)
    if forward:
        rw2[:B] = words
        ab2[:B] = amb
    rw2[B:] = rc_w
    ab2[B:] = rc_a
    return rw2, ab2, torch.full((2 * B,), L, dtype=torch.int32, device=words.device)


def revcomp_both(words: torch.Tensor, amb: torch.Tensor, L: int, out=None):
    """Both strands of uniform length-L packed reads (int32[B, W] words and
    ambiguity bits, W = ceil(L / 16)): (rw2, ab2) int32[2B, W], the rows
    as they are and then their packed reverse complements (slots >= L
    zero), and lens2 int32[2B] = L. `out` = (rw2, ab2) writes into given
    planes; where words and amb are their rows [0, B) (the engine's
    upload) only the reverse half is written, in place. The kernel
    revcomp_both on CUDA tensors (its instance without the forward copy
    for that call), `revcomp_both_plain` on CPU tensors, else an error;
    the two are equal on every output."""
    if not _build.on_cuda("revcomp_both", words):
        return revcomp_both_plain(words, amb, L, out)
    dev = words.device
    _build.check_tensor("revcomp_both", "words", words, torch.int32, 2, dev)
    _build.check_tensor("revcomp_both", "amb", amb, torch.int32, 2, dev)
    rw2, ab2, forward = _planes(words, amb, L, out)
    B, W = words.shape
    lens2 = torch.empty(2 * B, dtype=torch.int32, device=dev)
    if B == 0:
        return rw2, ab2, lens2
    lib = _build.library("prep")
    f = lib.bwtpu_revcomp_both
    if f.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        f.restype = i
        f.argtypes = [p, p, i, i, i, p, p, p, i, p]
    _build.launch(lib, f, "revcomp_both", words, words.data_ptr(), amb.data_ptr(), B, W, L,
                  rw2.data_ptr(), ab2.data_ptr(), lens2.data_ptr(), int(forward))
    _build.count_launch(revcomp_both)
    return rw2, ab2, lens2


revcomp_both.launches = 0  # kernel launches since the last reset


def extract_bits(words: torch.Tensor, j: int, nbits: int) -> torch.Tensor:
    """`nbits` (<= 26) bits from base slot j of each packed row, as u32."""
    assert nbits <= 26, nbits
    w, b = divmod(2 * j, 32)
    v = u32(words[:, w]) >> b
    if b + nbits > 32:
        v = v | (u32(words[:, w + 1]) << (32 - b))
    return v & ((1 << nbits) - 1)


def kmer_key_packed(words, amb, off: int, L: int, d: int):
    """Start-table key over bases [off+L-d, off+L), leftmost base
    weighted 4^(d-1). Returns (key int32[B], amb_tail bool[B])."""
    assert 1 <= d <= 13, d
    j0 = off + L - d
    key = _rev_fields(extract_bits(words, j0, 2 * d)) >> (2 * (16 - d))
    return key.to(torch.int32), extract_bits(amb, j0, 2 * d) != 0


def smer_codes_packed(words, amb, base: int, T: int, step: int):
    """(B, T) s-mer codes (MSB-first) + ambiguity flags; group g covers
    bases [base + step*g, base + step*(g+1))."""
    cols_t, cols_a = [], []
    for g in range(T):
        j = base + step * g
        v = extract_bits(words, j, 2 * step)
        code = torch.zeros_like(v)
        for f in range(step):  # field f (LSB-first) has weight 4^(step-1-f)
            code = code | (((v >> (2 * f)) & 3) << (2 * (step - 1 - f)))
        cols_t.append(code.to(torch.int32))
        cols_a.append(extract_bits(amb, j, 2 * step) != 0)
    return torch.stack(cols_t, dim=1), torch.stack(cols_a, dim=1)


def unpack_slice(words: torch.Tensor, off: int, slen: int) -> torch.Tensor:
    """(B, W) packed -> (B, slen) int32 codes of bases [off, off+slen)."""
    j = torch.arange(off, off + slen, device=words.device)
    sh = 2 * (j % 16)
    return ((u32(words)[:, j // 16] >> sh) & 3).to(torch.int32)
