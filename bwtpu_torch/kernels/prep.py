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


def revcomp_both_plain(words: torch.Tensor, amb: torch.Tensor, L: int):
    """Plain version of `revcomp_both`."""
    rc_w, rc_a = revcomp_packed_plain(words, amb, L)
    lens2 = torch.full((2 * words.shape[0],), L, dtype=torch.int32, device=words.device)
    return torch.cat([words, rc_w]), torch.cat([amb, rc_a]), lens2


def revcomp_both(words: torch.Tensor, amb: torch.Tensor, L: int):
    """Both strands of uniform length-L packed reads (int32[B, W] words and
    ambiguity bits, W = ceil(L / 16)): (rw2, ab2) int32[2B, W], the rows
    as they are and then their packed reverse complements (slots >= L
    zero), and lens2 int32[2B] = L. The kernel revcomp_both on CUDA
    tensors, `revcomp_both_plain` on CPU tensors, else an error; the two
    are equal on every output."""
    if not _build.on_cuda("revcomp_both", words):
        return revcomp_both_plain(words, amb, L)
    dev = words.device
    _build.check_tensor("revcomp_both", "words", words, torch.int32, 2, dev)
    _build.check_tensor("revcomp_both", "amb", amb, torch.int32, 2, dev)
    B, W = words.shape
    if amb.shape != (B, W) or not 16 * (W - 1) < L <= 16 * W:
        raise ValueError(f"revcomp_both: words {tuple(words.shape)} and amb "
                         f"{tuple(amb.shape)} must be [B, ceil(L / 16)] for L = {L}")
    rw2 = torch.empty((2 * B, W), dtype=torch.int32, device=dev)
    ab2 = torch.empty((2 * B, W), dtype=torch.int32, device=dev)
    lens2 = torch.empty(2 * B, dtype=torch.int32, device=dev)
    if B == 0:
        return rw2, ab2, lens2
    lib = _build.library("prep")
    f = lib.bwtpu_revcomp_both
    if f.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        f.restype = i
        f.argtypes = [p, p, i, i, i, p, p, p, p]
    rc = f(words.data_ptr(), amb.data_ptr(), B, W, L, rw2.data_ptr(), ab2.data_ptr(),
           lens2.data_ptr(), _build.stream_of(words))
    _build.check(lib, rc, "revcomp_both")
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
