"""Packed-word batch prep on torch tensors (counterpart of
bwtpu/kernels/prep.py): SWAR bit ops straight on the 2-bit packed read
words (int32[B, W], base b at word b//16, bits 2*(b%16)), so no (B, L)
code plane is ever built. Shifts run on `common.u32` values."""

from __future__ import annotations

import torch

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


def revcomp_packed(words: torch.Tensor, amb: torch.Tensor, L: int):
    """Packed reverse complement of uniform length-L reads: int32[B, W]
    (rc_words, rc_amb), slots >= L zero."""
    W = words.shape[1]
    S = 16 * W - L  # dead slots at the stream's right end
    ru = _rev_fields(~u32(words) & MASK32).flip(1)
    ra = _rev_fields(u32(amb)).flip(1)
    return i32(_funnel_right(ru, S)), i32(_funnel_right(ra, S))


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
