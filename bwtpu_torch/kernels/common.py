"""Lattice decoding on torch tensors (counterpart of bwtpu/kernels/common.py).

The layout contract lives in bwtpu/index.py. Bit work runs on int64
tensors holding unsigned 32-bit values (`u32`), because torch's `>>` on
int32 is arithmetic and this torch has no `>>` for uint32 on the CPU;
`i32` turns such a value back into the int32 with the same bits.
"""

from __future__ import annotations

import torch

BLOCK = 128
LOG2_BLOCK = 7
BWT_WORD0 = 4
MARK_WORD0 = 12
MARK_RANK_WORD = 16
NEXT_CK0 = 17
NEXT_BWT0 = 21

MASK32 = 0xFFFFFFFF
EVEN = 0x55555555


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 (or int64) tensor -> int64 tensor of its unsigned 32-bit value."""
    return x.to(torch.int64) & MASK32


def i32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor of 32-bit patterns -> int32 tensor with the same bits."""
    x = x & MASK32
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def select_lane(arr: torch.Tensor, idx: torch.Tensor, width: int) -> torch.Tensor:
    """arr[..., idx] over the first `width` lanes; 0 where idx is outside
    [0, width) (the one-hot masked sum of the reference)."""
    ok = (idx >= 0) & (idx < width)
    safe = idx.clamp(0, width - 1).to(torch.int64).unsqueeze(-1)
    got = torch.gather(arr[..., :width], -1, safe).squeeze(-1)
    return torch.where(ok, got, 0)


def select_scalar_table(table: torch.Tensor, idx: torch.Tensor, width: int) -> torch.Tensor:
    """table[idx] for a tiny table such as C; 0 where idx is outside [0, width)."""
    ok = (idx >= 0) & (idx < width)
    got = table[:width].index_select(0, idx.clamp(0, width - 1).reshape(-1))
    return torch.where(ok, got.reshape(idx.shape), 0)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of 32-bit words -> int32 counts."""
    x = u32(x)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) >> 24) & 0xFF).to(torch.int32)


def block_rank(bwt_words: torch.Tensor, c: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Count of base `c` among the first `m` bases of each 128-base block.

    bwt_words: (..., 8) int32; c, m: (...,). Returns (...,) int32.
    """
    w = u32(bwt_words)
    pattern = ((c.to(torch.int64) * EVEN) & MASK32).unsqueeze(-1)
    y = w ^ pattern
    match = ~(y | (y >> 1)) & EVEN
    k16 = torch.arange(8, dtype=torch.int64, device=w.device) * 16
    nb = (m.to(torch.int64).unsqueeze(-1) - k16).clamp(0, 16)
    mask = torch.where(nb >= 16, MASK32, (torch.ones_like(nb) << (2 * nb)) - 1)
    return popcount32(match & mask).sum(-1, dtype=torch.int32)


def occ_from_records(rec, dollar_row: int, c, i):
    """Occ(c, i) given the already-gathered record of block i>>7."""
    j = i >> LOG2_BLOCK
    m = i & (BLOCK - 1)
    ck = select_lane(rec[:, 0:4], c, 4)
    inblk = block_rank(rec[:, BWT_WORD0 : BWT_WORD0 + 8], c, m)
    corr = ((c == 0) & ((dollar_row >> LOG2_BLOCK) == j) & (dollar_row < i)).to(torch.int32)
    return ck + inblk - corr


def occ(lattice, dollar_row: int, c, i):
    """Batched Occ(c, i) = count of base c in BWT[0:i); i in [0, n], so
    the record index i>>7 never leaves the lattice (n_blocks+1 rows)."""
    rec = lattice.index_select(0, i >> LOG2_BLOCK)
    return occ_from_records(rec, dollar_row, c, i)


def bwt_code_at(rec, m):
    """Base code stored at block-local position m of each record."""
    word = select_lane(rec[:, BWT_WORD0 : BWT_WORD0 + 8], m >> 4, 8)
    return (word >> (2 * (m & 15))) & 3


def mark_bit_and_rank(rec, m):
    """(is-sampled bit, in-block mark rank) at block-local position m."""
    words = rec[:, MARK_WORD0 : MARK_WORD0 + 4]
    bit_word = u32(select_lane(words, m >> 5, 4))
    bit = (bit_word >> (m & 31).to(torch.int64)) & 1
    k32 = torch.arange(4, dtype=torch.int64, device=rec.device) * 32
    nbits = (m.to(torch.int64).unsqueeze(-1) - k32).clamp(0, 32)
    masks = torch.where(nbits >= 32, MASK32, (torch.ones_like(nbits) << nbits) - 1)
    rank = popcount32(u32(words) & masks).sum(1, dtype=torch.int32)
    return bit.to(torch.int32), rank


def occ_pair_from_record(rec, dollar_row: int, c, sp, ep):
    """Occ(c, sp) and Occ(c, ep) from the single record of block sp>>7;
    strag flags lanes whose ep lies past block j+1 (occ_ep is garbage)."""
    j = sp >> LOG2_BLOCK
    jep = ep >> LOG2_BLOCK
    ck_j = select_lane(rec[:, 0:4], c, 4)
    bwt_j = rec[:, BWT_WORD0 : BWT_WORD0 + 8]
    occ_sp = ck_j + block_rank(bwt_j, c, sp & (BLOCK - 1))
    occ_sp = occ_sp - ((c == 0) & ((dollar_row >> LOG2_BLOCK) == j)
                       & (dollar_row < sp)).to(torch.int32)
    mep = ep & (BLOCK - 1)
    occ_ep_j = ck_j + block_rank(bwt_j, c, mep)
    ck_n = select_lane(rec[:, NEXT_CK0 : NEXT_CK0 + 4], c, 4)
    occ_ep_n = ck_n + block_rank(rec[:, NEXT_BWT0 : NEXT_BWT0 + 8], c, mep)
    occ_ep = torch.where(jep == j, occ_ep_j, occ_ep_n)
    occ_ep = occ_ep - ((c == 0) & ((dollar_row >> LOG2_BLOCK) == jep)
                       & (dollar_row < ep)).to(torch.int32)
    return occ_sp, occ_ep, jep > j + 1
