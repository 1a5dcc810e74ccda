"""Banded Smith-Waterman rescoring (counterpart of bwtpu/sw.py).

`align --rescore` scores each primary hit's text window with a banded
local alignment and writes the score as an AS:i tag. Three versions of
the score, all with bwtpu's conventions (band around the diagonal, cells
outside the band or the text and rows past the read's length count 0):

  sw_score_batch      the entry point: the CUDA kernel `sw_band`
                      (csrc/sw.cu) on CUDA tensors, sw_score_plain on CPU
                      tensors, an error on any other device
  sw_score_plain      plain torch, the reference's jnp loop row by row
  sw_score_reference  plain Python, one pair at a time (the tests' oracle;
                      a verbatim copy of bwtpu's)

rescore_candidates cuts each hit's window (with flanks) out of the
engine's host shards and scores all of them in one sw_score_batch call on
the engine's device.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from bwtpu_torch.kernels import _build


def sw_score_plain(text, text_lens, reads, read_lens, band: int = 8, match: int = 2,
                   mismatch: int = -3, gap: int = -4):
    """Best local-alignment score per lane (int32[B]), banded around the
    diagonal: band cell w of read row i (1-based) is text position
    j = i + w - band. Plain torch in the kernel's order (csrc/sw.cu): a
    lane's rows end at min(L, read_len, text_len + band), the last one
    with a cell inside the read and the text (later rows are all zero in
    the reference); row i's valid cells are w in [lo, hi] (both masks);
    the scan step is max(cur[w], cur[w - 1] + gap), which equals the
    reference's max(cur[w], max(cur[w - 1] + gap, 0)) since cur >= 0."""
    B, L = reads.shape
    W = 2 * band + 1
    dev = reads.device
    if text.shape[1] == 0:  # every cell is outside the text
        text = text.new_zeros((B, 1))
    Lt = text.shape[1]
    tl, rl = text_lens.long(), read_lens.long()
    end = torch.minimum(torch.minimum(rl, tl + band), torch.full_like(rl, L))
    end = torch.where(tl >= 1, end, 0).clamp(min=0)
    w_idx = torch.arange(W, dtype=torch.int64, device=dev)
    prev = torch.zeros((B, W), dtype=torch.int32, device=dev)
    best = torch.zeros(B, dtype=torch.int32, device=dev)
    zero = prev.new_zeros((B, 1))
    for i in range(1, int(end.max()) + 1 if B else 1):
        lo = max(0, band + 1 - i)
        hi = (tl - i + band).clamp(max=2 * band)
        ok = (w_idx >= lo).unsqueeze(0) & (w_idx.unsqueeze(0) <= hi.unsqueeze(1)) & (
            i <= end).unsqueeze(1)
        rc = reads[:, i - 1]
        tc = text.index_select(1, (i + w_idx - band - 1).clamp(0, Lt - 1))
        s = torch.where(tc == rc.unsqueeze(1), match, mismatch).to(torch.int32)
        up = torch.cat([prev[:, 1:], zero], dim=1)
        cur = torch.maximum(torch.maximum(prev + s, up + gap), torch.zeros_like(prev))
        cur = torch.where(ok, cur, 0)
        # left dependency within the row: a sequential pass over the band
        for w in range(1, W):
            cur[:, w] = torch.maximum(cur[:, w], cur[:, w - 1] + gap)
        cur = torch.where(ok, cur, 0)
        best = torch.maximum(best, cur.max(1).values)
        prev = cur
    return best


def sw_score_batch(text, text_lens, reads, read_lens, band: int = 8, match: int = 2,
                   mismatch: int = -3, gap: int = -4):
    """Best banded local-alignment score per lane: int32 text windows
    [B, Lt] with their lengths [B], left-aligned int32 read codes [B, L]
    with their lengths [B]. The CUDA kernel on CUDA tensors (`band` up to
    bwtpu_sw_max_band()), `sw_score_plain` on CPU tensors, else an error.

    The kernel replaces bwtpu/sw.py:28 sw_score_batch, jnp code that XLA
    fused on the TPU; no PyTorch call computes a banded DP."""
    if not _build.on_cuda("sw_band", reads):
        return sw_score_plain(text, text_lens, reads, read_lens, band, match, mismatch, gap)
    dev = reads.device
    check = _build.check_tensor
    check("sw_band", "text", text, torch.int32, 2, dev)
    check("sw_band", "reads", reads, torch.int32, 2, dev)
    check("sw_band", "text_lens", text_lens, torch.int32, 1, dev)
    check("sw_band", "read_lens", read_lens, torch.int32, 1, dev)
    B, L = reads.shape
    if not (text.shape[0] == B and text_lens.shape == read_lens.shape == (B,)):
        raise ValueError("sw_band: text, text_lens, reads and read_lens disagree in lanes")
    lib = _lib()
    if not 0 <= band <= lib.bwtpu_sw_max_band():
        raise ValueError(f"sw_band: band {band} has no kernel instance (0.."
                         f"{lib.bwtpu_sw_max_band()})")
    out = torch.empty(B, dtype=torch.int32, device=dev)
    _build.launch(lib, lib.bwtpu_sw_band, "sw_band", reads,
                  text.data_ptr(), text.shape[1], text_lens.data_ptr(),
                  reads.data_ptr(), L, read_lens.data_ptr(), B, int(band),
                  int(match), int(mismatch), int(gap), out.data_ptr())
    _build.count_launch(sw_score_batch)
    return out


sw_score_batch.launches = 0  # kernel launches since the last reset


def _lib():
    lib = _build.library("sw")
    f = lib.bwtpu_sw_band
    if f.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.bwtpu_sw_max_band.restype = i
        lib.bwtpu_sw_max_band.argtypes = []
        f.restype = i
        f.argtypes = [p, i, p, p, i, p, i, i, i, i, i, p, p]
    return lib


def sw_score_reference(text: str, read: str, band: int = 8, match: int = 2,
                       mismatch: int = -3, gap: int = -4) -> int:
    """Plain-Python banded SW (test oracle; same out-of-band = 0
    convention as sw_score_batch)."""
    Lt, L = len(text), len(read)
    H = {}

    def get(i, j):  # uncomputed/out-of-grid cells contribute 0
        return H.get((i, j), 0)

    best = 0
    for i in range(1, L + 1):
        for w in range(2 * band + 1):
            j = i + w - band
            if j < 1 or j > Lt:
                continue
            s = match if read[i - 1] == text[j - 1] else mismatch
            H[(i, j)] = max(
                0, get(i - 1, j - 1) + s, get(i - 1, j) + gap, get(i, j - 1) + gap
            )
            best = max(best, H[(i, j)])
    return best


def rescore_candidates(engine, reads, hits, band: int = 8, flank: int = 8):
    """Rescore each hit's window with banded SW; returns {(read index, hit
    index): score}. A copy of bwtpu.sw.rescore_candidates: the windows
    (with `flank` extra bases each side, so indel-shifted alignments fit
    in the band) are cut from the engine's host shards, a hit's window
    from the first shard that contains its position, and scored in one
    sw_score_batch call on the engine's device."""
    shards = engine.shards
    starts = np.array([sh.shard_offset for sh in shards], dtype=np.int64)
    ends = starts + np.array([sh.text_len for sh in shards], dtype=np.int64)

    owners, pos_l, rev_l, ri_l = [], [], [], []
    for ri, hlist in enumerate(hits):
        for hi, h in enumerate(hlist):
            owners.append((ri, hi))
            pos_l.append(h.pos)
            rev_l.append(h.strand == "-")
            ri_l.append(ri)
    if not owners:
        return {}
    pos = np.array(pos_l, dtype=np.int64)
    rev = np.array(rev_l, dtype=bool)
    ri_a = np.array(ri_l, dtype=np.int32)

    rd_f, rd_r, rlen = _encode_reads(reads)
    # first shard containing each position: shard ends are increasing,
    # so it's the first end strictly beyond pos (overlap regions belong
    # to the earlier shard, matching the engine's emission)
    sid = np.searchsorted(ends, pos, side="right")
    lanes_rlen = rlen[ri_a]
    lo = np.maximum(0, pos - starts[sid] - flank)
    hi_ = np.minimum(ends[sid] - starts[sid], pos - starts[sid] + lanes_rlen + flank)
    tlen = (hi_ - lo).astype(np.int32)
    text = _cut_windows(shards, sid, lo, tlen)

    rd = np.where(rev[:, None], rd_r[ri_a], rd_f[ri_a])
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(  # noqa: E731
        engine.device)
    scores = sw_score_batch(put(text), put(tlen), put(rd), put(lanes_rlen), band).cpu().numpy()
    return {owner: int(s) for owner, s in zip(owners, scores)}


def _encode_reads(reads):
    """Forward and reverse-complement codes of each read, left-aligned in
    int32[n, max length] (zero-padded), and the lengths."""
    from bwtpu_torch import dna

    L = max(len(r.seq) for r in reads)
    rd_f = np.zeros((len(reads), L), np.int32)
    rd_r = np.zeros((len(reads), L), np.int32)
    rlen = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        codes, _ = dna.encode_with_mask(r.seq)
        rc, _ = dna.revcomp_codes(codes)
        rd_f[i, : len(codes)] = codes
        rd_r[i, : len(rc)] = rc
        rlen[i] = len(codes)
    return rd_f, rd_r, rlen


def _cut_windows(shards, sid, lo, tlen):
    """int32[B, max tlen] text codes: lane b's window [lo, lo + tlen) of
    shard sid[b] (shard coordinates), zero past tlen."""
    B, Lt = len(sid), int(tlen.max())
    text = np.zeros((B, Lt), np.int32)
    col = np.arange(Lt, dtype=np.int64)[None, :]
    for s, sh in enumerate(shards):
        m = sid == s
        if not m.any():
            continue
        words = sh.text_packed.view(np.uint32)
        idx = np.clip(lo[m][:, None] + col, 0, sh.text_len - 1)
        vals = ((words[idx >> 4] >> (2 * (idx & 15))) & 3).astype(np.int32)
        text[m] = np.where(col < tlen[m][:, None], vals, 0)
    return text


def as_tags(scores: dict, n_reads: int) -> list:
    """Per read, the AS:i tag of its primary hit's score (hit index 0 of
    `scores`, as rescore_candidates returns it), or None without one."""
    return [f"AS:i:{scores[(i, 0)]}" if (i, 0) in scores else None for i in range(n_reads)]
