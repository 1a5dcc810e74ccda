"""Interval expansion (counterpart of bwtpu/kernels/search.py::interval_rows)."""

from __future__ import annotations

import torch


def interval_rows(sp: torch.Tensor, ep: torch.Tensor, max_hits: int):
    """Expand [sp, ep) into row lists with fixed capacity: (rows
    int32[B, max_hits], valid bool[B, max_hits], overflow int32[B] —
    rows beyond capacity, 0 if none)."""
    width = ep - sp
    k = torch.arange(max_hits, dtype=torch.int32, device=sp.device).unsqueeze(0)
    rows = sp.unsqueeze(1) + k
    valid = k < width.unsqueeze(1)
    overflow = torch.clamp(width - max_hits, min=0)
    return torch.where(valid, rows, 0), valid, overflow
