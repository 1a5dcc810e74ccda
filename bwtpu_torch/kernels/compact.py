"""Fixed-capacity stream compaction on torch tensors (counterpart of
bwtpu/kernels/compact.py). The reference's `.at[...](mode="drop")`
scatters become scatters into one extra spill slot that is sliced off;
overflow is counted, never silent."""

from __future__ import annotations

import torch


def compact(valid: torch.Tensor, capacity: int):
    """Compact the True lanes of a 1-D mask to the front.

    Returns (sel int32[capacity], count, overflow) as int32 tensors:
    sel[i] = source lane of the i-th valid lane (0 beyond count, so
    always safe to gather with); overflow = valid lanes past capacity.
    """
    v = valid.to(torch.int32)
    pos = torch.cumsum(v, 0, dtype=torch.int32) - v
    total = v.sum(dtype=torch.int32)  # 0 for an empty mask
    count = torch.clamp(total, max=capacity)
    overflow = torch.clamp(total - capacity, min=0)
    slot = torch.where(valid & (pos < capacity), pos, capacity)  # spill slot
    lane_ids = torch.arange(valid.shape[0], dtype=torch.int32, device=valid.device)
    sel = torch.zeros(capacity + 1, dtype=torch.int32, device=valid.device)
    sel = sel.scatter(0, slot.to(torch.int64), lane_ids)[:capacity]
    return sel, count, overflow


def compact_counts(counts: torch.Tensor, H: int, capacity: int):
    """Structured compaction: lane l owns slots [l*H, l*H + counts[l]).

    Same (sel, count, overflow) as ``compact`` over the prefix mask
    ``k < counts[l]`` of int32[Nlanes, H], plus dropped bool[Nlanes]:
    lanes whose slots did not all fit the capacity. sel[i] =
    cummax(base)[i] + i, with base_l = l*H - cum_l scattered (max) at
    each live lane's first slot.
    """
    c = counts.to(torch.int32).clamp(0, H)
    cum = torch.cumsum(c, 0, dtype=torch.int32) - c
    total = cum[-1] + c[-1]
    count = torch.clamp(total, max=capacity)
    overflow = torch.clamp(total - capacity, min=0)
    dropped = (c > 0) & (cum + c > capacity)
    lane_ids = torch.arange(c.shape[0], dtype=torch.int32, device=c.device)
    # empty lanes and lanes starting past the capacity go to the spill slot
    start = torch.where((c > 0) & (cum < capacity), cum, capacity)
    base = torch.zeros(capacity + 1, dtype=torch.int32, device=c.device)
    base = base.scatter_reduce(0, start.to(torch.int64), lane_ids * H - cum,
                               reduce="amax", include_self=True)[:capacity]
    base = torch.cummax(base, 0).values
    i = torch.arange(capacity, dtype=torch.int32, device=c.device)
    sel = torch.where(i < count, base + i, 0)
    return sel, count, overflow, dropped


def scatter_back(values: torch.Tensor, sel: torch.Tensor, count, total: int, fill):
    """Inverse of compact: place values[i] at lane sel[i] for i < count."""
    out = torch.full((total + 1,) + tuple(values.shape[1:]), fill,
                     dtype=values.dtype, device=values.device)
    k = torch.arange(sel.shape[0], dtype=torch.int32, device=sel.device)
    slot = torch.where(k < count, sel, total).to(torch.int64)
    out[slot] = values
    return out[:total]
