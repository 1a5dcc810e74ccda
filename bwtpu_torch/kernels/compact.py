"""Fixed-capacity stream compaction on torch tensors (counterpart of
bwtpu/kernels/compact.py).

`compact` and `compact_counts` launch the hand-written kernels of
csrc/compact.cu on CUDA tensors (`compact_mask` and `compact_slots`: one
memset and one single-pass scan a call, no host sync) and run their plain
versions `compact_plain` and `compact_counts_plain` on CPU tensors;
anything else raises, and nothing falls back. The plain versions are the
port's torch forms of the reference: its `.at[...](mode="drop")`
scatters become scatters into one extra spill slot that is sliced off.
Overflow is counted, never silent.
"""

from __future__ import annotations

import ctypes

import torch

from bwtpu_torch.kernels import _build


def compact_plain(valid: torch.Tensor, capacity: int):
    """Plain version of `compact`."""
    v = valid.to(torch.int32)
    pos = torch.cumsum(v, 0, dtype=torch.int32) - v
    total = v.sum(dtype=torch.int32)  # 0 for an empty mask
    count = torch.clamp(total, max=capacity)
    overflow = torch.clamp(total - capacity, min=0)
    over = valid & (pos >= capacity)
    slot = torch.where(valid & ~over, pos, capacity)  # spill slot
    lane_ids = torch.arange(valid.shape[0], dtype=torch.int32, device=valid.device)
    sel = torch.zeros(capacity + 1, dtype=torch.int32, device=valid.device)
    sel = sel.scatter(0, slot.to(torch.int64), lane_ids)[:capacity]
    return sel, count, overflow, over


def compact(valid: torch.Tensor, capacity: int):
    """Compact the True lanes of a 1-D bool mask to the front.

    Returns (sel int32[capacity], count, overflow, over bool[N]): sel[i] =
    source lane of the i-th valid lane (0 beyond count, so always safe to
    gather with); count = min(valid lanes, capacity) and overflow = valid
    lanes past capacity, 0-dim int32; over flags the valid lanes at a
    position >= capacity, the ones sel has no slot for (the reference's
    callers compute it as `valid & (cumsum(valid) > capacity)`). The
    kernel compact_mask on CUDA tensors, `compact_plain` on CPU tensors,
    else an error; the two are equal on every output."""
    if not _build.on_cuda("compact_mask", valid):
        return compact_plain(valid, capacity)
    _build.check_tensor("compact_mask", "valid", valid, torch.bool, 1, valid.device)
    lib, tile = _lib()
    n = valid.shape[0]
    ws = _workspace(n, capacity, tile, valid.device)
    over = torch.empty(n, dtype=torch.bool, device=valid.device)
    rc = lib.bwtpu_compact_mask(valid.data_ptr(), n, capacity, ws.data_ptr(), ws.numel(),
                                over.data_ptr(), _build.stream_of(valid))
    _build.check(lib, rc, "compact_mask")
    _build.count_launch(compact)
    return ws[:capacity], ws[capacity], ws[capacity + 1], over


compact.launches = 0  # kernel launches since the last reset


def compact_counts_plain(counts: torch.Tensor, H: int, capacity: int):
    """Plain version of `compact_counts`: sel[i] = cummax(base)[i] + i,
    with base_l = l*H - cum_l scattered (max) at each live lane's first
    slot."""
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


def compact_counts(counts: torch.Tensor, H: int, capacity: int):
    """Structured compaction: lane l owns slots [l*H, l*H + counts[l]),
    counts clamped to [0, H].

    Same (sel, count, overflow) as ``compact`` over the prefix mask
    ``k < counts[l]`` of int32[Nlanes, H], plus dropped bool[Nlanes]:
    lanes whose slots did not all fit the capacity. The kernel
    compact_slots on CUDA tensors (int32 counts), `compact_counts_plain`
    on CPU tensors, else an error; the two are equal on every output."""
    if not _build.on_cuda("compact_slots", counts):
        return compact_counts_plain(counts, H, capacity)
    _build.check_tensor("compact_slots", "counts", counts, torch.int32, 1, counts.device)
    lib, tile = _lib()
    n = counts.shape[0]
    ws = _workspace(n, capacity, tile, counts.device)
    dropped = torch.empty(n, dtype=torch.bool, device=counts.device)
    rc = lib.bwtpu_compact_slots(counts.data_ptr(), n, H, capacity, ws.data_ptr(), ws.numel(),
                                 dropped.data_ptr(), _build.stream_of(counts))
    _build.check(lib, rc, "compact_slots")
    _build.count_launch(compact_counts)
    return ws[:capacity], ws[capacity], ws[capacity + 1], dropped


compact_counts.launches = 0  # kernel launches since the last reset


def _workspace(n: int, capacity: int, tile: int, device):
    """The kernels' int32 workspace: sel[capacity], count, overflow, the
    ticket, one look-back word a tile of `tile` lanes (the entry point
    zeroes it)."""
    return torch.empty(capacity + 3 + max(1, -(-n // tile)), dtype=torch.int32,
                       device=device)


def _lib():
    """(library, lanes a CTA) of compact.cu."""
    lib = _build.library("compact")
    if lib.bwtpu_compact_mask.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.bwtpu_compact_mask.restype = i
        lib.bwtpu_compact_mask.argtypes = [p, i, i, p, i, p, p]
        lib.bwtpu_compact_slots.restype = i
        lib.bwtpu_compact_slots.argtypes = [p, i, i, i, p, i, p, p]
        lib.bwtpu_compact_tile.restype = i
        lib.tile = lib.bwtpu_compact_tile()
    return lib, lib.tile


def scatter_back(values: torch.Tensor, sel: torch.Tensor, count, total: int, fill):
    """Inverse of compact: place values[i] at lane sel[i] for i < count."""
    out = torch.full((total + 1,) + tuple(values.shape[1:]), fill,
                     dtype=values.dtype, device=values.device)
    k = torch.arange(sel.shape[0], dtype=torch.int32, device=sel.device)
    slot = torch.where(k < count, sel, total).to(torch.int64)
    out[slot] = values
    return out[:total]
