"""Fixed-capacity stream compaction on torch tensors (counterpart of
bwtpu/kernels/compact.py).

`compact` and `compact_counts` launch the hand-written kernels of
csrc/compact.cu on CUDA tensors (`compact_mask` and `compact_slots`; no
host sync) and run their plain versions `compact_plain` and
`compact_counts_plain` on CPU tensors; anything else raises, and nothing
falls back. Up to one cluster's capacity (32,768 lanes on an H100) a
call is one kernel on one thread-block cluster (no memset, no scratch
kept between calls); above it, a memset and a kernel whose tiles chain by
decoupled look-back (`plan`). The plain versions are the port's torch forms of the
reference: its `.at[...](mode="drop")` scatters become scatters into one
extra spill slot that is sliced off. Overflow is counted, never silent.
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
    out = _launch("compact_mask", valid, 1, capacity)
    _build.count_launch(compact)
    return out


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
    out = _launch("compact_slots", counts, H, capacity)
    _build.count_launch(compact_counts)
    return out


compact_counts.launches = 0  # kernel launches since the last reset


def plan(n: int, capacity: int, cluster_ctas: int, tile: int):
    """(form, ws_words) of a call on n lanes: the one place that picks a
    call's form and sizes its workspace. Up to one cluster's capacity (the
    device's `cluster_ctas` CTAs of `tile` lanes) form is the cluster
    form's CTA count, the fewest (a power of two) that hold the lanes,
    with a workspace of sel[capacity], count and overflow; above it (and
    for any n > 0 at cluster_ctas 0), 0: the tiles form, whose workspace
    adds the ticket and one look-back word a tile. The edge between the
    two is the cluster's capacity: clusters holding more lanes were slower
    than the tiles form on the card (scripts/torch_compact_ab.py, PERF.md
    §6)."""
    if n <= cluster_ctas * tile:
        ctas = 1
        while ctas * tile < n:
            ctas *= 2
        return ctas, capacity + 2
    return 0, capacity + 3 + max(1, -(-n // tile))


def _launch(kernel: str, x: torch.Tensor, H: int, capacity: int):
    """One call of compact.cu's `kernel` on x (a mask, or int32 counts of
    H slots a lane): (sel, count, overflow, flag) as views of one int32
    workspace and one bool tensor."""
    lib = _lib()
    n = x.shape[0]
    form, words = plan(n, capacity, _cluster_ctas(lib, x.device), lib.tile)
    ws = torch.empty(words, dtype=torch.int32, device=x.device)
    flag = torch.empty(n, dtype=torch.bool, device=x.device)
    if kernel == "compact_mask":
        _build.launch(lib, lib.bwtpu_compact_mask, kernel, x, x.data_ptr(), n, capacity, form,
                      ws.data_ptr(), words, flag.data_ptr())
    else:
        _build.launch(lib, lib.bwtpu_compact_slots, kernel, x, x.data_ptr(), n, H, capacity,
                      form, ws.data_ptr(), words, flag.data_ptr())
    sel, scalars, _ = ws.split((capacity, 2, words - capacity - 2))
    count, overflow = scalars.unbind()
    return sel, count, overflow, flag


def _cluster_ctas(lib, device) -> int:
    """The cluster size compact.cu finds placeable on `device`, asked once
    a device (which also allows that size there) and kept here."""
    ctas = lib.cluster_ctas.get(device.index)
    if ctas is None:
        out = ctypes.c_int()
        with torch.cuda.device(device):
            rc = lib.bwtpu_compact_cluster_query(ctypes.byref(out))
        _build.check(lib, rc, "compact cluster query")
        ctas = lib.cluster_ctas[device.index] = out.value
    return ctas


def _lib():
    """compact.cu's library, with its entry points typed and its lanes a
    CTA (`tile`) read."""
    lib = _build.library("compact")
    if not hasattr(lib, "cluster_ctas"):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.bwtpu_compact_mask.restype = i
        lib.bwtpu_compact_mask.argtypes = [p, i, i, i, p, i, p, p]
        lib.bwtpu_compact_slots.restype = i
        lib.bwtpu_compact_slots.argtypes = [p, i, i, i, i, p, i, p, p]
        lib.bwtpu_compact_cluster_query.restype = i
        lib.bwtpu_compact_cluster_query.argtypes = [p]
        lib.bwtpu_compact_tile.restype = i
        lib.tile = lib.bwtpu_compact_tile()
        lib.cluster_ctas = {}
    return lib


def scatter_back(values: torch.Tensor, sel: torch.Tensor, count, total: int, fill):
    """Inverse of compact: place values[i] at lane sel[i] for i < count."""
    out = torch.full((total + 1,) + tuple(values.shape[1:]), fill,
                     dtype=values.dtype, device=values.device)
    k = torch.arange(sel.shape[0], dtype=torch.int32, device=sel.device)
    slot = torch.where(k < count, sel, total).to(torch.int64)
    out[slot] = values
    return out[:total]
