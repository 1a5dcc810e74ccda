"""The traced run's device side: a torch.profiler window (CUDA activity
only; with CPU activity its overhead swamps the host), exported as a
Chrome trace into TMPDIR, read and deleted.

The trace's clock is tied to perf_counter by the two synchronize calls
that open and close the window: each is a cudaDeviceSynchronize runtime
event in the trace, taken at a known host time.

  busy_s       seconds in which a kernel, copy or memset ran (merged)
  kernel_s     the kernels' summed durations
  device_ops   [name, seconds] of the 10 names that ran longest
  idle_gaps    [host activity, seconds]: the device's idle time within the
               window, by the spans open on the host at each gap's middle
               ("main span|worker span", "-" for none), the 10 largest sums
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
from time import perf_counter

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
ANCHOR = "cudaDeviceSynchronize"


class DeviceTrace:
    """Context manager around the window: open() and close() return the
    host times of the anchoring synchronize calls."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        return self

    def anchor(self) -> float:
        import torch

        t = perf_counter()
        torch.cuda.synchronize()
        return t

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        return False

    def events(self) -> list:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                return json.load(f)["traceEvents"]
        finally:
            os.unlink(path)


def _merge(iv: list) -> list:
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _open_at(spans_by_thread: dict, t: float) -> str:
    names = []
    for who in ("main", "worker"):
        starts, items = spans_by_thread.get(who, ([], []))
        i = bisect.bisect_right(starts, t) - 1
        names.append(items[i][0] if i >= 0 and items[i][3] > t else "-")
    return "|".join(names)


def summarize(events: list, anchors: tuple[float, float], t_open: float, t_close: float,
              spans: list) -> dict:
    """The device summary of the window [t_open, t_close] (host seconds)."""
    syncs = sorted(e["ts"] for e in events if e.get("name") == ANCHOR and "ts" in e)
    if syncs:
        # trace microseconds -> host seconds, from the first and last anchor
        offsets = [syncs[0] / 1e6 - anchors[0], syncs[-1] / 1e6 - anchors[1]]
        offset = sum(offsets) / 2
        drift = abs(offsets[1] - offsets[0])
    else:
        dev = [e["ts"] for e in events if e.get("cat") in DEVICE_CATS]
        offset = (min(dev) / 1e6 - t_open) if dev else 0.0
        drift = None
    busy_iv, kernel_s, by_name = [], 0.0, collections.Counter()
    for e in events:
        if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
            continue
        a = e["ts"] / 1e6 - offset
        b = a + e.get("dur", 0) / 1e6
        a, b = max(a, t_open), min(b, t_close)
        if b <= a:
            continue
        busy_iv.append((a, b))
        by_name[e["name"]] += b - a
        if e["cat"] == "kernel":
            kernel_s += b - a
    merged = _merge(busy_iv)
    busy = sum(b - a for a, b in merged)
    per = collections.defaultdict(lambda: ([], []))
    for s in sorted(spans, key=lambda s: s[2]):
        per[s[1]][0].append(s[2])
        per[s[1]][1].append(s)
    gaps, prev = collections.Counter(), t_open
    for a, b in merged + [[t_close, t_close]]:
        if a > prev:
            gaps[_open_at(per, (prev + a) / 2)] += a - prev
        prev = max(prev, b)
    return {
        "busy_s": busy,
        "kernel_s": kernel_s,
        "window_s": t_close - t_open,
        "anchored": bool(syncs),
        "anchor_drift_s": drift,
        "device_ops": [[n, s] for n, s in by_name.most_common(10)],
        "idle_gaps": [[n, s] for n, s in gaps.most_common(10)],
    }
