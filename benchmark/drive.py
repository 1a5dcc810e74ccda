"""The window: closed loops over the program's entries, as
`bwtpu_torch.cli._align_block_stream` runs `align` (its loop copied: the
program has no function that takes a chunk iterator and a writable sink).

  align  the parsed pool blocks, cycled: Engine.dispatch_block on this
         thread, Engine.finish_block on one worker thread, `depth` blocks in
         flight. A block is done when its FlatHits are on the host.
  sam    the pool FASTQ re-read by readblock.read_fastq_stream (which parses
         one chunk ahead on its own thread), each pass one FASTQ -> SAM job:
         the SAM header, then per chunk dispatch_block, then finish_block and
         results.select_primary_flat on the worker, then samfast.emit_single
         into the sink. A chunk is done when its records are in the sink.

Spans (name, thread, start, end) are taken here, around the calls into
each layer; the per-layer metrics read them.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
from concurrent.futures import ThreadPoolExecutor
from time import perf_counter

import numpy as np


class Spans:
    """(name, "main" or "worker", start, end) in perf_counter seconds."""

    def __init__(self):
        self.items: list[tuple[str, str, float, float]] = []

    def add(self, name: str, t0: float, t1: float) -> None:
        who = "main" if threading.current_thread() is threading.main_thread() else "worker"
        self.items.append((name, who, t0, t1))  # list.append is atomic


@dataclasses.dataclass
class Window:
    """What one window did; the metric readers read this."""

    entry: str  # "align" or "sam"
    t_open: float
    t_close: float
    done: list  # (pool block, t_dispatch, t_done, reads, heals) in completion order
    dispatched: int  # reads dispatched in the window
    spans: Spans
    setup_s: float = 0.0
    trace: dict | None = None  # the traced run's device summary (devtrace)
    sam_bytes: int = 0  # what the sam loop wrote into its sink, header included

    @property
    def seconds(self) -> float:
        return self.t_close - self.t_open

    def in_window(self) -> list:
        return [d for d in self.done if d[2] <= self.t_close]

    @property
    def reads(self) -> int:
        """Reads whose results reached the host (align) or the sink (sam)
        within the window."""
        return sum(d[3] for d in self.in_window())

    def latencies_s(self) -> np.ndarray:
        return np.array([d[2] - d[1] for d in self.in_window()])

    @property
    def heals(self) -> int:
        return sum(d[4] for d in self.in_window())

    def span_s(self, *names: str) -> tuple[float, int]:
        """(seconds, count) of the named spans that started in the window."""
        d = [t1 - t0 for n, _, t0, t1 in self.spans.items
             if n in names and self.t_open <= t0 < self.t_close]
        return float(sum(d)), len(d)


def _process(engine, spans, primary):
    def process(handle):
        h0 = engine.stats.heals
        t0 = perf_counter()
        flat = engine.finish_block(handle)
        t1 = perf_counter()
        spans.add("finish_block", t0, t1)
        heals = engine.stats.heals - h0
        if not primary:
            return flat, None, t1, heals
        from bwtpu_torch.results import select_primary_flat

        prim = select_primary_flat(flat)
        t2 = perf_counter()
        spans.add("select_primary_flat", t1, t2)
        return flat, prim, t2, heals
    return process


def run_align(engine, blocks, *, k: int, depth: int, seconds: float | None,
              on_done=None, spans: Spans | None = None) -> Window:
    """Cycle the blocks for `seconds` (None: one pass, the warm-up)."""
    spans = spans or Spans()
    bs = max(b.n for b in blocks)
    process = _process(engine, spans, primary=False)
    inflight, done = collections.deque(), []
    dispatched = 0
    ex = ThreadPoolExecutor(max_workers=1)

    def drain():
        b, t0, fut = inflight.popleft()
        tw = perf_counter()
        flat, _, t_done, heals = fut.result()
        t1 = perf_counter()
        spans.add("wait", tw, t1)
        done.append((b, t0, t_done, blocks[b].n, heals))
        if on_done is not None:
            on_done(b, flat)
            spans.add("check", t1, perf_counter())

    t_open = perf_counter()
    t_close = t_open + seconds if seconds is not None else float("inf")
    try:
        for i in itertools.count():
            if seconds is None and i == len(blocks):
                break
            t0 = perf_counter()
            if t0 >= t_close:
                break
            b = i % len(blocks)
            handle = engine.dispatch_block(blocks[b], k, pad_to=bs)
            spans.add("dispatch_block", t0, perf_counter())
            inflight.append((b, t0, ex.submit(process, handle)))
            dispatched += blocks[b].n
            if len(inflight) >= depth:
                drain()
        while inflight:
            drain()
    finally:
        ex.shutdown(wait=True)
    if seconds is None:
        t_close = perf_counter()
    return Window("align", t_open, t_close, done, dispatched, spans)


def run_sam(engine, path: str, manifest, *, k: int, block: int, depth: int,
            seconds: float | None, sink, on_done=None, spans: Spans | None = None) -> Window:
    """FASTQ -> SAM passes over the pool file for `seconds` (None: one pass)."""
    from bwtpu_torch.readblock import read_fastq_stream
    from bwtpu_torch.results import ContigTable
    from bwtpu_torch.sam import sam_header
    from bwtpu_torch.samfast import emit_single

    spans = spans or Spans()
    ctable = ContigTable.build(manifest.contigs)
    header = sam_header(manifest.contigs).encode()
    process = _process(engine, spans, primary=True)
    inflight, done = collections.deque(), []
    dispatched = 0
    ex = ThreadPoolExecutor(max_workers=1)

    def drain():
        j, t0, sub, fut = inflight.popleft()
        tw = perf_counter()
        flat, prim, _, heals = fut.result()
        te = perf_counter()
        spans.add("wait", tw, te)
        blob = emit_single(sub, prim, ctable, truncated=flat.truncated)
        sink.write(blob)
        t_done = perf_counter()
        spans.add("emit_single", te, t_done)
        done.append((j, t0, t_done, sub.n, heals))
        if on_done is not None:
            on_done(j, blob)
            spans.add("check", t_done, perf_counter())

    t_open = perf_counter()
    t_close = t_open + seconds if seconds is not None else float("inf")
    closed = False
    try:
        while not closed:
            t0 = perf_counter()
            res = read_fastq_stream(path, block)
            spans.add("read_fastq_stream", t0, perf_counter())
            if res is None:
                raise ValueError(f"{path}: not a uniform-length FASTQ")
            chunks = res[2]
            sink.write(header)
            try:
                for j in itertools.count():
                    if perf_counter() >= t_close:
                        closed = True
                        break
                    t0 = perf_counter()
                    sub = next(chunks, None)
                    spans.add("next_chunk", t0, perf_counter())
                    if sub is None:
                        break
                    t0 = perf_counter()
                    handle = engine.dispatch_block(sub, k, pad_to=block)
                    spans.add("dispatch_block", t0, perf_counter())
                    inflight.append((j, t0, sub, ex.submit(process, handle)))
                    dispatched += sub.n
                    if len(inflight) >= depth:
                        drain()
                while inflight:
                    drain()
            finally:
                chunks.close()
            closed = closed or seconds is None
    finally:
        ex.shutdown(wait=True)
    if seconds is None:
        t_close = perf_counter()
    return Window("sam", t_open, t_close, done, dispatched, spans, sam_bytes=sink.bytes)


class CountingSink:
    """Where the SAM goes: its bytes are counted, not written to disk (a
    30 s window of SAM is about 10 GB)."""

    def __init__(self):
        self.bytes = 0

    def write(self, b: bytes) -> None:
        self.bytes += len(b)
