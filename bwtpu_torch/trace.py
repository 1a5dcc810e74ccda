"""Spans and counters of the Engine's block path, kept in memory.

  span(name, block=-1, cpu=False)
                        a context manager: one span of the calling thread;
                        its wall (and with cpu=True thread-CPU) seconds are
                        read back as .wall and .cpu once it has closed
  count(name, n)        add n to a counter
  new_block()           the next block number (Engine.dispatch_block gives
                        one to each level-0 dispatch; its heals share it)
  current_block()       the block of the calling thread's innermost open span
  between(t0, t1)       the Records of the spans that started in [t0, t1),
                        by start; None where the ring dropped any of them
  spans()               every Record in the ring, by start
  timeline(records)     per thread, the innermost span at each moment, as
                        (name, who, t0, t1) segments that do not overlap
  totals()              ({span name: [count, wall s, CPU s]}, {counter: total})
  dropped()             the spans the ring has dropped

A span records its id, name, thread ("main" for the main thread, else
"worker"), parent (the id of the enclosing span on the same thread, -1 for
none), block (given, or the enclosing span's; -1 for none), wall t0/t1 from
time.perf_counter (the clock the harness's device trace is anchored to) and,
for the spans opened with cpu=True, thread CPU c0/c1 from time.thread_time
(0.0 for the others: the thread's CPU clock is a system call, which costs
more than the rest of a span where system calls are trapped). Closed spans go into a ring of RING
entries as plain tuples of numbers and strings, which the garbage collector
stops tracking, so a full ring adds nothing to a collection; past RING the
oldest are dropped, and counted. Totals and counters are kept per thread,
so no thread waits on another's. The recorder is always on: a span costs a
few microseconds of host time and no device sync.
"""

from __future__ import annotations

import collections
import itertools
import threading
from time import perf_counter, thread_time
from typing import NamedTuple

RING = 1 << 18
NONE_DROPPED = float("-inf")


class Record(NamedTuple):
    """A closed span, as between() and spans() give it."""

    id: int
    name: str
    who: str
    parent: int
    block: int
    t0: float
    t1: float
    c0: float
    c1: float

    @property
    def wall(self) -> float:
        return self.t1 - self.t0

    @property
    def cpu(self) -> float:
        return self.c1 - self.c0


class Span:
    """One span while its `with` block runs; its Record goes into the ring."""

    __slots__ = ("_rec", "_th", "_cpu", "id", "name", "who", "parent", "block", "t0", "t1",
                 "c0", "c1")

    def __init__(self, rec: Recorder, name: str, block: int, cpu: bool):
        self._rec, self.name, self.block, self._cpu = rec, name, block, cpu

    def __enter__(self) -> Span:
        th = self._th = self._rec._thread()
        stack = th.stack
        if stack:
            top = stack[-1]
            self.parent = top.id
            if self.block < 0:
                self.block = top.block
        else:
            self.parent = -1
        self.who = th.who
        self.id = next(self._rec._ids)
        stack.append(self)
        self.c0 = thread_time() if self._cpu else 0.0
        self.t0 = perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = perf_counter()
        self.c1 = thread_time() if self._cpu else 0.0
        self._th.stack.pop()
        self._rec._close(self)
        return False

    @property
    def wall(self) -> float:
        return self.t1 - self.t0

    @property
    def cpu(self) -> float:
        return self.c1 - self.c0


class _Thread:
    """One thread's open spans, totals and counters."""

    __slots__ = ("stack", "who", "spans", "counters", "dropped_t0")

    def __init__(self, who: str):
        self.stack, self.who = [], who
        self.spans: dict = {}  # name -> (count, wall s, CPU s)
        self.counters: dict = {}
        self.dropped_t0 = NONE_DROPPED  # latest start among the spans it dropped


class Recorder:
    """The spans and counters of one process (module functions below use
    one Recorder; tests make their own)."""

    def __init__(self, ring: int = RING):
        self._ring: list = [None] * ring
        self._slots = itertools.count()  # a slot a closed span, never shared
        self._ids = itertools.count()
        self._blocks = itertools.count()
        self._threads: list[_Thread] = []
        self._local = threading.local()

    def _thread(self) -> _Thread:
        th = getattr(self._local, "th", None)
        if th is None:
            who = "main" if threading.current_thread() is threading.main_thread() else "worker"
            th = self._local.th = _Thread(who)
            self._threads.append(th)
        return th

    def _close(self, s: Span) -> None:
        th = s._th
        i = next(self._slots) % len(self._ring)
        old = self._ring[i]
        self._ring[i] = (s.id, s.name, s.who, s.parent, s.block, s.t0, s.t1, s.c0, s.c1)
        if old is not None and old[5] > th.dropped_t0:
            th.dropped_t0 = old[5]
        n, wall, cpu = th.spans.get(s.name, (0, 0.0, 0.0))
        th.spans[s.name] = (n + 1, wall + s.t1 - s.t0, cpu + s.c1 - s.c0)

    def span(self, name: str, block: int = -1, cpu: bool = False) -> Span:
        return Span(self, name, block, cpu)

    def count(self, name: str, n: int) -> None:
        c = self._thread().counters
        c[name] = c.get(name, 0) + n

    def new_block(self) -> int:
        return next(self._blocks)

    def current_block(self) -> int:
        stack = self._thread().stack
        return stack[-1].block if stack else -1

    def dropped(self) -> int:
        closed = sum(n for th in list(self._threads) for n, _, _ in list(th.spans.values()))
        return max(0, closed - len(self._ring))

    def spans(self) -> list[Record]:
        return _records(list(self._ring), float("-inf"), float("inf"))

    def between(self, t0: float, t1: float) -> list[Record] | None:
        ring = list(self._ring)
        latest = max((th.dropped_t0 for th in list(self._threads)), default=NONE_DROPPED)
        if latest > NONE_DROPPED and latest >= t0:
            return None
        return _records(ring, t0, t1)

    def timeline(self, spans: list[Record] | None = None) -> list[tuple[str, str, float, float]]:
        """Each thread's time split among its innermost open spans: a
        span's own segments are its interval less its children's. Spans
        whose parent is not among `spans` count as outermost."""
        spans = self.spans() if spans is None else sorted(spans, key=lambda s: s.t0)
        ids = {s.id for s in spans}
        kids, roots = collections.defaultdict(list), []
        for s in spans:
            (kids[s.parent] if s.parent in ids else roots).append(s)
        out = []

        def walk(s):
            at = s.t0
            for c in kids[s.id]:
                if c.t0 > at:
                    out.append((s.name, s.who, at, c.t0))
                walk(c)
                at = max(at, c.t1)
            if s.t1 > at:
                out.append((s.name, s.who, at, s.t1))

        for r in roots:
            walk(r)
        return sorted(out, key=lambda x: (x[1], x[2]))

    def totals(self) -> tuple[dict, dict]:
        spans, counters = {}, collections.Counter()
        for th in list(self._threads):
            for name, (n, wall, cpu) in list(th.spans.items()):
                tot = spans.setdefault(name, [0, 0.0, 0.0])
                tot[0] += n
                tot[1] += wall
                tot[2] += cpu
            counters.update(dict(th.counters))
        return spans, dict(counters)


def _records(ring: list, t0: float, t1: float) -> list[Record]:
    return sorted((Record._make(r) for r in ring if r is not None and t0 <= r[5] < t1),
                  key=lambda r: r.t0)


_REC = Recorder()
span = _REC.span
count = _REC.count
new_block = _REC.new_block
current_block = _REC.current_block
dropped = _REC.dropped
spans = _REC.spans
between = _REC.between
timeline = _REC.timeline
totals = _REC.totals
