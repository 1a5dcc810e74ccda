# Copy of bwtpu/hosttune.py for the port; only its imports differ (tests/test_torch_hostcopy.py).
"""Host allocator tuning for the streaming batch path.

Measured on this host (round 3, docs/DESIGN.md "page-fault wall"):
first-touch page faults run at ~50 MB/s, and glibc returns every
>=128 KB allocation to the kernel on free (mmap/munmap per buffer), so
each per-batch NumPy array refaults its pages from scratch — a 200 MB
astype measured 3.1 s cold vs 0.03 s once pages are reused. Raising
M_MMAP_THRESHOLD / M_TRIM_THRESHOLD keeps large buffers on the heap
between batches: steady-state host stages sped up ~100x.

Call tune_malloc() once at entry (cli, bench, multihost). Safe no-op on
non-glibc platforms.
"""

from __future__ import annotations

import ctypes
import logging

log = logging.getLogger(__name__)

_done = False

M_TRIM_THRESHOLD = -1
M_MMAP_THRESHOLD = -3


def tune_malloc(threshold: int = 1 << 30) -> bool:
    """Keep <threshold-sized allocations on the heap across free()."""
    global _done
    if _done:
        return True
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        ok = bool(libc.mallopt(M_MMAP_THRESHOLD, threshold)) and bool(
            libc.mallopt(M_TRIM_THRESHOLD, threshold)
        )
        _done = ok
        return ok
    except Exception as e:  # non-glibc / sandboxed
        log.debug("mallopt unavailable: %s", e)
        return False
