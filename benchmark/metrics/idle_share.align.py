"""idle_share.align: 100 * (1 - merged device busy time / the traced window),
from the profiler's kernel, copy and memset events, in % (align cells)."""


def read(w):
    t = w.trace
    if w.entry != "align" or t is None or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
