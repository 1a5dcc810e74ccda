"""emit_ms_per_mread: the time in results.select_primary_flat (worker) and
samfast.emit_single (main thread), in ms per million reads done (sam
cells)."""


def read(w):
    s, _ = w.span_s("select_primary_flat", "emit_single")
    return s * 1e3 / (w.reads / 1e6) if w.entry == "sam" and w.reads else None
