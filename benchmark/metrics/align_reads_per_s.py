"""align_reads_per_s: reads whose FlatHits reached the host within the
window, over the window's seconds (align cells)."""


def read(w):
    return w.reads / w.seconds if w.entry == "align" else None
