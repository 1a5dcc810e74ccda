"""sam_reads_per_s: reads whose SAM records reached the sink within the
window, over the window's seconds (sam cells)."""


def read(w):
    return w.reads / w.seconds if w.entry == "sam" else None
