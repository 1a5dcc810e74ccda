"""kernel_ms_per_mread.align: the summed durations of the device kernels in
the traced window, in ms per million reads done in it (align cells)."""


def read(w):
    if w.entry != "align" or w.trace is None or not w.reads:
        return None
    return w.trace["kernel_s"] * 1e3 / (w.reads / 1e6)
