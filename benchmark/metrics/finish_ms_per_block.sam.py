"""finish_ms_per_block.sam: the mean wall of Engine.finish_block (wait,
fetch, host assembly, heals) on the worker thread over the calls the
window started, in ms (sam cells)."""


def read(w):
    s, n = w.span_s("finish_block")
    return s * 1e3 / n if w.entry == "sam" and n else None
