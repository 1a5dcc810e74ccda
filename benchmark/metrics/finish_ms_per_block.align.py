"""finish_ms_per_block.align: the mean wall of Engine.finish_block (wait,
fetch, host assembly, heals) on the worker thread over the calls the
window started, in ms (align cells)."""


def read(w):
    s, n = w.span_s("finish_block")
    return s * 1e3 / n if w.entry == "align" and n else None
