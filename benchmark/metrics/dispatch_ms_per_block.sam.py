"""dispatch_ms_per_block.sam: the mean wall of Engine.dispatch_block (pack,
upload, issue) over the calls the window started, in ms (sam cells)."""


def read(w):
    s, n = w.span_s("dispatch_block")
    return s * 1e3 / n if w.entry == "sam" and n else None
