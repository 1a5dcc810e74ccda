"""offcpu_ms_per_block.sam: the time the finish thread was neither running
nor waiting for the card (the interpreter lock, held by the main thread's
dispatch, SAM emission and parse, other locks, the scheduler): over the
level-0 "finish" spans, wall less thread CPU, less the same of the "wait"
spans inside them, in ms a block (sam cells).
Read from the program's recorder (bwtpu_torch.trace): the spans that
started in the window, per block done. None without the recorder, where
its ring dropped a span of the window, or where no block was done."""


def read(w):
    try:
        from bwtpu_torch import trace
    except ImportError:  # a program without the recorder
        return None
    n = len(w.in_window())
    spans = trace.between(w.t_open, w.t_close) if w.entry == "sam" and n else None
    if spans is None:
        return None
    by_id = {s.id: s for s in spans}
    top = {s.id: s for s in spans if s.name == "finish" and s.parent < 0}

    def root(s):
        while s.parent in by_id:
            s = by_id[s.parent]
        return s.id

    off = sum(s.wall - s.cpu for s in top.values())
    off -= sum(s.wall - s.cpu for s in spans if s.name == "wait" and root(s) in top)
    return off * 1e3 / n
