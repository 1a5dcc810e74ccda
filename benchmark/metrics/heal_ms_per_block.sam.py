"""heal_ms_per_block.sam: the heals of Engine.finish_block (each a whole
dispatch and finish of the block at doubled caps): the "heal" spans whose
parent is a level-0 "finish" (nested heals are inside them, counted once),
summed, in ms a block (sam cells).
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
    top = [s for s in spans if s.name == "heal" and s.parent in by_id
           and by_id[s.parent].name == "finish" and by_id[s.parent].parent < 0]
    return sum(s.wall for s in top) * 1e3 / n
