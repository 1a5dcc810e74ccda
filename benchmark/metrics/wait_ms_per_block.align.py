"""wait_ms_per_block.align: the host blocked on the card inside
Engine.finish_block, until the event its dispatch recorded: the "wait"
spans of every heal level, summed, in ms a block (align cells).
Read from the program's recorder (bwtpu_torch.trace): the spans that
started in the window, per block done. None without the recorder, where
its ring dropped a span of the window, or where no block was done."""


def read(w):
    try:
        from bwtpu_torch import trace
    except ImportError:  # a program without the recorder
        return None
    n = len(w.in_window())
    spans = trace.between(w.t_open, w.t_close) if w.entry == "align" and n else None
    if spans is None:
        return None
    return sum(s.wall for s in spans if s.name == "wait") * 1e3 / n
