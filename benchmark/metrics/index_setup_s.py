"""index_setup_s: the set-up seconds of the index: the program's
"load_index" (index.load_index: the artifact from disk) and "upload_index"
(engine.upload_index: the tables on the device) spans before the window
opens, the latest of each (a run loads and uploads once), summed (every
cell). Read from the program's recorder (bwtpu_torch.trace); None without
it, where its ring dropped a span before the window, or where neither ran."""


def read(w):
    try:
        from bwtpu_torch import trace
    except ImportError:  # a program without the recorder
        return None
    spans = trace.between(float("-inf"), w.t_open)
    if spans is None:
        return None
    last = {s.name: s.wall for s in spans if s.name in ("load_index", "upload_index")}
    return sum(last.values()) if last else None
