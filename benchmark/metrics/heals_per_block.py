"""heals_per_block: Engine.stats.heals (re-dispatches with doubled caps)
added by the blocks done in the window, per block (align cells)."""


def read(w):
    n = len(w.in_window())
    return w.heals / n if w.entry == "align" and n else None
