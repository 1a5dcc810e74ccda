"""block_ms_p95: the 95th percentile (linear interpolation), over every
block done in the window, of the time from the start of dispatch_block to
the return of finish_block, in ms (align cells)."""

import numpy as np


def read(w):
    lat = w.latencies_s()
    if w.entry != "align" or len(lat) == 0:
        return None
    return float(np.percentile(lat, 95)) * 1e3
