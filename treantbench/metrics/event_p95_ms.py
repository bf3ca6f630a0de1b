"""95th percentile of the window's event latencies (host clock, each to a
device sync), over all its events."""

import numpy as np


def read(run):
    if not run.events:
        return None
    return float(np.percentile([(e.t1 - e.t0) * 1e3 for e in run.events], 95))
