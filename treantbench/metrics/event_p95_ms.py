"""95th percentile of the window's event latencies (host clock, each to a
device sync), over all its events."""

import numpy as np


def CASE():
    """The synthetic run (treantbench/tests/synthetic.py) and what read() gives on it."""
    from treantbench.tests import synthetic

    return synthetic.run(), 1000.0


def read(run):
    if not run.events:
        return None
    return float(np.percentile([(e.t1 - e.t0) * 1e3 for e in run.events], 95))
