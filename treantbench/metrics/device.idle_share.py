"""Share of the traced slice's wall time in which no kernel or copy ran on
the device: 1 - (union of device activity) / (slice length)."""


def CASE():
    """The synthetic run (treantbench/tests/synthetic.py) and what read() gives on it."""
    from treantbench.tests import synthetic

    return synthetic.run(), 100 * (1 - 0.0008 / 0.004)


def read(run):
    t = run.trace
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
