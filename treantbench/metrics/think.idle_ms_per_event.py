"""Think time spent per event: the harness's host-clock span around each
``Session.idle`` (to a device sync), summed over the window, over its
events."""


def CASE():
    """The synthetic run (treantbench/tests/synthetic.py) and what read() gives on it."""
    from treantbench.tests import synthetic

    return synthetic.run(), (250 + 50) / 2


def read(run):
    if not run.events or not run.idles:
        return None
    return sum(t1 - t0 for t0, t1 in run.idles) * 1e3 / len(run.events)
