"""Kernel launches per event: the port's launch counters (segment kernels
1-2, contract kernels 3-4) inside each event's ``Session.apply``, over the
window's events."""


def CASE():
    """The synthetic run (treantbench/tests/synthetic.py) and what read() gives on it."""
    from treantbench.tests import synthetic

    return synthetic.run(), (5 + 1) / 2


def read(run):
    if not run.events:
        return None
    return sum(e.launches for e in run.events) / len(run.events)
