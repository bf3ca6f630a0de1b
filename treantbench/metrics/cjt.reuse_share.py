"""Share of the messages the window's events needed that the message store
served: reused / (computed + reused), from each event's ``ExecStats``."""


def CASE():
    """The synthetic run (treantbench/tests/synthetic.py) and what read() gives on it."""
    from treantbench.tests import synthetic

    return synthetic.run(), 100 * 6 / 12


def read(run):
    computed = sum(e.computed for e in run.events)
    reused = sum(e.reused for e in run.events)
    if computed + reused == 0:
        return None
    return 100.0 * reused / (computed + reused)
