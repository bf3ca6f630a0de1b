"""Messages the CJT engine computed per event: ``ExecStats.messages_computed``
summed over each event's rendered vizzes, over the window's events."""


def CASE():
    """The synthetic run (treantbench/tests/synthetic.py) and what read() gives on it."""
    from treantbench.tests import synthetic

    return synthetic.run(), (2 + 4) / 2


def read(run):
    if not run.events:
        return None
    return sum(e.computed for e in run.events) / len(run.events)
