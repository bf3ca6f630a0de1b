"""Events completed in the window over the window's seconds."""


def CASE():
    """The synthetic run (treantbench/tests/synthetic.py) and what read() gives on it."""
    from treantbench.tests import synthetic

    return synthetic.run(), 2 / 2.0


def read(run):
    if not run.events or run.window_s <= 0:
        return None
    return len(run.events) / run.window_s
