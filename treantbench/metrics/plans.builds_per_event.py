"""Plans built per event: ``PlanStats.plans_built`` over the window (every
engine of the Treant), over the window's events."""


def CASE():
    """The synthetic run (treantbench/tests/synthetic.py) and what read() gives on it."""
    from treantbench.tests import synthetic

    return synthetic.run(), 3 / 2


def read(run):
    if not run.events:
        return None
    return run.plans_built / len(run.events)
