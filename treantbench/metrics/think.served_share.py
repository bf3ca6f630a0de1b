"""Share of rendered vizzes that think time served: bin-cube and prefetch
hits (each result's ``ExecStats``) over the vizzes the window's events
rendered."""


def CASE():
    """The synthetic run (treantbench/tests/synthetic.py) and what read() gives on it."""
    from treantbench.tests import synthetic

    return synthetic.run(), 100 * 2 / 5


def read(run):
    rendered = sum(e.rendered for e in run.events)
    if rendered == 0:
        return None
    return 100.0 * sum(e.cube_hits + e.prefetch_hits for e in run.events) / rendered
