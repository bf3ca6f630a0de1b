"""Host time of the program's ``think.cube_build`` spans per event, in the
traced slice: the sum of end - start of the slice's ``think.cube_build``
ranges (``repro_torch.trace`` spans, on while the profiler records), over
the slice's events (its ``tb.event.*`` ranges), in ms."""

NAME = "think.cube_build"


def CASE():
    """The synthetic run (treantbench/tests/synthetic.py) and what read() gives on it."""
    from treantbench.tests import synthetic

    return synthetic.run(), (0.3) / 2


def read(run):
    if run.trace is None:
        return None
    events = sum(1 for n, *_ in run.trace["spans"] if n.startswith("tb.event."))
    spans = [(s, e) for n, s, e, *_ in run.trace["spans"] if n == NAME]
    if not events or not spans:
        return None
    return sum(e - s for s, e in spans) / 1e3 / events
