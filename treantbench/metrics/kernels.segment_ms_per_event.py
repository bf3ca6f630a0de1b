"""Device time of the segment kernels (1-2) per event, in the traced slice:
the profiler's durations of kernels whose name holds
``segment_aggregate`` and that start inside an event span (``tb.event.*``),
over the events in the slice."""


def CASE():
    """The synthetic run (treantbench/tests/synthetic.py) and what read() gives on it."""
    from treantbench.tests import synthetic

    return synthetic.run(), (0.3 + 0.2) / 2


def read(run):
    if run.trace is None:
        return None
    events = sorted((s, e) for n, s, e, *_ in run.trace["spans"] if n.startswith("tb.event."))
    if not events:
        return None
    starts = [s for s, _ in events]
    import bisect

    total = 0.0
    for name, s, e, *_ in run.trace["kernels"]:
        if "segment_aggregate" not in name:
            continue
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and s <= events[i][1]:
            total += e - s
    return total / 1e3 / len(events)
