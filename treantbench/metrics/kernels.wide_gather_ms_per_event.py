"""Device time of segment kernels that gather from a message table past the
card's L2 per event, in the traced slice: the profiler's durations of the
kernels whose name holds ``segment_aggregate`` and whose owning
``kernels.launch`` range carries ``gather_rows`` of at least ``MIN_ROWS``
(the most rows of a message table that a fused member of that launch reads
at a row's index: 2^20 rows hold 4 MiB a lane, so 13 lanes pass the 50 MB
L2), over the slice's events (its ``tb.event.*`` ranges), in ms.  The
profiler's ``kernels.launch`` ranges and the program's span records of
that name (``repro_torch.trace``, made while the profiler records) are the
same launches in the same order."""

MIN_ROWS = 1 << 20


def CASE():
    """The synthetic run (treantbench/tests/synthetic.py), its one
    ``kernels.launch`` range's span record added with a 15M-row gather, and
    what read() gives on it: that launch's kernel, 300 µs, over 2 events."""
    from treantbench.tests import synthetic

    run = synthetic.run()
    run.trace["records"].append(
        {"id": 9, "parent": 0, "root": 0, "name": "kernels.launch", "t0": 0, "t1": 0,
         "prof": True, "attrs": {"symbol": "segment_aggregate", "members": 2,
                                 "gather_rows": 15_000_000}})
    return run, 0.3 / 2


def read(run):
    if run.trace is None:
        return None
    events = sum(1 for n, *_ in run.trace["spans"] if n.startswith("tb.event."))
    launches = [i for i, s in enumerate(run.trace["spans"]) if s[0] == "kernels.launch"]
    recs = [r["attrs"] for r in run.trace["records"]
            if r.get("name") == "kernels.launch" and r["prof"]]
    # a program whose launches carry no gather_rows reads nothing
    if not events or len(recs) != len(launches) or all("gather_rows" not in a for a in recs):
        return None
    wide = [a.get("gather_rows", 0) >= MIN_ROWS for a in recs]
    wide_at = {i for i, w in zip(launches, wide) if w}
    return sum(e - s for name, s, e, _, owner in run.trace["kernels"]
               if "segment_aggregate" in name and owner in wide_at) / 1e3 / events
