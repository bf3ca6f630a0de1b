"""Messages computed out of a large inner relation per event, in the
traced slice: the slice's ``cjt.message`` spans (``repro_torch.trace``
records, on while the profiler records) whose source bag holds at least
``MIN_ROWS`` rows (``rows``) and is not the fact, the bag that holds the
query's measure (``from_measure``), over the slice's events (its
``tb.event.*`` ranges).  In a snowflake these are the messages out of
Orders, Customer or Part that a brush on them or below them recomputes.
A program whose message spans carry no ``from_measure`` reads nothing."""

MIN_ROWS = 1 << 20


def CASE():
    """A synthetic run (treantbench/tests/synthetic.py) with four message
    spans added to its records and no contraction of the fact, and what
    read() gives on it: the two messages out of Orders and Customer over 2
    events (Orders is the largest bag the slice reads, and still inner)."""
    from treantbench.tests import synthetic

    run = synthetic.run()

    def span(prof=True, **attrs):
        return {"id": 0, "parent": 0, "root": 0, "name": "cjt.message", "t0": 0, "t1": 0,
                "prof": prof, "attrs": dict(attrs, from_measure=False)}

    run.trace["records"] += [
        span(edge="bag:Orders->bag:Lineitem", rows=15_000_000, level=2),
        span(edge="bag:Customer->bag:Orders", rows=1_500_000, level=1),
        span(edge="bag:Supplier->bag:Lineitem", rows=100_000, level=1),
        # made while no profiler recorded: outside the slice
        span(prof=False, edge="bag:Orders->bag:Lineitem", rows=15_000_000, level=2),
    ]
    return run, 2 / 2


def read(run):
    if run.trace is None:
        return None
    events = sum(1 for n, *_ in run.trace["spans"] if n.startswith("tb.event."))
    msgs = [r["attrs"] for r in run.trace["records"]
            if r.get("name") == "cjt.message" and r["prof"] and "from_measure" in r["attrs"]]
    if not events or not msgs:
        return None
    return sum(1 for a in msgs if a["rows"] >= MIN_ROWS and not a["from_measure"]) / events
