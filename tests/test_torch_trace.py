"""The port's program spans and shape records (``repro_torch.trace``).

At a tiny size on the CPU: off, a span is the shared no-op and nothing is
recorded, timed or opened in a profiler over a brush event and an idle; on,
an event's spans form one tree under ``session.apply`` with one root id and
think-time spans sit under ``session.idle``; under ``torch.profiler`` every
span is a profiler range of the same name and nesting; shape records match
the tensors they describe; and answers are bit-equal with tracing on and
off.  The card's half (kernel 1-2 launches linked to ``kernels.launch``
spans by correlation id) is in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import trace
from repro_torch.core import DashboardSpec, Drill, PredictiveThinkTime, SetFilter, Treant, VizSpec
from repro_torch.core import plans
from repro_torch.core import semiring as sr
from repro_torch.kernels import launch
from repro_torch.kernels.segment_aggregate import ops
from repro_torch.relational.relation import catalog_from_arrays

DOMS = {"a": 13, "b": 7, "c": 10, "d": 5, "e": 9}
STAR = [("F", ("a", "b"), 600, True), ("S", ("b", "c"), 77, False),
        ("T", ("a", "d"), 29, False), ("U", ("b", "e"), 41, False)]


@pytest.fixture(autouse=True)
def clean_trace():
    trace.disable()
    trace.take()
    yield
    trace.disable()
    trace.take()


def catalog(seed=0):
    rng = np.random.default_rng(seed)
    return catalog_from_arrays([
        dict(name=name, attrs=attrs, domains=DOMS,
             codes={a: rng.integers(0, DOMS[a], n).astype(np.int32) for a in attrs},
             measures={"m": rng.normal(size=n).astype(np.float32)} if measure else {})
        for name, attrs, n, measure in STAR
    ])


def session(cat, ring="sum"):
    measure = None if ring == "count" else ("F", "m")
    spec = DashboardSpec(vizzes=tuple(
        VizSpec(name, measure=measure, ring=ring, group_by=(g,))
        for name, g in (("main", "a"), ("src", "c"), ("third", "d"))))
    primary = sr.SUM if ring in ("count", "sum") else sr.get(ring)
    return Treant(cat, ring=primary, device="cpu").open_session(spec, name="x")


BRUSH = SetFilter("c", lo=2, hi=5, source="src")


def work(sess, what):
    if what == "event":
        return [sess.apply(BRUSH)]
    sess.apply(BRUSH)
    sess.idle(policy=PredictiveThinkTime(4, 2))
    return [sess.apply(SetFilter("c", lo=3, hi=6, source="src")), sess.apply(Drill("main", "e"))]


def spans(records):
    return [r for r in records if "name" in r]


def ancestors(rec, by_id):
    out = []
    while rec["parent"]:
        rec = by_id[rec["parent"]]
        out.append(rec["name"])
    return out


@pytest.mark.parametrize("what", ["event", "idle"])
def test_off_span_is_the_shared_no_op_and_makes_nothing(monkeypatch, what):
    sess = session(catalog())

    def forbidden(*a, **k):
        raise AssertionError("tracing is off")

    class Clock:
        perf_counter_ns = staticmethod(forbidden)

    monkeypatch.setattr(trace, "_range", forbidden)
    monkeypatch.setattr(trace, "time", Clock)
    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", forbidden)
    monkeypatch.setattr(torch.cuda, "Event", forbidden)
    assert not trace.on()
    assert trace.span("plans.rowwise") is trace.span("session.apply", event="x") is trace._OFF
    work(sess, what)
    trace.record("plans.member", rows=1)
    assert trace.take() == []


@pytest.mark.parametrize("what", ["event", "idle"])
def test_on_spans_form_one_tree_per_event(what):
    sess = session(catalog())
    trace.enable()
    work(sess, what)
    recs = spans(trace.take())
    by_id = {r["id"]: r for r in recs}
    roots = [r for r in recs if r["parent"] == 0]
    assert {r["name"] for r in roots} <= {"session.apply", "session.idle"}
    for r in recs:
        assert r["root"] == (r["id"] if r["parent"] == 0 else by_id[r["parent"]]["root"])
        if r["parent"]:
            p = by_id[r["parent"]]
            assert p["t0"] <= r["t0"] <= r["t1"] <= p["t1"]
        if r["name"].startswith("think."):
            assert by_id[r["root"]]["name"] == "session.idle"
    first = roots[0]
    assert first["name"] == "session.apply" and first["attrs"]["event"] == "SetFilter"
    assert set(first["attrs"]["affected"]) == {"main", "third"}
    kids = {r["name"] for r in recs if r["parent"] == first["id"]}
    assert {"session.derive", "session.execute", "session.sync"} <= kids
    chain = ["plans.contraction", "cjt.execute_many", "session.execute", "session.apply"]
    rowwise = [r for r in recs if r["name"] == "plans.rowwise" and r["root"] == first["id"]]
    assert rowwise and all(ancestors(r, by_id)[:4] == chain for r in rowwise)
    if what == "idle":
        names = {r["name"] for r in recs}
        assert {"session.idle", "think.drain", "think.cube_build"} <= names
        builds = [r for r in recs if r["name"] == "think.cube_build"]
        assert all(set(b["attrs"]) == {"viz", "dim", "built", "cells"} for b in builds)
        assert any(b["attrs"]["built"] and b["attrs"]["cells"] > 0 for b in builds)


@pytest.mark.parametrize("what", ["event", "idle"])
def test_under_a_profiler_every_span_is_a_range_of_the_same_name_and_nesting(what):
    sess = session(catalog())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.on()
        work(sess, what)
    assert not trace.on()
    recs = spans(trace.take())
    assert recs and all(r["prof"] for r in recs)
    by_id = {r["id"]: r for r in recs}
    program = ("session.", "think.", "cjt.", "plans.", "kernels.")
    ranges = sorted((e for e in prof.events() if e.name.startswith(program)),
                    key=lambda e: e.time_range.start)

    def program_parent(e):
        e = e.cpu_parent
        while e is not None and not e.name.startswith(program):
            e = e.cpu_parent
        return e.name if e is not None else None

    assert [e.name for e in ranges] == [r["name"] for r in sorted(recs, key=lambda r: r["t0"])]
    assert [program_parent(e) for e in ranges] == [
        by_id[r["parent"]]["name"] if r["parent"] else None
        for r in sorted(recs, key=lambda r: r["t0"])]


@pytest.mark.parametrize("ring", ["sum", "moments"])
def test_member_records_match_the_contractions_tensors(monkeypatch, ring):
    sess = session(catalog(), ring)
    calls = []
    run_sparse, run_batch = plans.PlanCache.run_sparse, plans.PlanCache._run_batch_group

    def sparse(self, catalog, rel, vals, incoming, preds, out_attrs, *a, **k):
        out = run_sparse(self, catalog, rel, vals, incoming, preds, out_attrs, *a, **k)
        calls.append((rel, vals, incoming, preds, out_attrs, out))
        return out

    def batch(self, catalog, items, stats_list, calibration):
        outs = run_batch(self, catalog, items, stats_list, calibration)
        calls.extend((it.rel, it.vals, it.incoming, it.preds, it.out_attrs, f)
                     for it, f in zip(items, outs))
        return outs

    monkeypatch.setattr(plans.PlanCache, "run_sparse", sparse)
    monkeypatch.setattr(plans.PlanCache, "_run_batch_group", batch)
    trace.enable()
    work(sess, "event")
    sess.apply(Drill("third", "e"))
    members = [r for r in trace.take() if r.get("kind") == "plans.member"]
    assert len(members) == len(calls) >= 3
    want = []
    for rel, vals, incoming, preds, out_attrs, out in calls:
        leaves = sr.leaves(vals)
        rel_set = set(rel.attrs)
        carried = {a: d for m in incoming for a, d in m.domains.items() if a not in rel_set}
        want.append({
            "rel": rel.name, "num_rows": rel.num_rows, "row_bucket": leaves[0].shape[0],
            "lanes": int(np.prod(list(carried.values()))),
            "gather_cols": sum(1 for m in incoming if rel_set & set(m.attrs)),
            "sigma_cols": len(preds),
            "lift_row_bytes": sum(leaf[0].numel() * leaf.element_size() for leaf in leaves),
            "in_elems": [sum(x.numel() for x in sr.leaves(m.field)) for m in incoming],
            "out_elems": sum(x.numel() for x in sr.leaves(out.field)),
            "code_bytes": 4, "value_bytes": 4,
        })
    got = [{k: v for k, v in r.items() if k not in ("kind", "span", "root", "prof")}
           for r in members]
    assert sorted(got, key=repr) == sorted(want, key=repr)


@pytest.mark.parametrize("n,g,v,ordered,regime", [
    (5000, 6, 3, False, "thread"),
    (5000, 300, 2, False, "warp"),
    (5000, 4000, 1, False, "sort"),     # read through the row order
    (5000, 4000, 1, True, "sort"),      # values in code order
], ids=["thread", "warp", "sort", "sort_ordered"])
def test_segment_records_match_the_launchs_messages(monkeypatch, n, g, v, ordered, regime):
    monkeypatch.setattr(ops.kernel, "launch", lambda name, members, op, gather_rows=None: 1)
    rng = np.random.default_rng(n + g)
    codes = torch.as_tensor(rng.integers(0, g, n).astype(np.int32))
    values = torch.zeros((n, v), dtype=torch.float32)
    out = torch.zeros((g, v), dtype=torch.float32)
    trace.enable()
    ops._launch_members("level_segment_aggregate", [(codes, values, out, ordered)], "sum")
    (rec,) = trace.take()
    order = (ops.cached_row_order(codes, g, launch.segment_geometry(n, g, v).chunk)
             if regime == "sort" else None)
    assert rec == {
        "kind": "kernels.segment", "span": 0, "root": 0, "prof": False,
        "kernel": "level_segment_aggregate", "n": n, "g": g, "v": v, "elem_bytes": 4,
        "regime": regime, "ordered": ordered,
        "n_items": order.n_items if order else 0,
        "table_bytes": order.table.numel() * 4 if order else 0,
        "fused": False, "msgs": 0, "preds": 0, "recipe_bytes": 0,
        "gather_rows": 0, "gather_bytes": 0,
    }


def test_fused_segment_record_carries_the_recipes_counts(monkeypatch):
    """A fused member's ``kernels.segment`` record says so, with its
    messages (K), σ predicates (P) and the bytes of its recipe, which it
    reads in place of an (N, V) slab."""
    monkeypatch.setattr(ops.kernel, "launch", lambda name, members, op, gather_rows=None: 1)
    rng = np.random.default_rng(3)
    n, g = 4000, 6
    i32 = lambda hi: torch.as_tensor(rng.integers(0, hi, n).astype(np.int32))  # noqa: E731
    lanes = torch.arange(12, dtype=torch.int32)
    rc = ops.Recipe(torch.ones(n), ((i32(30), torch.ones(30, 4), lanes // 3),
                                    (None, torch.ones(1, 3), lanes % 3)),
                    ((i32(7), torch.ones(7, dtype=torch.bool)),), lanes=12)
    trace.enable()
    ops._launch_members("segment_aggregate", [(i32(g), rc, torch.zeros(g, 12), False)], "sum")
    (rec,) = trace.take()
    assert (rec["fused"], rec["msgs"], rec["preds"], rec["v"], rec["regime"]) == (
        True, 2, 1, 12, "thread")
    # lift, index, σ codes (4 B a row each); the tables, lane columns and mask
    assert rec["recipe_bytes"] == rc.nbytes == 12 * n + 4 * (120 + 12 + 3 + 12) + 7


def test_fused_members_and_their_launch_carry_the_tables_they_gather_from(monkeypatch):
    """A fused member's ``kernels.segment`` record gives the rows of the
    largest message table it reads at a row's index and the bytes of every
    such table (a broadcast table, read at row 0, is not gathered; a slab
    member gathers nothing); each ``kernels.launch`` span gives the most
    rows a member of that launch gathers from."""
    from repro_torch.kernels.segment_aggregate import kernel as seg_kernel

    rng = np.random.default_rng(5)
    n, g = 3000, 6
    i32 = lambda hi: torch.as_tensor(rng.integers(0, hi, n).astype(np.int32))  # noqa: E731
    lanes = torch.arange(8, dtype=torch.int32)
    wide = ops.Recipe(torch.ones(n), ((i32(900), torch.ones(900, 2), lanes // 4),
                                      (i32(40), torch.ones(40, 4), lanes % 4),
                                      (None, torch.ones(1, 8), lanes)), lanes=8)
    narrow = ops.Recipe(torch.ones(n), ((i32(40), torch.ones(40, 8), lanes),), lanes=8)
    slab = torch.zeros((n, 8))
    members = [(i32(g), rc, torch.zeros(g, 8), False) for rc in (wide, narrow, slab)]
    calls = []
    kern = launch.Kernel("segment_aggregate", [])
    kern._fn = lambda *args: calls.append(args) or 0
    kern._stream = lambda index: 7
    monkeypatch.setattr(kern, "scratch", lambda device, one: (0, 0))
    monkeypatch.setitem(seg_kernel.KERNELS, "segment_aggregate", kern)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(launch, "SEG_MAX_MEMBERS", 2)     # two launches: wide + narrow, slab
    trace.enable()
    ops._launch_members("segment_aggregate", members, "sum")
    recs = trace.take()
    segs = [r for r in recs if r.get("kind") == "kernels.segment"]
    assert [(r["gather_rows"], r["gather_bytes"]) for r in segs] == [
        (900, 4 * (900 * 2 + 40 * 4)), (40, 4 * 40 * 8), (0, 0)]
    spans = [r["attrs"] for r in recs if r.get("name") == "kernels.launch"]
    assert [(a["members"], a["gather_rows"]) for a in spans] == [(2, 900), (1, 0)]
    assert len(calls) == 2
    trace.disable()
    ops._launch_members("segment_aggregate", members, "sum")
    assert trace.take() == [] and len(calls) == 4


def test_kernel_launch_span_carries_symbol_and_members(monkeypatch):
    calls = []
    kern = launch.Kernel("segment_aggregate", [])
    kern._fn = lambda *args: calls.append(args) or 0
    kern._stream = lambda index: 7
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    trace.enable()
    with trace.span("plans.reduce"):
        kern(torch.device("cuda", 0), 1, 2, members=3)
    outer, inner = trace.take()
    assert calls == [(1, 2, 7)]
    assert inner["name"] == "kernels.launch" and inner["parent"] == outer["id"]
    assert inner["attrs"] == {"symbol": "segment_aggregate", "members": 3}


def test_a_span_closes_when_its_work_raises():
    trace.enable()
    with pytest.raises(KeyError):
        with trace.span("session.apply") as sp:
            sp.set(event="x")
            with trace.span("session.derive"):
                raise KeyError("boom")
    with trace.span("session.idle"):
        pass
    outer, inner, after = trace.take()
    assert (outer["attrs"], inner["parent"], after["parent"], after["root"]) == (
        {"event": "x"}, outer["id"], 0, after["id"])
    assert outer["t1"] >= inner["t1"] > 0


def _fields(results):
    return [(viz, r.factor.attrs, [x.clone() for x in sr.leaves(r.factor.field)],
             r.stats.messages_computed, r.stats.messages_reused)
            for res in results for viz, r in sorted(res.results.items())]


@pytest.mark.parametrize("ring", ["sum", "moments"])
@pytest.mark.parametrize("mode", ["enable", "profiler"])
def test_answers_are_bit_equal_with_tracing_on_and_off(mode, ring):
    cat = catalog(seed=3)
    off = _fields(work(session(cat, ring), "idle"))
    sess = session(cat, ring)
    if mode == "enable":
        trace.enable()
        on = _fields(work(sess, "idle"))
        trace.disable()
    else:
        with profile(activities=[ProfilerActivity.CPU]):
            on = _fields(work(sess, "idle"))
    assert trace.take()
    assert len(on) == len(off) > 0
    for (v1, a1, f1, c1, r1), (v2, a2, f2, c2, r2) in zip(off, on):
        assert (v1, a1, c1, r1) == (v2, a2, c2, r2)
        assert all(torch.equal(x, y) for x, y in zip(f1, f2))
