"""Declarative dashboard sessions in the port, held against the JAX package.

The scenarios of ``tests/test_dashboard_sessions.py`` — typed events
(SetFilter, ClearFilter, Drill, Rollup, SwapMeasure, ToggleRelation, Undo)
through ``Treant.open_session(DashboardSpec)`` / ``Session.apply``, the
crossfilter fan-out, undo, sibling sharing, COUNT with a measure, SQL and the
legacy wrappers — run on both packages over the same data (integer-valued
measures): affected vizzes, query digests, computed/reused counts, session
and scheduler counters must be equal and every rendered viz bit-identical.
The port's fan-out must also equal a cold engine's ``execute``.
"""

import numpy as np
import pytest

from _torch_parity import (
    assert_factors_match, jax_catalog_from_port, packages, port_catalog,
)
from _torch_parity import same_union_budget  # noqa: F401 — autouse fixture
import repro.core  # noqa: F401 — import order (core before relational)
from repro.relational import schema as jschema

J, T = packages()


@pytest.fixture(scope="module")
def cats():
    tcat = port_catalog(jschema.flight(n_flights=1500), round_measures=True, measure_scale=1.0)
    return jax_catalog_from_port(tcat), tcat


def flight_spec(P):
    V = P.core.VizSpec
    m = ("Flights", "dep_delay")
    return P.core.DashboardSpec(vizzes=(
        V("by_state", measure=m, ring="sum", group_by=("airport_state",)),
        V("by_month", measure=m, ring="sum", group_by=("month",)),
        V("by_size", measure=m, ring="sum", group_by=("airport_size",)),
        V("by_carrier", measure=m, ring="sum", group_by=("carrier_group",)),
    ))


def ev(P, name, *args, **kw):
    return getattr(P.core, name)(*args, **kw)


def rendered(res):
    """An ApplyResult as (affected, {viz: digest}, {viz: (factor, stats)})."""
    return (res.affected, {v: q.digest for v, q in res.queries.items()},
            {v: (r.factor, r.stats) for v, r in res.results.items()})


def assert_same_apply(jres, tres):
    (ja, jd, jr), (ta, td, tr) = rendered(jres), rendered(tres)
    assert ja == ta and jd == td and sorted(jr) == sorted(tr)
    for viz in jr:
        (jf, js), (tf, ts) = jr[viz], tr[viz]
        assert (js.messages_computed, js.messages_reused) == (ts.messages_computed,
                                                              ts.messages_reused), viz
        assert_factors_match(jf, tf, exact=True)


def run_events(cats, events, calibrate=True, spec=flight_spec, **treant_kw):
    """Open one session per package and apply ``events`` (tuples of event
    class name and arguments) to both, checking every step; returns the two
    sessions."""
    out = []
    for P, cat in zip((J, T), cats):
        t = P.core.Treant(cat, ring=P.sr.SUM, **treant_kw, **P.kw)
        sess = t.open_session(spec(P), name="s", calibrate=calibrate)
        out.append((sess, [sess.apply(ev(P, name, *a, **kw)) for name, a, kw in events]))
    (jsess, jres), (tsess, tres) = out
    for a, b in zip(jres, tres):
        assert_same_apply(a, b)
    assert jsess.stats() | tsess.stats() == jsess.stats()
    return jsess, tsess, tres


def cold(cat, q):
    eng = T.core.CJTEngine(T.core.jt_from_catalog(cat), cat, T.sr.get(q.ring_name),
                           store=T.core.MessageStore(), **T.kw)
    return eng.execute(q)[0]


ATTRS = ["carrier_group", "airport_size", "month", "dow"]
DRILLS = ["month", "dow", "carrier_group"]


@pytest.mark.parametrize("seed", [3, 11])
def test_event_sequence_matches_reference_and_hand_built_chains(cats, seed):
    """A random SetFilter/ClearFilter/Drill/Rollup sequence: both packages
    render the same vizzes bit for bit, and the derived queries' digests equal
    hand-built ``with_predicate`` / ``add_group_by`` chains."""
    tcat = cats[1]
    d = tcat.domains()
    names = flight_spec(T).names
    rng = np.random.default_rng(seed)
    events, filters = [], {}
    drills = {v: [] for v in names}
    for _ in range(6):
        kind = rng.integers(4)
        if kind == 0:
            attr = ATTRS[rng.integers(len(ATTRS))]
            vals = sorted({int(v) for v in rng.integers(0, d[attr], 2)})
            events.append(("SetFilter", (attr,), {"values": tuple(vals)}))
            filters[attr] = vals
        elif kind == 1 and filters:
            attr = sorted(filters)[rng.integers(len(filters))]
            events.append(("ClearFilter", (attr,), {}))
            del filters[attr]
        elif kind == 2:
            viz, a = names[rng.integers(len(names))], DRILLS[rng.integers(len(DRILLS))]
            events.append(("Drill", (viz, a), {}))
            if a not in drills[viz] and a not in flight_spec(T).viz(viz).group_by:
                drills[viz].append(a)
        elif kind == 3:
            viz = names[rng.integers(len(names))]
            if drills[viz]:
                events.append(("Rollup", (viz, drills[viz].pop()), {}))
    _, tsess, _ = run_events(cats, events, calibrate=False)
    for v in flight_spec(T).vizzes:
        ref = T.core.Query.make(tcat, ring=v.ring, measure=v.measure, group_by=v.group_by)
        for a in drills[v.name]:
            ref = ref.add_group_by(a)
        for attr, vals in filters.items():
            ref = ref.with_predicate(T.rel.mask_in(d[attr], vals, attr=attr))
        assert tsess.query_of(v.name).digest == ref.digest


def test_undo_round_trip(cats):
    events = [("SetFilter", ("carrier_group",), {"values": (0, 1), "source": "by_carrier"}),
              ("SetFilter", ("carrier_group",), {"values": (2, 3), "source": "by_carrier"}),
              ("Undo", (), {}), ("Undo", (), {}), ("Undo", (), {})]
    _, tsess, res = run_events(cats, events, calibrate=False)
    assert set(res[2].affected) == set(res[1].affected)
    assert res[2].queries == res[0].queries
    assert_factors_match(res[0].results["by_state"].factor, res[2].results["by_state"].factor,
                         exact=True)
    assert res[4].affected == ()  # empty-stack Undo is a no-op


def test_crossfilter_fan_out_excludes_source_and_matches_cold(cats):
    events = [("SetFilter", ("carrier_group",), {"values": (0, 1), "source": "by_carrier"}),
              ("SetFilter", ("month",), {"lo": 2, "hi": 7})]
    _, tsess, res = run_events(cats, events)
    assert set(res[0].affected) == {"by_state", "by_month", "by_size"}
    assert tsess.query_of("by_carrier").predicates != ()  # the month σ reached it
    for r in res:
        for viz in r.affected:
            assert_factors_match(cold(cats[1], r.queries[viz]), r.results[viz].factor,
                                 exact=True)


def test_sibling_vizzes_share_messages(cats):
    events = [("SetFilter", ("airport_size",), {"values": (1, 2), "source": "by_size"})]
    jsess, tsess, _ = run_events(cats, events)
    for sess, P in ((jsess, J), (tsess, T)):
        sess.idle()
        sess.apply(ev(P, "SetFilter", "airport_size", values=(0, 3), source="by_size"))
    st = tsess.stats()
    assert jsess.stats() | st == jsess.stats()
    assert st["cross_viz_hits_total"] > 0 and st["pending_calibrations"] > 0
    assert set(st) >= {"vizzes", "events", "pending_calibrations", "preemptions",
                       "scheduler_messages_total", "cross_viz_hits_total"}


def test_preemption_counts_only_interacted_viz(cats):
    events = [("SetFilter", ("carrier_group",), {"values": (0,), "source": "by_carrier"}),
              ("SetFilter", ("carrier_group",), {"values": (1,), "source": "by_carrier"})]
    _, tsess, _ = run_events(cats, events, calibrate=False)
    assert tsess.stats()["preemptions"] == 3
    assert tsess.scheduler.pending(tsess.id) == 3


def test_swap_measure_routes_to_sibling_ring_engine(cats):
    events = [("SwapMeasure", ("by_size", "Flights", "dep_delay"), {"ring": "tropical_min"}),
              ("SwapMeasure", ("by_month", "Flights", "dep_delay"), {"ring": "tropical_max"})]
    _, tsess, res = run_events(cats, events, calibrate=False)
    assert res[0].affected == ("by_size",)
    q = tsess.query_of("by_size")
    assert q.ring_name == "tropical_min"
    assert_factors_match(cold(cats[1], q), res[0].results["by_size"].factor, exact=True)
    t = tsess._treant
    assert "tropical_min" in t._engines and t._engines["tropical_min"].store is t.store


def test_count_with_measure_not_collapsed_onto_sum_engine(cats):
    """COUNT carrying a measure runs on a real COUNT engine; measure-free
    COUNT collapses onto the SUM primary."""
    out = []
    for P, cat in zip((J, T), cats):
        t = P.core.Treant(cat, ring=P.sr.SUM, **P.kw)
        q = P.core.Query.make(cat, ring="count", measure=("Flights", "dep_delay"),
                              group_by=("carrier_group",))
        t.register_dashboard("v", q)
        r = t.interact("s", "v", q)
        assert t.engine_for("count", ("Flights", "dep_delay")) is not t.engine
        assert t.engine_for("count", None) is t.engine
        out.append((r.factor, q))
    assert_factors_match(out[0][0], out[1][0], exact=True)
    assert_factors_match(cold(cats[1], out[1][1]), out[1][0], exact=True)


def test_toggle_relation_round_trip(cats):
    events = [("ToggleRelation", ("Dates",), {"viz": "by_state"}),
              ("SetFilter", ("month",), {"values": (1, 2)}),
              ("ToggleRelation", ("Dates",), {"viz": "by_state"})]
    _, tsess, res = run_events(cats, events, calibrate=False)
    assert res[0].affected == ("by_state",)
    assert tsess.query_of("by_state").removed == frozenset()
    assert res[2].affected == ("by_state",)
    # the month σ is unplaceable while Dates is out of by_state's join
    assert res[1].queries["by_state"].removed == frozenset({"Dates"})
    assert res[1].queries["by_state"].predicates == ()
    assert len(res[2].queries["by_state"].predicates) == 1


def test_session_sql_matches_parse(cats):
    text = ("SELECT airport_state, SUM(dep_delay) FROM Flights "
            "WHERE month IN (1,2) AND airport_size BETWEEN 1 AND 2 GROUP BY airport_state")
    out = []
    for P, cat in zip((J, T), cats):
        from importlib import import_module

        sql = import_module(("repro_torch" if P.port else "repro") + ".relational.sql")
        sess = P.core.Treant(cat, ring=P.sr.SUM, **P.kw).open_session(
            flight_spec(P), calibrate=False)
        res = sess.sql("by_state", text)
        ref = sql.parse(text, cat)
        assert sess.query_of("by_state").digest == ref.digest
        out.append((res.factor, ref))
    assert_factors_match(out[0][0], out[1][0], exact=True)
    assert_factors_match(cold(cats[1], out[1][1]), out[1][0], exact=True)


def test_legacy_wrappers_still_work(cats):
    out = []
    for P, cat in zip((J, T), cats):
        t = P.core.Treant(cat, ring=P.sr.SUM, **P.kw)
        d = cat.domains()
        q0 = P.core.Query.make(cat, ring="sum", measure=("Flights", "dep_delay"))
        t.register_dashboard("v", q0)
        q1 = q0.with_predicate(P.rel.mask_in(d["month"], [3], attr="month"))
        r_a = t.interact("alice", "v", q1)
        r_b = t.interact("bob", "v", q1)
        assert r_b.stats.messages_computed == 0
        assert t.think_time("alice", "v", budget_messages=2) == 2
        st = t.cache_stats()
        assert st["sessions"] == 2 and st["scheduler"]["pending"] >= 1
        with pytest.raises(KeyError):
            t.interact("alice", "unregistered", q1)
        out.append(((r_a.factor, r_a.stats), {k: st[k] for k in ("messages", "hits", "misses",
                                                                    "scheduler", "sessions")}))
    (ja, jst), (ta, tst) = out
    assert jst["scheduler"] | tst["scheduler"] == jst["scheduler"]
    assert {k: v for k, v in jst.items() if k != "scheduler"} == {
        k: v for k, v in tst.items() if k != "scheduler"}
    assert_factors_match(ja[0], ta[0], exact=True)


def test_toggle_away_a_grouped_attr_calibrates_in_think_time():
    """ToggleRelation removes the only relation carrying a viz's γ attr.  Both
    packages render the viz without that attr; the reference's think-time
    calibration then fails on the attr (KeyError in its level pass, ROADMAP
    Queue 3), the port's carries no message for it and calibrates."""
    tcat = port_catalog(jschema.salesforce(n_opp=2000, n_user=50, n_camp=20, n_acc=30),
                        round_measures=True)
    out = []
    for P, cat in zip((J, T), (jax_catalog_from_port(tcat), tcat)):
        spec = P.core.DashboardSpec(vizzes=tuple(
            P.core.VizSpec(f"by_{g}", measure=("Opp", "amount"), ring="sum", group_by=(g,))
            for g in ("camp_type", "stage")))
        sess = P.core.Treant(cat, ring=P.sr.SUM, **P.kw).open_session(spec, name="s")
        res = sess.apply(P.core.ToggleRelation("Camp"))
        assert res.results["by_camp_type"].factor.attrs == ()
        if P.port:
            assert sess.idle() > 0 and sess.stats()["pending_calibrations"] == 0
            for viz in res.affected:
                assert sess.read(viz).stats.messages_computed == 0
        else:
            with pytest.raises(KeyError, match="camp_type"):
                sess.idle()
        out.append(res)
    assert_same_apply(*out)
