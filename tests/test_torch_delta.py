"""Delta calibration in the port, held against the JAX package.

Each test runs one scenario of ``tests/test_delta_updates.py`` — appends,
deletes, ``CJTEngine.apply_delta``, ``Treant.update`` — on both packages over
the same data (integer-valued measures, so float sums are exact): the
``DeltaStats``, computed/reused counts, relation versions, ``Query.digest``s
and watermarks must be equal and the answers bit-identical, and the port's
maintained answers must equal its own cold rebuild.  One more test runs a
fact delta under ``dense_rows_threshold > 0``, where the port routes the
delta's bag by the relation's new row count (sparse) and the reference
densifies it, and the answers must still agree.
"""

import dataclasses

import numpy as np
import pytest

from _torch_parity import (
    assert_factors_match, assert_same_results, jax_catalog_from_port, packages, port_catalog,
    star_catalogs,
)
from _torch_parity import same_union_budget  # noqa: F401 — autouse fixture
import repro.core  # noqa: F401 — import order (core before relational)
from repro.relational import schema as jschema

J, T = packages()
RINGS = ("sum", "count", "moments")


def flight_catalogs(n_flights: int, seed: int = 0):
    tcat = port_catalog(jschema.flight(n_flights=n_flights, seed=seed),
                        round_measures=True, measure_scale=1.0)
    return jax_catalog_from_port(tcat), tcat


def _query(P, cat, ring_name, group_by=("carrier_group", "month")):
    measure = ("Flights", "dep_delay") if ring_name != "count" else None
    return P.core.Query.make(cat, ring=ring_name, measure=measure, group_by=group_by)


def _append(rel, rng, n, value=None):
    codes = {a: rng.integers(0, rel.domains[a], n) for a in rel.attrs}
    meas = (np.full(n, value, np.float32) if value is not None
            else rng.integers(0, 60, n).astype(np.float32))
    return rel.append_rows(codes, measures={"dep_delay": meas})


def _random_update(rel, rng, kind=None):
    if (rng.integers(2) if kind is None else kind) == 0:
        return _append(rel, rng, int(rng.integers(1, 200)))
    return rel.delete_rows(rng.random(rel.num_rows) < 0.08)


def _cold(P, jt, cat, ring, q):
    return P.core.CJTEngine(jt, cat, ring, store=P.core.MessageStore(), **P.kw).execute(q)


def _both(scenario, *args):
    jcat, tcat = args[0]
    return scenario(J, jcat, *args[1:]), scenario(T, tcat, *args[1:])


@pytest.mark.parametrize("ring_name", RINGS)
def test_update_sequence_matches_rebuild(ring_name):
    """update(Δ)* then query ≡ rebuild, on both packages, with equal stats:
    an append, a delete, then one of either."""
    seed = 7

    def scenario(P, cat):
        rng = np.random.default_rng(seed)
        jt = P.core.jt_from_catalog(cat)
        ring = P.sr.get(ring_name)
        eng = P.core.CJTEngine(jt, cat, ring, **P.kw)
        q = _query(P, cat, ring_name)
        eng.calibrate(q)
        rel = cat.get("Flights")
        stats, versions = [], []
        for kind in (0, 1, None):
            rel, delta = _random_update(rel, rng, kind)
            cat.put(rel)
            q, st = eng.apply_delta(q, delta)
            assert not st.fallback and st.edges_maintained == len(jt.bags) - 1
            stats.append(dataclasses.asdict(st))
            versions.append((delta.old_version, delta.new_version, delta.rows.version))
        got = eng.execute(q)
        assert got[1].messages_computed == 0
        cold = _cold(P, jt, cat, ring, _query(P, cat, ring_name))
        return got, cold, stats, versions, q.digest, cat.watermark

    (jgot, jcold, *jrest), (tgot, tcold, *trest) = _both(scenario, flight_catalogs(600, 2))
    assert jrest == trest
    assert_same_results([jgot], [tgot])
    assert_factors_match(tcold[0], tgot[0], exact=True)
    assert_factors_match(jcold[0], tcold[0], exact=True)


def test_update_with_predicates_matches_rebuild():
    """Maintenance respects σ annotations placed anywhere in the tree."""

    def scenario(P, cat):
        rng = np.random.default_rng(5)
        jt = P.core.jt_from_catalog(cat)
        eng = P.core.CJTEngine(jt, cat, P.sr.SUM, **P.kw)
        d = cat.domains()
        q = _query(P, cat, "sum").with_predicate(P.rel.mask_in(
            d["airport_state"], [int(v) for v in rng.choice(d["airport_state"], 10, replace=False)],
            attr="airport_state",
        )).with_predicate(P.rel.mask_in(d["delay_bucket"], [0, 1, 2, 3], attr="delay_bucket"))
        eng.calibrate(q)
        rel = cat.get("Flights")
        stats = []
        for _ in range(2):
            rel, delta = _random_update(rel, rng)
            cat.put(rel)
            q, st = eng.apply_delta(q, delta)
            assert not st.fallback
            stats.append(dataclasses.asdict(st))
        got = eng.execute(q)
        assert got[1].messages_computed == 0
        return got, _cold(P, jt, cat, P.sr.SUM, q), stats, q.digest

    (jgot, jcold, *jrest), (tgot, tcold, *trest) = _both(scenario, flight_catalogs(600, 2))
    assert jrest == trest
    assert_same_results([jgot], [tgot])
    assert_factors_match(tcold[0], tgot[0], exact=True)


def test_append_then_delete_roundtrip():
    """Deleting exactly the appended rows restores the original answers (SUM)."""

    def scenario(P, cat):
        jt = P.core.jt_from_catalog(cat)
        eng = P.core.CJTEngine(jt, cat, P.sr.SUM, **P.kw)
        q0 = _query(P, cat, "sum")
        eng.calibrate(q0)
        base = eng.execute(q0)
        rel = cat.get("Flights")
        n0 = rel.num_rows
        rel1, d1 = _append(rel, np.random.default_rng(3), 64)
        cat.put(rel1)
        q1, _ = eng.apply_delta(q0, d1)
        mask = np.zeros(rel1.num_rows, bool)
        mask[n0:] = True
        rel2, d2 = rel1.delete_rows(mask)
        cat.put(rel2)
        q2, _ = eng.apply_delta(q1, d2)
        back = eng.execute(q2)
        assert back[1].messages_computed == 0
        return base, back, (rel1.version, rel2.version, q2.digest)

    (jbase, jback, jv), (tbase, tback, tv) = _both(scenario, flight_catalogs(600))
    assert jv == tv
    assert_same_results([jbase, jback], [tbase, tback])
    assert_factors_match(jbase[0], tback[0], exact=True)


def test_no_stale_signature_survives_update():
    """Prop-2 signature bumping: equal signatures across packages, changed
    exactly on the edges whose subtree holds the updated relation."""

    def scenario(P, cat):
        jt = P.core.jt_from_catalog(cat)
        eng = P.core.CJTEngine(jt, cat, P.sr.SUM, **P.kw)
        q_old = _query(P, cat, "sum")
        eng.calibrate(q_old)
        placement = eng.place_predicates(q_old)
        old_answer = eng.execute(q_old)
        new_rel, delta = _append(cat.get("Flights"), np.random.default_rng(9), 300, 100.0)
        cat.put(new_rel)
        q_new, st = eng.apply_delta(q_old, delta)
        assert not st.fallback
        placement_new = eng.place_predicates(q_new)
        u0 = jt.mapping["Flights"]
        sigs = []
        for u, v in jt.directed_edges():
            old, new = eng.edge_sig(q_old, u, v, placement), eng.edge_sig(q_new, u, v, placement_new)
            assert (old != new) == (u0 in jt.subtree_bags(u, v)), (u, v)
            assert eng.store.contains(new, eng.gamma_carry(q_new, u, v))
            sigs.append((old, new))
        return old_answer, eng.execute(q_new), eng.execute(q_old), sigs

    (ja, jn, jo, jsigs), (ta, tn, to, tsigs) = _both(scenario, flight_catalogs(600))
    assert jsigs == tsigs
    assert_same_results([ja, jn, jo], [ta, tn, to])
    assert_factors_match(ta[0], to[0], exact=True)  # the old snapshot still answers
    assert not np.array_equal(ta[0].field.numpy(), tn[0].field.numpy())


def test_tropical_append_maintains_delete_falls_back():
    """MIN ring: appends combine via ⊕=min; deletes have no inverse → fallback."""

    def scenario(P, cat):
        jt = P.core.jt_from_catalog(cat)
        eng = P.core.CJTEngine(jt, cat, P.sr.TROPICAL_MIN, **P.kw)
        q = P.core.Query.make(cat, ring="tropical_min", measure=("Flights", "dep_delay"),
                              group_by=("carrier_group",))
        eng.calibrate(q)
        rng = np.random.default_rng(5)
        rel1, d_app = _append(cat.get("Flights"), rng, 40)
        cat.put(rel1)
        q1, st_app = eng.apply_delta(q, d_app)
        assert not st_app.fallback
        got = eng.execute(q1)
        assert got[1].messages_computed == 0
        rel2, d_del = rel1.delete_rows(rng.random(rel1.num_rows) < 0.1)
        cat.put(rel2)
        q2, st_del = eng.apply_delta(q1, d_del)
        assert st_del.fallback and st_del.edges_maintained == 0
        got2 = eng.execute(q2)
        cold2 = _cold(P, jt, cat, P.sr.TROPICAL_MIN, q2)
        return got, got2, cold2, [dataclasses.asdict(s) for s in (st_app, st_del)]

    (jg, jg2, jc2, js), (tg, tg2, tc2, ts) = _both(scenario, flight_catalogs(500))
    assert js == ts
    assert_same_results([jg, jg2], [tg, tg2])
    assert_factors_match(tc2[0], tg2[0], exact=True)


def test_pinned_dashboard_messages_stay_pinned():
    """Maintained counterparts of pinned messages are pinned; the stale
    generation is evictable again — the same pin set in both packages."""

    def scenario(P, cat):
        jt = P.core.jt_from_catalog(cat)
        eng = P.core.CJTEngine(jt, cat, P.sr.SUM, **P.kw)
        q = _query(P, cat, "sum")
        eng.calibrate(q, pin=True)
        new_rel, delta = _append(cat.get("Flights"), np.random.default_rng(2), 50)
        cat.put(new_rel)
        q_new, st = eng.apply_delta(q, delta)
        assert st.edges_maintained == len(jt.bags) - 1
        placement, placement_old = eng.place_predicates(q_new), eng.place_predicates(q)
        u0 = jt.mapping["Flights"]
        for u, v in jt.directed_edges():
            if u0 in jt.subtree_bags(u, v):
                assert eng.store.is_pinned(eng.edge_sig(q_new, u, v, placement),
                                           eng.gamma_carry(q_new, u, v)), (u, v)
                assert not eng.store.is_pinned(eng.edge_sig(q, u, v, placement_old),
                                               eng.gamma_carry(q, u, v)), (u, v)
        return dict(eng.store._pinned)

    jp, tp = _both(scenario, flight_catalogs(500))
    assert jp == tp


@pytest.mark.parametrize("weird", ["v0Δweird", "aΔbΔc", "Δ"])
def test_delta_version_derivation_with_delta_in_caller_version(weird):
    """Caller versions containing 'Δ' round-trip, and every derived version
    string is equal across packages (digests and signatures hash them)."""

    def scenario(P, cat):
        rel = cat.get("Flights").with_version(weird)
        new_rel, delta = _append(rel, np.random.default_rng(2), 10, 1.0)
        assert delta.old_version == weird
        assert new_rel.version.startswith(weird + "+")
        assert delta.rows.version.startswith(weird + "Δ")
        assert new_rel.version[len(weird) + 1:] == delta.rows.version[len(weird) + 1:]
        assert delta.new_version == new_rel.version
        nxt, d2 = new_rel.delete_rows(np.arange(new_rel.num_rows) < 3)
        assert nxt.version.startswith(new_rel.version + "+")
        assert d2.rows.version.startswith(new_rel.version + "Δ")
        jt = P.core.jt_from_catalog(cat)
        eng = P.core.CJTEngine(jt, cat, P.sr.SUM, **P.kw)
        cat.put(rel)
        q = _query(P, cat, "sum").with_version("Flights", weird)
        eng.calibrate(q)
        cat.put(new_rel)
        q, st = eng.apply_delta(q, delta)
        assert not st.fallback
        got = eng.execute(q)
        assert got[1].messages_computed == 0
        versions = (new_rel.version, delta.rows.version, nxt.version, d2.rows.version)
        return got, _cold(P, jt, cat, P.sr.SUM, q), versions, q.digest

    (jg, jc, *jrest), (tg, tc, *trest) = _both(scenario, flight_catalogs(300))
    assert jrest == trest
    assert_same_results([jg], [tg])
    assert_factors_match(tc[0], tg[0], exact=True)


def test_zero_row_updates_short_circuit():
    """Empty appends/deletes/compactions return the same relation and no
    delta; ``Treant.update(rel, None)`` maintains nothing and bumps nothing."""
    _, cat = flight_catalogs(300)
    rel = cat.get("Flights")
    same, delta = rel.append_rows({a: np.zeros(0, np.int32) for a in rel.attrs},
                                  measures={"dep_delay": np.zeros(0, np.float32)})
    assert same is rel and delta is None
    same, delta = rel.delete_rows(np.zeros(rel.num_rows, bool))
    assert same is rel and delta is None
    same, delta = rel.compact()
    assert same is rel and delta is None
    t = T.core.Treant(cat, ring=T.sr.SUM, **T.kw)
    t.register_dashboard("v1", _query(T, cat, "sum", group_by=("carrier_group",)))
    wm, ver = t.catalog.watermark, t.catalog.latest_version("Flights")
    res = t.update(rel, None)
    assert (res.queries_maintained, res.queries_fallback, res.stats) == (0, 0, [])
    assert t.catalog.watermark == wm and t.catalog.latest_version("Flights") == ver
    assert t.ingest.version_bumps == 0 and t.ingest.delta_sweeps == 0


def test_treant_update_end_to_end():
    """Treant.update maintains dashboards and sessions and serves fresh data
    at cache-hit speed; equal results, watermarks and ingest counters."""

    def scenario(P, cat):
        t = P.core.Treant(cat, ring=P.sr.SUM, **P.kw)
        q0 = _query(P, cat, "sum", group_by=("carrier_group",))
        t.register_dashboard("v1", q0)
        d = cat.domains()
        q1 = q0.with_predicate(P.rel.mask_in(d["month"], [0, 1, 2], attr="month"))
        t.interact("s", "v1", q1)
        t.think_time("s", "v1")
        new_rel, delta = _append(cat.get("Flights"), np.random.default_rng(4), 120, 77.0)
        res = t.update(new_rel, delta)
        assert res.queries_fallback == 0 and res.queries_maintained >= 1
        r = t.read("s", "v1")
        assert r.stats.messages_computed == 0
        cold = P.core.Treant(cat, ring=P.sr.SUM, **P.kw)
        cold.register_dashboard("v1", _query(P, cat, "sum", group_by=("carrier_group",)))
        cold.interact("s", "v1", _query(P, cat, "sum", group_by=("carrier_group",))
                      .with_predicate(P.rel.mask_in(d["month"], [0, 1, 2], attr="month")))
        summary = ([dataclasses.asdict(s) for s in res.stats], res.queries_maintained,
                   t.catalog.watermark, dataclasses.asdict(t.ingest),
                   t.session("s").query_of("v1").digest)
        return (r.factor, r.stats), cold.read("s", "v1").factor, summary

    (jr, jc, js), (tr, tc, ts) = _both(scenario, flight_catalogs(600))
    assert js == ts
    assert_same_results([jr], [tr])
    assert_factors_match(tc, tr[0], exact=True)


def test_dense_fact_delta_routes_sparse_and_matches_reference():
    """A fact delta under ``dense_rows_threshold > 0``: the reference
    densifies the delta's bag (the delta's 40 rows are under the threshold),
    the port keeps it on the sparse path (F's new 340 rows are over it, as a
    full recalibration would route them).  Same answers, stats and digests;
    the port densifies no version of F."""
    threshold = 100

    def scenario(P, cat):
        jt = P.core.jt_from_catalog(cat)
        eng = P.core.CJTEngine(jt, cat, P.sr.SUM, dense_rows_threshold=threshold, **P.kw)
        q = P.core.Query.make(cat, ring="sum", measure=("F", "m"), group_by=("c", "a"))
        eng.calibrate(q)
        rel = cat.get("F")
        rng = np.random.default_rng(8)
        rel, delta = rel.append_rows(
            {a: rng.integers(0, rel.domains[a], 40) for a in rel.attrs},
            measures={"m": rng.integers(0, 16, 40).astype(np.float32)})
        cat.put(rel)
        q, st = eng.apply_delta(q, delta)
        assert not st.fallback and delta.num_rows <= threshold < rel.num_rows
        got = eng.execute(q)
        assert got[1].messages_computed == 0
        if P.port:
            dense = [k for k in eng.plans._factors._data if k[0] == "base"]
            assert dense and not [k for k in dense if k[1][0] == "F"], dense
        return got, _cold(P, jt, cat, P.sr.SUM, q), dataclasses.asdict(st), q.digest

    (jg, jc, *jrest), (tg, tc, *trest) = _both(scenario, star_catalogs(300, seed=4))
    assert jrest == trest
    assert_same_results([jg], [tg])
    assert_factors_match(tc[0], tg[0], exact=True)
