"""Batched fan-out in the port, held against the JAX package.

The non-speculative scenarios of ``tests/test_batched_plans.py``: sibling
absorptions through ``CJTEngine.execute_many`` must be bit-identical to
executing them one by one, across every ring and batch width, with
heterogeneous γ domains and with plans on or off — and equal, bit for bit
and counter for counter (``batched_*`` in ``PlanStats`` and ``ExecStats``),
to the JAX package's vmapped batches.  On the card a batch group is one
``level_segment_aggregate`` launch (``tests/test_torch_cuda.py``).  Plus the
session layer: fan-out batched ≡ per viz, and session GC (close unpins and
drops what the session produced; a fallback update releases its pins; a
sibling session's pins survive a close).
"""

import numpy as np
import pytest
import torch

from _torch_parity import assert_factors_match, assert_same_results, packages, star_catalogs
from _torch_parity import same_union_budget  # noqa: F401 — autouse fixture
import repro.core  # noqa: F401 — import order (core before relational)

J, T = packages()
RINGS = ("count", "sum", "tropical_min", "tropical_max", "moments")
BATCH_COUNTERS = ("batched_execs", "batched_absorptions", "batch_width")


def _engine(P, cat, ring_name, **kw):
    return P.core.CJTEngine(P.core.jt_from_catalog(cat), cat, P.sr.get(ring_name), **kw, **P.kw)


def _batch_counters(eng) -> dict:
    return {k: getattr(eng.plans.stats, k) for k in BATCH_COUNTERS}


def _both(make_queries, seed, ring_name="sum", warm=False, **engine_kw):
    """execute_many on both packages and one-by-one execute on the port.
    Returns (jax results, port results, port sequential results, port engine,
    jax engine)."""
    cats = star_catalogs(seed=seed)
    out = []
    for P, cat in zip((J, T), cats):
        qs = make_queries(P, cat)
        bat = _engine(P, cat, ring_name, **engine_kw)
        if warm:  # the offline stage: every root converges on the σ'd bag
            for q in qs:
                bat.calibrate(q.without_predicate(q.predicates[0].attr))
        out.append((bat.execute_many(qs), bat, qs))
    (jres, jeng, _), (tres, teng, tqs) = out
    seq = _engine(T, cats[1], ring_name, **engine_kw)
    if warm:
        for q in tqs:
            seq.calibrate(q.without_predicate(q.predicates[0].attr))
    return jres, tres, [seq.execute(q) for q in tqs], teng, jeng


def _measure(ring_name):
    return None if ring_name == "count" else ("F", "m")


@pytest.mark.parametrize("width", [2, 3, 5])
@pytest.mark.parametrize("ring_name", RINGS)
def test_batched_parity_rings_and_widths(ring_name, width):
    """Same-γ siblings differing only in σ masks, every ring, widths that do
    (2) and do not (3, 5) tile evenly against the σ attr's domain."""

    def queries(P, cat):
        base = P.core.Query.make(cat, ring=ring_name, measure=_measure(ring_name),
                                 group_by=("c",))
        return [base.with_predicate(P.rel.mask_in(5, [i % 5], attr="d")) for i in range(width)]

    jres, tres, seq, teng, jeng = _both(queries, width, ring_name)
    assert_same_results(jres, tres)
    for (fs, _), (fb, _) in zip(seq, tres):
        _identical(fs, fb)
    assert teng.plans.stats.batched_absorptions >= 2 and teng.plans.stats.batch_width >= 2
    assert _batch_counters(teng) == _batch_counters(jeng)


def _identical(f1, f2):
    """Two port factors, bit for bit."""
    assert f1.attrs == f2.attrs
    for a, b in zip(T.sr.leaves(f1.field), T.sr.leaves(f2.field)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("ring_name", RINGS)
def test_batched_parity_heterogeneous_gamma_padding(ring_name):
    """Siblings carrying different γ attrs (domains 10/5/9/7) batch through
    placeholder canonicalization — still bit-identical."""

    def queries(P, cat):
        base = P.core.Query.make(cat, ring=ring_name, measure=_measure(ring_name))
        pred = P.rel.mask_in(13, [0, 2, 5, 7], attr="a")
        return [base.with_group_by(g).with_predicate(pred) for g in ("c", "d", "e", "b")]

    jres, tres, seq, teng, jeng = _both(queries, 11, ring_name, warm=True)
    assert_same_results(jres, tres)
    for (fs, _), (fb, _) in zip(seq, tres):
        _identical(fs, fb)
    assert teng.plans.stats.batched_absorptions >= 2
    assert _batch_counters(teng) == _batch_counters(jeng)


@pytest.mark.parametrize("use_plans", [False, True])
def test_batched_parity_plans_on_off(use_plans):
    """execute_many agrees bit for bit with the plain reference engine
    whether the plan cache (and hence batching) is on or off."""

    def queries(P, cat):
        base = P.core.Query.make(cat, ring="sum", measure=("F", "m"))
        pred = P.rel.mask_in(5, [1, 3], attr="d")
        return [base.with_group_by(g).with_predicate(pred) for g in ("c", "d", "e")]

    jres, tres, _, teng, _ = _both(queries, 17, warm=True, use_plans=use_plans)
    assert_same_results(jres, tres)
    tcat = star_catalogs(seed=17)[1]
    ref = _engine(T, tcat, "sum", use_plans=False)
    for q in queries(T, tcat):
        ref.calibrate(q.without_predicate("d"))
    for q, (fb, _) in zip(queries(T, tcat), tres):
        _identical(ref.execute(q)[0], fb)
    if use_plans:
        assert teng.plans.stats.batched_execs >= 1
    else:
        assert teng.plans is None


def test_batched_execstats_counters():
    def queries(P, cat):
        base = P.core.Query.make(cat, ring="sum", measure=("F", "m"), group_by=("c",))
        return [base.with_predicate(P.rel.mask_in(5, [i], attr="d")) for i in range(3)]

    jres, tres, _, teng, jeng = _both(queries, 23)
    batched = [s for _, s in tres if s.batched_absorptions]
    assert len(batched) >= 2 and all(s.batch_width >= 2 for s in batched)
    assert teng.plans.stats.batch_width == max(s.batch_width for s in batched)
    assert [(s.batched_absorptions, s.batch_width, s.batch_sessions) for _, s in jres] == [
        (s.batched_absorptions, s.batch_width, s.batch_sessions) for _, s in tres]
    assert _batch_counters(teng) == _batch_counters(jeng)


def test_batched_plan_rebuilds_only_on_new_structure():
    """Re-brushing the same batch signature (new masks) re-runs the cached
    batch plan: no new plan built, in either package."""
    built = []
    for P, cat in zip((J, T), star_catalogs(seed=29)):
        base = P.core.Query.make(cat, ring="sum", measure=("F", "m"), group_by=("c",))
        eng = _engine(P, cat, "sum")
        eng.execute_many([base.with_predicate(P.rel.mask_in(5, [i], attr="d")) for i in (0, 1)])
        before = eng.plans.stats.plans_built
        out = eng.execute_many(
            [base.with_predicate(P.rel.mask_in(5, [i], attr="d")) for i in (2, 4)])
        assert eng.plans.stats.plans_built == before
        assert all(s.plan_hits > 0 or s.messages_reused > 0 for _, s in out)
        built.append(before)
    assert built[0] == built[1]


# ---------------------------------------------------------------------------
# session level
# ---------------------------------------------------------------------------

def star_spec(P):
    V = P.core.VizSpec
    return P.core.DashboardSpec(vizzes=tuple(
        V(f"by_{g}", measure=("F", "m"), ring="sum", group_by=(g,)) for g in "acde"))


def test_session_fanout_batched_vs_unbatched_bit_identical():
    events = [("a", {"values": (0, 1), "source": "by_a"}), ("a", {"values": (3,), "source": "by_a"}),
              ("b", {"values": (2, 4)})]
    runs = {}
    for P, cat in zip((J, T), star_catalogs(seed=31)):
        for batched in (True, False):
            t = P.core.Treant(cat, ring=P.sr.SUM, batch_fanout=batched, **P.kw)
            sess = t.open_session(star_spec(P), name="s")
            runs[(P.port, batched)] = (t, [sess.apply(P.core.SetFilter(a, **kw))
                                           for a, kw in events])
    for i in range(len(events)):
        jb, tb, tu = (runs[k][1][i] for k in ((False, True), (True, True), (True, False)))
        assert jb.affected == tb.affected == tu.affected
        for viz in tb.affected:
            _identical(tb.results[viz].factor, tu.results[viz].factor)
            assert_factors_match(jb.results[viz].factor, tb.results[viz].factor, exact=True)
    stats = {k: t.cache_stats()["plans"] for k, (t, _) in runs.items()}
    assert stats[(True, True)]["batched_absorptions"] > 0 and stats[(True, True)]["batch_width"] >= 2
    assert stats[(True, False)]["batched_absorptions"] == 0
    for batched in (True, False):
        assert {k: stats[(True, batched)][k] for k in BATCH_COUNTERS} == {
            k: stats[(False, batched)][k] for k in BATCH_COUNTERS}


def test_session_close_gc_two_cycles_store_stable():
    """Two open-close cycles (each brushing another σ) do not grow the store:
    close unpins the base CJTs and drops the session-produced messages."""
    out = []
    for P, cat in zip((J, T), star_catalogs(seed=43)):
        t = P.core.Treant(cat, ring=P.sr.SUM, **P.kw)
        sizes, pinned = [], []
        for i in range(2):
            sess = t.open_session(star_spec(P))
            sess.apply(P.core.SetFilter("a", values=(i,), source="by_a"))
            sess.idle()
            sess.apply(P.core.SetFilter("b", values=(i, i + 1)))
            sess.idle()
            sess.close()
            sizes.append(len(t.store))
            pinned.append(len(t.store._pinned))
            assert t.scheduler.pending(sess.id) == 0
        assert sizes[1] <= sizes[0] and pinned == [0, 0]
        assert t.cache_stats()["sessions"] == 0
        out.append((sizes, t.store.nbytes))
    assert out[0][0] == out[1][0]


def test_fallback_update_releases_pins_before_version_bump():
    """A MIN delete migrates no pins, but the base queries are version-bumped:
    the old-version pins are released during the update."""
    for P, cat in zip((J, T), star_catalogs(seed=59)):
        t = P.core.Treant(cat, ring=P.sr.TROPICAL_MIN, **P.kw)
        spec = P.core.DashboardSpec(vizzes=(
            P.core.VizSpec("by_c", measure=("F", "m"), ring="tropical_min", group_by=("c",)),))
        sess = t.open_session(spec)
        assert t.store._pinned
        mask = np.zeros(cat.get("F").num_rows, bool)
        mask[:5] = True
        new_rel, delta = cat.get("F").delete_rows(mask)
        res = t.update(new_rel, delta)
        assert res.queries_fallback > 0
        sess.close()
        assert not t.store._pinned


def test_close_keeps_other_sessions_pins():
    pins = []
    for P, cat in zip((J, T), star_catalogs(seed=47)):
        t = P.core.Treant(cat, ring=P.sr.SUM, **P.kw)
        s1 = t.open_session(star_spec(P), name="s1")
        s2 = t.open_session(star_spec(P), name="s2")
        s1.apply(P.core.SetFilter("a", values=(0,), source="by_a"))
        s1.close()
        assert t.store._pinned, "shared pins dropped by sibling close"
        pins.append(dict(t.store._pinned))
        for v in ("by_a", "by_c", "by_d", "by_e"):
            assert t.engine.is_calibrated(s2.query_of(v))
        s2.close()
        assert not t.store._pinned
    assert pins[0] == pins[1]
