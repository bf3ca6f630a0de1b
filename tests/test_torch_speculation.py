"""Speculative σ prefetch in the port, held against the JAX package.

The scenarios of ``tests/test_speculation_fixes.py`` and the speculation
tests of ``tests/test_batched_plans.py`` on both packages over the same star
catalog (integer measures): ``speculate_filters`` returns the same
candidates; ``idle(speculate=k)`` parks the same (viz, digest) entries at the
same ranks; capacity eviction keeps the nearest entries; update and flush
drop only entries that can see the changed relation; a re-brush onto a
prefetched σ is a pure hit (no messages, no plan executions, no store
probes) equal to a cold engine; and sessions close without leaking pins.
"""

import warnings

import numpy as np
from _hypothesis_compat import given, settings, strategies as st

from _torch_parity import assert_factors_match, jax_catalog_from_port, leaves_np, packages
from _torch_parity import same_union_budget  # noqa: F401 — autouse fixture
import repro.core  # noqa: F401 — import order (core before relational)
from repro_torch.relational.relation import catalog_from_arrays

J, T = packages()


def star_catalog(P, n_fact: int = 300, seed: int = 0):
    """F(a,b)+m ← S(b,c), T(a,d), U(b,e), drawn as the reference tests draw
    it, as package ``P``'s catalog."""
    rng = np.random.default_rng(seed)
    doms = {"a": 13, "b": 7, "c": 10, "d": 5, "e": 9}

    def rel(name, attrs, n, measure=False):
        codes = {x: rng.integers(0, doms[x], n).astype(np.int32) for x in attrs}
        m = {"m": rng.integers(0, 16, n).astype(np.float32)} if measure else {}
        return dict(name=name, attrs=attrs, codes=codes, domains=doms, measures=m)

    tcat = catalog_from_arrays([rel("F", ("a", "b"), n_fact, True), rel("S", ("b", "c"), 77),
                                rel("T", ("a", "d"), 29), rel("U", ("b", "e"), 41)])
    return tcat if P.port else jax_catalog_from_port(tcat)


def star_spec(P, **viz_kwargs):
    V = P.core.VizSpec
    m = ("F", "m")
    return P.core.DashboardSpec(vizzes=(
        V("by_a", measure=m, ring="sum", group_by=("a",)),
        V("by_c", measure=m, ring="sum", group_by=("c",)),
        V("by_d", measure=m, ring="sum", group_by=("d",), **viz_kwargs),
        V("by_e", measure=m, ring="sum", group_by=("e",)),
    ))


def treant(P, cat, **kw):
    return P.core.Treant(cat, ring=P.sr.SUM, **kw, **P.kw)


def idle(sess, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return sess.idle(**kw)


def parked(sess):
    """The prefetch cache as comparable (viz, digest, rank) triples plus the
    parked factors in the same order."""
    keys = sorted(sess._prefetched)
    return ([(k, sess._prefetched[k].dist) for k in keys],
            [sess._prefetched[k].factor for k in keys])


def both(scenario, *args):
    """Run ``scenario(P, *args)`` on both packages; each returns checkpoints
    ``(comparable, [factors])`` that must agree bit for bit."""
    jout, tout = scenario(J, *args), scenario(T, *args)
    assert len(jout) == len(tout)
    for (jc, jfs), (tc, tfs) in zip(jout, tout):
        assert jc == tc
        assert len(jfs) == len(tfs)
        for jf, tf in zip(jfs, tfs):
            assert_factors_match(jf, tf, exact=True)
    return tout


def same(P, f1, f2):
    """Two factors of package ``P`` are equal bit for bit."""
    assert f1.attrs == f2.attrs
    for a, b in zip(leaves_np(f1.field, P.port), leaves_np(f2.field, P.port)):
        np.testing.assert_array_equal(a, b)


def cands(P, ev_kw, domain, k):
    out = P.core.speculate_filters(P.core.SetFilter("x", **ev_kw), domain, k)
    return [(c.attr, c.values, c.lo, c.hi, c.source) for c in out]


# ---------------------------------------------------------------------------
# speculate_filters: the same candidates as the reference
# ---------------------------------------------------------------------------

def test_speculate_filters_shapes():
    for P in (J, T):
        assert [(lo, hi) for *_, lo, hi, _ in cands(P, dict(lo=4, hi=8), 20, 3)] == [
            (8, 12), (0, 4), (12, 16)]
        assert [(lo, hi) for *_, lo, hi, _ in cands(P, dict(lo=0, hi=8), 10, 4)] == [(8, 10)]
        out = P.core.speculate_filters(P.core.SetFilter("x", values=(2, 3), source="v"), 10, 4)
        assert [c.values for c in out] == [(4, 5), (0, 1), (6, 7), (8, 9)]
        assert all(c.attr == "x" and c.source == "v" for c in out)


def _range_feasible(lo: int, hi: int, domain: int) -> int:
    width = max(hi - lo, 1)
    return (domain - lo - 1) // width + (hi - 1) // width


@settings(max_examples=60, deadline=None)
@given(d=st.integers(0, 10_000), l=st.integers(0, 10_000),
       h=st.integers(0, 10_000), k=st.integers(0, 60))
def test_range_speculation_count_property(d, l, h, k):
    domain = 1 + d % 50
    lo = l % domain
    hi = lo + 1 + h % (domain - lo)
    got = cands(T, dict(lo=lo, hi=hi), domain, k)
    assert got == cands(J, dict(lo=lo, hi=hi), domain, k)
    assert len(got) == min(k, _range_feasible(lo, hi, domain))
    assert len(set(got)) == len(got)
    for *_, clo, chi, _ in got:
        assert 0 <= clo < chi <= domain and (clo, chi) != (lo, hi)


@settings(max_examples=60, deadline=None)
@given(d=st.integers(0, 10_000), v=st.integers(0, 10_000),
       w=st.integers(0, 10_000), k=st.integers(0, 60))
def test_in_list_speculation_count_property(d, v, w, k):
    domain = 2 + d % 40
    v0 = v % domain
    vals = tuple(sorted({v0, min(domain - 1, v0 + w % 3)}))
    span = vals[-1] - vals[0] + 1
    feasible = (domain - 1 - vals[-1]) // span + vals[0] // span
    got = cands(T, dict(values=vals), domain, k)
    assert got == cands(J, dict(values=vals), domain, k)
    assert len(got) == min(k, feasible) and len(set(got)) == len(got)
    for _, cv, *_ in got:
        assert all(0 <= x < domain for x in cv) and cv != vals


def test_speculation_domain_edge_regressions():
    for P in (J, T):
        assert [(lo, hi) for *_, lo, hi, _ in cands(P, dict(lo=6, hi=8), 10, 10)] == [
            (8, 10), (4, 6), (2, 4), (0, 2)]
        assert [(lo, hi) for *_, lo, hi, _ in cands(P, dict(lo=3, hi=7), 9, 10)] == [
            (7, 9), (0, 3)]
        assert [v for _, v, *_ in cands(P, dict(values=(8, 9)), 10, 10)] == [
            (6, 7), (4, 5), (2, 3), (0, 1)]
        assert cands(P, dict(lo=0, hi=10), 10, 5) == []
        assert cands(P, dict(values=(0, 9)), 10, 5) == []
        assert cands(P, dict(lo=2, hi=4), 10, 0) == []


def test_speculation_candidates_are_nearest_first():
    got = cands(T, dict(lo=4, hi=6), 12, 6)
    assert got == cands(J, dict(lo=4, hi=6), 12, 6)
    dist = [abs(lo - 4) for *_, lo, _, _ in got]
    assert dist == sorted(dist)


# ---------------------------------------------------------------------------
# capacity eviction keeps the nearest-to-anchor entries
# ---------------------------------------------------------------------------

def test_eviction_keeps_nearest_candidates():
    def scenario(P):
        t = treant(P, star_catalog(P, seed=71), use_plans=True)
        sess = t.open_session(star_spec(P), name="s")
        sess.prefetch_capacity = 3
        ev = P.core.SetFilter("a", lo=4, hi=6, source="by_a")
        sess.apply(ev)
        idle(sess, speculate=3)
        assert len(sess._prefetched) == 3
        assert all(e.dist == 0 for e in sess._prefetched.values())
        out = [parked(sess)]
        res = sess.apply(P.core.speculate_filters(ev, 13, 3)[0])
        assert len(res.affected) == 3
        for viz in res.affected:
            s_ = res.results[viz].stats
            assert s_.prefetch_hits == 1 and s_.messages_computed == 0
        out.append((res.affected, [res.results[v].factor for v in res.affected]))
        sess.close()
        return out

    both(scenario)


def test_eviction_order_regression_vs_insertion_order():
    def scenario(P):
        t = treant(P, star_catalog(P, seed=73), use_plans=False)
        sess = t.open_session(star_spec(P), name="s", calibrate=False)
        sess.prefetch_capacity = 4
        sess.apply(P.core.SetFilter("a", values=(5, 6), source="by_a"))
        idle(sess, speculate=4)
        assert sorted(e.dist for e in sess._prefetched.values()) == [0, 0, 0, 1]
        out = [parked(sess)]
        sess.close()
        return out

    both(scenario)


# ---------------------------------------------------------------------------
# update / flush invalidate only prefetches that can see the relation
# ---------------------------------------------------------------------------

def _u_rows(cat, n, seed):
    rng = np.random.default_rng(seed)
    u = cat.get("U")
    return {a: rng.integers(0, u.domains[a], n).astype(np.int32) for a in u.attrs}


def test_update_keeps_prefetch_on_disjoint_dimension():
    def scenario(P):
        cat = star_catalog(P, seed=79)
        t = treant(P, cat, use_plans=True)
        sess = t.open_session(star_spec(P, removed=("U",)), name="s")
        ev = P.core.SetFilter("a", lo=2, hi=4, source="by_a")
        sess.apply(ev)
        idle(sess, speculate=1)
        blind = {k for k, e in sess._prefetched.items() if "U" in e.query.removed}
        assert blind and set(sess._prefetched) - blind
        new_u, delta = cat.get("U").append_rows(_u_rows(cat, 10, 0))
        res = t.update(new_u, delta)
        assert res.queries_fallback == 0 and set(sess._prefetched) == blind
        res2 = sess.apply(P.core.speculate_filters(ev, 13, 1)[0])
        s_d = res2.results["by_d"].stats
        assert s_d.prefetch_hits == 1 and s_d.messages_computed == 0
        assert res2.results["by_c"].stats.prefetch_hits == 0
        out = [(sorted(blind), []),
               (res2.affected, [res2.results[v].factor for v in res2.affected])]
        sess.close()
        return out

    both(scenario)


def test_flush_invalidates_only_streamed_relation_prefetches():
    def scenario(P):
        cat = star_catalog(P, seed=83)
        t = treant(P, cat, use_plans=False, compaction_threshold=0.0)
        sess = t.open_session(star_spec(P, removed=("U",)), name="s")
        sess.apply(P.core.SetFilter("a", lo=2, hi=4, source="by_a"))
        idle(sess, speculate=1)
        blind = {k for k, e in sess._prefetched.items() if "U" in e.query.removed}
        assert blind
        t.stream("U").append(_u_rows(cat, 6, 1))
        t.flush()
        assert set(sess._prefetched) == blind
        out = [parked(sess)]
        sess.close()
        return out

    both(scenario)


# ---------------------------------------------------------------------------
# speculation after ToggleRelation removed the brush dimension's relation
# ---------------------------------------------------------------------------

def test_speculation_skips_viz_that_no_longer_sees_brush_dim():
    def scenario(P):
        t = treant(P, star_catalog(P, seed=89), use_plans=True)
        sess = t.open_session(star_spec(P), name="s")
        ev = P.core.SetFilter("c", lo=3, hi=6, source="by_c")
        sess.apply(ev)
        res = sess.apply(P.core.ToggleRelation("S", viz="by_e"))
        assert res.affected == ("by_e",)
        assert not t.sees_attr(sess.derive("by_e"), "c")
        idle(sess, speculate=2)
        assert sess._prefetched and all(viz != "by_e" for viz, _ in sess._prefetched)
        res2 = sess.apply(P.core.speculate_filters(ev, 10, 1)[0])
        for viz in ("by_a", "by_d"):
            assert res2.results[viz].stats.prefetch_hits == 1
        out = [parked(sess), ((res.affected, res2.affected),
                              [res.results["by_e"].factor]
                              + [res2.results[v].factor for v in res2.affected])]
        sess.close()
        return out

    both(scenario)


def test_toggle_unfiltered_viz_matches_cold_execution():
    def scenario(P):
        sess = treant(P, star_catalog(P, seed=97), use_plans=True).open_session(
            star_spec(P), name="s")
        sess.apply(P.core.SetFilter("c", lo=2, hi=5, source="by_c"))
        warm = sess.apply(P.core.ToggleRelation("S", viz="by_e")).results["by_e"]
        s2 = treant(P, star_catalog(P, seed=97), use_plans=True).open_session(
            star_spec(P), name="s2")
        cold = s2.apply(P.core.ToggleRelation("S", viz="by_e")).results["by_e"]
        same(P, warm.factor, cold.factor)
        sess.close()
        s2.close()
        return [(warm.factor.attrs, [warm.factor])]

    both(scenario)


# ---------------------------------------------------------------------------
# the speculation tests of tests/test_batched_plans.py
# ---------------------------------------------------------------------------

@settings(max_examples=6, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_prefetched_rebrush_is_pure_hit(seed):
    """After ``idle(speculate=2)`` a SetFilter to any prefetched σ value is a
    pure hit (no messages, no plan executions, no store probes) equal to a
    cold engine.  Seeds are drawn as the reference draws them; when the drawn
    range covers the whole domain there is no candidate, and then nothing
    may be parked."""
    def scenario(P):
        rng = np.random.default_rng(seed)
        cat = star_catalog(P, n_fact=400, seed=seed % 7)
        jt = P.core.jt_from_catalog(cat)
        t = P.core.Treant(cat, ring=P.sr.SUM, jt=jt, use_plans=True, batch_fanout=True,
                          **P.kw)
        sess = t.open_session(star_spec(P), name="s")
        attr, dom = ("a", 13) if rng.integers(2) else ("b", 7)
        lo = int(rng.integers(0, dom - 1))
        ev = P.core.SetFilter(attr, lo=lo, hi=int(rng.integers(lo + 1, dom + 1)),
                              source="by_a")
        sess.apply(ev)
        idle(sess, speculate=2)
        cs = P.core.speculate_filters(ev, dom, 2)
        if not cs:
            assert sess.stats()["prefetched"] == 0
            return [((ev.lo, ev.hi), [])]
        assert sess.stats()["prefetched"] > 0
        cand = cs[int(rng.integers(len(cs)))]
        st0 = t.cache_stats()
        res = sess.apply(cand)
        st1 = t.cache_stats()
        assert res.affected
        for viz in res.affected:
            s = res.results[viz].stats
            assert s.prefetch_hits == 1 and s.messages_computed == 0
            cold = P.core.CJTEngine(jt, cat, P.sr.SUM, store=P.core.MessageStore(),
                                    use_plans=True, **P.kw)
            f_cold, _ = cold.execute(sess.query_of(viz))
            same(P, f_cold, res.results[viz].factor)
        execs = [s_["plans"]["plans_built"] + s_["plans"]["plan_hits"] for s_ in (st0, st1)]
        assert execs[0] == execs[1]
        assert (st1["misses"], st1["hits"]) == (st0["misses"], st0["hits"])
        return [((ev.lo, ev.hi), []), (res.affected, [res.results[v].factor
                                                      for v in res.affected])]

    both(scenario)


def test_speculation_counts_and_capacity():
    def scenario(P):
        t = treant(P, star_catalog(P, seed=41), use_plans=True)
        sess = t.open_session(star_spec(P), name="s")
        sess.prefetch_capacity = 4
        sess.apply(P.core.SetFilter("a", values=(1, 2), source="by_a"))
        idle(sess, speculate=3)
        st_ = sess.stats()
        assert st_["speculative_queries_total"] > 0 and 0 < st_["prefetched"] <= 4
        assert t.scheduler.stats()["speculative_queries"] == st_["speculative_queries_total"]
        return [((st_["speculative_queries_total"], t.scheduler.stats()), []), parked(sess)]

    both(scenario)


def test_session_close_gc_two_cycles_store_stable():
    def scenario(P):
        t = treant(P, star_catalog(P, seed=43), use_plans=True)
        sizes, pinned = [], []
        for i in range(2):
            sess = t.open_session(star_spec(P))
            sess.apply(P.core.SetFilter("a", values=(i,), source="by_a"))
            sess.idle()
            sess.apply(P.core.SetFilter("b", values=(i, i + 1)))
            idle(sess, speculate=1)
            sess.close()
            sizes.append(len(t.store))
            pinned.append(len(t.store._pinned))
            assert t.scheduler.pending(sess.id) == 0
        assert sizes[1] <= sizes[0] and pinned == [0, 0]
        assert t.cache_stats()["sessions"] == 0
        return [((sizes, pinned), [])]

    both(scenario)


def test_fallback_update_releases_pins_before_version_bump():
    def scenario(P):
        cat = star_catalog(P, seed=59)
        t = P.core.Treant(cat, ring=P.sr.TROPICAL_MIN, use_plans=True, **P.kw)
        spec = P.core.DashboardSpec(vizzes=(
            P.core.VizSpec("by_c", measure=("F", "m"), ring="tropical_min", group_by=("c",)),
        ))
        sess = t.open_session(spec)
        assert t.store._pinned
        mask = np.zeros(cat.get("F").num_rows, bool)
        mask[:5] = True
        new_rel, delta = cat.get("F").delete_rows(mask)
        res = t.update(new_rel, delta)
        assert res.queries_fallback > 0
        sess.close()
        assert not t.store._pinned
        return [((res.queries_maintained, res.queries_fallback), [])]

    both(scenario)


def test_idle_budget_gates_speculation():
    def scenario(P):
        t = treant(P, star_catalog(P, seed=61), use_plans=True)
        sess = t.open_session(star_spec(P), name="s")
        sess.apply(P.core.SetFilter("a", values=(1,), source="by_a"))
        idle(sess, budget_messages=1, speculate=2)
        assert sess.stats()["prefetched"] == 0
        idle(sess, speculate=2)
        assert sess.stats()["prefetched"] > 0
        return [parked(sess)]

    both(scenario)


def test_clear_and_undo_invalidate_speculation_anchor():
    def scenario(P):
        t = treant(P, star_catalog(P, seed=67), use_plans=True)
        sess = t.open_session(star_spec(P), name="s", calibrate=False)
        sess.apply(P.core.SetFilter("a", values=(1,), source="by_a"))
        sess.apply(P.core.ClearFilter("a"))
        idle(sess, speculate=2)
        assert sess.stats()["prefetched"] == 0
        sess.apply(P.core.SetFilter("b", values=(2,)))
        sess.apply(P.core.Undo())
        idle(sess, speculate=2)
        assert sess.stats()["prefetched"] == 0
        return [(sess._last_filter, [])]

    both(scenario)


def test_close_keeps_other_sessions_pins():
    def scenario(P):
        t = treant(P, star_catalog(P, seed=47), use_plans=True)
        s1 = t.open_session(star_spec(P), name="s1")
        s2 = t.open_session(star_spec(P), name="s2")
        s1.apply(P.core.SetFilter("a", values=(0,), source="by_a"))
        s1.close()
        n_pinned = len(t.store._pinned)
        assert n_pinned
        for v in ("by_a", "by_c", "by_d", "by_e"):
            assert t.engine.is_calibrated(s2.query_of(v))
        s2.close()
        assert not t.store._pinned
        return [(n_pinned, [])]

    both(scenario)
