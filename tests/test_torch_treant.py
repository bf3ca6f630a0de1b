"""The slice end to end: the quickstart sequence (``register_dashboard`` →
``interact`` → ``think_time`` → ``interact`` → SQL ``interact``, plus one
MAX query through ``engine_for``) on the port and on the JAX package over
the same catalog.

Digests, ``edge_sig``s and computed/reused counts must be equal.  Answers
must be bit-identical on integer-valued measures; on the generator's
gamma-valued measure the float sums run in another order, so they must agree
to rtol 1e-5 (float32 rounding of sums over a few thousand rows).  The JAX
side runs once on its default route and once with the Pallas kernels forced
(``REPRO_PLAN_KERNEL_COST`` raised) in interpret mode."""

import numpy as np
import pytest
import torch

from _torch_parity import assert_factors_match, jax_catalog_from_port, port_catalog
from repro.core import Query as JQuery
from repro.core import Treant as JTreant
from repro.core import semiring as jsr
from repro.relational import schema as jschema
from repro.relational.relation import mask_in as j_mask_in
from repro.relational.sql import parse as j_parse
from repro_torch.core import Query, Treant, steiner
from repro_torch.core import semiring as tsr
from repro_torch.relational import schema
from repro_torch.relational.relation import mask_in
from repro_torch.relational.sql import parse

SQL = ("SELECT camp_type, SUM(amount) FROM Opp WHERE state IN (1,2,3) "
       "GROUP BY camp_type")


def quickstart(treant_cls, query_cls, sr, mask_in_, parse_, cat, **kw):
    """The quickstart's calls; returns (treant, per-step stats, results, queries)."""
    t = treant_cls(cat, ring=sr.SUM, **kw)
    total = query_cls.make(cat, ring="sum", measure=("Opp", "amount"))
    pie = total.with_group_by("camp_type")
    cal = [t.register_dashboard("pipeline_total", total),
           t.register_dashboard("pipeline_by_campaign", pie)]
    q1 = pie.with_predicate(mask_in_(cat.domains()["role_name"], [1], attr="role_name"))
    res = [t.interact("anna", "pipeline_by_campaign", q1)]
    thought = t.think_time("anna", "pipeline_by_campaign")
    q2 = q1.add_group_by("title")
    res.append(t.interact("anna", "pipeline_by_campaign", q2))
    q3 = parse_(SQL, cat)
    res.append(t.interact("anna", "pipeline_by_campaign", q3))
    qm = query_cls.make(cat, ring="tropical_max", measure=("Opp", "amount"), group_by=("stage",))
    res.append(t.engine_for("tropical_max").execute(qm))
    return t, cal, thought, res, [total, pie, q1, q2, q3, qm]


def _factor_stats(r):
    return (r.factor, r.stats) if hasattr(r, "factor") else r


@pytest.mark.parametrize("measures", ["integer", "gamma"])
@pytest.mark.parametrize("jax_route", ["default", "pallas"])
def test_quickstart_matches_reference(measures, jax_route, monkeypatch):
    if jax_route == "pallas":
        monkeypatch.setenv("REPRO_PLAN_KERNEL_COST", "1000000000000")
    tcat = port_catalog(jschema.salesforce(n_opp=4000, n_user=80, n_camp=25, n_acc=40),
                        round_measures=measures == "integer")
    jcat = jax_catalog_from_port(tcat)
    jt_, jcal, jthought, jres, jqs = quickstart(JTreant, JQuery, jsr, j_mask_in, j_parse, jcat)
    tt_, tcal, tthought, tres, tqs = quickstart(Treant, Query, tsr, mask_in, parse, tcat,
                                                device="cpu")
    for a, b in zip(jcal, tcal):
        assert (a.messages_computed, a.messages_reused, a.calibration_dispatches) == (
            b.messages_computed, b.messages_reused, b.calibration_dispatches)
    assert jthought == tthought
    for a, b in zip(jres, tres):
        (jf, js), (tf, ts) = _factor_stats(a), _factor_stats(b)
        assert (js.messages_computed, js.messages_reused) == (ts.messages_computed,
                                                              ts.messages_reused)
        exact = measures == "integer" or tf.ring.name == "tropical_max"
        assert_factors_match(jf, tf, exact=exact, rtol=1e-5)
    je, te = jt_.engine, tt_.engine
    for jq, tq in zip(jqs, tqs):
        assert jq.digest == tq.digest
        jp, tp = je.place_predicates(jq), te.place_predicates(tq)
        assert [je.edge_sig(jq, u, v, jp) for u, v in je.jt.directed_edges()] == [
            te.edge_sig(tq, u, v, tp) for u, v in te.jt.directed_edges()]
    jstats, tstats = jt_.cache_stats(), tt_.cache_stats()
    for k in ("messages", "hits", "misses", "widen_hits", "sessions", "watermark"):
        assert jstats[k] == tstats[k], k
    for k in ("calibration_dispatches", "fused_level_launches", "plans_built", "plan_hits"):
        if jax_route == "pallas" or k not in ("fused_level_launches",):
            assert jstats["plans"][k] == tstats["plans"][k], k
    # on the port every sum-ring contraction takes the kernel route
    assert tstats["plans"]["fallback_execs"] == 0


@pytest.fixture(scope="module")
def tcat():
    return schema.salesforce(n_opp=2000, n_user=50, n_camp=20, n_acc=30)


def test_quickstart_answers_match_numpy_brute_force(tcat):
    _, _, _, res, _ = quickstart(Treant, Query, tsr, mask_in, parse, tcat, device="cpu")
    opp, user, camp, acc = (tcat.get(n) for n in ("Opp", "User", "Camp", "Acc"))
    amount = opp.measures["amount"].astype(np.float64)
    ctype = camp.codes["camp_type"][opp.codes["camp_id"]]
    role = user.codes["role_id"][opp.codes["user_id"]]  # role_name == role_id
    title = user.codes["title"][opp.codes["user_id"]]
    state = acc.codes["state"][opp.codes["acc_id"]]
    sel = role == 1
    want = [
        np.bincount(ctype[sel], amount[sel], 8),
        np.bincount(ctype[sel] * 12 + title[sel], amount[sel], 96).reshape(8, 12),
        np.bincount(ctype[np.isin(state, [1, 2, 3])], amount[np.isin(state, [1, 2, 3])], 8),
    ]
    for r, w in zip(res[:3], want):
        np.testing.assert_allclose(r.factor.field.numpy(), w, rtol=1e-5)
    mx = np.full(6, -np.inf)
    np.maximum.at(mx, opp.codes["stage"], opp.measures["amount"])
    np.testing.assert_array_equal(res[3][0].field.numpy(), mx.astype(np.float32))


def test_think_time_budget_parks_and_resumes(tcat):
    t = Treant(tcat, ring=tsr.COUNT, device="cpu")
    base = Query.make(tcat, ring="count", group_by=("stage",))
    t.register_dashboard("v", base)
    q = base.with_predicate(mask_in(tcat.domains()["state"], [1, 2], attr="state"))
    t.interact("s", "v", q)
    assert t.think_time("s", "v", budget_messages=3) == 3
    rest = t.think_time("s", "v")
    assert rest == 2 * (len(t.jt.bags) - 1) - 3
    assert t.engine.is_calibrated(q)
    r = t.read("s", "v")
    assert r.stats.messages_computed == 0 and r.steiner_size == 1
    sched = t.cache_stats()["scheduler"]
    assert sched["completed"] == 1 and sched["messages"] == rest + 3
    n_messages = len(t.store)
    t.think_time("s", "v")  # a calibrated query re-steps cache hits only
    assert len(t.store) == n_messages


def test_interaction_preempts_only_its_own_viz(tcat):
    t = Treant(tcat, ring=tsr.SUM, device="cpu")
    d = tcat.domains()
    for v, g in (("a", "stage"), ("b", "title")):
        t.register_dashboard(v, Query.make(tcat, ring="sum", measure=("Opp", "amount"),
                                           group_by=(g,)))
    qa = t._dashboards["a"].with_predicate(mask_in(d["state"], [4], attr="state"))
    qb = t._dashboards["b"].with_predicate(mask_in(d["state"], [4], attr="state"))
    t.interact("s", "a", qa)
    t.interact("s", "b", qb)
    t.think_time("s", "a", budget_messages=2)
    t.interact("s", "b", qb.add_group_by("stage"))
    assert t.scheduler.preemptions == 1 and t.scheduler.pending() == 2
    sess = t.session("s")
    assert sess.vizzes == ("a", "b") and sess.query_of("b").group_by == ("title", "stage")
    assert sess.idle() > 0 and t.scheduler.pending() == 0


def test_scheduler_drop_discards_pending_calibrations(tcat):
    t = Treant(tcat, ring=tsr.COUNT, device="cpu")
    t.register_dashboard("v", Query.make(tcat, ring="count", group_by=("stage",)))
    for s, states in (("s", [1]), ("u", [2])):
        t.interact(s, "v", t._dashboards["v"].with_predicate(
            mask_in(tcat.domains()["state"], states, attr="state")))
    assert t.scheduler.pending() == 2
    assert t.scheduler.drop("s") == 1 and t.scheduler.drop("s", "v") == 0
    assert t.scheduler.pending("s") == 0 and t.scheduler.pending("u") == 1
    assert t.scheduler.stats()["invalidations"] == 1
    assert t.think_time("u", "v") > 0 and t.scheduler.pending() == 0


def test_recomputed_edges_lie_in_the_steiner_tree(tcat):
    t = Treant(tcat, ring=tsr.COUNT, device="cpu")
    base = Query.make(tcat, ring="count", group_by=("camp_type",))
    t.register_dashboard("v", base)
    q = base.with_predicate(mask_in(tcat.domains()["role_name"], [2], attr="role_name"))
    plan = steiner.plan(t.engine, base, q)
    res = t.interact("s", "v", q)
    allowed = steiner.directed_edges_into(plan)
    assert set(res.stats.recomputed_edges) <= allowed
    assert res.steiner_size == steiner.realized_size(res.stats, t.engine.choose_root(q))


def test_sql_interaction_and_sibling_ring_share_the_store(tcat):
    t = Treant(tcat, ring=tsr.SUM, device="cpu")
    t.register_dashboard("v", Query.make(tcat, ring="sum", measure=("Opp", "amount")))
    t.interact("s", "v", t._dashboards["v"])
    res = t.session("s").sql("v", "SELECT COUNT(*) FROM Opp WHERE stage IN (1,2)")
    assert res.factor.attrs == () and float(res.factor.field) == float(
        np.isin(tcat.get("Opp").codes["stage"], [1, 2]).sum())
    assert t.engine_for("count") is t.engine
    mn = t.engine_for("tropical_min")
    assert mn is not t.engine and mn.store is t.store and mn.device == torch.device("cpu")
    stats = t.cache_stats()
    assert stats["plans"]["kernel_execs"] > 0 and stats["plans_cached"] > 0
