"""The port's CJT engine held against the JAX package's on one catalog.

Both engines calibrate and answer the same queries over the same numpy data
(measures rounded to integers, so float sums are exact): answers must be
bit-identical for COUNT, SUM, MIN, MAX and MOMENTS, and every message
signature (``edge_sig``) and computed/reused count must be equal.  The
port's three execution paths (level-fused plans, per-edge plans, plain
reference) must agree with each other bit for bit."""

import numpy as np
import pytest
import torch

from _torch_parity import assert_factors_match, jax_catalog_from_port, port_catalog
from repro.core import CJTEngine as JEngine
from repro.core import Query as JQuery
from repro.core import insert_empty_bag as j_insert_empty_bag
from repro.core import jt_from_catalog as j_jt
from repro.core import semiring as jsr
from repro.relational import schema as jschema
from repro.relational.relation import mask_in as j_mask_in
from repro_torch.core import semiring as tsr
from repro_torch.core.calibration import CJTEngine, ExecStats, MessageStore
from repro_torch.core.hypertree import insert_empty_bag, jt_from_catalog
from repro_torch.core.query import Query
from repro_torch.relational.relation import mask_in


@pytest.fixture(scope="module")
def cats():
    tcat = port_catalog(jschema.salesforce(n_opp=3000, n_user=60, n_camp=30, n_acc=40),
                        round_measures=True)
    return jax_catalog_from_port(tcat), tcat


RINGS = [
    ("count", None),
    ("sum", ("Opp", "amount")),
    ("tropical_min", ("Opp", "amount")),
    ("tropical_max", ("Camp", "budget")),
    ("moments", ("Opp", "amount")),
    ("count_i64", None),
]


def _queries(make, mask_in_, cat, ring, measure):
    d = cat.domains()
    base = make(cat, ring=ring, measure=measure)
    return [
        base,
        base.with_group_by("camp_type"),
        base.with_group_by("camp_type").with_predicate(
            mask_in_(d["role_name"], [1, 2], attr="role_name")),
        base.with_group_by("title", "stage").with_predicate(
            mask_in_(d["state"], [3, 4, 5], attr="state")),
        base.with_group_by("state").with_predicate(mask_in_(d["stage"], [0, 5], attr="stage")),
    ]


@pytest.mark.parametrize("ring,measure", RINGS, ids=[r for r, _ in RINGS])
def test_engine_matches_reference(cats, ring, measure):
    jcat, tcat = cats
    je = JEngine(j_jt(jcat), jcat, jsr.get(ring))
    te = CJTEngine(jt_from_catalog(tcat), tcat, tsr.get(ring), device="cpu")
    jqs = _queries(JQuery.make, j_mask_in, jcat, ring, measure)
    tqs = _queries(Query.make, mask_in, tcat, ring, measure)
    js, ts = je.calibrate(jqs[1], pin=True), te.calibrate(tqs[1], pin=True)
    assert (js.messages_computed, js.messages_reused, js.calibration_dispatches) == (
        ts.messages_computed, ts.messages_reused, ts.calibration_dispatches)
    for jq, tq in zip(jqs, tqs):
        assert jq.digest == tq.digest
        jp, tp = je.place_predicates(jq), te.place_predicates(tq)
        for u, v in je.jt.directed_edges():
            assert je.edge_sig(jq, u, v, jp) == te.edge_sig(tq, u, v, tp)
        assert je.choose_root(jq) == te.choose_root(tq)
        (jf, jst), (tf, tst) = je.execute(jq), te.execute(tq)
        assert (jst.messages_computed, jst.messages_reused, jst.steiner_size) == (
            tst.messages_computed, tst.messages_reused, tst.steiner_size)
        assert_factors_match(jf, tf, exact=True)


@pytest.mark.parametrize("ring,measure", [("sum", ("Opp", "amount")),
                                          ("tropical_max", ("Opp", "amount")),
                                          ("moments", ("Opp", "amount")),
                                          ("bool", None)])
def test_level_per_edge_and_reference_paths_agree(cats, ring, measure):
    _, tcat = cats
    jt = jt_from_catalog(tcat)
    engines = [
        CJTEngine(jt, tcat, tsr.get(ring), device="cpu"),
        CJTEngine(jt, tcat, tsr.get(ring), batch_calibration=False, device="cpu"),
        CJTEngine(jt, tcat, tsr.get(ring), use_plans=False, device="cpu"),
    ]
    qs = _queries(Query.make, mask_in, tcat, ring, measure)
    stats = [e.calibrate(qs[2]) for e in engines]
    assert len({s.messages_computed for s in stats}) == 1
    # level batching: one dispatch per calibration level (≤ 2·depth)
    assert stats[0].calibration_dispatches == len(jt.calibration_levels(
        engines[0].choose_root(qs[2])))
    assert stats[1].calibration_dispatches == stats[1].messages_computed
    for q in qs:
        outs = [e.execute(q)[0] for e in engines]
        for f in outs[1:]:
            assert f.attrs == outs[0].attrs
            for a, b in zip(tsr.leaves(f.field), tsr.leaves(outs[0].field)):
                assert torch.equal(a, b)


def test_every_root_gives_same_answer(cats):
    _, tcat = cats
    e = CJTEngine(jt_from_catalog(tcat), tcat, tsr.COUNT, device="cpu")
    q = _queries(Query.make, mask_in, tcat, "count", None)[3]
    outs = [e.execute(q, root=r)[0].field for r in sorted(e.jt.bags)]
    for f in outs[1:]:
        assert torch.equal(f, outs[0])


def test_interaction_reuses_and_widening_narrows(cats):
    jcat, tcat = cats
    je = JEngine(j_jt(jcat), jcat, jsr.SUM)
    te = CJTEngine(jt_from_catalog(tcat), tcat, tsr.SUM, device="cpu")
    for e, make in ((je, JQuery.make), (te, Query.make)):
        wide = make(e.catalog, ring="sum", measure=("Opp", "amount"),
                    group_by=("camp_type", "title"))
        e.calibrate(wide)
    jq = JQuery.make(jcat, ring="sum", measure=("Opp", "amount"), group_by=("title",))
    tq = Query.make(tcat, ring="sum", measure=("Opp", "amount"), group_by=("title",))
    (jf, jst), (tf, tst) = je.execute(jq), te.execute(tq)
    assert tst.messages_computed == jst.messages_computed == 0
    assert te.store.widen_hits == je.store.widen_hits > 0
    assert_factors_match(jf, tf, exact=True)


def test_byte_budget_eviction_keeps_pinned(cats):
    _, tcat = cats
    store = MessageStore(max_bytes=4096)
    e = CJTEngine(jt_from_catalog(tcat), tcat, tsr.SUM, store=store, device="cpu")
    q = Query.make(tcat, ring="sum", measure=("Opp", "amount"), group_by=("camp_type",))
    e.calibrate(q, pin=True)
    pinned = set(store._pinned)
    assert pinned and pinned <= set(store._data)
    for g in ("title", "stage", "state"):
        e.execute(q.with_group_by(g))
    assert pinned <= set(store._data) and store.evictions > 0
    snap = store.snapshot()
    n = len(store)
    e.execute(q.with_group_by("role_name"))
    store.restore(snap)
    assert len(store) == n and set(store._pinned) == pinned


def test_steps_resume_and_iterator_stops_anywhere(cats):
    _, tcat = cats
    e = CJTEngine(jt_from_catalog(tcat), tcat, tsr.COUNT, device="cpu")
    q = Query.make(tcat, ring="count", group_by=("stage",))
    plan = e.calibration_plan(q)
    total = plan.edges_left()
    assert e.step_calibration(plan, max_edges=3) == 3 and plan.edges_left() == total - 3
    assert e.run_calibration_level([plan]) > 0
    while not plan.done:
        e.run_calibration_level([plan])
    assert e.is_calibrated(q)
    levels = list(CJTEngine(e.jt, tcat, tsr.COUNT, device="cpu").calibrate_levels_iter(q))
    assert levels == list(e.jt.calibration_levels(plan.root))
    st = ExecStats()
    it = CJTEngine(e.jt, tcat, tsr.COUNT, device="cpu").calibrate_iter(q, stats=st)
    next(it)
    assert st.messages_computed >= 1


def _empty_bag_parity(jcat, tcat, make_jt, jq, tq):
    """Both engines on their own copy of one JT shape: equal signatures,
    counts and bit-identical answers; returns the port's answer."""
    je = JEngine(make_jt(j_jt(jcat), j_insert_empty_bag), jcat, jsr.get(tq.ring_name))
    te = CJTEngine(make_jt(jt_from_catalog(tcat), insert_empty_bag), tcat,
                   tsr.get(tq.ring_name), device="cpu")
    assert te.jt.bags == je.jt.bags and te.jt.adj == je.jt.adj
    js, ts = je.calibrate(jq), te.calibrate(tq)
    assert (js.messages_computed, js.messages_reused, js.calibration_dispatches) == (
        ts.messages_computed, ts.messages_reused, ts.calibration_dispatches)
    jp, tp = je.place_predicates(jq), te.place_predicates(tq)
    for u, v in je.jt.directed_edges():
        assert je.edge_sig(jq, u, v, jp) == te.edge_sig(tq, u, v, tp)
    (jf, jst), (tf, tst) = je.execute(jq), te.execute(tq)
    assert (jst.messages_computed, jst.messages_reused) == (tst.messages_computed,
                                                            tst.messages_reused)
    assert je.store.misses == te.store.misses
    assert_factors_match(jf, tf, exact=True)
    return tf


@pytest.mark.parametrize("ring,measure", [("count", None), ("sum", ("Opp", "amount")),
                                          ("tropical_max", ("Opp", "amount"))])
def test_opp_user_empty_bag_matches_reference(cats, ring, measure):
    """An empty bag holds no relation: it contracts its incoming messages on
    the dense path."""
    jcat, tcat = cats

    def make_jt(jt, insert):
        return insert(jt, "OppUser", ("user_id",), "bag:Opp", ["bag:User"])

    args = dict(ring=ring, measure=measure, group_by=("title",))
    tf = _empty_bag_parity(jcat, tcat, make_jt, JQuery.make(jcat, **args),
                           Query.make(tcat, **args))
    plain = CJTEngine(jt_from_catalog(tcat), tcat, tsr.get(ring), device="cpu")
    assert torch.equal(tf.field, plain.execute(Query.make(tcat, **args))[0].field)


def test_removed_relation_empties_its_bag(cats):
    """R̄: a bag whose only relation is removed takes the dense path as 1̄."""
    jcat, tcat = cats
    jq = JQuery.make(jcat, ring="sum", measure=("Opp", "amount"), group_by=("stage",),
                     removed=("Acc",))
    tq = Query.make(tcat, ring="sum", measure=("Opp", "amount"), group_by=("stage",),
                    removed=("Acc",))
    tf = _empty_bag_parity(jcat, tcat, lambda jt, _: jt, jq, tq)
    opp = tcat.get("Opp")
    want = np.bincount(opp.codes["stage"], opp.measures["amount"].astype(np.float64), 6)
    np.testing.assert_array_equal(tf.field.numpy(), want.astype(np.float32))


@pytest.mark.parametrize("ring,measure", [("count", None),
                                          ("tropical_max", ("Store_Sales", "sales_price"))])
def test_tpcds_time_stores_empty_bag_matches_reference(ring, measure):
    """Fig 21's empty bag (store_key, time_key) between Store_Sales and its
    Stores/Time dimensions: its shortcut view answers the (store_key,
    time_key) query as the tree without it does."""
    tcat = port_catalog(jschema.tpcds_star(n_sales=3000, n_stores=6, n_times=24, n_items=50),
                        round_measures=True)
    jcat = jax_catalog_from_port(tcat)

    def make_jt(jt, insert):
        return insert(jt, "TimeStores", ("store_key", "time_key"), "bag:Store_Sales",
                      ["bag:Stores", "bag:Time"])

    args = dict(ring=ring, measure=measure, group_by=("store_key", "time_key"))
    tf = _empty_bag_parity(jcat, tcat, make_jt, JQuery.make(jcat, **args),
                           Query.make(tcat, **args))
    plain = CJTEngine(jt_from_catalog(tcat), tcat, tsr.get(ring), device="cpu")
    assert torch.equal(tf.field, plain.execute(Query.make(tcat, **args))[0].field)


def test_default_device_needs_a_card(cats, monkeypatch):
    _, tcat = cats
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CJTEngine(jt_from_catalog(tcat), tcat, tsr.COUNT)
    assert np.isfinite(float(CJTEngine(jt_from_catalog(tcat), tcat, tsr.COUNT, device="cpu")
                             .execute(Query.make(tcat, ring="count"))[0].field))


@pytest.mark.parametrize("budget", [8, 512])
def test_calibrate_many_union_carry_matches_reference(cats, budget, monkeypatch):
    monkeypatch.setenv("REPRO_CALIBRATION_UNION_BUDGET", str(budget))
    jcat, tcat = cats
    je = JEngine(j_jt(jcat), jcat, jsr.COUNT)
    te = CJTEngine(jt_from_catalog(tcat), tcat, tsr.COUNT, device="cpu")
    groups = [("camp_type",), ("title",), ("stage",), ("camp_type", "title")]
    jqs = [JQuery.make(jcat, ring="count", group_by=g) for g in groups]
    tqs = [Query.make(tcat, ring="count", group_by=g) for g in groups]
    jst, jeff = je.calibrate_many(jqs, pin=True)
    tst, teff = te.calibrate_many(tqs, pin=True)
    assert [q.digest for q in jeff] == [q.digest for q in teff]
    assert len(teff) < len(tqs) or budget < 96
    assert [(s.messages_computed, s.messages_reused) for s in jst] == [
        (s.messages_computed, s.messages_reused) for s in tst]
    assert set(te.store._pinned) and len(te.store._pinned) == len(je.store._pinned)
    for jq, tq in zip(jqs, tqs):
        (jf, js), (tf, ts) = je.execute(jq), te.execute(tq)
        assert ts.messages_computed == js.messages_computed == 0
        assert_factors_match(jf, tf, exact=True)


CHECK_RINGS = [("sum", ("Opp", "amount")), ("tropical_max", ("Camp", "budget")),
               ("moments", ("Opp", "amount"))]


@pytest.mark.parametrize("ring,measure", CHECK_RINGS, ids=[r for r, _ in CHECK_RINGS])
def test_check_calibration_matches_reference(cats, ring, measure):
    """§3.4.1's check: both packages' calibrated engines pass it, and both
    fail it once the same cached message is perturbed (every cell x ↦ 2x + 1)."""
    import dataclasses

    import jax

    jcat, tcat = cats
    je = JEngine(j_jt(jcat), jcat, jsr.get(ring))
    te = CJTEngine(jt_from_catalog(tcat), tcat, tsr.get(ring), device="cpu")
    jq = _queries(JQuery.make, j_mask_in, jcat, ring, measure)[2]
    tq = _queries(Query.make, mask_in, tcat, ring, measure)[2]
    je.calibrate(jq)
    te.calibrate(tq)
    assert bool(je.check_calibration(jq)) is True
    assert te.check_calibration(tq) is True
    u, v = next(iter(te.jt.directed_edges()))
    base = te.edge_sig(tq, u, v, te.place_predicates(tq))
    assert base == je.edge_sig(jq, u, v, je.place_predicates(jq))
    gamma = te.gamma_carry(tq, u, v)
    sig = te.store.full_sig(base, gamma)
    jf, tf = je.store._data[sig], te.store._data[sig]
    je.store._data[sig] = dataclasses.replace(
        jf, field=jax.tree_util.tree_map(lambda x: x * 2 + 1, jf.field))
    te.store._data[sig] = dataclasses.replace(
        tf, field=tsr.field_map(lambda x: x * 2 + 1, tf.field))
    assert bool(je.check_calibration(jq)) is False
    assert te.check_calibration(tq) is False


def test_unpin_query_and_block_until_ready_match_reference(cats):
    """``unpin_query(q, root=...)`` releases as many pins in the port as in
    the reference (then none), and ``MessageStore.block_until_ready`` waits
    on a calibrated store in both."""
    jcat, tcat = cats
    je = JEngine(j_jt(jcat), jcat, jsr.get("sum"))
    te = CJTEngine(jt_from_catalog(tcat), tcat, tsr.get("sum"), device="cpu")
    jq = _queries(JQuery.make, j_mask_in, jcat, "sum", ("Opp", "amount"))[3]
    tq = _queries(Query.make, mask_in, tcat, "sum", ("Opp", "amount"))[3]
    je.calibrate(jq, pin=True)
    te.calibrate(tq, pin=True)
    assert je.store.block_until_ready() is None and te.store.block_until_ready() is None
    released = je.unpin_query(jq, root=je.choose_root(jq))
    assert released > 0
    assert te.unpin_query(tq, root=te.choose_root(tq)) == released
    assert je.unpin_query(jq) == te.unpin_query(tq) == 0
