"""Factorized ML (covariance ring) and CJT data cubes: the port against the
JAX package on the same catalogs.

Mirrors ``tests/test_ml_cube.py`` (its four tests, the ``slow`` mark kept)
and holds the port to the reference on the same seeds: fitted weights to a
relative 1e-4 (both packages sum the covariance ring in float32, in another
order; on these sizes they agree bit for bit, the tolerance leaves room for
another summation order), equal computed/reused message counts for every
augmentation candidate, bit-identical cuboids with equal counters, the lifted
dense path, and two engines sharing one plan cache with different lifts for
one relation.
"""

import numpy as np
import pytest
import torch

import repro.core as J
from repro.relational import schema as jschema
import repro_torch.core as T
from repro_torch.core import semiring as tsr
from repro_torch.relational import schema as tschema

from _torch_parity import assert_factors_match, leaves_np, port_catalog
from test_ml_cube import _numpy_fit

WEIGHT_RTOL = 1e-4
FAVORITA = dict(n_sales=8_000, n_stores=12, n_items=30, n_dates=20)


@pytest.fixture(scope="module")
def favorita():
    jcat = jschema.favorita(**FAVORITA)
    return jcat, port_catalog(jcat)


def _features(P, order=("Sales", "Stores", "Items")):
    spec = {"Sales": P.FeatureSpec("Sales", "unit_sales"),
            "Stores": P.FeatureSpec("Stores", "store_type", categorical=True),
            "Items": P.FeatureSpec("Items", "perishable", categorical=True)}
    return [spec[r] for r in order]


def _models(cats, order=("Sales", "Stores", "Items")):
    jcat, tcat = cats
    jm = J.FactorizedLinearRegression(jcat, _features(J, order),
                                      J.FeatureSpec("Trans", "transactions"))
    tm = T.FactorizedLinearRegression(tcat, _features(T, order),
                                      T.FeatureSpec("Trans", "transactions"), device="cpu")
    return jm, tm


def _augmentations(cats, **kw):
    jcat, tcat = cats
    ja = jschema.favorita_augmentations(jcat, **kw)
    ta = tschema.favorita_augmentations(tcat, **kw)
    for a, b in zip(ja, ta, strict=True):
        assert a.name == b.name and np.array_equal(a.measures["v"], b.measures["v"])
    return ja, ta


def _same_fit(jr, tr):
    np.testing.assert_allclose(tr.weights, jr.weights, rtol=WEIGHT_RTOL)
    assert abs(tr.r2 - jr.r2) < 1e-6
    assert (jr.stats.messages_computed, jr.stats.messages_reused) == (
        tr.stats.messages_computed, tr.stats.messages_reused)


def _predictions(model, weights) -> np.ndarray:
    """The fitted model's predictions at unit_sales = 0 for every (store_type,
    perishable) pair, and its unit_sales slope.  The intercept and the two
    one-hot blocks are collinear, so the ridge alone pins the weights along
    (intercept + 1, each one-hot - 1): float32 sums in another order move the
    weights there and leave these predictions as they were."""
    pos = {slot: j for j, slot in enumerate(model._feature_slots(with_aug=False))}
    i = pos[model.slot_of["__intercept__"][0]]
    st = [pos[s] for s in range(*model.slot_of["Stores.store_type#cat"])]
    pe = [pos[s] for s in range(*model.slot_of["Items.perishable#cat"])]
    grid = [weights[i] + weights[s] + weights[p] for s in st for p in pe]
    return np.array(grid + [weights[pos[model.slot_of["Sales.unit_sales"][0]]]])


def test_factorized_fit_matches_numpy(favorita):
    jm, tm = _models(favorita)
    jr, tr = jm.fit(), tm.fit()
    assert abs(tr.r2 - _numpy_fit(favorita[0])) < 1e-3, tr.r2
    _same_fit(jr, tr)


@pytest.mark.slow
def test_augmentation_single_message_and_agreement(favorita):
    jm, tm = _models(favorita)
    js, ts = jm.calibrate(), tm.calibrate()
    assert (js.messages_computed, js.messages_reused) == (ts.messages_computed,
                                                          ts.messages_reused)
    seen_keys = set()
    for ja, ta in zip(*_augmentations(favorita, n_per_key=2)):
        res, base = tm.fit_augmented(ta), tm.fit_unfactorized_baseline(ta)
        assert abs(res.r2 - base.r2) < 1e-4
        _same_fit(jm.fit_augmented(ja), res)
        key = ta.attrs[0]
        if key in seen_keys:
            # same host/separator → host→aug message fully reused (Fig 11)
            assert res.stats.messages_computed == 0
        else:
            assert res.stats.messages_computed <= 1
        seen_keys.add(key)


def test_aug_with_higher_phi_fits_better(favorita):
    jm, tm = _models(favorita)
    jm.calibrate()
    tm.calibrate()
    ja, ta = _augmentations(favorita, n_per_key=6, seed=9)
    store_augs = [(a, b) for a, b in zip(ja, ta) if b.attrs[0] == "store"]
    r2 = {}
    for a, b in store_augs:
        jr, tr = jm.fit_augmented(a), tm.fit_augmented(b)
        _same_fit(jr, tr)
        r2[b.name] = tr.r2
    phi = {b.name: float(b.measures["phi"][0]) for _, b in store_augs}
    best_phi = max(phi, key=phi.get)
    assert phi[best_phi] < 0.2 or r2[best_phi] == max(r2.values())


def test_cube_correctness_and_reuse():
    jcat = jschema.flight(n_flights=10_000)
    tcat = port_catalog(jcat)
    dims = ("carrier_group", "month", "dow")
    jeng = J.CJTEngine(J.jt_from_catalog(jcat), jcat, J.semiring.COUNT,
                       store=J.MessageStore())
    teng = T.CJTEngine(T.jt_from_catalog(tcat), tcat, tsr.COUNT, store=T.MessageStore(),
                       device="cpu")
    jrep = J.build_cube(jeng, J.Query.make(jcat, ring="count"), dims, h=2, pivot_k=1)
    rep = T.build_cube(teng, T.Query.make(tcat, ring="count"), dims, h=2, pivot_k=1)
    apex = float(rep.cuboids[()].field)
    assert apex == tcat.get("Flights").num_rows
    # roll-up consistency: every cuboid sums to the apex
    for combo, f in rep.cuboids.items():
        assert abs(float(f.field.sum()) - apex) < 1e-3 * apex
    # marginalizing the 2-attr cuboid gives the 1-attr cuboid
    f2 = rep.cuboids[("carrier_group", "month")]
    f1 = rep.cuboids[("carrier_group",)]
    torch.testing.assert_close(f2.field.sum(1), f1.field, rtol=1e-5, atol=0)
    # the reference's cube, bit for bit, with equal counters
    assert list(jrep.cuboids) == list(rep.cuboids)
    for combo, jf in jrep.cuboids.items():
        assert_factors_match(jf, rep.cuboids[combo], exact=True)
    assert (jrep.messages_computed, jrep.store_bytes) == (rep.messages_computed,
                                                          rep.store_bytes)
    assert jeng.store.hits == teng.store.hits and jeng.store.misses == teng.store.misses


@pytest.mark.parametrize("pivot_k", [0, 2])
def test_cube_pivots_and_naive_cost_match_reference(pivot_k):
    """``build_cube`` at each pivot dimensionality and the cold-store
    ``naive_cube_cost`` baseline: the reference's cuboids bit for bit and its
    message counts."""
    jcat = jschema.flight(n_flights=3_000)
    tcat = port_catalog(jcat)
    dims = ("carrier_group", "airport_state", "month", "dow")
    jjt, tjt = J.jt_from_catalog(jcat), T.jt_from_catalog(tcat)
    jq, tq = J.Query.make(jcat, ring="count"), T.Query.make(tcat, ring="count")
    jrep = J.build_cube(J.CJTEngine(jjt, jcat, J.semiring.COUNT), jq, dims, h=3,
                        pivot_k=pivot_k)
    rep = T.build_cube(T.CJTEngine(tjt, tcat, tsr.COUNT, device="cpu"), tq, dims, h=3,
                       pivot_k=pivot_k)
    assert (jrep.pivot_k, jrep.messages_computed) == (rep.pivot_k, rep.messages_computed)
    for combo, jf in jrep.cuboids.items():
        assert_factors_match(jf, rep.cuboids[combo], exact=True)
    jout, _ = J.naive_cube_cost(lambda: J.CJTEngine(jjt, jcat, J.semiring.COUNT), jq, dims, 1)
    tout, times = T.naive_cube_cost(lambda: T.CJTEngine(tjt, tcat, tsr.COUNT, device="cpu"),
                                    tq, dims, 1)
    assert set(times) == set(tout) == set(jout)
    for combo, jf in jout.items():
        assert_factors_match(jf, tout[combo], exact=True)


@pytest.mark.parametrize("use_plans", [True, False])
def test_lifted_dense_path_matches_reference(favorita, use_plans):
    """Custom lifts on densified relations (``dense_rows_threshold`` above
    every dimension table, ``_dense_lifted``): the model's base element
    through the dense path equals the reference's, with and without plans."""
    jcat, tcat = favorita
    jm, tm = _models(favorita)
    thr = 1_000  # Stores 12, Items 30, Dates 20, Trans 240 rows are dense; Sales sparse
    jeng = J.CJTEngine(jm.jt, jcat, jm.ring, lifts={n: jm._make_lift(n) for n in jcat.names()},
                       dense_rows_threshold=thr, use_plans=use_plans)
    teng = T.CJTEngine(tm.jt, tcat, tm.ring, lifts=tm._lifts(tcat), dense_rows_threshold=thr,
                       use_plans=use_plans, device="cpu")
    (jf, js), (tf, ts) = jeng.execute(jm._base_query()), teng.execute(tm._base_query())
    assert js.messages_computed == ts.messages_computed > 0
    for a, b in zip(leaves_np(jf.field, False), leaves_np(tf.field, True)):
        np.testing.assert_allclose(b, a, rtol=1e-5)
    # the dense contraction sums in another order than the reference's: the
    # fitted function agrees, the collinear weights need not (_predictions)
    jr, tr = jm._solve(jf.field, False, js), tm._solve(tf.field, False, ts)
    assert abs(tr.r2 - jr.r2) < 1e-5
    np.testing.assert_allclose(_predictions(tm, tr.weights), _predictions(jm, jr.weights),
                               rtol=WEIGHT_RTOL)
    if use_plans:
        assert any(k[0] == "lifted" for k in teng.plans._factors._data)


def test_shared_plan_cache_keeps_each_engines_lift(favorita):
    """Two models whose lifts differ but whose ``lift_tag`` and ring are equal
    (the same features in another slot order): engines sharing ONE plan
    cache must each get their own lift (the lift function is in the cache
    key) and the reference's fit."""
    jcat, tcat = favorita
    jm_a, tm_a = _models(favorita)
    jm_b, tm_b = _models(favorita, order=("Items", "Stores", "Sales"))
    assert tm_a.lift_tag == tm_b.lift_tag and tm_a.ring.name == tm_b.ring.name
    cache = T.PlanCache(tm_a.ring, "cpu")
    fits = []
    for tm in (tm_a, tm_b):
        eng = T.CJTEngine(tm.jt, tcat, tm.ring, lifts=tm._lifts(tcat), plan_cache=cache,
                          device="cpu")
        f, st = eng.execute(tm._base_query())
        fits.append(tm._solve(f.field, with_aug=False, stats=st))
    _same_fit(jm_a.fit(), fits[0])
    _same_fit(jm_b.fit(), fits[1])
    assert not np.allclose(fits[0].weights, fits[1].weights)
    assert cache.stats.plan_hits > 0  # the two engines did share plans


def test_rowwise_blocks_equal_one_pass(monkeypatch):
    """A contraction whose rowwise field would pass ``ROWWISE_MAX_ELEMS`` (a
    cold engine absorbs a 3-attr cuboid at the fact bag: 3,744 lanes per
    row) reduces its rows a block at a time: the same cuboids, bit for bit,
    as one pass and as the reference, with more segment-kernel calls."""
    from repro_torch.core import plans

    jcat = jschema.flight(n_flights=3_000)
    tcat = port_catalog(jcat)
    dims = ("carrier_group", "airport_state", "month")
    real, calls = plans.seg_ops.aggregate_op, []

    def counting(codes, values, g, op="sum", **kw):
        calls.append(codes.shape[0])
        return real(codes, values, g, op, **kw)

    monkeypatch.setattr(plans.seg_ops, "aggregate_op", counting)
    tjt = T.jt_from_catalog(tcat)

    def naive():
        calls.clear()
        out, _ = T.naive_cube_cost(lambda: T.CJTEngine(tjt, tcat, tsr.COUNT, device="cpu"),
                                   T.Query.make(tcat, ring="count"), dims, 3)
        return out, list(calls)

    one, one_calls = naive()
    monkeypatch.setattr(plans, "ROWWISE_MAX_ELEMS", 1 << 16)
    blocks, block_calls = naive()
    # the same rows reduced, in more calls
    assert sum(block_calls) == sum(one_calls) and len(block_calls) > len(one_calls)
    jout, _ = J.naive_cube_cost(
        lambda: J.CJTEngine(J.jt_from_catalog(jcat), jcat, J.semiring.COUNT),
        J.Query.make(jcat, ring="count"), dims, 3)
    for combo, f in one.items():
        assert torch.equal(f.field, blocks[combo].field)
        assert_factors_match(jout[combo], blocks[combo], exact=True)
