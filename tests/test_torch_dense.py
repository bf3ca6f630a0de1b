"""The port's dense-bag path held against the JAX package's.

Every relation of at most ``dense_rows_threshold`` rows is densified, and a
dense bag contracts dense factors: a two-factor matrix product goes to the
semiring_contract (SUM, COUNT) or tropical_contract (MIN, MAX) wrapper —
their plain versions on the CPU — and every other contraction to
``factor.contract``.  The JAX side routes the same products through its
Pallas kernels in interpret mode (``REPRO_PLAN_KERNEL_COST`` raised past
every product).

Measures are integer-valued, so SUM, COUNT, MIN, MAX and int64 COUNT answers
must be bit-identical; MOMENTS (the generic path) agrees with allclose at
rtol 1e-5.
Message signatures, computed/reused/dispatch counts and the store's miss
counts must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_factors_match, jax_catalog_from_port, port_catalog
from repro.core import CJTEngine as JEngine
from repro.core import Query as JQuery
from repro.core import Treant as JTreant
from repro.core import jt_from_catalog as j_jt
from repro.core import semiring as jsr
from repro.core.plans import _build_dense_plan as j_dense_plan
from repro.relational import schema as jschema
from repro.relational.relation import mask_in as j_mask_in
from repro.relational.sql import parse as j_parse
from repro_torch.core import CJTEngine, Query, Treant, jt_from_catalog
from repro_torch.core import plans as tplans
from repro_torch.core import semiring as tsr
from repro_torch.kernels.semiring_contract import ops as sc_ops
from repro_torch.kernels.tropical_contract import ops as tc_ops
from repro_torch.relational.relation import catalog_from_arrays, mask_in
from repro_torch.relational.sql import parse
from test_torch_treant import _factor_stats, quickstart

DENSE_ALL = 10**9


@pytest.fixture(autouse=True)
def _jax_takes_its_kernels(monkeypatch):
    monkeypatch.setenv("REPRO_PLAN_KERNEL_COST", "1000000000000")


def star_cats(seed: int, n_fact: int = 600):
    """``tests/test_plans.py``'s star F(a,b)+m ← S(b,c), T(a,d), in both
    packages from the same numpy columns."""
    rng = np.random.default_rng(seed)
    doms = {"a": 13, "b": 7, "c": 10, "d": 5}

    def rel(name, attrs, n, measures=None):
        codes = {x: rng.integers(0, doms[x], n).astype(np.int32) for x in attrs}
        return dict(name=name, attrs=attrs, codes=codes, domains=doms,
                    measures=measures(n) if measures else {})

    tcat = catalog_from_arrays([
        rel("F", ("a", "b"), n_fact, lambda n: {"m": rng.integers(0, 16, n)}),
        rel("S", ("b", "c"), 77, lambda n: {"w": rng.integers(0, 8, n)}),
        rel("T", ("a", "d"), 29),
    ])
    return jax_catalog_from_port(tcat), tcat


STAR_RINGS = [("sum", ("F", "m")), ("count", None), ("tropical_min", ("F", "m")),
              ("tropical_max", ("F", "m")), ("moments", ("F", "m")), ("count_i64", None)]


@pytest.mark.parametrize("ring,measure", STAR_RINGS, ids=[r for r, _ in STAR_RINGS])
def test_dense_star_matches_reference(ring, measure):
    jcat, tcat = star_cats(seed=11)
    jt, tt = j_jt(jcat), jt_from_catalog(tcat)
    je = JEngine(jt, jcat, jsr.get(ring), dense_rows_threshold=DENSE_ALL)
    ports = [CJTEngine(tt, tcat, tsr.get(ring), dense_rows_threshold=DENSE_ALL,
                       use_plans=plans, device="cpu") for plans in (True, False)]
    kernel_route = ring in ("sum", "count", "tropical_min", "tropical_max")
    q0 = JQuery.make(jcat, ring=ring, measure=measure, group_by=("c",))
    t0 = Query.make(tcat, ring=ring, measure=measure, group_by=("c",))
    pairs = [(q0, t0), (q0.with_group_by("c", "d"), t0.with_group_by("c", "d")),
             (q0.with_predicate(j_mask_in(7, [0, 2, 5], attr="b")),
              t0.with_predicate(mask_in(7, [0, 2, 5], attr="b"))),
             (q0.with_removed("T"), t0.with_removed("T"))]
    for jq, tq in pairs:
        jf, js = je.execute(jq)
        for te in ports:
            tf, ts = te.execute(tq)
            assert (ts.messages_computed, ts.messages_reused) == (js.messages_computed,
                                                                  js.messages_reused)
            assert_factors_match(jf, tf, exact=ring != "moments", rtol=1e-5)
        assert ports[0].plans.stats.kernel_execs == je.plans.stats.kernel_execs
    assert (ports[0].plans.stats.kernel_execs > 0) == kernel_route
    assert ports[0].store.misses == je.store.misses


def _sf_cats():
    tcat = port_catalog(jschema.salesforce(n_opp=4000, n_user=80, n_camp=25, n_acc=40),
                        round_measures=True)
    dims = max(tcat.get(n).num_rows for n in tcat.names() if n != "Opp")
    return jax_catalog_from_port(tcat), tcat, dims


@pytest.mark.parametrize("batch", [True, False], ids=["levels", "per_edge"])
def test_dense_dimensions_calibrate_like_reference(batch):
    """Salesforce with every dimension table dense and Opp sparse: equal
    signatures, counts (store misses included) and answers."""
    jcat, tcat, dims = _sf_cats()
    rings = [("sum", ("Opp", "amount")), ("tropical_max", ("Opp", "amount"))]
    for ring, measure in rings:
        je = JEngine(j_jt(jcat), jcat, jsr.get(ring), dense_rows_threshold=dims,
                     batch_calibration=batch)
        te = CJTEngine(jt_from_catalog(tcat), tcat, tsr.get(ring), dense_rows_threshold=dims,
                       batch_calibration=batch, device="cpu")
        jq = JQuery.make(jcat, ring=ring, measure=measure, group_by=("camp_type",))
        tq = Query.make(tcat, ring=ring, measure=measure, group_by=("camp_type",))
        js, ts = je.calibrate(jq, pin=True), te.calibrate(tq, pin=True)
        assert (js.messages_computed, js.messages_reused, js.calibration_dispatches) == (
            ts.messages_computed, ts.messages_reused, ts.calibration_dispatches)
        assert je.store.misses == te.store.misses
        d = tcat.domains()
        jq2 = jq.with_predicate(j_mask_in(d["role_name"], [1, 2], attr="role_name"))
        tq2 = tq.with_predicate(mask_in(d["role_name"], [1, 2], attr="role_name"))
        for a, b in ((jq, tq), (jq2, tq2), (jq2.add_group_by("title"), tq2.add_group_by("title"))):
            jp, tp = je.place_predicates(a), te.place_predicates(b)
            for u, v in je.jt.directed_edges():
                assert je.edge_sig(a, u, v, jp) == te.edge_sig(b, u, v, tp)
            (jf, jst), (tf, tst) = je.execute(a), te.execute(b)
            assert (jst.messages_computed, jst.messages_reused) == (
                tst.messages_computed, tst.messages_reused)
            assert_factors_match(jf, tf, exact=True)
        assert je.store.misses == te.store.misses
        assert te.plans.stats.kernel_execs == je.plans.stats.kernel_execs > 0


def test_dense_treant_quickstart_matches_reference():
    jcat, tcat, dims = _sf_cats()
    jt_, jcal, jthought, jres, _ = quickstart(JTreant, JQuery, jsr, j_mask_in, j_parse, jcat,
                                              dense_rows_threshold=dims)
    tt_, tcal, tthought, tres, _ = quickstart(Treant, Query, tsr, mask_in, parse, tcat,
                                              dense_rows_threshold=dims, device="cpu")
    for a, b in zip(jcal, tcal):
        assert (a.messages_computed, a.messages_reused, a.calibration_dispatches) == (
            b.messages_computed, b.messages_reused, b.calibration_dispatches)
    assert jthought == tthought
    for a, b in zip(jres, tres):
        (jf, js), (tf, ts) = _factor_stats(a), _factor_stats(b)
        assert (js.messages_computed, js.messages_reused) == (ts.messages_computed,
                                                              ts.messages_reused)
        assert_factors_match(jf, tf, exact=True)
    jstats, tstats = jt_.cache_stats(), tt_.cache_stats()
    for key in ("messages", "hits", "misses", "widen_hits"):
        assert jstats[key] == tstats[key], key
    for key in ("plans_built", "plan_hits", "kernel_execs", "calibration_dispatches"):
        assert jstats["plans"][key] == tstats["plans"][key], key


def test_custom_lifts_match_reference():
    """A custom SUM lift on F (twice m, plus one) and on S (w) gives the
    reference's answers bit for bit, with F sparse and with every relation
    densified (the lifted dense path)."""
    jcat, tcat = star_cats(seed=1)
    jlifts = {"F": lambda r: 2.0 * jnp.asarray(r.measures["m"], jnp.float32) + 1.0,
              "S": lambda r: jnp.asarray(r.measures["w"], jnp.float32)}
    tlifts = {"F": lambda r: 2.0 * torch.as_tensor(r.measures["m"], dtype=torch.float32) + 1.0,
              "S": lambda r: torch.as_tensor(r.measures["w"], dtype=torch.float32)}
    for thr in (0, 1_000):
        je = JEngine(j_jt(jcat), jcat, jsr.SUM, lifts=jlifts, dense_rows_threshold=thr)
        te = CJTEngine(jt_from_catalog(tcat), tcat, tsr.SUM, lifts=tlifts,
                       dense_rows_threshold=thr, device="cpu")
        for gb in ((), ("c",), ("c", "d")):
            (jf, js), (tf, ts) = (je.execute(JQuery.make(jcat, ring="sum", group_by=gb)),
                                  te.execute(Query.make(tcat, ring="sum", group_by=gb)))
            assert js.messages_computed == ts.messages_computed
            assert_factors_match(jf, tf, exact=True)


@pytest.mark.parametrize("ring", ["sum", "tropical_max"])
@pytest.mark.parametrize("order", ["shared_first", "shared_second"])
def test_dense_plan_hands_the_kernel_a_view_of_the_factor(ring, order, monkeypatch):
    """A two-factor star product F1 ⋈ F2 on the shared attr s, kept (x, y):
    M is the projected F1 reshaped to (x, s).  When s comes first in F1, M
    is the transposed view of F1's own storage, strides (1, |x|), and no
    copy is made; the answers still equal the reference plan's (Pallas
    kernels in interpret mode)."""
    rng = np.random.default_rng(31)
    doms = {"x": 5, "s": 300, "y": 3}
    a1 = ("s", "x") if order == "shared_first" else ("x", "s")
    f1 = rng.integers(0, 9, [doms[a] for a in a1]).astype(np.float32)
    f2 = rng.integers(0, 9, (300, 3)).astype(np.float32)
    structs = ((a1, tuple(doms[a] for a in a1)), (("s", "y"), (300, 3)))
    module = sc_ops if ring == "sum" else tc_ops
    real, seen = module.contract_op, []

    def recording(m, r, *args, **kwargs):
        seen.append((m, r))
        return real(m, r, *args, **kwargs)

    monkeypatch.setattr(module, "contract_op", recording)
    t1, t2 = torch.as_tensor(f1), torch.as_tensor(f2)
    plan = tplans._build_dense_plan(tsr.get(ring), structs, (), ("x", "y"))
    got = plan.fn([t1, t2], ())
    (m, r), = seen
    assert tuple(m.shape) == (5, 300) and tuple(r.shape) == (300, 3)
    assert m.untyped_storage().data_ptr() == t1.untyped_storage().data_ptr()
    assert r.untyped_storage().data_ptr() == t2.untyped_storage().data_ptr()
    assert m.stride() == ((1, 5) if order == "shared_first" else (300, 1))
    want = j_dense_plan(jsr.get(ring), structs, (), ("x", "y")).fn(
        [jnp.asarray(f1), jnp.asarray(f2)], ())
    assert got.attrs == tuple(want.attrs) == ("x", "y")
    np.testing.assert_array_equal(got.field.numpy(), np.asarray(want.field))
