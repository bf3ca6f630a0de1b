"""Think-time policies and bin cubes in the port, held against the JAX package.

The scenarios of ``tests/test_predictive.py`` on both packages over the same
catalogs (integer measures, so every ⊕ order gives the same float32 bits):
a brush served by slicing a parked γ∪{dim} bin cube must equal cold
execution bit for bit in each package and across packages — SUM, COUNT,
MIN, MAX (MOMENTS allclose), on chain, star and bushy trees — with equal
counters (``bin_cube_hits``, cube builds and slices, policy decisions),
equal parked digests and equal trajectory predictions.  Plus the policy
surface (``speculate=k`` ≡ ``FixedKPrefetch(k)``, warn-once shims, the
typed config and its env overrides), invalidation on update and flush, and
the server pool admitting cubes.
"""

import dataclasses
import warnings

import numpy as np
import pytest

from _torch_parity import assert_factors_match, jax_catalog_from_port, packages
from _torch_parity import same_union_budget  # noqa: F401 — autouse fixture
import repro.core  # noqa: F401 — import order (core before relational)
from repro_torch.relational.relation import catalog_from_arrays

J, T = packages()
RINGS = ("count", "sum", "tropical_min", "tropical_max", "moments")


def _arrays(spec, doms, seed):
    rng = np.random.default_rng(seed)
    out = []
    for name, attrs, n, measure in spec:
        codes = {a: rng.integers(0, doms[a], n).astype(np.int32) for a in attrs}
        measures = {"m": rng.integers(0, 16, n).astype(np.float32)} if measure else {}
        out.append(dict(name=name, attrs=attrs, codes=codes, domains=doms, measures=measures))
    return out


CHAIN = ({"a": 6, "b": 7, "c": 5, "d": 8},
         [("F", ("a", "b"), 500, True), ("S", ("b", "c"), 60, False),
          ("T", ("c", "d"), 40, False)], "d")
STAR = ({"a": 13, "b": 7, "c": 10, "d": 5, "e": 9},
        [("F", ("a", "b"), 600, True), ("S", ("b", "c"), 77, False),
         ("T", ("a", "d"), 29, False), ("U", ("b", "e"), 41, False)], "c")
BUSHY = ({"a": 6, "b": 7, "c": 5, "d": 8, "e": 4, "g": 9},
         [("F", ("a", "b"), 400, True), ("S", ("b", "c"), 70, False),
          ("T", ("c", "d"), 50, False), ("A", ("a", "e"), 30, False),
          ("D", ("d", "g"), 35, False)], "g")
SHAPES = {"chain": CHAIN, "star": STAR, "bushy": BUSHY}


def catalog(P, shape, seed):
    """A fresh catalog of ``shape`` for package ``P`` (the same arrays in
    both packages) and its brush dimension."""
    doms, spec, dim = SHAPES[shape]
    tcat = catalog_from_arrays(_arrays(spec, doms, seed))
    return (tcat if P.port else jax_catalog_from_port(tcat)), dim


def two_viz_spec(P, ring, dim):
    measure = None if ring == "count" else ("F", "m")
    V = P.core.VizSpec
    return P.core.DashboardSpec(vizzes=(
        V("main", measure=measure, ring=ring, group_by=("a",)),
        V("brush_src", measure=measure, ring=ring, group_by=(dim,)),
    ))


def treant(P, cat, ring="sum", **kw):
    primary = P.sr.SUM if ring in ("count", "sum") else P.sr.get(ring)
    return P.core.Treant(cat, ring=primary, **kw, **P.kw)


def plan_execs(t):
    p = t.cache_stats().get("plans")
    return (p["plans_built"] + p["plan_hits"]) if p else 0


def both(scenario, *args):
    """Run ``scenario(P, *args)`` on both packages; each returns a list of
    checkpoints ``(comparable, [factors], exact)``, which must agree."""
    jout, tout = scenario(J, *args), scenario(T, *args)
    assert len(jout) == len(tout)
    for (jc, jfs, exact), (tc, tfs, _) in zip(jout, tout):
        assert jc == tc
        assert len(jfs) == len(tfs)
        for jf, tf in zip(jfs, tfs):
            assert_factors_match(jf, tf, exact=exact)
    return tout


def same_within(P, f1, f2, exact=True):
    """Two factors of one package are equal (bit for bit unless MOMENTS)."""
    if P.port:
        assert f1.attrs == f2.attrs
        for a, b in zip(P.sr.leaves(f1.field), P.sr.leaves(f2.field)):
            if exact:
                assert np.array_equal(a.numpy(), b.numpy())
            else:
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5)


def without_dwell(st: dict) -> dict:
    """Session stats minus the dwell EWMA (a wall-clock reading)."""
    st = dict(st)
    st["trajectory"] = {k: v for k, v in st["trajectory"].items() if k != "dwell_ewma_s"}
    return st


@pytest.fixture(autouse=True)
def _fresh_config():
    for P in (J, T):
        P.core.reset_think_time_config()
    yield
    for P in (J, T):
        P.core.reset_think_time_config()


# ---------------------------------------------------------------------------
# cube slice ≡ cold execution (rings × shapes)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ring", RINGS)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_cube_slice_matches_cold_execution(ring, shape):
    exact = ring != "moments"

    def scenario(P):
        cat, dim = catalog(P, shape, 11)
        spec = two_viz_spec(P, ring, dim)
        t = treant(P, cat, ring, use_plans=True)
        sess = t.open_session(spec, name="s")
        dom = cat.domains()[dim]
        sess.apply(P.core.SetFilter(dim, lo=0, hi=max(dom // 2, 1), source="brush_src"))
        built = sess._build_bin_cube("main", dim)
        cold = treant(P, catalog(P, shape, 11)[0], ring, use_plans=True).open_session(
            spec, name="cold")
        out = [((built, sorted(sess._bin_cubes)), [e.factor for e in sess._bin_cubes.values()],
                exact)]
        for ev in (P.core.SetFilter(dim, lo=1, hi=dom, source="brush_src"),
                   P.core.SetFilter(dim, values=(0, dom - 1), source="brush_src"),
                   P.core.ClearFilter(dim)):
            warm, cres = sess.apply(ev), cold.apply(ev)
            assert warm.affected == cres.affected == ("main",)
            st = warm.results["main"].stats
            assert st.bin_cube_hits == 1, f"{ev} missed the cube"
            same_within(P, warm.results["main"].factor, cres.results["main"].factor, exact)
            out.append(((st.bin_cube_hits, st.messages_computed, warm.queries["main"].digest),
                        [warm.results["main"].factor], exact))
        out.append((t.cache_stats()["plans"]["cube_slices"], [], exact))
        sess.close()
        cold.close()
        return out

    both(scenario)


# ---------------------------------------------------------------------------
# 0 plan executions, 0 store probes on a warm brush
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_plans", [False, True])
def test_warm_brush_zero_executions_zero_store_probes(use_plans):
    def scenario(P):
        cat, dim = catalog(P, "star", 23)
        t = treant(P, cat, use_plans=use_plans)
        sess = t.open_session(two_viz_spec(P, "sum", dim), name="s")
        sess.apply(P.core.SetFilter(dim, lo=2, hi=5, source="brush_src"))
        sess.idle(policy=P.core.PredictiveThinkTime(prefetch_k=0))
        assert sess._bin_cubes, "predictive idle built no cube"
        store = t.store
        probes0 = (store.hits, store.misses, store.widen_hits)
        execs0 = plan_execs(t)
        res = sess.apply(P.core.SetFilter(dim, lo=7, hi=9, source="brush_src"))
        assert res.affected == ("main",)
        assert res.results["main"].stats.bin_cube_hits == 1 == sess.bin_cube_hits
        assert (store.hits, store.misses, store.widen_hits) == probes0
        assert plan_execs(t) == execs0
        out = [((sorted(sess._bin_cubes), probes0, t.scheduler.stats()),
                [res.results["main"].factor], True)]
        sess.close()
        return out

    both(scenario)


# ---------------------------------------------------------------------------
# invalidation on update / flush: only cubes that see the relation
# ---------------------------------------------------------------------------

def _star_cube_session(P, seed):
    cat, dim = catalog(P, "star", seed)
    t = treant(P, cat, use_plans=True, compaction_threshold=0.0)
    V = P.core.VizSpec
    spec = P.core.DashboardSpec(vizzes=(
        V("sees_u", measure=("F", "m"), ring="sum", group_by=("a",)),
        V("blind_u", measure=("F", "m"), ring="sum", group_by=("d",), removed=("U",)),
        V("brush_src", measure=("F", "m"), ring="sum", group_by=(dim,)),
    ))
    sess = t.open_session(spec, name="s")
    sess.apply(P.core.SetFilter(dim, lo=2, hi=6, source="brush_src"))
    assert sess._build_bin_cube("sees_u", dim)
    assert sess._build_bin_cube("blind_u", dim)
    return cat, t, sess, dim


def test_update_invalidates_only_cubes_that_see_the_relation():
    def scenario(P):
        cat, t, sess, dim = _star_cube_session(P, 31)
        rng = np.random.default_rng(0)
        u = cat.get("U")
        new_u, delta = u.append_rows(
            {a: rng.integers(0, u.domains[a], 10).astype(np.int32) for a in u.attrs})
        t.update(new_u, delta)
        vizzes = {viz for viz, _ in sess._bin_cubes}
        assert vizzes == {"blind_u"}
        res = sess.apply(P.core.SetFilter(dim, lo=0, hi=3, source="brush_src"))
        assert res.results["blind_u"].stats.bin_cube_hits == 1
        assert res.results["sees_u"].stats.bin_cube_hits == 0
        V = P.core.VizSpec
        cold = t.open_session(P.core.DashboardSpec(vizzes=(
            V("blind_u", measure=("F", "m"), ring="sum", group_by=("d",), removed=("U",)),
            V("brush_src", measure=("F", "m"), ring="sum", group_by=(dim,)),
        )), name="cold")
        cres = cold.apply(P.core.SetFilter(dim, lo=0, hi=3, source="brush_src"))
        same_within(P, res.results["blind_u"].factor, cres.results["blind_u"].factor)
        out = [(sorted(sess._bin_cubes), [res.results[v].factor for v in ("blind_u", "sees_u")],
                True)]
        sess.close()
        cold.close()
        return out

    both(scenario)


def test_flush_invalidates_only_cubes_that_see_the_relation():
    def scenario(P):
        cat, t, sess, dim = _star_cube_session(P, 37)
        rng = np.random.default_rng(1)
        u = cat.get("U")
        t.stream("U").append(
            {a: rng.integers(0, u.domains[a], 6).astype(np.int32) for a in u.attrs})
        t.flush()
        assert {viz for viz, _ in sess._bin_cubes} == {"blind_u"}
        out = [(sorted(sess._bin_cubes), [e.factor for e in sess._bin_cubes.values()], True)]
        sess.close()
        return out

    both(scenario)


# ---------------------------------------------------------------------------
# deprecation shims + FixedKPrefetch parity
# ---------------------------------------------------------------------------

def test_speculate_kwarg_equals_fixed_k_policy():
    def parked(P, policy=None, speculate=0):
        cat, dim = catalog(P, "star", 41)
        t = treant(P, cat, use_plans=True)
        sess = t.open_session(two_viz_spec(P, "sum", dim), name="s")
        sess.apply(P.core.SetFilter(dim, lo=3, hi=5, source="brush_src"))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            sess.idle(speculate=speculate, policy=policy)
        keys = sorted(sess._prefetched)
        out = (keys, [sess._prefetched[k].dist for k in keys])
        factors = [sess._prefetched[k].factor for k in keys]
        sess.close()
        return out, factors

    def scenario(P):
        (a, fa), (b, fb) = parked(P, speculate=3), parked(P, policy=P.core.FixedKPrefetch(3))
        assert a == b
        return [(a, fa, True)]

    both(scenario)


def test_deprecated_kwargs_warn_exactly_once():
    from repro_torch.serve import TreantServer

    T.core.reset_deprecation_warnings()
    cat, dim = catalog(T, "star", 43)
    t = treant(T, cat, use_plans=False)
    sess = t.open_session(two_viz_spec(T, "sum", dim), name="s", calibrate=False)
    sess.apply(T.core.SetFilter(dim, lo=1, hi=3, source="brush_src"))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        sess.idle(speculate=1)
        sess.idle(speculate=2)   # second use: silent
        sess.idle(speculate=1)
    dep = [w for w in rec if issubclass(w.category, DeprecationWarning)]
    assert len(dep) == 1 and "FixedKPrefetch" in str(dep[0].message)
    # the server argument is a distinct key: it warns once too
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        TreantServer(t, speculate=2)
        TreantServer(t, speculate=3)
    dep = [w for w in rec if issubclass(w.category, DeprecationWarning)]
    assert len(dep) == 1
    sess.close()


def test_default_idle_is_pure_drain():
    def scenario(P):
        cat, dim = catalog(P, "star", 47)
        t = treant(P, cat, use_plans=True)
        assert isinstance(t.think_time_policy, P.core.DrainCalibration)
        sess = t.open_session(two_viz_spec(P, "sum", dim), name="s")
        sess.apply(P.core.SetFilter(dim, lo=2, hi=4, source="brush_src"))
        edges = sess.idle()
        assert not sess._prefetched and not sess._bin_cubes
        assert t.scheduler.policy_decisions == 0
        out = [((edges, t.scheduler.stats()), [], True)]
        sess.close()
        return out

    both(scenario)


def test_treant_level_policy_default_applies_to_sessions():
    def scenario(P):
        cat, dim = catalog(P, "star", 53)
        t = treant(P, cat, use_plans=True, policy=P.core.PredictiveThinkTime(prefetch_k=0))
        sess = t.open_session(two_viz_spec(P, "sum", dim), name="s")
        sess.apply(P.core.SetFilter(dim, lo=2, hi=4, source="brush_src"))
        sess.idle()
        assert sess._bin_cubes and t.scheduler.policy_decisions > 0
        out = [((sorted(sess._bin_cubes), t.scheduler.stats()),
                [e.factor for e in sess._bin_cubes.values()], True)]
        sess.close()
        return out

    both(scenario)


# ---------------------------------------------------------------------------
# one typed config, env overrides win
# ---------------------------------------------------------------------------

def test_think_time_config_env_overrides(monkeypatch):
    for name, value in (("REPRO_PREFETCH_CAPACITY", "7"), ("REPRO_PREFETCH_K", "5"),
                        ("REPRO_BIN_CUBE", "0"), ("REPRO_BIN_CUBE_MAX_DIMS", "2"),
                        ("REPRO_BIN_CUBE_CAPACITY", "9"), ("REPRO_BIN_CUBE_CELLS", "123")):
        monkeypatch.setenv(name, value)
    cfgs = []
    for P in (J, T):
        P.core.reset_think_time_config()
        cfg = P.core.think_time_config()
        assert (cfg.prefetch_capacity, cfg.prefetch_k, cfg.bin_cubes) == (7, 5, False)
        assert (cfg.cube_builds_per_idle, cfg.cube_capacity, cfg.cube_cell_budget) == (2, 9, 123)
        cfgs.append(dataclasses.astuple(cfg))
        cat, dim = catalog(P, "star", 59)
        t = treant(P, cat, use_plans=False)
        sess = t.open_session(two_viz_spec(P, "sum", dim), name="s", calibrate=False)
        assert sess.prefetch_capacity == 7
        # REPRO_BIN_CUBE=0 disables builds even under the predictive policy
        sess.apply(P.core.SetFilter(dim, lo=2, hi=4, source="brush_src"))
        sess.idle(policy=P.core.PredictiveThinkTime(prefetch_k=0))
        assert not sess._bin_cubes
        sess.close()
    assert cfgs[0] == cfgs[1]


def test_cube_cell_budget_derives_from_union_budget(monkeypatch):
    """Both packages derive their union budget from
    ``REPRO_CALIBRATION_UNION_BUDGET`` (else their own cost profile), and the
    cube cell budget is 32 × that budget.  The port's engines read the budget
    on every union-carry pass, not once at construction.  An explicit
    ``REPRO_BIN_CUBE_CELLS`` wins in both."""
    from repro_torch.core import plans

    monkeypatch.setenv("REPRO_CALIBRATION_UNION_BUDGET", "100")
    monkeypatch.delenv("REPRO_BIN_CUBE_CELLS", raising=False)
    for P in (J, T):
        P.core.reset_think_time_config()
    jcfg, tcfg = J.core.think_time_config(), T.core.think_time_config()
    assert (jcfg.union_budget, jcfg.cube_cell_budget) == (100, 3200)
    assert (tcfg.union_budget, tcfg.cube_cell_budget) == (100, 3200)
    assert plans.calibration_union_budget() == 100
    cat, _ = catalog(T, "star", 1)
    assert not hasattr(treant(T, cat).engine, "union_budget")
    monkeypatch.setenv("REPRO_BIN_CUBE_CELLS", "50")
    for P in (J, T):
        P.core.reset_think_time_config()
        assert P.core.think_time_config().cube_cell_budget == 50


def test_cube_cell_budget_caps_builds(monkeypatch):
    monkeypatch.setenv("REPRO_BIN_CUBE_CELLS", "4")  # 13·10 cells ≫ 4

    def scenario(P):
        P.core.reset_think_time_config()
        cat, dim = catalog(P, "star", 61)
        t = treant(P, cat, use_plans=False)
        sess = t.open_session(two_viz_spec(P, "sum", dim), name="s", calibrate=False)
        sess.apply(P.core.SetFilter(dim, lo=2, hi=4, source="brush_src"))
        built = sess._build_bin_cube("main", dim)
        assert not built and not sess._bin_cubes
        sess.close()
        return [(built, [], True)]

    both(scenario)


# ---------------------------------------------------------------------------
# trajectory model
# ---------------------------------------------------------------------------

def test_trajectory_direction_biases_candidates():
    def windows(P, start, step):
        tr = P.core.BrushTrajectory()
        for i in range(3):
            lo = start + step * i
            tr.observe(P.core.SetFilter("x", lo=lo, hi=lo + 2), now=float(i))
        return tr, [(c.lo, c.hi) for c in tr.next_filters(domain=20, k=2)]

    out = []
    for P in (J, T):
        up, up_c = windows(P, 2, 2)
        down, down_c = windows(P, 14, -2)
        assert up.direction["x"] > 0 and all(lo > 6 for lo, _ in up_c), up_c
        assert down.direction["x"] < 0 and all(lo < 10 for lo, _ in down_c), down_c
        out.append((up.state(), up_c, down.state(), down_c))
    assert out[0] == out[1]


def test_trajectory_switch_probability_and_ranking():
    out = []
    for P in (J, T):
        tr = P.core.BrushTrajectory()
        for i, attr in enumerate(["x", "y", "x", "y"]):
            tr.observe(P.core.SetFilter(attr, lo=0, hi=2, source=f"src_{attr}"), now=float(i))
        assert tr.switch_prob > 0.5 and tr.ranked_dims()[0] == "x"
        assert tr.source_of("y") == "src_y"
        tr2 = P.core.BrushTrajectory()
        for i in range(4):
            tr2.observe(P.core.SetFilter("x", lo=i, hi=i + 2), now=float(i))
        assert tr2.switch_prob < 0.5 and tr2.ranked_dims()[0] == "x"
        out.append((tr.state(), tr2.state(), tr.ranked_vizzes(["a", "src_x", "src_y"])))
    assert out[0] == out[1]


def test_predictive_policy_skips_brush_source_viz():
    def scenario(P):
        cat, dim = catalog(P, "star", 67)
        t = treant(P, cat, use_plans=True)
        sess = t.open_session(two_viz_spec(P, "sum", dim), name="s")
        sess.apply(P.core.SetFilter(dim, lo=2, hi=5, source="brush_src"))
        sess.idle(policy=P.core.PredictiveThinkTime(prefetch_k=0))
        assert all(e.viz != "brush_src" for e in sess._bin_cubes.values())
        out = [(sorted(sess._bin_cubes), [], True)]
        sess.close()
        return out

    both(scenario)


# ---------------------------------------------------------------------------
# serving tier: pooled cubes serve ANY session
# ---------------------------------------------------------------------------

def test_server_pool_cube_serves_sibling_session():
    import repro.serve as jserve
    import repro_torch.serve as tserve

    def scenario(P):
        serve = tserve if P.port else jserve
        cat, dim = catalog(P, "star", 71)
        t = treant(P, cat, use_plans=True)
        server = serve.TreantServer(t, policy=P.core.PredictiveThinkTime(prefetch_k=0))
        spec = two_viz_spec(P, "sum", dim)
        h1 = server.open_session(spec, name="u1")
        h2 = server.open_session(spec, name="u2")
        h1.submit(P.core.SetFilter(dim, lo=2, hi=5, source="brush_src"))
        server.step()
        server.idle()
        assert any(e.dim == dim for e in server._pool.values())
        h2.submit(P.core.SetFilter(dim, lo=7, hi=9, source="brush_src"))
        server.step()
        res = h2.last_result
        assert res.affected == ("main",)
        assert res.results["main"].stats.bin_cube_hits == 1
        assert server.stats_.pool_cube_hits == 1
        cold = treant(P, catalog(P, "star", 71)[0], use_plans=True).open_session(spec, "cold")
        cres = cold.apply(P.core.SetFilter(dim, lo=7, hi=9, source="brush_src"))
        same_within(P, res.results["main"].factor, cres.results["main"].factor)
        st = server.stats()
        out = [((sorted(server._pool), st["pool_cube_hits"], st["think_time_messages"]),
                [res.results["main"].factor], True)]
        cold.close()
        server.close_session("u1")
        server.close_session("u2")
        return out

    both(scenario)


def test_session_stats_and_cache_stats_surface_cube_counters():
    def scenario(P):
        cat, dim = catalog(P, "star", 73)
        t = treant(P, cat, use_plans=True)
        sess = t.open_session(two_viz_spec(P, "sum", dim), name="s")
        sess.apply(P.core.SetFilter(dim, lo=2, hi=5, source="brush_src"))
        sess.idle(policy=P.core.PredictiveThinkTime(prefetch_k=0))
        sess.apply(P.core.SetFilter(dim, lo=6, hi=8, source="brush_src"))
        st = without_dwell(sess.stats())
        assert st["bin_cubes"] >= 1 and st["bin_cube_hits"] == 1 and st["bin_cube_bytes"] > 0
        assert st["trajectory"]["events"] == 2
        cs = t.cache_stats()
        assert cs["bin_cube_hits"] == 1 and cs["bin_cube_bytes"] > 0
        assert cs["scheduler"]["cube_builds"] >= 1 and cs["scheduler"]["policy_decisions"] > 0
        assert cs["plans"]["cube_builds"] >= 1 and cs["plans"]["cube_slices"] == 1
        picked = {k: cs[k] for k in ("bin_cubes", "bin_cube_bytes", "bin_cube_hits",
                                     "scheduler")}
        picked["plans"] = {k: cs["plans"][k] for k in ("cube_builds", "cube_slices")}
        sess.close()
        assert not sess._bin_cubes
        return [((st, picked), [], True)]

    both(scenario)


# ---------------------------------------------------------------------------
# the slicing functions and the row-chunked rowwise stage
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ring", RINGS)
def test_slice_bin_cubes_equal_reference_slices(ring):
    """``slice_bin_cube(s)`` on the same cube and σ masks equals the
    reference's jitted slices; one device mask serves every slice of a mask."""
    from repro.core.plans import slice_bin_cubes as jslice
    from repro_torch.core import plans

    def cube(P):
        cat, dim = catalog(P, "star", 5)
        t = treant(P, cat, ring, use_plans=True)
        q = P.core.Query.make(cat, ring=ring, measure=None if ring == "count" else ("F", "m"),
                              group_by=("a", dim))
        return t.engine_for(q.ring_name, q.measure).execute(q)[0], dim

    (jc, dim), (tc, _) = cube(J), cube(T)
    masks = [np.arange(10) % 3 == 0, np.arange(10) < 7]
    items = [(dim, masks, ("a",)), (dim, masks[:1], ("a",)), (dim, [], ("a",)),
             (dim, masks[1:], (dim, "a"))]
    jout = jslice([(jc, d, m, g) for d, m, g in items])
    stats = plans.PlanStats()
    tout = plans.slice_bin_cubes([(tc, d, m, g) for d, m, g in items], stats=stats)
    assert stats.cube_slices == len(items)
    for jf, tf in zip(jout, tout):
        assert_factors_match(jf, tf, exact=ring != "moments")
    single = plans.slice_bin_cube(tc, dim, masks, ("a",), stats=stats)
    assert_factors_match(jout[0], single, exact=ring != "moments")
    assert stats.cube_slices == len(items) + 1
    key = (masks[0].tobytes(), masks[0].shape, str(masks[0].dtype), "cpu")
    assert key in plans._DEVICE_MASKS


@pytest.mark.parametrize("ring", ["sum", "tropical_max", "moments", "count_i64"])
def test_split_level_launch_equals_one_launch(monkeypatch, ring):
    """A level launch whose pending slabs would pass ``ROWWISE_MAX_ELEMS``
    goes out as several launches, in member order: the same messages, bit
    for bit, as one launch, and the kernel-route rings launch more often.
    A message hands the launch one item per leaf of its ring (MOMENTS:
    three); the launches are counted in messages."""
    from repro_torch.core import plans

    real, launches = plans.seg_ops.level_aggregate, []
    leaves = len(T.sr.get(ring).zero_values)

    def counting(items, **kw):
        assert len(items) % leaves == 0, (len(items), leaves)
        launches.append(len(items) // leaves)
        return real(items, **kw)

    monkeypatch.setattr(plans.seg_ops, "level_aggregate", counting)

    def run():
        launches.clear()
        cat, _ = catalog(T, "star", 9)
        t = treant(T, cat, ring if ring != "count_i64" else "sum", use_plans=True)
        q = T.core.Query.make(cat, ring=ring, group_by=("c", "d", "e"),
                              measure=("F", "m") if ring in ("sum", "tropical_max", "moments")
                              else None)
        eng = t.engine_for(q.ring_name, q.measure)
        eng.calibrate(q)
        out = [eng.execute(q.with_group_by(*g))[0]
               for g in (("c", "d", "e"), ("a", "e"), ("b",))]
        return out, list(launches)

    one, one_launches = run()
    monkeypatch.setattr(plans, "ROWWISE_MAX_ELEMS", 100)
    split, split_launches = run()
    if T.sr.get(ring).kernel_segment_op is not None and ring != "count_i64":
        assert max(one_launches) > 1, one_launches
        assert max(split_launches) == 1 and sum(split_launches) == sum(one_launches)
    for a, b in zip(one, split):
        assert a.attrs == b.attrs
        for x, y in zip(T.sr.leaves(a.field), T.sr.leaves(b.field)):
            assert np.array_equal(x.numpy(), y.numpy())
