"""The port reads the reference's environment knobs, and its union-carry
budget resolves the reference's way: env, then a cost profile, then 512.

Mirrors ``tests/test_batched_plans.py::test_env_gates_use_plans_and_batch_fanout``,
``tests/test_level_calibration.py::test_env_gate_batch_calibration`` and
``::test_union_carry_respects_budget``, and ``tests/test_level_fusion.py``'s
``test_fused_vs_unfused_batched_identical``, ``test_env_gate_fuse_level_kernel``,
``test_kernel_cost_profile_resolution`` and
``test_kernel_cost_profile_disabled_and_malformed`` (the port has no
plan-kernel-cost gate, so those two test only the union budget).  Adds
``REPRO_SPARSE_BATCH_ELEMS`` chunking, ``REPRO_COMPACTION_THRESHOLD``, the
budget read on every call, and default settings with no env pin: equal
counters across packages whenever both resolve the same budget.

Measures are small integers, so float sums are exact in any order and the
answers must be bit-identical.
"""

import json

import numpy as np
import pytest
import torch

from _torch_parity import assert_factors_match, assert_same_results, packages, star_catalogs
import repro.core  # noqa: F401 — import order (core before relational)
from repro.core import plans as jplans
from repro.kernels import costs as jcosts
from repro_torch.core import plans as tplans
from repro_torch.kernels import costs as tcosts

J, T = packages()
KNOBS = ("REPRO_USE_PLANS", "REPRO_BATCH_FANOUT", "REPRO_BATCH_CALIBRATION",
         "REPRO_FUSE_LEVEL_KERNEL", "REPRO_SPARSE_BATCH_ELEMS", "REPRO_COMPACTION_THRESHOLD",
         "REPRO_CALIBRATION_UNION_BUDGET", "REPRO_KERNEL_COSTS")


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    """Every knob unset, and both profile caches re-read, before and after."""
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    jcosts.reset_cache()
    tcosts.reset_cache()
    yield
    jcosts.reset_cache()
    tcosts.reset_cache()


@pytest.fixture(scope="module")
def cats():
    return star_catalogs(seed=53)


def _treant(P, cat, **kw):
    return P.core.Treant(cat, ring=P.sr.SUM, **kw, **P.kw)


def _engine(P, cat, ring=None, **kw):
    ring = ring or P.sr.SUM
    return P.core.CJTEngine(P.core.jt_from_catalog(cat), cat, ring, **kw, **P.kw)


def test_env_gates_use_plans_and_batch_fanout(cats, monkeypatch):
    for P, cat in zip((J, T), cats):
        monkeypatch.setenv("REPRO_USE_PLANS", "0")
        monkeypatch.setenv("REPRO_BATCH_FANOUT", "0")
        t = _treant(P, cat)
        assert t.engine.plans is None and not t.batch_fanout
        assert "plans" not in t.cache_stats()
        monkeypatch.setenv("REPRO_USE_PLANS", "1")
        monkeypatch.setenv("REPRO_BATCH_FANOUT", "1")
        t = _treant(P, cat)
        assert t.engine.plans is not None and t.batch_fanout
        # explicit arguments always win over the env
        t = _treant(P, cat, use_plans=False, batch_fanout=False)
        assert t.engine.plans is None and not t.batch_fanout
    # the port's engine reads REPRO_USE_PLANS itself; an argument wins
    monkeypatch.setenv("REPRO_USE_PLANS", "false")
    assert _engine(T, cats[1]).plans is None
    assert _engine(T, cats[1], use_plans=True).plans is not None


def test_env_gate_batch_calibration(cats, monkeypatch):
    for P, cat in zip((J, T), cats):
        monkeypatch.setenv("REPRO_BATCH_CALIBRATION", "0")
        t = _treant(P, cat)
        assert not t.engine.batch_calibration and not t.engine._batch_enabled()
        monkeypatch.setenv("REPRO_BATCH_CALIBRATION", "1")
        t = _treant(P, cat)
        assert t.engine.batch_calibration
        # explicit argument wins over the env
        t = _treant(P, cat, batch_calibration=False)
        assert not t.engine.batch_calibration


def test_union_carry_respects_budget(cats, monkeypatch):
    """Read on every call: one engine fuses nothing at budget 1 and fuses the
    pair after the env changes to 256, in both packages."""
    for P, cat in zip((J, T), cats):
        monkeypatch.setenv("REPRO_CALIBRATION_UNION_BUDGET", "1")
        eng = _engine(P, cat)
        qs = [P.core.Query.make(cat, ring="sum", measure=("F", "m"), group_by=(g,))
              for g in ("c", "d")]
        assert [q.group_by for q in eng._union_carry(qs)] == [("c",), ("d",)]
        monkeypatch.setenv("REPRO_CALIBRATION_UNION_BUDGET", "256")
        assert [q.group_by for q in eng._union_carry(qs)] == [("c", "d")]


def test_budget_change_reaches_an_open_session(cats, monkeypatch):
    """The budget is not frozen at construction: a session opened after the
    env changes on a live Treant calibrates the new budget's union queries,
    as the reference's does, with the reference's counters and answers."""
    specs, results = [], []
    for P, cat in zip((J, T), cats):
        V = P.core.VizSpec
        spec = P.core.DashboardSpec(vizzes=(
            V("by_c", measure=("F", "m"), ring="sum", group_by=("c",)),
            V("by_d", measure=("F", "m"), ring="sum", group_by=("d",)),
            V("by_e", measure=("F", "m"), ring="sum", group_by=("e",)),
        ))
        monkeypatch.setenv("REPRO_CALIBRATION_UNION_BUDGET", "1")
        t = _treant(P, cat)
        s1 = t.open_session(spec, name="narrow")
        narrow = len(t.store._pinned)
        monkeypatch.setenv("REPRO_CALIBRATION_UNION_BUDGET", "1000")
        s2 = t.open_session(spec, name="wide")
        specs.append((narrow, len(t.store._pinned), t.cache_stats()["plans"]["plans_built"]))
        results.append([s.read(v).factor for s in (s1, s2) for v in ("by_c", "by_d", "by_e")])
    assert specs[0] == specs[1]
    assert specs[1][1] > specs[1][0]  # the wide session pinned its union passes too
    for jf, tf in zip(*results):
        assert_factors_match(jf, tf, exact=True)


def _store_identical(e1, e2, q):
    placement = e1.place_predicates(q)
    for (u, v) in e1.jt.directed_edges():
        m1, m2 = e1.message(q, u, v, placement), e2.message(q, u, v, placement)
        assert m1.attrs == m2.attrs
        assert all(torch.equal(a, b) for a, b in zip(T.sr.leaves(m1.field),
                                                      T.sr.leaves(m2.field)))


def test_fused_vs_unfused_batched_identical(cats, monkeypatch):
    """Fused levels against the batched-but-unfused path: the same bits, and
    fusion never dispatches more often.  Four passes that differ only in
    σ(d) share each level's edges with equal batch keys, so the unfused path
    runs groups of several messages (``run_message_batch``).  The port's
    counters, fused and unfused, equal the reference's."""
    engines = {}
    for P, cat in zip((J, T), cats):
        base = P.core.Query.make(cat, ring="sum", measure=("F", "m"), group_by=("c",))
        qs = [base.with_predicate(P.rel.mask_in(5, [i], attr="d")) for i in range(4)]
        for fuse in (False, True):
            eng = _engine(P, cat, batch_calibration=True, fuse_level_kernel=fuse)
            st, eff = eng.calibrate_many(qs, pin=True)
            engines[(P.port, fuse)] = (eng, st, eff, qs)
    unf, _, _, qs = engines[(True, False)]
    fus = engines[(True, True)][0]
    for q in qs:
        _store_identical(unf, fus, q)
    assert fus.plans.stats.fused_level_launches > 0
    assert unf.plans.stats.fused_level_launches == 0
    assert unf.plans.stats.level_batched_execs > 0
    assert fus.plans.stats.calibration_dispatches <= unf.plans.stats.calibration_dispatches
    for fuse in (False, True):
        (je, jst, jeff, jqs), (te, tst, teff, tqs) = engines[(False, fuse)], engines[(True, fuse)]
        assert [q.digest for q in jeff] == [q.digest for q in teff]
        assert [(s.messages_computed, s.messages_reused, s.calibration_dispatches)
                for s in jst] == [(s.messages_computed, s.messages_reused,
                                   s.calibration_dispatches) for s in tst]
        for k in ("level_batched_execs", "level_batched_messages", "level_batch_width",
                  "calibration_dispatches", "fused_level_launches"):
            assert getattr(je.plans.stats, k) == getattr(te.plans.stats, k), k
        for jq, tq in zip(jqs, tqs):
            assert_same_results([je.execute(jq)], [te.execute(tq)])


def test_env_gate_fuse_level_kernel(cats, monkeypatch):
    for P, cat in zip((J, T), cats):
        monkeypatch.setenv("REPRO_FUSE_LEVEL_KERNEL", "0")
        t = _treant(P, cat)
        assert not t.fuse_level_kernel and not t.engine.fuse_level_kernel
        monkeypatch.setenv("REPRO_FUSE_LEVEL_KERNEL", "1")
        t = _treant(P, cat)
        assert t.fuse_level_kernel and t.engine.fuse_level_kernel
        # explicit argument wins over the env
        t = _treant(P, cat, fuse_level_kernel=False)
        assert not t.engine.fuse_level_kernel
        # sibling engines inherit the flag
        assert t.engine_for("count", ("F", "m")).fuse_level_kernel is False


def test_kernel_cost_profile_resolution(monkeypatch, tmp_path):
    prof = tmp_path / "h100_costs.json"
    prof.write_text(json.dumps({"derived": {"calibration_union_budget": 777}}))
    for costs, plans in ((jcosts, jplans), (tcosts, tplans)):
        monkeypatch.setenv(costs.PROFILE_ENV, str(prof))
        monkeypatch.delenv("REPRO_CALIBRATION_UNION_BUDGET", raising=False)
        costs.reset_cache()
        assert costs.derived_union_budget() == 777
        # the budget defaults to the measured value ...
        assert plans.calibration_union_budget() == 777
        # ... but an explicit env override always wins
        monkeypatch.setenv("REPRO_CALIBRATION_UNION_BUDGET", "64")
        assert plans.calibration_union_budget() == 64
    assert tcosts.PROFILE_ENV == jcosts.PROFILE_ENV == "REPRO_KERNEL_COSTS"


def test_kernel_cost_profile_disabled_and_malformed(monkeypatch, tmp_path):
    for costs, plans in ((jcosts, jplans), (tcosts, tplans)):
        # "" disables the profile → the static default
        monkeypatch.setenv(costs.PROFILE_ENV, "")
        costs.reset_cache()
        assert costs.load_profile() is None
        assert plans.calibration_union_budget() == 512
        # malformed JSON / non-positive values degrade to None, not a crash
        bad = tmp_path / "bad.json"
        bad.write_text("{not json")
        monkeypatch.setenv(costs.PROFILE_ENV, str(bad))
        costs.reset_cache()
        assert costs.load_profile() is None
        neg = tmp_path / "neg.json"
        neg.write_text(json.dumps({"derived": {"calibration_union_budget": -5}}))
        monkeypatch.setenv(costs.PROFILE_ENV, str(neg))
        costs.reset_cache()
        assert costs.derived_union_budget() is None
        assert plans.calibration_union_budget() == 512


def test_port_profile_is_the_card_sweep():
    """The committed H100 profile names its card, power limit and sweep, and
    the port's default budget is its knee."""
    prof = tcosts.load_profile(refresh=True)
    assert tcosts.profile_path() == tcosts.DEFAULT_PROFILE and prof is not None
    prov = prof["provenance"]
    assert "H100" in prov["card"] and prov["power_limit"].endswith("W")
    assert prov["tool"] == "tools/union_budget_sweep.py"
    knee = prof["derived"]["calibration_union_budget"]
    assert knee in prov["budgets"] and tplans.calibration_union_budget() == knee


def test_sparse_batch_elems_chunks_sibling_absorptions(monkeypatch):
    """Five same-key siblings absorbed at S (77 rows): a volume of 231
    rows·width caps a batch at 3 members (chunks 3 + 2), 1 at the floor of 2
    (2 + 2 + 1), 0 leaves one batch of five; the port's batch counters and
    answers equal the reference's."""
    counters = {}
    for env in ("231", "1", "0"):
        monkeypatch.setenv("REPRO_SPARSE_BATCH_ELEMS", env)
        for P, cat in zip((J, T), star_catalogs(seed=5)):
            base = P.core.Query.make(cat, ring="sum", measure=("F", "m"), group_by=("c",))
            qs = [base.with_predicate(P.rel.mask_in(5, [i], attr="d")) for i in range(5)]
            eng = _engine(P, cat)
            assert eng.choose_root(qs[0]) == "bag:S" and cat.get("S").num_rows == 77
            res = eng.execute_many(qs)
            st = eng.plans.stats
            counters[(env, P.port)] = (st.batched_execs, st.batched_absorptions,
                                       st.batch_width, res)
    for env, want in (("231", (2, 5, 3)), ("1", (2, 4, 2)), ("0", (1, 5, 5))):
        jc, tc = counters[(env, False)], counters[(env, True)]
        assert jc[:3] == tc[:3] == want
        assert_same_results(jc[3], tc[3])


@pytest.mark.parametrize("env,want", [(None, 0.25), ("0.5", 0.5), ("0", 0.0)])
def test_compaction_threshold_env(cats, monkeypatch, env, want):
    if env is not None:
        monkeypatch.setenv("REPRO_COMPACTION_THRESHOLD", env)
    for P, cat in zip((J, T), cats):
        assert _treant(P, cat).compaction_threshold == want
        assert _treant(P, cat, compaction_threshold=0.125).compaction_threshold == 0.125


def test_defaults_without_env_pin_give_equal_counters(monkeypatch):
    """No knob set: each package resolves its budget from its own profile.
    Where the two resolve the same budget, sessions give equal counters and
    answers; the port's budget is the card's knee either way."""
    jb, tb = jplans.calibration_union_budget(), tplans.calibration_union_budget()
    assert tb == tcosts.derived_union_budget()
    if jb != tb:
        # make the reference resolve the port's budget through its own
        # profile path, not the env
        monkeypatch.setenv(jcosts.PROFILE_ENV, str(tcosts.DEFAULT_PROFILE))
        jcosts.reset_cache()
    assert jplans.calibration_union_budget() == tb
    reads, stats = [], []
    for P, cat in zip((J, T), star_catalogs(seed=7)):
        V = P.core.VizSpec
        spec = P.core.DashboardSpec(vizzes=tuple(
            V(f"by_{g}", measure=("F", "m"), ring="sum", group_by=(g,)) for g in "cde"))
        t = _treant(P, cat)
        sess = t.open_session(spec, name="s")
        res = sess.apply(P.core.SetFilter("a", values=(1, 2), source="by_c"))
        reads.append([res.results[v].factor for v in sorted(res.affected)])
        stats.append((len(t.store._pinned), t.store.hits, t.store.misses,
                      {k: t.cache_stats()["plans"][k] for k in
                       ("calibration_dispatches", "fused_level_launches", "batched_execs")}))
    assert stats[0] == stats[1]
    for jf, tf in zip(*reads):
        assert_factors_match(jf, tf, exact=True)
    assert np.isfinite(float(reads[1][0].field.sum()))
