"""Sharded CJT execution in the port, held against the JAX package.

``tests/test_sharded.py``'s scenarios: the port's engine row-shards its
fact scans over a virtual CPU mesh (``ShardMesh.virtual(n, "cpu")``: n
shards run one after another in this process, their row blocks views of
the whole tensors) and ⊕-folds the γ-indexed partials; its answers and
stored messages must equal the *unsharded* JAX engine's on the same seeded
catalog — bit for bit on integer data, rtol 1e-5 for MOMENTS.  BOOL and
row buckets the mesh does not divide run unsharded (``shard_execs == 0``),
and a mesh whose first device is not the engine's raises.  One test runs
the reference's sharded engine on 8 forced XLA host devices in a
subprocess and holds the port's answers and shard counters to it.
"""

import gc
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import assert_factors_match, packages, port_catalog, star_catalogs
from _torch_parity import same_union_budget  # noqa: F401 — autouse fixture
import repro.core  # noqa: F401 — import order (core before relational)
from repro.core import CJTEngine as JEngine
from repro.core import MessageStore as JStore
from repro.core import Query as JQuery
from repro.core import jt_from_catalog as j_jt
from repro.core import semiring as jsr
from repro_torch.core import CJTEngine, MessageStore, Query, Treant, jt_from_catalog
from repro_torch.core import distributed as dist
from repro_torch.core import semiring as sr
from repro_torch.core.plans import PlanCache
from repro_torch.relational.relation import mask_in
from test_level_calibration import RINGS, SHAPES, bushy_catalog, chain_catalog

J, T = packages()
TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"


def _mesh(nshards: int) -> dist.ShardMesh:
    return dist.ShardMesh.virtual(nshards, "cpu")


def _query(P, cat, ring_name, shape="chain"):
    measure = None if ring_name in ("count", "bool") else ("F", "m")
    gamma = ("c",) if shape != "star" else ("c", "d")
    dom_a = cat.get("F").domains["a"]
    return P.core.Query.make(
        cat, ring=ring_name, measure=measure, group_by=gamma,
        predicates=(P.rel.mask_in(dom_a, [1, 2, 3], attr="a"),),
    )


def _engines(shape, ring_name, nshards, seed=3, use_plans=True):
    """(sharded port engine, unsharded JAX engine) over one seeded catalog,
    and their catalogs (port, JAX)."""
    jcat = SHAPES[shape](seed=seed)
    tcat = port_catalog(jcat)
    mesh = _mesh(nshards)
    tcat.set_row_placement(dist.row_placement(mesh))
    shd = CJTEngine(jt_from_catalog(tcat), tcat, sr.get(ring_name), store=MessageStore(),
                    use_plans=use_plans, mesh=mesh, device="cpu")
    ref = JEngine(j_jt(jcat), jcat, RINGS[ring_name] if ring_name in RINGS else jsr.get(ring_name),
                  store=JStore(), use_plans=use_plans)
    return shd, ref, (tcat, jcat)


def assert_stores_match(shd, ref, tq, jq, exact=True):
    """Every directed edge's message, from each engine's store or computed:
    equal across the packages."""
    tpl, jpl = shd.place_predicates(tq), ref.place_predicates(jq)
    for (u, v) in ref.jt.directed_edges():
        assert_factors_match(ref.message(jq, u, v, jpl), shd.message(tq, u, v, tpl), exact)


# ---------------------------------------------------------------------------
# metamorphic parity: the port sharded ≡ the reference on one device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ring_name", sorted(RINGS))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_sharded_matches_single_device(ring_name, shape):
    shd, ref, (tcat, jcat) = _engines(shape, ring_name, nshards=8)
    tq, jq = _query(T, tcat, ring_name, shape), _query(J, jcat, ring_name, shape)
    exact = ring_name != "moments"
    # cold execute, batched calibration, warm re-execute: every path agrees
    assert_factors_match(ref.execute(jq)[0], shd.execute(tq)[0], exact)
    shd.calibrate(tq, batch=True)
    ref.calibrate(jq, batch=True)
    assert_factors_match(ref.execute(jq)[0], shd.execute(tq)[0], exact)
    assert_stores_match(shd, ref, tq, jq, exact)
    assert shd.plans.stats.shard_execs > 0
    assert shd.plans.stats.allreduce_bytes > 0
    assert ref.plans.stats.shard_execs == 0


@pytest.mark.parametrize("nshards", [1, 2, 8])
@pytest.mark.parametrize("use_plans", [True, False])
def test_sharded_mesh_widths_and_plans_on_off(nshards, use_plans):
    """Every mesh width gives the single-device bits; with plans off the
    mesh is inert (sharding lives in the plan cache) but must stay correct;
    a one-shard mesh runs unsharded."""
    shd, ref, (tcat, jcat) = _engines("chain", "sum", nshards, use_plans=use_plans)
    tq, jq = _query(T, tcat, "sum"), _query(J, jcat, "sum")
    assert_factors_match(ref.execute(jq)[0], shd.execute(tq)[0], True)
    shd.calibrate(tq, batch=True)
    ref.calibrate(jq, batch=True)
    assert_factors_match(ref.execute(jq)[0], shd.execute(tq)[0], True)
    assert_stores_match(shd, ref, tq, jq)
    if use_plans:
        assert (shd.plans.stats.shard_execs > 0) == (nshards > 1)


def test_sharded_update_then_read():
    """apply_delta on a sharded fact: maintained messages equal the
    reference's single-device maintenance AND a cold rebuild over the
    updated catalog."""
    shd, ref, (tcat, jcat) = _engines("chain", "sum", nshards=8, seed=7)
    tq, jq = _query(T, tcat, "sum"), _query(J, jcat, "sum")
    shd.calibrate(tq, batch=True)
    ref.calibrate(jq, batch=True)
    rng = np.random.default_rng(5)
    n = 96
    codes = {a: rng.integers(0, tcat.get("F").domains[a], n) for a in ("a", "b")}
    meas = rng.integers(0, 16, n).astype(np.float32)
    execs = shd.plans.stats.shard_execs
    rel, delta = tcat.get("F").append_rows({a: v.copy() for a, v in codes.items()},
                                           measures={"m": meas.copy()})
    tcat.put(rel)
    tq, st = shd.apply_delta(tq, delta)
    assert not st.fallback
    jrel, jdelta = jcat.get("F").append_rows({a: v.copy() for a, v in codes.items()},
                                             measures={"m": meas.copy()})
    jcat.put(jrel)
    jq, _ = ref.apply_delta(jq, jdelta)
    assert shd.plans.stats.shard_execs > execs  # the delta's scan ran sharded
    got, es = shd.execute(tq)
    assert es.messages_computed == 0  # maintenance kept the CJT warm
    assert_factors_match(ref.execute(jq)[0], got, True)
    cold = CJTEngine(jt_from_catalog(tcat), tcat, sr.SUM, store=MessageStore(),
                     use_plans=False, device="cpu")
    assert torch.equal(cold.execute(tq)[0].field, got.field)


def test_sharded_stream_flush_parity(monkeypatch):
    """stream().flush() on a sharded Treant coalesces + maintains the same
    bits as an unsharded Treant fed the identical micro-batches, in both
    packages; ``mesh=0`` opts out even when REPRO_SHARD_DEVICES is set."""
    monkeypatch.setenv("REPRO_SHARD_DEVICES", "8")
    out = []
    for P, mesh in ((J, 0), (T, _mesh(8)), (T, 0)):
        jcat = chain_catalog(seed=9)
        cat = port_catalog(jcat) if P.port else jcat
        t = P.core.Treant(cat, ring=P.sr.SUM, mesh=mesh, **P.kw)
        q = _query(P, cat, "sum")
        t.engine.calibrate(q, batch=True)
        rng = np.random.default_rng(21)
        buf = t.stream("F")
        for _ in range(3):
            n = 40
            buf.append(
                {a: rng.integers(0, cat.get("F").domains[a], n) for a in ("a", "b")},
                measures={"m": rng.integers(0, 16, n).astype(np.float32)},
            )
        mask = np.zeros(cat.get("F").num_rows + buf.pending_appends, bool)
        mask[rng.choice(cat.get("F").num_rows, 25, replace=False)] = True
        buf.delete(mask)
        res = t.flush()
        assert res.relations == ["F"]
        q = q.with_version("F", cat.latest_version("F"))
        shards = t.cache_stats()["plans"]["shard_execs"] if P.port else 0
        out.append((t.engine.execute(q)[0], shards))
    (jf, _), (sharded, n_sharded), (unsharded, n_unsharded) = out
    assert n_sharded > 0 and n_unsharded == 0
    assert_factors_match(jf, sharded, True)
    assert_factors_match(jf, unsharded, True)


def test_sharded_mid_level_abandonment():
    """Abandoning the level iterator mid-pass on a mesh keeps every
    completed level's messages servable, and the finished pass matches the
    reference's single-device messages."""
    mesh = _mesh(8)
    jcat = bushy_catalog(seed=11)
    cat = port_catalog(jcat)
    cat.set_row_placement(dist.row_placement(mesh))
    eng = CJTEngine(jt_from_catalog(cat), cat, sr.SUM, store=MessageStore(), mesh=mesh,
                    device="cpu")
    q = Query.make(cat, ring="sum", measure=("F", "m"), group_by=("c",))
    it = eng.calibrate_levels_iter(q)
    completed = [next(it), next(it)]  # abandon mid-pass
    del it
    placement = eng.place_predicates(q)
    for level in completed:
        for (u, v) in level:
            base = eng.edge_sig(q, u, v, placement)
            assert eng.store.contains(base, eng.gamma_carry(q, u, v)), (
                f"completed-level message {(u, v)} not servable"
            )
    stats = eng.calibrate(q, batch=True)
    assert eng.is_calibrated(q)
    assert stats.messages_reused >= sum(len(lv) for lv in completed)
    assert eng.plans.stats.shard_execs > 0
    ref = JEngine(j_jt(jcat), jcat, jsr.SUM, store=JStore())
    jq = JQuery.make(jcat, ring="sum", measure=("F", "m"), group_by=("c",))
    ref.calibrate(jq, batch=True)
    assert_stores_match(eng, ref, q, jq)


def test_bool_ring_falls_back_unsharded():
    """BOOL has no ⊕-inverse and no min/max collective: the plan cache must
    refuse to shard (correct answers, zero sharded dispatches)."""
    shd, ref, (tcat, jcat) = _engines("chain", "bool", nshards=8)
    assert_factors_match(ref.execute(_query(J, jcat, "bool"))[0],
                         shd.execute(_query(T, tcat, "bool"))[0], True)
    assert shd.plans.stats.shard_execs == 0
    assert shd.plans.stats.allreduce_bytes == 0


@pytest.mark.parametrize("nshards", [3, 1024])
def test_indivisible_row_bucket_runs_unsharded(nshards):
    """A mesh that does not divide a relation's row bucket (a power of two,
    at least 64) leaves that relation's plans unsharded: same bits, zero
    sharded dispatches."""
    shd, ref, (tcat, jcat) = _engines("chain", "sum", nshards)
    tq, jq = _query(T, tcat, "sum"), _query(J, jcat, "sum")
    shd.calibrate(tq, batch=True)
    ref.calibrate(jq, batch=True)
    assert_factors_match(ref.execute(jq)[0], shd.execute(tq)[0], True)
    assert shd.plans.stats.shard_execs == 0


def test_shard_counters_surface_in_cache_stats():
    cat = port_catalog(chain_catalog(seed=3))
    t = Treant(cat, ring=sr.SUM, use_plans=True, mesh=_mesh(8), device="cpu")
    t.engine.execute(_query(T, cat, "sum"))
    st = t.cache_stats()["plans"]
    assert st["shard_execs"] > 0
    assert st["allreduce_bytes"] > 0
    assert st["shard_imbalance"] >= 1.0


def test_allreduce_bytes_count_the_folded_payloads(monkeypatch):
    """``allreduce_bytes`` (summed from the plans' static payloads) equals
    the bytes the ⊕-folds really carried: one partial's leaves per fold,
    counted by wrapping ``dist.allreduce_field``."""
    carried = []
    real = dist.allreduce_field

    def counting(partials, collective):
        out = real(partials, collective)
        leaves = []

        def walk(x):
            if isinstance(x, (tuple, list)):
                for y in x:
                    walk(y)
            elif x is not None:
                leaves.extend(sr.leaves(x.field))

        walk(out)
        carried.append(sum(leaf.numel() * leaf.element_size() for leaf in leaves))
        return out

    monkeypatch.setattr(dist, "allreduce_field", counting)
    shd, _, (tcat, _) = _engines("bushy", "sum", nshards=4)
    q = _query(T, tcat, "sum", "bushy")
    shd.calibrate(q, batch=True)
    shd.execute(q)
    st = shd.plans.stats
    assert len(carried) == st.shard_execs > 0
    assert sum(carried) == st.allreduce_bytes


def test_sharded_session_fanout_matches_reference():
    """Sessions reach sharding only through the Treant's engines: a sharded
    port session (batched sibling absorptions, level-fused calibration)
    renders the reference's unsharded answers, with the same plan counters
    but the shard counters."""
    jcat, tcat = star_catalogs(n_fact=600, seed=4)
    reads, stats = [], []
    for P, cat, mesh in ((J, jcat, 0), (T, tcat, _mesh(4)), (T, port_catalog(jcat), 0)):
        t = P.core.Treant(cat, ring=P.sr.SUM, mesh=mesh, **P.kw)
        V = P.core.VizSpec
        spec = P.core.DashboardSpec(vizzes=(
            V("by_c", measure=("F", "m"), ring="sum", group_by=("c",)),
            V("by_d", measure=("F", "m"), ring="sum", group_by=("d",)),
            V("by_e", measure=("F", "m"), ring="sum", group_by=("e",)),
            V("min_by_c", measure=("F", "m"), ring="tropical_min", group_by=("c",)),
        ))
        sess = t.open_session(spec)
        sess.apply(P.core.SetFilter("a", values=(1, 2, 3, 5), source="by_c"))
        reads.append({v: sess.read(v).factor for v in ("by_c", "by_d", "by_e", "min_by_c")})
        stats.append(t.cache_stats()["plans"] if P.port else None)
    for viz, jf in reads[0].items():
        assert_factors_match(jf, reads[1][viz], True)
        assert_factors_match(jf, reads[2][viz], True)
    sharded, plain = stats[1], stats[2]
    assert sharded["shard_execs"] > 0 and plain["shard_execs"] == 0
    shard_keys = ("shard_execs", "allreduce_bytes", "shard_imbalance")
    assert ({k: v for k, v in sharded.items() if k not in shard_keys}
            == {k: v for k, v in plain.items() if k not in shard_keys})


@pytest.mark.parametrize("width", [2, 5])
def test_sharded_batched_absorptions_match_reference(width):
    """Sibling absorptions through ``execute_many`` run as one sharded batch
    (one level plan per shard) and equal the reference's vmapped batch, bit
    for bit and batch counter for batch counter."""
    jcat, tcat = star_catalogs(seed=width)
    out = []
    for P, cat, kw in ((J, jcat, {}), (T, tcat, {"mesh": _mesh(8)})):
        eng = P.core.CJTEngine(P.core.jt_from_catalog(cat), cat, P.sr.SUM, **kw, **P.kw)
        base = P.core.Query.make(cat, ring="sum", measure=("F", "m"), group_by=("c",))
        qs = [base.with_predicate(P.rel.mask_in(5, [i % 5], attr="d")) for i in range(width)]
        out.append((eng.execute_many(qs), eng.plans.stats))
    (jres, jst), (tres, tst) = out
    for (jf, _), (tf, _) in zip(jres, tres):
        assert_factors_match(jf, tf, True)
    assert tst.batched_execs > 0 and tst.shard_execs > 0
    assert ((tst.batched_execs, tst.batched_absorptions, tst.batch_width)
            == (jst.batched_execs, jst.batched_absorptions, jst.batch_width))


@pytest.mark.parametrize("make", ["engine", "treant", "plan_cache"])
def test_mesh_off_the_engine_device_raises(make):
    """Sharded plans fold onto the engine's device: a mesh whose first
    device is another raises, and nothing is moved."""
    cat = port_catalog(chain_catalog(seed=3))
    mesh = dist.ShardMesh.virtual(2, "meta")
    with pytest.raises(ValueError, match="first device"):
        if make == "engine":
            CJTEngine(jt_from_catalog(cat), cat, sr.SUM, mesh=mesh, device="cpu")
        elif make == "treant":
            Treant(cat, ring=sr.SUM, mesh=mesh, device="cpu")
        else:
            PlanCache(sr.SUM, "cpu", mesh=mesh)


# ---------------------------------------------------------------------------
# the reference's own sharded engine, on 8 forced XLA host devices
# ---------------------------------------------------------------------------

REFERENCE_SCRIPT = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
import numpy as np
import repro.core
from repro.core import CJTEngine, MessageStore, Query, jt_from_catalog
from repro.core import distributed as dist
from repro.core import semiring as sr
from repro.relational.relation import mask_in
from test_level_calibration import SHAPES

out = {}
for shape in ("chain", "bushy"):
    for ring in ("sum", "tropical_min"):
        cat = SHAPES[shape](seed=3)
        mesh = dist.make_engine_mesh(8)
        assert mesh is not None
        cat.set_row_placement(dist.row_placement(mesh))
        eng = CJTEngine(jt_from_catalog(cat), cat, sr.get(ring), store=MessageStore(),
                        mesh=mesh)
        q = Query.make(cat, ring=ring, measure=("F", "m"), group_by=("c",),
                       predicates=(mask_in(cat.get("F").domains["a"], [1, 2, 3], attr="a"),))
        cold = np.asarray(eng.execute(q)[0].field).tolist()
        eng.calibrate(q, batch=True)
        warm = np.asarray(eng.execute(q)[0].field).tolist()
        st = eng.plans.stats
        out[f"{shape}/{ring}"] = dict(cold=cold, warm=warm, shard_execs=st.shard_execs,
                                      allreduce_bytes=st.allreduce_bytes,
                                      shard_imbalance=st.shard_imbalance)
print(json.dumps(out))
"""


def test_reference_sharded_engine_gives_equal_answers_and_counters():
    env = {**os.environ, "PYTHONPATH": f"{SRC}{os.pathsep}{TESTS}", "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", REFERENCE_SCRIPT], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    for key, rec in want.items():
        shape, ring = key.split("/")
        cat = port_catalog(SHAPES[shape](seed=3))
        mesh = _mesh(8)
        cat.set_row_placement(dist.row_placement(mesh))
        eng = CJTEngine(jt_from_catalog(cat), cat, sr.get(ring), store=MessageStore(),
                        mesh=mesh, device="cpu")
        q = Query.make(cat, ring=ring, measure=("F", "m"), group_by=("c",),
                       predicates=(mask_in(cat.get("F").domains["a"], [1, 2, 3], attr="a"),))
        cold = eng.execute(q)[0].field.numpy()
        eng.calibrate(q, batch=True)
        warm = eng.execute(q)[0].field.numpy()
        np.testing.assert_array_equal(cold, np.asarray(rec["cold"], np.float32), err_msg=key)
        np.testing.assert_array_equal(warm, np.asarray(rec["warm"], np.float32), err_msg=key)
        st = eng.plans.stats
        assert (st.shard_execs, st.allreduce_bytes) == (rec["shard_execs"],
                                                         rec["allreduce_bytes"]), key
        assert st.shard_imbalance == pytest.approx(rec["shard_imbalance"], rel=1e-12), key


# ---------------------------------------------------------------------------
# device-free units: collective map, imbalance math, mesh acquisition
# ---------------------------------------------------------------------------

def test_ring_collective_map():
    assert dist.ring_collective(sr.SUM) is torch.add
    assert dist.ring_collective(sr.COUNT) is torch.add
    assert dist.ring_collective(sr.MOMENTS) is torch.add
    assert dist.ring_collective(sr.TROPICAL_MIN) is torch.minimum
    assert dist.ring_collective(sr.TROPICAL_MAX) is torch.maximum
    assert dist.ring_collective(sr.BOOL) is None


def test_shard_imbalance_math():
    # perfectly balanced: 512 rows over 8 shards of a 512 bucket
    assert dist.shard_imbalance(512, 512, 8) == pytest.approx(1.0)
    # 500 rows padded to 512: the fullest shard holds 64/62.5 of its share
    assert dist.shard_imbalance(500, 512, 8) == pytest.approx(512 / 500)
    # tiny relation, one shard does all the work
    assert dist.shard_imbalance(3, 64, 8) == pytest.approx(8.0)
    assert dist.shard_imbalance(100, 128, 1) == 1.0
    assert dist.shard_imbalance(0, 64, 8) == 0.0


def test_make_engine_mesh_disabled(monkeypatch):
    assert dist.make_engine_mesh(0) is None
    assert dist.make_engine_mesh(1) is None
    monkeypatch.delenv("REPRO_SHARD_DEVICES", raising=False)
    assert dist.shard_devices() == 0
    assert dist.make_engine_mesh() is None
    monkeypatch.setenv("REPRO_SHARD_DEVICES", "not-a-number")
    assert dist.shard_devices() == 0
    monkeypatch.setenv("REPRO_SHARD_DEVICES", "8")
    assert dist.shard_devices() == 8
    # the env never gives virtual shards: one CPU device is never 8
    assert dist.make_engine_mesh(device="cpu") is None
    # more shards than cards: sharding silently disables (never an error)
    monkeypatch.setenv("REPRO_SHARD_DEVICES", str((torch.cuda.device_count() + 1) * 1000))
    assert dist.make_engine_mesh() is None


def test_row_blocks_on_another_device_are_copied_once():
    """A mesh over two device types stands in for distinct cards: the block
    on the source tensor's device is a view, the other is copied on the
    first split, reused on the next and dropped with its source."""
    mesh = dist.ShardMesh(("cpu", "meta"))
    src = torch.arange(8, dtype=torch.int32)
    own, other = dist.place_rows(src, mesh)
    assert own.data_ptr() == src.data_ptr() and tuple(own.shape) == (4,)
    assert other.device.type == "meta" and tuple(other.shape) == (4,)
    assert dist.place_rows(src, mesh)[1] is other
    # shard_map splits a row-major argument the same way, replicates the rest
    run = dist.shard_map(lambda rows, whole: (rows, whole), mesh, (dist.SHARD_AXIS, None))
    (rows0, whole0), (rows1, whole1) = run(src, src)
    assert rows0.data_ptr() == src.data_ptr() and rows1 is other
    assert whole0 is src and whole1.device.type == "meta" and tuple(whole1.shape) == (8,)
    placed = len(dist._PLACED)
    del src, own, other, rows0, rows1, whole0, whole1
    gc.collect()
    assert len(dist._PLACED) == placed - 1
    with pytest.raises(ValueError, match="axis"):
        dist.place_rows(torch.zeros(8), mesh, "data")
