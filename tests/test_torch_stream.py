"""Streaming ingestion in the port, held against the JAX package.

The scenarios of ``tests/test_stream_ingest.py`` on both packages over the
same star catalog and the same micro-batches: after every ``flush`` tick the
maintained reads must be bit-identical across packages and to the port's
cold rebuild over the committed versions (stream ≡ rebuild), with equal
``IngestStats``, ``UpdateResult`` counts, ``DeltaStats``, watermarks, relation
versions and query digests.  Group rings absorb signed deltas; MIN/MAX absorb
tombstoned deltas and recalibrate only at compaction.  A reader inside a
flush sees the complete pre-tick watermark, and union-carry pins migrate
without leaking.
"""

import dataclasses

import numpy as np
import pytest

from _torch_parity import assert_factors_match, packages, star_catalogs
from _torch_parity import same_union_budget  # noqa: F401 — autouse fixture
import repro.core  # noqa: F401 — import order (core before relational)

J, T = packages()


def fact_batch(rng, cat, n):
    rel = cat.get("F")
    return (
        {a: rng.integers(0, rel.domains[a], n).astype(np.int32) for a in rel.attrs},
        {"m": rng.integers(0, 16, n).astype(np.float32)},
    )


def spec_for(P, ring_name):
    measure = None if ring_name == "count" else ("F", "m")
    return P.core.DashboardSpec(vizzes=(
        P.core.VizSpec("by_c", measure=measure, ring=ring_name, group_by=("c",)),
        P.core.VizSpec("by_d", measure=measure, ring=ring_name, group_by=("d",)),
    ))


def cold_read(P, t, q):
    """``q`` on a from-scratch plain engine over the committed catalog."""
    eng = P.core.CJTEngine(t.jt, t.catalog, t.engine_for(q.ring_name, q.measure).ring,
                           store=P.core.MessageStore(), use_plans=False, **P.kw)
    return eng.execute(q)[0]


def summary(res) -> tuple:
    """A FlushResult's counts and versions, comparable across packages."""
    def upd(u):
        return (u.relation, u.new_version, u.queries_maintained, u.queries_fallback,
                [dataclasses.asdict(s) for s in u.stats])
    return res.watermark, [upd(u) for u in res.updates], [upd(u) for u in res.compactions]


def both(scenario, seed, n_fact=300):
    """Run ``scenario(P, cat)`` on both packages; it returns a list of
    checkpoints, each ``(comparable, [factors])``."""
    jcat, tcat = star_catalogs(n_fact=n_fact, seed=seed)
    jout, tout = scenario(J, jcat), scenario(T, tcat)
    assert len(jout) == len(tout)
    for (jc, jfs), (tc, tfs) in zip(jout, tout):
        assert jc == tc
        for jf, tf in zip(jfs, tfs):
            assert_factors_match(jf, tf, exact=True)
    return tout


def reads(P, t, sess, vizzes=("by_c", "by_d")):
    """Read every viz: a warm read executes no message, and on the port it
    equals a cold rebuild bit for bit (the reference's reads are then held
    against the port's by ``both``)."""
    fs, digests = [], []
    for viz in vizzes:
        r = sess.read(viz)
        assert r.stats.messages_computed == 0, f"warm read of {viz} recomputed"
        q = sess.query_of(viz)
        if P.port:
            _same(cold_read(P, t, q), r.factor)
        fs.append(r.factor)
        digests.append(q.digest)
    return fs, digests


def _same(a, b):
    """Two port factors, bit for bit."""
    assert a.attrs == b.attrs
    for x, y in zip(T.sr.leaves(a.field), T.sr.leaves(b.field)):
        assert x.shape == y.shape and bool((x == y).all())


@pytest.mark.parametrize("ring_name", ["sum", "count", "moments"])
def test_stream_flush_matches_rebuild_group_rings(ring_name):
    """Micro-batched appends + deletes over three ticks: after each flush the
    warm maintained read equals a cold rebuild and executes nothing."""

    def scenario(P, cat):
        rng = np.random.default_rng(3)
        t = P.core.Treant(cat, ring=P.sr.get(ring_name), compaction_threshold=0.0, **P.kw)
        sess = t.open_session(spec_for(P, ring_name), name="s")
        out = []
        for tick in range(3):
            buf = t.stream("F")
            for _ in range(4):  # several micro-batches, ONE delta per tick
                codes, meas = fact_batch(rng, cat, 25)
                buf.append(codes, measures=meas)
            mask = np.zeros(buf.base.num_rows + buf.pending_appends, bool)
            mask[rng.choice(buf.base.num_rows, 6, replace=False)] = True
            mask[buf.base.num_rows + rng.choice(buf.pending_appends, 5, replace=False)] = True
            buf.delete(mask)
            res = t.flush()
            assert res.relations == ["F"]
            (upd,) = res.updates
            assert upd.queries_fallback == 0 and upd.queries_maintained > 0
            fs, digests = reads(P, t, sess)
            out.append(((summary(res), digests), fs))
        assert t.ingest.rows_cancelled == 3 * 5 and t.ingest.rows_deleted == 3 * 6
        out.append((dataclasses.asdict(t.ingest), []))
        sess.close()
        return out

    both(scenario, seed=1)


def test_stream_mixed_delta_with_explicit_weights():
    """Weighted appends coalesce with deletes into one mixed delta whose
    negated-weight rows are the exact ⊕-inverse under SUM."""

    def scenario(P, cat):
        rng = np.random.default_rng(11)
        t = P.core.Treant(cat, ring=P.sr.SUM, use_plans=False, compaction_threshold=0.0,
                          **P.kw)
        sess = t.open_session(spec_for(P, "sum"), name="s")
        buf = t.stream("F")
        codes, meas = fact_batch(rng, cat, 30)
        buf.append(codes, measures=meas, weights=np.full(30, 2.0, np.float32))
        mask = np.zeros(buf.base.num_rows + 30, bool)
        mask[:8] = True
        buf.delete(mask)
        res = t.flush()
        assert res.updates[0].queries_fallback == 0
        fs, digests = reads(P, t, sess)
        sess.close()
        return [((summary(res), digests), fs)]

    both(scenario, seed=2)


def test_coalescing_invariant_counters_and_watermark():
    """T ticks over R=2 streamed relations: T·R bumps and sweeps however many
    micro-batches, one watermark per tick, and an empty flush is free."""

    def scenario(P, cat):
        rng = np.random.default_rng(5)
        t = P.core.Treant(cat, ring=P.sr.SUM, use_plans=False, compaction_threshold=0.0,
                          **P.kw)
        t.open_session(spec_for(P, "sum"), name="s")
        wm0 = t.catalog.watermark
        ticks = 3
        out = []
        for _ in range(ticks):
            for _ in range(5):
                codes, meas = fact_batch(rng, cat, 10)
                t.stream("F").append(codes, measures=meas)
                s_rel = t.stream("S").base
                t.stream("S").append({a: rng.integers(0, s_rel.domains[a], 4).astype(np.int32)
                                      for a in s_rel.attrs})
            res = t.flush()
            assert sorted(res.relations) == ["F", "S"]
            out.append((summary(res), []))
        assert t.ingest.ticks == ticks
        assert t.ingest.version_bumps == t.ingest.delta_sweeps == ticks * 2
        assert t.catalog.watermark == wm0 + ticks
        assert t.ingest.rows_appended == ticks * (5 * 10 + 5 * 4)
        res = t.flush()
        assert res.updates == [] and res.compactions == []
        assert t.catalog.watermark == wm0 + ticks and t.ingest.ticks == ticks
        out.append((dataclasses.asdict(t.ingest), []))
        return out

    both(scenario, seed=3)


@pytest.mark.parametrize("ring_name", ["tropical_min", "tropical_max"])
def test_min_max_delete_stream_recalibrates_only_at_compaction(ring_name):
    """Delete streams against MIN/MAX: every regular tick absorbs the
    tombstoned delta (no fallback, no calibration dispatch); the one real
    recalibration happens at compaction and lands in think-time."""

    def scenario(P, cat):
        rng = np.random.default_rng(7)
        t = P.core.Treant(cat, ring=P.sr.get(ring_name), compaction_threshold=0.25, **P.kw)
        sess = t.open_session(spec_for(P, ring_name), name="s")
        q0 = sess.query_of("by_c")
        dispatches0 = t.cache_stats()["plans"]["calibration_dispatches"]
        out, compacted_at = [], None
        for tick in range(6):
            buf = t.stream("F")
            codes, meas = fact_batch(rng, cat, 12)
            buf.append(codes, measures=meas)
            live = np.flatnonzero(buf.base._materialized_weights() != 0.0)
            mask = np.zeros(buf.base.num_rows + buf.pending_appends, bool)
            mask[rng.choice(live, 30, replace=False)] = True
            buf.delete(mask)
            res = t.flush()
            (upd,) = res.updates
            assert upd.queries_fallback == 0, f"tick {tick} fell back"
            fs, digests = reads(P, t, sess)
            out.append(((summary(res), digests), fs))
            if res.compactions:
                compacted_at = tick
                break
            assert t.cache_stats()["plans"]["calibration_dispatches"] == dispatches0
        assert compacted_at is not None
        (cupd,) = res.compactions
        assert cupd.queries_fallback > 0 and t.ingest.compactions == 1
        rel = t.catalog.get("F")
        assert rel.tombstone_count == 0
        sess.idle()  # drain the deprioritized recalibration
        q1 = sess.query_of("by_c")
        assert q1.version_of("F") == rel.version and q0.digest != q1.digest
        assert t.cache_stats()["plans"]["calibration_dispatches"] > dispatches0
        fs, digests = reads(P, t, sess)
        out.append(((compacted_at, digests, dataclasses.asdict(t.ingest)), fs))
        sess.close()
        return out

    both(scenario, seed=4, n_fact=400)


def test_group_ring_compaction_rekeys_without_fallback():
    """Under SUM the empty compaction delta re-keys the n−1 messages:
    maintained, no fallback, nothing recomputed, results bit-identical."""

    def scenario(P, cat):
        rng = np.random.default_rng(13)
        t = P.core.Treant(cat, ring=P.sr.SUM, use_plans=False, compaction_threshold=0.1,
                          **P.kw)
        sess = t.open_session(spec_for(P, "sum"), name="s")
        buf = t.stream("F")
        mask = np.zeros(buf.base.num_rows, bool)
        mask[rng.choice(buf.base.num_rows, 60, replace=False)] = True
        buf.delete(mask)
        res = t.flush()
        (cupd,) = res.compactions
        assert cupd.queries_fallback == 0 and cupd.queries_maintained > 0
        assert t.catalog.get("F").tombstone_count == 0
        fs, digests = reads(P, t, sess)
        sess.close()
        return [((summary(res), digests), fs)]

    both(scenario, seed=6)


def test_mid_flush_reader_sees_complete_pre_tick_watermark(monkeypatch):
    """Snapshot the catalog's latest pointers from inside every apply_delta
    of a two-relation tick: each equals the complete pre-tick commit, and a
    query derived mid-flush executes against pre-tick data."""
    jcat, cat = star_catalogs(seed=8)
    t = T.core.Treant(cat, ring=T.sr.SUM, use_plans=False, compaction_threshold=0.0, **T.kw)
    t.open_session(spec_for(T, "sum"), name="s")
    pre = {n: cat.latest_version(n) for n in cat.names()}
    wm_pre = cat.watermark

    def q_now():
        return T.core.Query.make(cat, ring="sum", measure=("F", "m"), group_by=("c",))

    want = cold_read(T, t, q_now())
    snapshots, mid = [], []
    orig = T.core.CJTEngine.apply_delta

    def spying_apply_delta(self, q, delta):
        snapshots.append({n: cat.latest_version(n) for n in cat.names()})
        mid.append(cold_read(T, t, q_now()))
        return orig(self, q, delta)

    monkeypatch.setattr(T.core.CJTEngine, "apply_delta", spying_apply_delta)
    rng = np.random.default_rng(17)
    codes, meas = fact_batch(rng, cat, 20)
    t.stream("F").append(codes, measures=meas)
    s_rel = t.stream("S").base
    t.stream("S").append({a: rng.integers(0, s_rel.domains[a], 6).astype(np.int32)
                          for a in s_rel.attrs})
    res = t.flush()
    monkeypatch.setattr(T.core.CJTEngine, "apply_delta", orig)
    assert len(res.updates) == 2 and snapshots
    logged = dict(cat.commit_log)
    for snap in snapshots:
        assert snap == pre == logged[wm_pre]
    for f in mid:
        _same(f, want)
    assert res.watermark == wm_pre + 1 == cat.watermark
    post = {n: cat.latest_version(n) for n in cat.names()}
    assert dict(cat.commit_log)[res.watermark] == post
    assert post["F"] != pre["F"] and post["S"] != pre["S"]
    # the same tick on the reference commits the same versions
    jt = J.core.Treant(jcat, ring=J.sr.SUM, use_plans=False, compaction_threshold=0.0)
    jt.open_session(spec_for(J, "sum"), name="s")
    rng = np.random.default_rng(17)
    codes, meas = fact_batch(rng, jcat, 20)
    jt.stream("F").append(codes, measures=meas)
    jt.stream("S").append({a: rng.integers(0, s_rel.domains[a], 6).astype(np.int32)
                           for a in s_rel.attrs})
    jres = jt.flush()
    assert summary(jres) == summary(res)
    assert {n: jcat.latest_version(n) for n in jcat.names()} == post


def test_stream_ticks_migrate_union_pins_no_leak():
    """The pinned union-carry queries' pins migrate (not multiply) across
    coalesced ticks, and close() releases every one."""

    def scenario(P, cat):
        rng = np.random.default_rng(19)
        t = P.core.Treant(cat, ring=P.sr.SUM, batch_calibration=True,
                          compaction_threshold=0.0, **P.kw)
        sess = t.open_session(spec_for(P, "sum"), name="s")
        pinned0 = len(t.store._pinned)
        assert pinned0
        out = []
        for _ in range(3):
            buf = t.stream("F")
            codes, meas = fact_batch(rng, cat, 15)
            buf.append(codes, measures=meas)
            mask = np.zeros(buf.base.num_rows + 15, bool)
            mask[rng.choice(buf.base.num_rows, 3, replace=False)] = True
            buf.delete(mask)
            res = t.flush()
            assert res.updates[0].queries_fallback == 0
            assert len(t.store._pinned) <= pinned0, "tick multiplied pins"
            out.append(((summary(res), sorted(t.store._pinned.items())), []))
        fs, digests = reads(P, t, sess)
        out.append((digests, fs))
        sess.close()
        assert not t.store._pinned, "stream ticks + close leaked pins"
        return out

    both(scenario, seed=9)


def test_stream_buffer_cancellation_and_empty_tick():
    _, cat = star_catalogs(seed=10)
    buf = T.stream.StreamBuffer(cat.get("F"))
    rng = np.random.default_rng(23)
    rel = cat.get("F")
    codes = {a: rng.integers(0, rel.domains[a], 8).astype(np.int32) for a in rel.attrs}
    buf.append(codes, measures={"m": np.arange(8, dtype=np.float32)})
    mask = np.zeros(rel.num_rows + 8, bool)
    mask[rel.num_rows:] = True
    buf.delete(mask)  # delete every appended row within the tick: full cancellation
    base, delta = buf.coalesce()
    assert delta is None and base is rel
    assert buf.stats.rows_cancelled == 8 and buf.stats.ticks == 0
    buf.delete(np.arange(rel.num_rows) < 4)
    new_rel, d = buf.coalesce()
    assert d is not None and d.tombstoned and new_rel.tombstone_count == 4
    # the same coalesced tick on the reference: equal versions
    jbuf = J.stream.StreamBuffer(star_catalogs(seed=10)[0].get("F"))
    jbuf.delete(np.arange(rel.num_rows) < 4)
    jnew, jd = jbuf.coalesce()
    assert (jnew.version, jd.rows.version, jd.kind) == (new_rel.version, d.rows.version, d.kind)
    buf2 = T.stream.StreamBuffer(new_rel)
    assert buf2.tombstone_fraction() == pytest.approx(4 / new_rel.num_rows)
    assert buf2.delete(np.arange(new_rel.num_rows) < 4) == 0  # re-deleting a tombstone
    base, delta = buf2.coalesce()
    assert delta is None
    with pytest.raises(ValueError):
        buf2.append({"a": np.zeros(2, np.int32)})
    with pytest.raises(ValueError):
        buf2.append({a: np.zeros(2, np.int32) for a in rel.attrs})
    buf2.append({a: np.zeros(2, np.int32) for a in rel.attrs},
                measures={"m": np.zeros(2, np.float32)})
    with pytest.raises(ValueError):
        buf2.rebase(rel)  # pending batches would misalign


def test_flush_result_and_ingest_stats_surfaces():
    def scenario(P, cat):
        rng = np.random.default_rng(29)
        t = P.core.Treant(cat, ring=P.sr.SUM, use_plans=False, compaction_threshold=0.0,
                          **P.kw)
        codes, meas = fact_batch(rng, cat, 5)
        t.stream("F").append(codes, measures=meas)
        res = t.flush()
        assert res.relations == ["F"] and res.watermark == t.catalog.watermark
        st = t.cache_stats()
        assert st["watermark"] == t.catalog.watermark
        expected = dataclasses.asdict(t.ingest)
        expected["compaction"] = t.compaction_policy.state(t.compaction_threshold)
        assert st["ingest"] == expected
        assert st["ingest"]["version_bumps"] == 1
        assert st["ingest"]["compaction"] == {"F": {"ewma": 0.0, "threshold": 0.0}}
        return [((summary(res), st["ingest"]), [])]

    both(scenario, seed=12)
