"""The serving tier in the port, held against the JAX package.

The scenarios of ``tests/test_serve.py`` on both packages over the same star
catalog (integer measures): N sessions served through one ``TreantServer``
— micro-batches, coalescing, cross-session batched fan-out, the shared
prefetch pool and a store byte budget — read bit-identically to serial
per-session apply, in each package and across packages, with equal serving
counters (coalesced events, batches, cross-session width, pool hits,
evictions) and equal store accounting.  Plus snapshot pinning across ticks,
the learned compaction thresholds and background flushes in ``idle``.
"""

import types
import warnings

import numpy as np
import pytest

from _torch_parity import assert_factors_match, leaves_np, packages, star_catalogs
from _torch_parity import same_union_budget  # noqa: F401 — autouse fixture
import repro.core  # noqa: F401 — import order (core before relational)
import repro.serve as jserve
import repro_torch.serve as tserve
from repro.serve.server import _Pooled as JPooled
from repro_torch.serve.server import _Pooled as TPooled

J, T = packages()


def cat_of(P, n_fact=300, seed=0):
    jcat, tcat = star_catalogs(n_fact=n_fact, seed=seed)
    return tcat if P.port else jcat


def serve(P):
    return tserve if P.port else jserve


def spec_for(P, ring_name):
    measure = None if ring_name == "count" else ("F", "m")
    V = P.core.VizSpec
    return P.core.DashboardSpec(vizzes=(
        V("by_c", measure=measure, ring=ring_name, group_by=("c",)),
        V("by_d", measure=measure, ring=ring_name, group_by=("d",)),
    ))


def treant(P, cat=None, ring="sum", **kw):
    return P.core.Treant(cat_of(P) if cat is None else cat, ring=P.sr.get(ring), **kw, **P.kw)


def brush(P, lo, hi):
    return P.core.SetFilter(attr="a", lo=lo, hi=hi, source="by_c")


def speculating_server(P, t, **kw):
    """A server with the deprecated ``speculate=`` argument (FixedKPrefetch)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return serve(P).TreantServer(t, **kw)


def drain(server):
    while server.queue_depth:
        server.step()


def fact_batch(rng, cat, n):
    rel = cat.get("F")
    return ({a: rng.integers(0, rel.domains[a], n).astype(np.int32) for a in rel.attrs},
            {"m": rng.integers(0, 16, n).astype(np.float32)})


def same(P, f1, f2, exact=True):
    """Two factors of package ``P`` are equal: bit for bit, or to rtol 1e-5
    (MOMENTS)."""
    assert f1.attrs == f2.attrs
    for a, b in zip(leaves_np(f1.field, P.port), leaves_np(f2.field, P.port)):
        if exact:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5)


def both(scenario, *args, exact=True):
    """Run ``scenario(P, *args)`` on both packages; each returns checkpoints
    ``(comparable, [factors])`` that must agree."""
    jout, tout = scenario(J, *args), scenario(T, *args)
    assert len(jout) == len(tout)
    for (jc, jfs), (tc, tfs) in zip(jout, tout):
        assert jc == tc
        assert len(jfs) == len(tfs)
        for jf, tf in zip(jfs, tfs):
            assert_factors_match(jf, tf, exact=exact)
    return tout


SERVE_COUNTERS = ("events_submitted", "events_processed", "batches", "coalesced_events",
                  "rejected_events", "backpressure_drains", "queue_peak",
                  "cross_session_batch_width", "dedup_hits", "shared_prefetch_hits",
                  "pool_cube_hits", "pool_evictions", "background_flushes",
                  "think_time_messages", "errors", "queue_depth", "sessions",
                  "pool_entries")


def counters(server) -> dict:
    st = server.stats()
    return {k: st[k] for k in SERVE_COUNTERS}


# ---------------------------------------------------------------------------
# cross-session batched fan-out ≡ serial per-session apply
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ring_name", ["sum", "tropical_min", "moments"])
def test_cross_session_fanout_matches_serial_apply(ring_name):
    def scenario(P):
        spec = spec_for(P, ring_name)
        t = treant(P, ring=ring_name, use_plans=True)
        server = serve(P).TreantServer(t)
        events = [brush(P, i % 4, i % 4 + 3) for i in range(8)]
        handles = [server.open_session(spec, name=f"s{i}") for i in range(8)]
        for h, ev in zip(handles, events):
            h.submit(ev)
        drain(server)
        assert t.cache_stats()["serve"]["cross_session_batch_width"] > 1
        out = [(counters(server), [])]
        for h, ev in zip(handles, events):
            ref = treant(P, ring=ring_name, use_plans=True).open_session(spec, name="ref")
            ref.apply(ev)
            reads = [h.read(viz).factor for viz in ("by_c", "by_d")]
            for viz, f in zip(("by_c", "by_d"), reads):
                same(P, f, ref.read(viz).factor, exact=ring_name != "moments")
            out.append((h.id, reads))
        return out

    both(scenario, exact=ring_name != "moments")


def test_followup_brushes_and_multi_event_sequences_match_serial():
    def scenario(P):
        spec = spec_for(P, "sum")
        server = serve(P).TreantServer(treant(P, use_plans=True))
        seqs = {
            "s0": [brush(P, 0, 3), brush(P, 4, 7), P.core.ClearFilter(attr="a")],
            "s1": [brush(P, 2, 5), P.core.Undo(), brush(P, 6, 9)],
            "s2": [brush(P, 0, 3), brush(P, 0, 3)],
        }
        handles = {sid: server.open_session(spec, name=sid) for sid in seqs}
        for rnd in range(3):
            for sid, seq in seqs.items():
                if rnd < len(seq):
                    handles[sid].submit(seq[rnd])
            drain(server)
        out = [(counters(server), [])]
        for sid, seq in seqs.items():
            ref = treant(P, use_plans=True).open_session(spec, name="ref")
            for ev in seq:
                ref.apply(ev)
            reads = [handles[sid].read(viz).factor for viz in ("by_c", "by_d")]
            for viz, f in zip(("by_c", "by_d"), reads):
                same(P, f, ref.read(viz).factor)
            out.append((sid, reads))
        return out

    both(scenario)


# ---------------------------------------------------------------------------
# event queue: coalescing, fairness, backpressure
# ---------------------------------------------------------------------------

def test_superseded_events_coalesce_and_are_never_executed():
    def scenario(P):
        spec = spec_for(P, "sum")
        server = serve(P).TreantServer(treant(P, use_plans=True))
        h = server.open_session(spec, name="s")
        for lo in range(5):
            h.submit(brush(P, lo, lo + 3))
        assert server.queue_depth == 1 and server.stats_.coalesced_events == 4
        drain(server)
        ref = treant(P, use_plans=True).open_session(spec, name="ref")
        ref.apply(brush(P, 4, 7))
        same(P, h.read("by_d").factor, ref.read("by_d").factor)
        assert server.stats_.events_processed == 1
        return [(counters(server), [h.read("by_d").factor])]

    both(scenario)


def test_queued_undo_blocks_coalescing():
    def scenario(P):
        spec = spec_for(P, "sum")
        server = serve(P).TreantServer(treant(P, use_plans=True))
        h = server.open_session(spec, name="s")
        for ev in (brush(P, 0, 3), P.core.Undo(), brush(P, 4, 7)):
            h.submit(ev)
        assert server.queue_depth == 3
        drain(server)
        ref = treant(P, use_plans=True).open_session(spec, name="ref")
        for ev in (brush(P, 0, 3), P.core.Undo(), brush(P, 4, 7)):
            ref.apply(ev)
        same(P, h.read("by_d").factor, ref.read("by_d").factor)
        return [(counters(server), [h.read("by_d").factor])]

    both(scenario)


def test_micro_batch_fairness_one_event_per_session():
    def scenario(P):
        spec = spec_for(P, "sum")
        server = serve(P).TreantServer(treant(P, use_plans=True))
        ha = server.open_session(spec, name="a")
        hb = server.open_session(spec, name="b")
        ha.submit(P.core.Drill(viz="by_c", attr="d"))
        ha.submit(P.core.Rollup(viz="by_c", attr="d"))
        ha.submit(P.core.Drill(viz="by_c", attr="e"))
        hb.submit(brush(P, 0, 3))
        n = server.step()
        assert n == 2 and server.stats_.batches == 1
        drain(server)
        assert server.stats_.events_processed == 4
        return [((n, counters(server)), [ha.read("by_c").factor, hb.read("by_d").factor])]

    both(scenario)


def test_backpressure_reject_raises_and_drain_makes_room():
    def scenario(P):
        spec = spec_for(P, "sum")
        S = serve(P)
        server = S.TreantServer(treant(P, use_plans=True), max_queue=2, backpressure="reject")
        h = server.open_session(spec, name="s")
        h.submit(P.core.Drill(viz="by_c", attr="d"))
        h.submit(P.core.Drill(viz="by_c", attr="e"))
        with pytest.raises(S.QueueFull):
            h.submit(P.core.Drill(viz="by_d", attr="e"))
        assert server.stats_.rejected_events == 1
        drain(server)
        server2 = S.TreantServer(treant(P, use_plans=True), max_queue=2, backpressure="drain")
        h2 = server2.open_session(spec, name="s")
        h2.submit(P.core.Drill(viz="by_c", attr="d"))
        h2.submit(P.core.Drill(viz="by_c", attr="e"))
        h2.submit(P.core.Drill(viz="by_d", attr="e"))
        assert server2.stats_.backpressure_drains == 1 and server2.queue_depth <= 2
        drain(server2)
        assert server2.stats_.events_processed == 3
        with pytest.raises(ValueError):
            S.TreantServer(treant(P), backpressure="spill")
        return [((counters(server), counters(server2)),
                 [h2.read("by_c").factor, h2.read("by_d").factor])]

    both(scenario)


# ---------------------------------------------------------------------------
# global byte budget
# ---------------------------------------------------------------------------

def _run_brush_storm(P, max_store_bytes=None, sessions=6):
    spec = spec_for(P, "sum")
    t = treant(P, use_plans=True)
    server = serve(P).TreantServer(t, max_store_bytes=max_store_bytes)
    handles = [server.open_session(spec, name=f"s{i}") for i in range(sessions)]
    for rnd in range(4):
        for i, h in enumerate(handles):
            h.submit(brush(P, (rnd + i) % 9, (rnd + i) % 9 + 3))
        drain(server)
    return t, server, handles


def test_byte_budget_stays_under_budget_and_reads_bit_identical():
    def scenario(P):
        t_free, _, free_handles = _run_brush_storm(P)
        unbudgeted = t_free.store.nbytes
        refs = {(h.id, viz): h.read(viz).factor for h in free_handles for viz in ("by_c", "by_d")}
        t, server, handles = _run_brush_storm(P, max_store_bytes=unbudgeted // 2)
        store = t.store
        assert store.evictions > 0
        assert store.nbytes - store.pinned_nbytes <= store.max_bytes
        assert all(sig in store._data for sig in store._pinned)
        assert store._inflight_depth == 0 and not store._inflight
        reads = []
        for h in handles:
            for viz in ("by_c", "by_d"):
                f = h.read(viz).factor
                same(P, f, refs[(h.id, viz)])
                reads.append(f)
        return [((unbudgeted, store.evictions, store.nbytes, store.pinned_nbytes,
                  counters(server)), reads)]

    both(scenario)


def test_inflight_entries_survive_eviction_inside_a_dispatch():
    def scenario(P):
        spec = spec_for(P, "sum")
        ref = treant(P, use_plans=True).open_session(spec, name="ref")
        server = serve(P).TreantServer(treant(P, use_plans=True), max_store_bytes=1)
        h = server.open_session(spec, name="s")
        h.submit(brush(P, 2, 5))
        drain(server)
        ref.apply(brush(P, 2, 5))
        reads = [h.read(viz).factor for viz in ("by_c", "by_d")]
        for viz, f in zip(("by_c", "by_d"), reads):
            same(P, f, ref.read(viz).factor)
        return [(counters(server), reads)]

    both(scenario)


# ---------------------------------------------------------------------------
# Session.close under sharing: consumer refcounts
# ---------------------------------------------------------------------------

def test_close_does_not_drop_entries_a_live_session_references():
    def scenario(P):
        spec = spec_for(P, "sum")
        t = treant(P, use_plans=True)
        server = serve(P).TreantServer(t)
        ha = server.open_session(spec, name="a")
        hb = server.open_session(spec, name="b")
        ha.submit(brush(P, 1, 4))
        drain(server)
        hb.submit(brush(P, 1, 4))
        drain(server)
        owned_by_a = {s for s, owner in t.store._producer.items() if owner.startswith("a:")}
        shared = {s for s in owned_by_a if "b" in t.store._users.get(s, set())}
        assert shared
        ha.close()
        for sig in shared:
            assert sig in t.store._data and t.store._producer[sig].startswith("b:")
        r = hb.read("by_d")
        assert r.stats.messages_computed == 0
        hb.close()
        assert all(sig not in t.store._data for sig in shared)
        return [((sorted(shared), len(t.store)), [r.factor])]

    both(scenario)


def test_interleaved_open_close_cycles_stay_consistent():
    def scenario(P):
        spec = spec_for(P, "sum")
        t = treant(P, use_plans=True)
        server = serve(P).TreantServer(t)
        ref = treant(P, use_plans=True).open_session(spec, name="ref")
        ref.apply(brush(P, 3, 6))
        live = {}
        for cycle in range(4):
            sid = f"g{cycle}"
            live[sid] = server.open_session(spec, name=sid)
            live[sid].submit(brush(P, 3, 6))
            drain(server)
            if cycle % 2 == 1:
                live.pop(f"g{cycle - 1}").close()
            for h in live.values():
                same(P, h.read("by_d").factor, ref.read("by_d").factor)
        for h in list(live.values()):
            h.close()
        assert len(server.sessions) == 0
        closed = {f"g{c}:" for c in range(4)}
        for sig, owner in t.store._producer.items():
            assert sig in t.store._data
            assert not any(owner.startswith(p) for p in closed) or sig in t.store._pinned
        return [((len(t.store), len(t.store._pinned)), [ref.read("by_d").factor])]

    both(scenario)


# ---------------------------------------------------------------------------
# commit_log retention + snapshot-read pinning
# ---------------------------------------------------------------------------

def test_commit_log_trims_unpinned_but_keeps_pinned_snapshots():
    def scenario(P):
        cat = cat_of(P)
        cat.commit_retention = 8
        t = treant(P, cat, use_plans=False, compaction_threshold=0.0)
        rng = np.random.default_rng(3)
        pinned_wm = cat.pin_watermark()
        pinned_snapshot = dict(cat._latest)
        for _ in range(20):
            codes, meas = fact_batch(rng, cat, 5)
            t.stream("F").append(codes, measures=meas)
            t.flush()
        logged = dict(cat.commit_log)
        assert pinned_wm in logged and logged[pinned_wm] == pinned_snapshot
        assert len(cat.commit_log) > cat.commit_retention
        cat.release_watermark(pinned_wm)
        assert len(cat.commit_log) <= cat.commit_retention
        assert pinned_wm not in dict(cat.commit_log)
        return [(list(cat.commit_log), [])]

    both(scenario)


def test_snapshot_read_context_and_refcounted_pins():
    def scenario(P):
        cat = cat_of(P)
        cat.commit_retention = 2
        t = treant(P, cat, use_plans=False, compaction_threshold=0.0)
        rng = np.random.default_rng(4)
        with cat.snapshot_read() as (wm, versions):
            assert cat.pin_watermark(wm) == wm
            for _ in range(6):
                codes, meas = fact_batch(rng, cat, 5)
                t.stream("F").append(codes, measures=meas)
                t.flush()
            assert dict(cat.commit_log)[wm] == versions
        assert wm in dict(cat.commit_log)
        cat.release_watermark(wm)
        assert wm not in dict(cat.commit_log) and len(cat.commit_log) <= cat.commit_retention
        return [((wm, list(cat.commit_log)), [])]

    both(scenario)


def test_server_sessions_pin_their_read_watermark_across_ticks():
    def scenario(P):
        spec = spec_for(P, "sum")
        cat = cat_of(P)
        cat.commit_retention = 2
        t = treant(P, cat, use_plans=True, compaction_threshold=0.0)
        server = serve(P).TreantServer(t)
        h = server.open_session(spec, name="s")
        opened_at = h._pinned_wm
        rng = np.random.default_rng(5)
        for _ in range(5):
            codes, meas = fact_batch(rng, cat, 5)
            t.stream("F").append(codes, measures=meas)
            t.flush()
        assert opened_at in dict(cat.commit_log)
        h.submit(brush(P, 0, 3))
        drain(server)
        assert h._pinned_wm == cat.watermark and opened_at not in dict(cat.commit_log)
        reads = [h.read("by_d").factor]
        h.close()
        return [((opened_at, cat.watermark), reads)]

    both(scenario)


# ---------------------------------------------------------------------------
# per-relation compaction thresholds (learned delete mix)
# ---------------------------------------------------------------------------

def test_compaction_policy_learns_per_relation_delete_mix():
    out = []
    for P in (J, T):
        pol = P.stream.CompactionPolicy()
        base = 0.25
        assert pol.threshold("F", base) == base
        for _ in range(8):
            pol.observe("heavy", n_app=1, n_del=9)
            pol.observe("light", n_app=9, n_del=1)
        assert pol.threshold("heavy", base) < base < pol.threshold("light", base)
        assert pol.threshold("heavy", base) >= base * 0.5
        assert pol.threshold("light", base) <= min(0.9, base * 1.5)
        assert pol.threshold("anything", 0.0) == 0.0
        out.append((pol.threshold("heavy", base), pol.threshold("light", base),
                    pol.state(base)))
    assert out[0] == out[1]


def test_delete_heavy_relation_compacts_earlier_than_append_mostly():
    def scenario(P):
        cat = cat_of(P, n_fact=400)
        t = treant(P, cat, use_plans=False, compaction_threshold=0.25)
        rng = np.random.default_rng(9)
        compacted: dict[str, int] = {}
        for tick in range(12):
            buf = t.stream("F")
            codes, meas = fact_batch(rng, cat, 4)
            buf.append(codes, measures=meas)
            live = np.flatnonzero(buf.base._materialized_weights() != 0.0)
            mask = np.zeros(buf.base.num_rows + buf.pending_appends, bool)
            mask[rng.choice(live, 20, replace=False)] = True
            buf.delete(mask)
            for c in t.flush().compactions:
                compacted.setdefault(c.relation, tick)
        assert "F" in compacted
        thr = t.compaction_policy.threshold("F", t.compaction_threshold)
        assert thr < t.compaction_threshold
        return [((compacted, thr), [])]

    both(scenario)


# ---------------------------------------------------------------------------
# server-driven think-time: background flush, scheduler drain, shared pool
# ---------------------------------------------------------------------------

def test_idle_runs_background_flush_and_unturn_watermark_reads():
    def scenario(P):
        spec = spec_for(P, "sum")
        cat = cat_of(P)
        t = treant(P, cat, use_plans=True, compaction_threshold=0.0)
        server = serve(P).TreantServer(t)
        handles = [server.open_session(spec, name=f"s{i}") for i in range(3)]
        rng = np.random.default_rng(11)
        out = []
        for rnd in range(3):
            buf = t.stream("F")
            codes, meas = fact_batch(rng, cat, 10)
            buf.append(codes, measures=meas)
            for i, h in enumerate(handles):
                h.submit(brush(P, (rnd + i) % 6, (rnd + i) % 6 + 3))
            drain(server)
            assert buf.has_pending
            server.idle()
            assert not buf.has_pending
            reads = []
            for h in handles:
                q = h.query_of("by_d")
                assert q.version_of("F") == cat.latest_version("F")
                cold = P.core.CJTEngine(t.jt, cat, t.engine.ring, store=P.core.MessageStore(),
                                        use_plans=False, **P.kw)
                ref, _ = cold.execute(q)
                f = h.read("by_d").factor
                same(P, f, ref)
                reads.append(f)
            out.append((counters(server), reads))
        assert server.stats_.background_flushes == 3
        return out

    both(scenario)


def test_idle_drains_think_time_and_shared_pool_serves_sibling_sessions():
    def scenario(P):
        spec = spec_for(P, "sum")
        server = speculating_server(P, treant(P, use_plans=True), speculate=4)
        ha = server.open_session(spec, name="a")
        hb = server.open_session(spec, name="b")
        ha.submit(brush(P, 3, 6))
        drain(server)
        server.idle()
        assert len(server._pool) > 0
        before = server.stats_.shared_prefetch_hits
        hb.submit(brush(P, 6, 9))
        drain(server)
        assert server.stats_.shared_prefetch_hits > before
        ref = treant(P, use_plans=True).open_session(spec, name="ref")
        ref.apply(brush(P, 6, 9))
        same(P, hb.read("by_d").factor, ref.read("by_d").factor)
        return [((sorted(server._pool), counters(server)), [hb.read("by_d").factor])]

    both(scenario)


def test_pool_eviction_keeps_just_hit_entry_fifo_would_drop():
    def scenario(P):
        spec = spec_for(P, "sum")
        server = speculating_server(P, treant(P, use_plans=True), speculate=4,
                                    pool_capacity=4)
        ha = server.open_session(spec, name="a")
        hb = server.open_session(spec, name="b")
        ha.submit(brush(P, 3, 6))
        drain(server)
        server.idle()
        oldest = next(iter(server._pool))
        hb.submit(brush(P, 6, 9))
        drain(server)
        assert server.stats_.shared_prefetch_hits > 0
        assert [d for d, p in server._pool.items() if p.hot] == [oldest]
        ha.submit(brush(P, 0, 3))
        hb.submit(brush(P, 12, 15))
        drain(server)
        server.idle()
        assert server.stats_.pool_evictions > 0 and oldest in server._pool
        return [((oldest, list(server._pool), counters(server)), [])]

    both(scenario)


def test_pool_eviction_orders_by_cost_and_never_drops_hot_entries():
    def scenario(P):
        S = serve(P)
        pooled = TPooled if P.port else JPooled
        server = S.TreantServer(treant(P, use_plans=True), pool_capacity=3)
        for d, c in {"d1": 0.0, "d2": 1.0, "d3": 4.0, "d4": 2.0, "d5": 3.0}.items():
            server._pool[d] = pooled(None, None, cost=c, hot=(d == "d1"))
        server._absorb_prefetch(types.SimpleNamespace(_prefetched={}))
        assert set(server._pool) == {"d1", "d3", "d5"}
        assert server.stats_.pool_evictions == 2
        for p in server._pool.values():
            p.hot = True
        server._pool["d6"] = pooled(None, None, cost=0.0, hot=True)
        server._absorb_prefetch(types.SimpleNamespace(_prefetched={}))
        assert len(server._pool) == 4 and server.stats_.pool_evictions == 2
        return [(list(server._pool), [])]

    both(scenario)


def test_recompute_cost_prices_the_query_join_and_a_missing_version_at_zero():
    """The pool's eviction cost is the rows the query's join sees; a
    relation version the catalog does not hold prices at 0 (the one
    exception the cost swallows)."""
    def scenario(P):
        cat = cat_of(P)
        t = treant(P, cat, use_plans=True)
        server = serve(P).TreantServer(t)
        q = P.core.Query.make(cat, ring="sum", measure=("F", "m"), group_by=("c",))
        blind = q.with_relation_toggled("U")
        missing = q.with_version("F", "no-such-version")
        costs = [server._recompute_cost(x) for x in (q, blind, missing)]
        assert costs[0] == sum(cat.get(r).num_rows for r in cat.names())
        assert costs[1] == costs[0] - cat.get("U").num_rows and costs[2] == 0.0
        return [(costs, [])]

    both(scenario)


def test_serve_counters_surface_in_cache_stats():
    def scenario(P):
        spec = spec_for(P, "sum")
        t = treant(P, use_plans=True)
        server = serve(P).TreantServer(t, max_store_bytes=1 << 20)
        h = server.open_session(spec, name="s")
        h.submit(brush(P, 0, 3))
        drain(server)
        st = t.cache_stats()["serve"]
        for key in ("queue_depth", "coalesced_events", "cross_session_batch_width",
                    "store_evictions", "bytes_held", "bytes_pinned", "byte_budget",
                    "sessions", "events_processed", "batches"):
            assert key in st, key
        assert st["sessions"] == 1 and st["events_processed"] == 1
        assert st["byte_budget"] == 1 << 20
        return [(st, [])]

    both(scenario)

