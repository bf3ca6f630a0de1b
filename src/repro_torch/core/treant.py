"""Treant middleware (paper §4): dashboards, sessions, think-time calibration,
live data.

The public surface is the declarative session layer in
:mod:`repro_torch.core.dashboard`: ``open_session(DashboardSpec)`` returns a
:class:`~repro_torch.core.dashboard.Session` whose typed events (SetFilter,
Drill, …) fan out over linked vizzes sharing one engine per ring, one
:class:`~repro_torch.core.calibration.MessageStore` and plan cache, and whose
think-time calibration runs on the shared
:class:`~repro_torch.core.dashboard.ThinkTimeScheduler`.

``register_dashboard`` / ``interact`` / ``think_time`` / ``read`` are thin
legacy wrappers over that layer: each legacy session name maps to a
spec-less Session whose vizzes are seeded from the registered dashboard
queries.

Live data:

- ``update(new_rel, delta)`` maintains every tracked query's cached CJT
  (``CJTEngine.apply_delta``: old message ⊕ ΔY under the bumped signature),
  commits the new version and re-snapshots every stored query, so the next
  interaction reads fresh data at cache-hit speed.  Rings that cannot absorb
  a delta (MIN/MAX deletes) skip maintenance; their recalibration is
  re-queued on the scheduler.
- ``stream(relation)`` buffers append/delete micro-batches; ``flush()``
  coalesces each buffer into ONE signed delta per tick, maintains, commits
  every relation under one catalog watermark, and compacts tombstones once
  a relation's tombstone fraction crosses its threshold.

Multi-ring dashboards: the primary engine serves its own ring (and
measure-free COUNT queries when the primary ring is SUM); any other ring
gets a lazily created sibling engine sharing the same MessageStore.  Prop-2
signatures include the ring name, so the shared store never serves one
ring's message to another.

Every engine runs on ``device`` (default ``cuda``; without a card the
caller must pass ``device="cpu"``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Mapping

import torch

from repro_torch.relational.relation import Catalog, Delta, Relation
from repro_torch.relational.stream import CompactionPolicy, StreamBuffer
from . import distributed as dist
from . import semiring as sr
from .calibration import CJTEngine, DeltaStats, ExecStats, MessageStore, synchronize
from .dashboard import (
    ApplyResult,
    DashboardSpec,
    InteractionResult,
    Session,
    ThinkTimeScheduler,
    VizSpec,
)
from .hypertree import JTree, jt_from_catalog
from .plans import (
    PlanStats,
    batch_calibration_default,
    batch_fanout_default,
    fuse_level_default,
    resolve_device,
    use_plans_default,
)
from .predictive import DrainCalibration, ThinkTimeBudget, ThinkTimePolicy
from .query import Query

__all__ = [
    "Treant", "InteractionResult", "UpdateResult", "FlushResult", "IngestStats",
    "ApplyResult", "DashboardSpec", "VizSpec", "Session", "ThinkTimeScheduler",
]


def compaction_threshold_default() -> float:
    """Tombstone fraction that triggers compaction at flush
    (``REPRO_COMPACTION_THRESHOLD``, default 0.25; <= 0 disables)."""
    try:
        return float(os.environ.get("REPRO_COMPACTION_THRESHOLD", "0.25"))
    except ValueError:  # pragma: no cover — malformed env
        return 0.25


@dataclasses.dataclass
class UpdateResult:
    relation: str
    new_version: str
    queries_maintained: int   # distinct cached CJTs updated via delta calibration
    queries_fallback: int     # CJTs that must recalibrate (no ⊕-inverse, σ moved)
    stats: list[DeltaStats]


@dataclasses.dataclass
class IngestStats:
    """Cumulative streaming-ingestion counters (the coalescing invariants).

    After T flush ticks over R streamed relations,
    ``version_bumps == delta_sweeps == T·R`` however many micro-batches each
    tick buffered; every ``update`` and every compaction adds one bump and
    one sweep of its own (compactions are also counted in ``compactions``).
    """

    ticks: int = 0            # flush() calls that committed at least one delta
    version_bumps: int = 0    # committed relation version advances
    delta_sweeps: int = 0     # apply_delta maintenance sweeps (one per relation per tick)
    rows_appended: int = 0
    rows_deleted: int = 0     # tombstoned
    rows_cancelled: int = 0   # same-tick append+delete (never materialized)
    compactions: int = 0


@dataclasses.dataclass
class FlushResult:
    """Outcome of one ``Treant.flush`` tick."""

    watermark: int                    # catalog watermark after the commit
    updates: list[UpdateResult]       # one per relation with pending batches
    compactions: list[UpdateResult]   # tombstone reclaims triggered this tick

    @property
    def relations(self) -> list[str]:
        return [u.relation for u in self.updates]


class Treant:
    """Dashboard accelerator managing CJTs over one join graph.

    ``lifts`` are custom per-relation lifts, handed to every engine
    (``CJTEngine``).  ``batch_fanout`` absorbs sibling vizzes of one event
    together (``CJTEngine.execute_many``); ``compaction_threshold`` is the
    tombstone fraction at which ``flush`` compacts a streamed relation (≤ 0:
    never), adjusted per relation by ``compaction_policy``.  ``None``
    resolves each knob from the env: ``REPRO_USE_PLANS``,
    ``REPRO_BATCH_FANOUT``, ``REPRO_BATCH_CALIBRATION``,
    ``REPRO_FUSE_LEVEL_KERNEL`` (on unless 0) and
    ``REPRO_COMPACTION_THRESHOLD`` (0.25); an explicit argument wins.

    ``mesh`` row-shards every engine's fact scans: a
    ``distributed.ShardMesh`` (``ShardMesh.virtual(k, device)`` puts k
    shards on one device, ``ShardMesh.cards(k)`` one shard per card);
    ``None`` reads ``REPRO_SHARD_DEVICES`` (a mesh over that many distinct
    cards, or none when fewer are present); ``0`` or ``False`` opts out.
    ``device`` defaults to the mesh's first device and must be that device.
    """

    def __init__(
        self,
        catalog: Catalog,
        ring: sr.Semiring = sr.SUM,
        jt: JTree | None = None,
        lifts: Mapping[str, Callable] | None = None,
        max_cache_bytes: int | None = None,
        dense_rows_threshold: int = 0,
        use_plans: bool | None = None,
        batch_fanout: bool | None = None,
        batch_calibration: bool | None = None,
        fuse_level_kernel: bool | None = None,
        compaction_threshold: float | None = None,
        policy: ThinkTimePolicy | None = None,
        device: torch.device | str | None = None,
        mesh: dist.ShardMesh | int | bool | None = None,
    ):
        if use_plans is None:
            use_plans = use_plans_default()
        if batch_fanout is None:
            batch_fanout = batch_fanout_default()
        if batch_calibration is None:
            batch_calibration = batch_calibration_default()
        if fuse_level_kernel is None:
            fuse_level_kernel = fuse_level_default()
        if compaction_threshold is None:
            compaction_threshold = compaction_threshold_default()
        if mesh is None:
            mesh = dist.make_engine_mesh(device="cuda" if device is None else device)
        elif mesh is False or mesh == 0:
            mesh = None  # explicit opt-out: ignore REPRO_SHARD_DEVICES
        if device is None and mesh is not None:
            device = mesh.devices[0]
        self.device = resolve_device(device)
        # row-sharded execution: every engine's plan cache shards fact scans
        # and ⊕-folds the γ-indexed partials (the engine raises on a mesh off
        # its device)
        self.mesh = mesh
        self.catalog = catalog
        self.jt = jt or jt_from_catalog(catalog)
        self.store = MessageStore(max_bytes=max_cache_bytes)
        self._lifts = dict(lifts or {})
        # relations of at most this many rows are densified (dense plans)
        self._dense_rows_threshold = dense_rows_threshold
        self._use_plans = use_plans
        self.batch_fanout = batch_fanout
        self.batch_calibration = batch_calibration
        self.fuse_level_kernel = fuse_level_kernel
        self.engine = self._new_engine(ring)
        if mesh is not None:
            catalog.set_row_placement(dist.row_placement(mesh))
        # ring name -> engine; siblings share the store (per-ring plan caches)
        self._engines: dict[str, CJTEngine] = {ring.name: self.engine}
        self.scheduler = ThinkTimeScheduler()
        self.think_time_policy: ThinkTimePolicy = (
            policy if policy is not None else DrainCalibration()
        )
        self._sees_attr_memo: dict[tuple[str, tuple[str, ...]], bool] = {}
        self._dashboards: dict[str, Query] = {}
        self._sessions: dict[str, Session] = {}
        self._session_seq = 0  # monotonic: closed sessions never recycle ids
        # streaming ingestion: per-relation micro-batch buffers, coalesced
        # and committed by flush() under one catalog watermark
        self._streams: dict[str, StreamBuffer] = {}
        self.compaction_threshold = compaction_threshold
        # per-relation thresholds learned from the observed delete mix
        self.compaction_policy = CompactionPolicy()
        self.ingest = IngestStats()
        # attached TreantServer (repro_torch.serve), surfaced in cache_stats
        self._server = None

    def _new_engine(self, ring: sr.Semiring) -> CJTEngine:
        return CJTEngine(
            self.jt, self.catalog, ring, lifts=self._lifts, store=self.store,
            dense_rows_threshold=self._dense_rows_threshold, use_plans=self._use_plans,
            batch_calibration=self.batch_calibration, fuse_level_kernel=self.fuse_level_kernel,
            device=self.device, mesh=self.mesh,
        )

    # -- engines ---------------------------------------------------------------
    def engine_for(self, ring_name: str, measure=None) -> CJTEngine:
        """Engine executing ``ring_name`` queries (shared MessageStore).

        A *measure-free* COUNT collapses onto a SUM primary (the SUM lift is
        then all-ones); a COUNT query carrying a measure gets the real COUNT
        engine.
        """
        primary = self.engine.ring.name
        if ring_name == primary:
            return self.engine
        if primary == "sum" and ring_name == "count" and measure is None:
            return self.engine
        eng = self._engines.get(ring_name)
        if eng is None:
            eng = self._new_engine(sr.get(ring_name))
            self._engines[ring_name] = eng
        return eng

    # -- declarative sessions (the primary API) --------------------------------
    def open_session(self, spec: DashboardSpec, name: str | None = None,
                     calibrate: bool = True) -> Session:
        """Open a dashboard session: derive per-viz base queries from the
        spec and (by default) calibrate each base CJT offline, pinned."""
        if name is None:
            while f"sess{self._session_seq}" in self._sessions:
                self._session_seq += 1
            name = f"sess{self._session_seq}"
            self._session_seq += 1
        if name in self._sessions:
            raise ValueError(f"session {name!r} already open")
        sess = Session(self, name, spec, calibrate=calibrate)
        self._sessions[name] = sess
        return sess

    def session(self, name: str) -> Session:
        return self._sessions[name]

    def _legacy_session(self, name: str) -> Session:
        """Spec-less session backing the legacy wrapper API."""
        sess = self._sessions.get(name)
        if sess is None:
            sess = Session(self, name, spec=None)
            self._sessions[name] = sess
        return sess

    # -- offline stage (§4.1.1) — legacy wrapper -------------------------------
    def register_dashboard(self, viz: str, query: Query) -> ExecStats:
        """[legacy] Store the dashboard query and calibrate its CJT (pinned)."""
        self._dashboards[viz] = query
        return self.engine_for(query.ring_name, query.measure).calibrate(query, pin=True)

    def _legacy_viz(self, session: str, viz: str) -> Session:
        sess = self._legacy_session(session)
        if viz not in sess._views:
            sess.add_viz(viz, self._dashboards[viz])  # KeyError if unregistered
        return sess

    # -- online stage (§4.1.2) — legacy wrappers -------------------------------
    def interact(self, session: str, viz: str, query: Query) -> InteractionResult:
        """[legacy] Execute an interaction query using the latest CJT for
        this viz.  Preempts only this viz's pending background calibration."""
        return self._legacy_viz(session, viz).interact_query(viz, query)

    def read(self, session: str, viz: str) -> InteractionResult:
        return self._legacy_viz(session, viz).read(viz)

    # -- data updates (delta calibration) ---------------------------------------
    def update(self, new_rel: Relation, delta: Delta | None) -> UpdateResult:
        """Apply a base-data update online, maintaining every cached CJT.

        ``new_rel`` is the post-update version produced by
        ``Relation.append_rows`` / ``delete_rows`` alongside ``delta``.  Each
        distinct tracked query whose snapshot matches ``delta.old_version``
        is delta-maintained (pinned messages stay pinned), the new version is
        committed, and every stored query is re-snapshotted.  Where
        maintenance is impossible the bumped signatures simply miss and the
        recalibration is re-queued on the scheduler.  ``delta=None`` (an
        empty update) is a no-op.
        """
        if delta is None:
            return UpdateResult(new_rel.name, new_rel.version, 0, 0, [])
        if new_rel.name != delta.relation or new_rel.version != delta.new_version:
            raise ValueError(f"{new_rel.name}@{new_rel.version} is not the version "
                             f"{delta.relation}@{delta.new_version} the delta produces")
        self.catalog.put(new_rel, make_latest=False)  # staged until commit
        return self._ingest([delta])[0]

    def _tracked_queries(self) -> list[Query]:
        return list(self._dashboards.values()) + [
            view.base for sess in self._sessions.values() for view in sess._views.values()
        ] + [
            q for sess in self._sessions.values() for q in sess._current.values()
        ] + [
            # pinned offline-calibration passes (union-carry queries):
            # maintaining them migrates their pins to the bumped signatures
            q for sess in self._sessions.values() for q in sess._pinned_queries.values()
        ]

    def _sees(self, q: Query, relation: str) -> bool:
        """Can ``relation``'s data reach this query's answer?"""
        return relation not in q.removed and relation in self.jt.mapping

    def sees_attr(self, q: Query, attr: str) -> bool:
        """Does any relation still in this query's join scope carry ``attr``?

        ``ToggleRelation`` can remove the only relation holding a brushed
        dimension; a σ on that attr is then unplaceable.  Memoized on
        (attr, removed set): the join tree and schemas are fixed for this
        Treant's lifetime.
        """
        key = (attr, tuple(sorted(q.removed)))
        hit = self._sees_attr_memo.get(key)
        if hit is not None:
            return hit
        out = any(
            rel not in q.removed and attr in self.catalog.get(rel).attrs
            for bag in self.jt.bags_with_attr(attr) for rel in self.jt.relations_of(bag)
        )
        self._sees_attr_memo[key] = out
        return out

    def _ingest(self, deltas: list[Delta], deprioritized: bool = False) -> list[UpdateResult]:
        """Maintain, commit and re-snapshot for a batch of per-relation deltas.

        The commit protocol: every delta's maintenance runs first, against
        *staged* catalog versions — readers still resolve the old watermark
        and every old message stays servable.  Only when all sweeps have
        landed does ``Catalog.commit`` advance the latest pointers (one
        watermark for the whole batch) and the tracked queries get
        re-snapshotted.  ``deprioritized`` marks the re-queued
        recalibrations of fallback queries as lowest-priority scheduler work
        (compaction must not starve interactive think-time calibration).
        """
        results: list[UpdateResult] = []
        for delta in deltas:
            todo = {
                q.digest: q for q in self._tracked_queries()
                if q.version_of(delta.relation) == delta.old_version
            }
            all_stats: list[DeltaStats] = []
            maintained = fallbacks = 0
            fallback_digests: set[str] = set()
            for q in todo.values():
                _, st = self.engine_for(q.ring_name, q.measure).apply_delta(q, delta)
                all_stats.append(st)
                fallbacks += int(st.fallback)
                if st.fallback:
                    fallback_digests.add(q.digest)
                # a query the update cannot reach is neither maintained nor a
                # fallback; a compaction maintains by re-keying
                maintained += int(
                    not st.fallback and (st.delta_messages > 0 or st.edges_maintained > 0)
                )
            # fallback CJTs migrate no pins, but their pinned queries are
            # version-bumped below: release the old-version pins now, while the
            # pre-bump query still derives the pinned signatures
            for sess in self._sessions.values():
                for key, qp in sorted(sess._pinned_queries.items()):
                    if qp.digest in fallback_digests:
                        self.engine_for(qp.ring_name, qp.measure).unpin_query(qp)
                        del sess._pinned_queries[key]

            def bump(q: Query, delta: Delta = delta) -> Query:
                if q.version_of(delta.relation) == delta.old_version:
                    return q.with_version(delta.relation, delta.new_version)
                return q

            self._dashboards = {v: bump(q) for v, q in self._dashboards.items()}
            for sess in self._sessions.values():
                for view in sess._views.values():
                    view.base = bump(view.base)
                sess._current = {v: bump(q) for v, q in sess._current.items()}
                sess._pinned_queries = {k: bump(q) for k, q in sess._pinned_queries.items()}
            self.ingest.delta_sweeps += 1
            results.append(UpdateResult(
                relation=delta.relation, new_version=delta.new_version,
                queries_maintained=maintained, queries_fallback=fallbacks, stats=all_stats,
            ))
        # ---- commit point: all latest pointers advance under ONE watermark
        self.catalog.commit({d.relation: d.new_version for d in deltas})
        self.ingest.version_bumps += len(deltas)
        # selective invalidation: only prefetched results and bin cubes whose
        # query can see an updated relation are stale (their digests can
        # never be served again); entries on disjoint dimensions keep stable
        # digests and stay servable.  Then re-queue the sessions' bumped
        # current queries: a changed digest preempts exactly the stale parked
        # calibration, an unchanged one keeps its position and progress
        changed = [d.relation for d in deltas]
        if self._server is not None:
            self._server._on_commit(changed)
        for sess in self._sessions.values():
            sess._prefetched = {
                k: e for k, e in sess._prefetched.items()
                if not any(self._sees(e.query, r) for r in changed)
            }
            sess.invalidate_bin_cubes(changed)
            for viz, q in sess._current.items():
                engine = self.engine_for(q.ring_name, q.measure)
                dep = deprioritized and not engine.is_calibrated(q)
                self.scheduler.schedule(sess.id, viz, q, engine, deprioritized=dep)
        # absorption prewarm: the commit leaves every device cache slot for
        # the new versions cold (codes, lifts); execute each still-calibrated
        # affected query once NOW, on the write path, so the first post-tick
        # interaction pays σ-absorption only.  Fallback queries are skipped:
        # their recalibration belongs to think-time.
        prewarmed = []
        for sess in self._sessions.values():
            for q in sess._current.values():
                if not any(self._sees(q, r) for r in changed):
                    continue
                engine = self.engine_for(q.ring_name, q.measure)
                if engine.plans is not None and engine.is_calibrated(q):
                    f, _ = engine.execute(q, sync=False)
                    prewarmed.append(f.field)
        # drain the prewarm here: its results live in no store, and the next
        # interaction would otherwise queue behind them on the device
        synchronize(prewarmed)
        return results

    # -- streaming ingestion ------------------------------------------------------
    def stream(self, relation: str) -> StreamBuffer:
        """The per-relation ingestion buffer (created on first use).

        Queue micro-batches with ``stream(r).append(...)`` / ``.delete(...)``;
        nothing is visible to readers until :meth:`flush`.
        """
        buf = self._streams.get(relation)
        if buf is None:
            buf = StreamBuffer(self.catalog.get(relation))
            self._streams[relation] = buf
        return buf

    def flush(self) -> FlushResult:
        """Tick boundary: coalesce every buffer, maintain, commit, compact.

        Per streamed relation with pending micro-batches: exactly ONE version
        bump and ONE ``apply_delta`` sweep (``IngestStats``).  All relations
        commit under one catalog watermark.  Afterwards any buffer whose
        tombstone fraction crossed its compaction threshold is compacted: one
        more (empty) delta that group rings absorb by re-keying, while
        inverse-free rings take their single real recalibration, scheduled
        at lowest priority.
        """
        deltas: list[Delta] = []
        for name in sorted(self._streams):
            buf = self._streams[name]
            before = dataclasses.replace(buf.stats)
            new_rel, delta = buf.coalesce()
            n_app = buf.stats.rows_appended - before.rows_appended
            n_del = buf.stats.rows_deleted - before.rows_deleted
            self.ingest.rows_appended += n_app
            self.ingest.rows_deleted += n_del
            self.ingest.rows_cancelled += buf.stats.rows_cancelled - before.rows_cancelled
            if delta is not None:
                self.compaction_policy.observe(name, n_app, n_del)
                self.catalog.put(new_rel, make_latest=False)  # stage
                deltas.append(delta)
        updates = self._ingest(deltas) if deltas else []
        if deltas:
            self.ingest.ticks += 1
        compactions: list[UpdateResult] = []
        if self.compaction_threshold > 0:
            cdeltas: list[Delta] = []
            rebased: list[tuple[StreamBuffer, Relation]] = []
            for name in sorted(self._streams):
                buf = self._streams[name]
                thr = self.compaction_policy.threshold(name, self.compaction_threshold)
                if buf.tombstone_fraction() < thr:
                    continue
                new_rel, cdelta = buf.base.compact()
                if cdelta is None:
                    continue
                self.catalog.put(new_rel, make_latest=False)
                cdeltas.append(cdelta)
                rebased.append((buf, new_rel))
            if cdeltas:
                compactions = self._ingest(cdeltas, deprioritized=True)
                for buf, new_rel in rebased:
                    buf.rebase(new_rel)
                self.ingest.compactions += len(cdeltas)
        return FlushResult(watermark=self.catalog.watermark, updates=updates,
                           compactions=compactions)

    # -- think-time calibration (§4.2.1) — legacy wrapper -----------------------
    def think_time(self, session: str, viz: str, budget_messages: int | None = None,
                   budget_seconds: float | None = None) -> int:
        """[legacy] Calibrate this viz's current query in the background.

        Preemptible: stops when the budget is exhausted; every message
        materialized so far stays in the store and is immediately reusable.
        Returns the number of edges processed.
        """
        sess = self._legacy_viz(session, viz)
        q = sess._current[viz]
        self.scheduler.schedule(session, viz, q, self.engine_for(q.ring_name, q.measure))
        return self.think_time_policy.run(
            sess, ThinkTimeBudget(messages=budget_messages, seconds=budget_seconds, viz=viz),
        )

    # -- introspection ------------------------------------------------------------
    def cache_stats(self) -> dict:
        ingest = dataclasses.asdict(self.ingest)
        # the learned per-relation compaction posture rides under ingest
        ingest["compaction"] = self.compaction_policy.state(self.compaction_threshold)
        out = {
            "messages": len(self.store),
            "bytes": self.store.nbytes,
            "hits": self.store.hits,
            "misses": self.store.misses,
            "widen_hits": self.store.widen_hits,
            "widen_scans": self.store.widen_scans,
            "widen_scan_steps": self.store.widen_scan_steps,
            "cross_viz_hits": self.store.cross_tag_hits,
            "scheduler": self.scheduler.stats(),
            "sessions": len(self._sessions),
            "watermark": self.catalog.watermark,
            "ingest": ingest,
            # bin cubes parked across all sessions (core/predictive.py)
            "bin_cubes": sum(len(s._bin_cubes) for s in self._sessions.values()),
            "bin_cube_bytes": sum(s.bin_cube_bytes for s in self._sessions.values()),
            "bin_cube_hits": sum(s.bin_cube_hits for s in self._sessions.values()),
        }
        if self._server is not None:
            out["serve"] = self._server.stats()
        # plan counters over the primary AND sibling-ring engines
        caches = [e.plans for e in self._engines.values() if e.plans is not None]
        if caches:
            agg = PlanStats()
            for c in caches:
                for k, v in c.stats.as_dict().items():
                    setattr(agg, k, max(getattr(agg, k), v) if k in PlanStats.MAX_FIELDS
                            else getattr(agg, k) + v)
            out["plans"] = agg.as_dict()
            out["plans_cached"] = sum(len(c) for c in caches)
        return out
