"""Treant middleware (paper §4): dashboards, sessions, think-time calibration.

This slice ports the legacy surface the quickstart drives:
``register_dashboard`` calibrates a dashboard query's CJT offline (pinned),
``interact`` answers a new query for a (session, viz) by reusing cached
messages, ``think_time`` calibrates the viz's latest query in the
background, and ``read`` / ``cache_stats`` inspect the state.  Each legacy
session name maps to a :class:`~repro_torch.core.dashboard.Session` whose
vizzes are seeded from the registered dashboard queries.

Multi-ring dashboards: the primary engine serves its own ring (and
measure-free COUNT queries when the primary ring is SUM); any other ring
gets a lazily created sibling engine sharing the same MessageStore.  Prop-2
signatures include the ring name, so the shared store never serves one
ring's message to another.

Every engine runs on ``device`` (default ``cuda``; without a card the
caller must pass ``device="cpu"``).  Declarative sessions, data updates and
streaming ingestion are not ported yet.
"""

from __future__ import annotations

import torch

from repro_torch.relational.relation import Catalog
from . import semiring as sr
from .calibration import CJTEngine, ExecStats, MessageStore
from .dashboard import InteractionResult, Session, ThinkTimeScheduler
from .hypertree import JTree, jt_from_catalog
from .plans import PlanStats, resolve_device
from .predictive import DrainCalibration, ThinkTimeBudget, ThinkTimePolicy
from .query import Query

__all__ = ["Treant", "InteractionResult", "Session", "ThinkTimeScheduler"]


class Treant:
    """Dashboard accelerator managing CJTs over one join graph."""

    def __init__(
        self,
        catalog: Catalog,
        ring: sr.Semiring = sr.SUM,
        jt: JTree | None = None,
        max_cache_bytes: int | None = None,
        dense_rows_threshold: int = 0,
        use_plans: bool = True,
        batch_calibration: bool = True,
        policy: ThinkTimePolicy | None = None,
        device: torch.device | str | None = None,
    ):
        self.device = resolve_device(device)
        self.catalog = catalog
        self.jt = jt or jt_from_catalog(catalog)
        self.store = MessageStore(max_bytes=max_cache_bytes)
        # relations of at most this many rows are densified (dense plans)
        self._dense_rows_threshold = dense_rows_threshold
        self._use_plans = use_plans
        self.batch_calibration = batch_calibration
        self.engine = self._new_engine(ring)
        # ring name -> engine; siblings share the store (per-ring plan caches)
        self._engines: dict[str, CJTEngine] = {ring.name: self.engine}
        self.scheduler = ThinkTimeScheduler()
        self.think_time_policy: ThinkTimePolicy = (
            policy if policy is not None else DrainCalibration()
        )
        self._dashboards: dict[str, Query] = {}
        self._sessions: dict[str, Session] = {}

    def _new_engine(self, ring: sr.Semiring) -> CJTEngine:
        return CJTEngine(
            self.jt, self.catalog, ring, store=self.store,
            dense_rows_threshold=self._dense_rows_threshold, use_plans=self._use_plans,
            batch_calibration=self.batch_calibration, device=self.device,
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

    def _legacy_session(self, name: str) -> Session:
        sess = self._sessions.get(name)
        if sess is None:
            sess = Session(self, name)
            self._sessions[name] = sess
        return sess

    def session(self, name: str) -> Session:
        return self._sessions[name]

    # -- offline stage (§4.1.1) -------------------------------------------------
    def register_dashboard(self, viz: str, query: Query) -> ExecStats:
        """Store the dashboard query and calibrate its CJT (pinned)."""
        self._dashboards[viz] = query
        return self.engine_for(query.ring_name, query.measure).calibrate(query, pin=True)

    def _legacy_viz(self, session: str, viz: str) -> Session:
        sess = self._legacy_session(session)
        if viz not in sess._views:
            sess.add_viz(viz, self._dashboards[viz])  # KeyError if unregistered
        return sess

    # -- online stage (§4.1.2) --------------------------------------------------
    def interact(self, session: str, viz: str, query: Query) -> InteractionResult:
        """Execute an interaction query using the latest CJT for this viz.
        Preempts only this viz's pending background calibration."""
        return self._legacy_viz(session, viz).interact_query(viz, query)

    def read(self, session: str, viz: str) -> InteractionResult:
        return self._legacy_viz(session, viz).read(viz)

    # -- think-time calibration (§4.2.1) ----------------------------------------
    def think_time(self, session: str, viz: str, budget_messages: int | None = None,
                   budget_seconds: float | None = None) -> int:
        """Calibrate this viz's current query in the background.

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
        }
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
