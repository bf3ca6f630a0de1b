"""Dashboard sessions and the shared think-time scheduler (paper §4).

This slice ports what the legacy ``Treant`` API runs on:

- :class:`ThinkTimeScheduler`: a priority queue of pending calibrations
  across all (session, viz) pairs.  An interaction preempts *only* the
  pending calibration of the viz it changed; background progress on every
  other viz survives.  ``run`` drains the queue cheapest-remaining-work
  first, level by level across vizzes when no budget is set.
- :class:`Session`'s imperative bridge: ``add_viz``, ``interact_query``,
  ``sql``, ``read`` and ``idle``.

The declarative layer (``DashboardSpec``, typed events, crossfilter fan-out,
undo, σ prefetch, bin cubes) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING

from .calibration import CalibrationPlan, CJTEngine, ExecStats
from .predictive import ThinkTimeBudget, ThinkTimePolicy
from .query import Query

if TYPE_CHECKING:  # pragma: no cover — import cycle guard (treant imports us)
    from .treant import Treant


@dataclasses.dataclass
class InteractionResult:
    """One viz's rendered aggregate plus execution accounting.
    ``latency_s`` covers dispatch and the device sync of this viz."""

    factor: object
    stats: ExecStats
    latency_s: float
    steiner_size: int


# ---------------------------------------------------------------------------
# Think-time scheduler
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _CalTask:
    session: str
    viz: str
    digest: str
    query: Query
    engine: CJTEngine
    priority: int
    plan: CalibrationPlan | None = None
    done: int = 0


class ThinkTimeScheduler:
    """Priority queue of pending calibrations across all (session, viz) pairs.

    Priority is cost-weighted: the task with the cheapest estimated
    remaining work runs first, with recency (most recently interacted) as the
    tie-break.  ``schedule`` replaces a pending task only when the query for
    that exact (session, viz) changed — the *only* preemption.  Exhausting a
    ``run`` budget parks the current task without losing position (§4.2.1).
    """

    def __init__(self):
        self._tasks: dict[tuple[str, str], _CalTask] = {}
        self._seq = 0
        self.preemptions = 0     # unfinished tasks replaced by a new query
        self.invalidations = 0   # tasks dropped
        self.completed = 0       # tasks fully calibrated
        self.messages = 0        # edges processed across all runs

    def schedule(self, session: str, viz: str, query: Query, engine: CJTEngine) -> None:
        key = (session, viz)
        self._seq += 1
        t = self._tasks.get(key)
        if t is not None:
            if t.digest == query.digest:
                t.priority = self._seq  # refresh recency, keep progress
                return
            self.preemptions += 1
        self._tasks[key] = _CalTask(session, viz, query.digest, query, engine, priority=self._seq)

    def pending(self, session: str | None = None) -> int:
        if session is None:
            return len(self._tasks)
        return sum(1 for t in self._tasks.values() if t.session == session)

    def drop(self, session: str, viz: str | None = None) -> int:
        keys = [k for k in self._tasks if k[0] == session and (viz is None or k[1] == viz)]
        for k in keys:
            del self._tasks[k]
        self.invalidations += len(keys)
        return len(keys)

    def _remaining_cost(self, t: _CalTask) -> float:
        """Σ of ``estimate_edge_cost`` over all directed edges (cached edges
        cost 0, so the estimate shrinks as the pass progresses)."""
        eng, q = t.engine, t.query
        placement = eng.place_predicates(q)
        return sum(eng.estimate_edge_cost(q, u, v, placement) for u, v in eng.jt.directed_edges())

    def _pick(self, cands: list[_CalTask]) -> _CalTask:
        return min(cands, key=lambda t: (self._remaining_cost(t), -t.priority))

    def run(self, budget_messages: int | None = None, budget_seconds: float | None = None,
            session: str | None = None, viz: str | None = None) -> int:
        """Drain matching tasks by cost-weighted priority; returns edges
        processed.

        On a fully unbudgeted drain, tasks on a batch-calibration engine
        advance level by level across vizzes (``run_calibration_level``).
        Any budget forces per-edge stepping; both modes park and resume the
        same per-task position.
        """
        done = 0
        t0 = time.perf_counter()
        while True:
            cands = [
                t for t in self._tasks.values()
                if (session is None or t.session == session) and (viz is None or t.viz == viz)
            ]
            if not cands:
                return done
            task = self._pick(cands)
            # completed tasks are popped when re-picked, NOT when their last
            # edge lands, so a caller polling until a run returns 0 terminates
            if task.plan is not None and task.plan.done:
                self._tasks.pop((task.session, task.viz), None)
                self.completed += 1
                continue
            engine = task.engine
            use_levels = (
                budget_messages is None and budget_seconds is None
                and engine.batch_calibration and engine.plans is not None
            )
            group = (
                [t for t in cands
                 if t.engine is engine and not (t.plan is not None and t.plan.done)]
                if use_levels else [task]
            )
            for t in group:
                if t.plan is None:
                    t.plan = engine.calibration_plan(t.query)
            before = {id(t): t.plan.edges_left() for t in group}
            if use_levels:
                n = engine.run_calibration_level(
                    [t.plan for t in group], tags=[f"{t.session}:{t.viz}" for t in group],
                )
            else:
                left = None if budget_messages is None else budget_messages - done
                deadline = None if budget_seconds is None else t0 + budget_seconds
                store = engine.store
                store.tag = f"{task.session}:{task.viz}"
                try:
                    n = engine.step_calibration(task.plan, max_edges=left, deadline=deadline)
                finally:
                    store.tag = None
            done += n
            self.messages += n
            for t in group:
                t.done += before[id(t)] - t.plan.edges_left()
            if budget_messages is not None and done >= budget_messages:
                return done
            if budget_seconds is not None and time.perf_counter() - t0 >= budget_seconds:
                return done

    def stats(self) -> dict:
        return {
            "pending": len(self._tasks),
            "preemptions": self.preemptions,
            "invalidations": self.invalidations,
            "completed": self.completed,
            "messages": self.messages,
        }


# ---------------------------------------------------------------------------
# Session
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _VizView:
    base: Query
    group_by: tuple[str, ...]


class Session:
    """One user's live dashboard over a shared Treant.

    Executes through the Treant's shared engines/store so sessions and
    sibling vizzes reuse each other's materialized messages.
    """

    def __init__(self, treant: "Treant", session_id: str):
        self._treant = treant
        self.id = session_id
        self._views: dict[str, _VizView] = {}
        self._current: dict[str, Query] = {}
        self.policy: ThinkTimePolicy | None = None

    @property
    def catalog(self):
        return self._treant.catalog

    @property
    def store(self):
        return self._treant.store

    @property
    def scheduler(self) -> ThinkTimeScheduler:
        return self._treant.scheduler

    def _view(self, viz: str) -> _VizView:
        try:
            return self._views[viz]
        except KeyError:
            raise KeyError(f"no viz {viz!r} in session {self.id!r}") from None

    def add_viz(self, name: str, base: Query) -> None:
        """Attach a viz from an explicit base query."""
        if name in self._views:
            return
        self._views[name] = _VizView(base=base, group_by=tuple(base.group_by))
        self._current[name] = base

    def query_of(self, viz: str) -> Query:
        """The viz's latest executed query."""
        self._view(viz)
        return self._current[viz]

    @property
    def vizzes(self) -> tuple[str, ...]:
        return tuple(sorted(self._views))

    def _execute(self, viz: str, query: Query) -> tuple[object, ExecStats, CJTEngine, float]:
        engine = self._treant.engine_for(query.ring_name, query.measure)
        self.store.tag = f"{self.id}:{viz}"
        t0 = time.perf_counter()
        try:
            factor, stats = engine.execute(query)
        finally:
            self.store.tag = None
        return factor, stats, engine, time.perf_counter() - t0

    def interact_query(self, viz: str, query: Query) -> InteractionResult:
        """Execute an explicit Query as this viz's current view; the viz's
        pending calibration is preempted iff the query changed."""
        self._view(viz)
        factor, stats, engine, dt = self._execute(viz, query)
        self._current[viz] = query
        self.scheduler.schedule(self.id, viz, query, engine)
        return InteractionResult(factor, stats, dt, stats.steiner_size)

    def sql(self, viz: str, text: str, strict_from: bool = False) -> InteractionResult:
        """Parse restricted SQL and execute it as this viz's current view."""
        from repro_torch.relational import sql as _sql

        return self.interact_query(viz, _sql.parse(text, self.catalog, strict_from))

    def read(self, viz: str) -> InteractionResult:
        """Re-execute the viz's current query (pure cache hits when warm)."""
        factor, stats, _, dt = self._execute(viz, self.query_of(viz))
        return InteractionResult(factor, stats, dt, stats.steiner_size)

    def idle(self, budget_messages: int | None = None, budget_seconds: float | None = None,
             policy: ThinkTimePolicy | None = None) -> int:
        """Spend user think-time on this session, driven by ONE policy
        (``policy``, else ``self.policy``, else the Treant's default).
        Returns the number of calibration edges processed."""
        if policy is None:
            policy = self.policy or self._treant.think_time_policy
        return policy.run(self, ThinkTimeBudget(messages=budget_messages, seconds=budget_seconds))
