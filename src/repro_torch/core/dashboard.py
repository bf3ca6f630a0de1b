"""Declarative dashboard sessions: typed interaction events, crossfilter
fan-out, and a shared think-time scheduler (paper §4, serving layer).

The paper's Treant serves whole *dashboards* — many linked visualizations
whose interaction queries differ incrementally from one another:

- :class:`DashboardSpec` declares named vizzes (:class:`VizSpec`: measure,
  ring, group-by, local σ) over one catalog/join graph.
- ``Treant.open_session(spec)`` returns a :class:`Session` holding the shared
  *crossfilter* state (one active filter per attribute, linked selection)
  plus per-viz view state (drill path, measure, toggled relations).
- Typed events (:class:`SetFilter`, :class:`ClearFilter`, :class:`Drill`,
  :class:`Rollup`, :class:`SwapMeasure`, :class:`ToggleRelation`,
  :class:`Undo`) go through :meth:`Session.apply`, which derives the per-viz
  :class:`~repro_torch.core.query.Query` objects and fans execution out to
  every viz whose query changed.  All vizzes share one engine per ring, one
  :class:`~repro_torch.core.calibration.MessageStore` and plan cache, so a
  message materialized for one viz serves its siblings.
- **Batched fan-out**: the re-render dispatches every changed viz through
  ``CJTEngine.execute_many`` (one engine call per ring), which absorbs the
  siblings sharing a batch signature in one ``level_segment_aggregate``
  launch; ``Treant(batch_fanout=False)`` dispatches viz by viz.  The device
  is synchronized once per fan-out.
- :class:`ThinkTimeScheduler`: a priority queue of pending calibrations
  across all (session, viz) pairs.  An interaction preempts *only* the
  pending calibration of the viz it changed; ``Session.idle`` drains the
  queue through the session's think-time policy.
- **Think-time policies** (:mod:`repro_torch.core.predictive`):
  ``Session.idle(policy=FixedKPrefetch(k))`` pre-executes the fan-out for up
  to ``k`` neighboring σ values of the latest ``SetFilter``
  (:func:`speculate_filters`) and parks the absorbed per-viz results in the
  session's prefetch cache; ``PredictiveThinkTime`` also materializes **bin
  cubes** — the γ∪{brush-dim} aggregate per (viz, likely dim), so any later
  σ on that dim is an O(bins) slice.  A brush on a prefetched σ or a
  cube-covered dim is served with zero store probes and zero plan
  executions (``ExecStats.prefetch_hits`` / ``bin_cube_hits``).  The
  deprecated ``idle(speculate=k)`` maps onto ``FixedKPrefetch(k)``.
- ``Session.sql(viz, text)`` routes the restricted SQL front-end into the
  same layer, and the legacy ``Treant`` wrappers run on spec-less sessions.

Query derivation contract (equal digests to hand-built chains): for each viz,

    base → with_measure(swap) → with_group_by(spec γ + drills)
         → relation toggles → with_filters(crossfilter σ, source excluded)
"""

from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING, Mapping

from repro_torch.relational.relation import Predicate, mask_in, mask_range
from .calibration import CalibrationPlan, CJTEngine, ExecStats, factor_nbytes, synchronize
from .plans import slice_bin_cube, slice_bin_cubes
from .predictive import (
    BrushTrajectory,
    FixedKPrefetch,
    ThinkTimeBudget,
    ThinkTimePolicy,
    _BinCube,
    think_time_config,
    warn_deprecated_once,
)
from .query import Query

if TYPE_CHECKING:  # pragma: no cover — import cycle guard (treant imports us)
    from .treant import Treant


# ---------------------------------------------------------------------------
# Declarative spec
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class VizSpec:
    """One visualization: an SPJA aggregate view over the shared join graph.

    ``crossfilter=False`` opts the viz out of linked selection (it keeps its
    local σ only and is never re-rendered by SetFilter/ClearFilter events).
    """

    name: str
    measure: tuple[str, str] | None = None     # (relation, column)
    ring: str = "count"
    group_by: tuple[str, ...] = ()
    predicates: tuple[Predicate, ...] = ()     # local σ, always applied
    removed: tuple[str, ...] = ()              # R̄: relations excluded up front
    crossfilter: bool = True


@dataclasses.dataclass(frozen=True)
class DashboardSpec:
    """A named set of linked vizzes over one catalog."""

    vizzes: tuple[VizSpec, ...]

    def __post_init__(self):
        names = [v.name for v in self.vizzes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate viz names in spec: {names}")

    def viz(self, name: str) -> VizSpec:
        for v in self.vizzes:
            if v.name == name:
                return v
        raise KeyError(f"no viz {name!r} in spec")

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(v.name for v in self.vizzes)


# ---------------------------------------------------------------------------
# Typed interaction events
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SetFilter:
    """Set the session-wide crossfilter on ``attr``.

    Either ``values`` (IN-list) or ``lo``/``hi`` (half-open range, like
    ``mask_range``).  ``source`` names the viz that originated the brush: it
    keeps showing its own unfiltered dimension, so the filter applies to
    every *other* crossfilter viz.
    """

    attr: str
    values: tuple[int, ...] = ()
    lo: int | None = None
    hi: int | None = None
    source: str | None = None


@dataclasses.dataclass(frozen=True)
class ClearFilter:
    attr: str


@dataclasses.dataclass(frozen=True)
class Drill:
    """Add ``attr`` to one viz's group-by (drill-down)."""

    viz: str
    attr: str


@dataclasses.dataclass(frozen=True)
class Rollup:
    """Remove ``attr`` (default: the most recent γ attr) from one viz."""

    viz: str
    attr: str | None = None


@dataclasses.dataclass(frozen=True)
class SwapMeasure:
    viz: str
    relation: str
    column: str
    ring: str = "sum"


@dataclasses.dataclass(frozen=True)
class ToggleRelation:
    """Flip a relation in/out of the join (R̄); all vizzes unless ``viz``."""

    relation: str
    viz: str | None = None


@dataclasses.dataclass(frozen=True)
class Undo:
    """Revert the last ``Session.apply`` event (declarative state only)."""


Event = (SetFilter, ClearFilter, Drill, Rollup, SwapMeasure, ToggleRelation, Undo)


def _group_by_engine(pairs):
    """Group ``(engine, item)`` pairs into ``[(engine, [items…])]`` in
    first-appearance order (engines hash by identity)."""
    groups: dict[CJTEngine, list] = {}
    for eng, item in pairs:
        groups.setdefault(eng, []).append(item)
    return list(groups.items())


_UNCACHED = object()  # cube-probe memo sentinel (None is a valid memo value)


def speculate_filters(ev: SetFilter, domain: int, k: int) -> list[SetFilter]:
    """Up to ``k`` likely-next σ values for the same dimension, nearest first.

    Brushes move locally: a range filter's neighbors are the adjacent windows
    of the same width (clipped at the domain edges); an IN-list's neighbors
    are the value set shifted by whole spans (sibling domain values).  The
    candidate list is deterministic — alternating +/- by distance — so
    prefetch behavior is reproducible and testable.

    Termination tracks each direction's *liveness* separately and stops only
    when both are exhausted, so the generator returns exactly
    ``min(k, feasible)`` distinct candidates, clipped edge windows
    included.
    """
    out: list[SetFilter] = []
    seen = set()

    def emit(cand: SetFilter) -> bool:
        key = (cand.values, cand.lo, cand.hi)
        if key not in seen:
            seen.add(key)
            out.append(cand)
        return len(out) >= k

    if k <= 0:
        return out
    if ev.values:
        vals = sorted(set(ev.values))
        span = vals[-1] - vals[0] + 1
        pos = neg = True  # direction still inside the domain
        step = 0
        while pos or neg:
            step += 1
            off = step * span
            # a shifted IN-list is feasible only when it fits whole: once one
            # endpoint leaves the domain, every later step in that direction
            # is further out — the direction is dead
            if pos and vals[-1] + off >= domain:
                pos = False
            elif pos:
                if emit(dataclasses.replace(
                        ev, values=tuple(v + off for v in vals))):
                    return out
            if neg and vals[0] - off < 0:
                neg = False
            elif neg:
                if emit(dataclasses.replace(
                        ev, values=tuple(v - off for v in vals))):
                    return out
        return out
    if ev.lo is None or ev.hi is None:
        return out
    width = max(ev.hi - ev.lo, 1)
    pos = neg = True
    step = 0
    while pos or neg:
        step += 1
        off = step * width
        # ranges clip at the edges: a direction stays live until the clipped
        # window collapses (lo >= domain / hi <= 0); the clipped edge windows
        # themselves are feasible candidates and must be emitted
        if pos:
            lo, hi = ev.lo + off, min(ev.hi + off, domain)
            if lo >= domain or lo >= hi:
                pos = False
            elif (lo, hi) != (ev.lo, ev.hi):
                if emit(dataclasses.replace(ev, lo=lo, hi=hi)):
                    return out
        if neg:
            lo, hi = max(ev.lo - off, 0), ev.hi - off
            if hi <= 0 or lo >= hi:
                neg = False
            elif (lo, hi) != (ev.lo, ev.hi):
                if emit(dataclasses.replace(ev, lo=lo, hi=hi)):
                    return out
    return out



# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class InteractionResult:
    """One viz's rendered aggregate plus execution accounting.

    ``latency_s`` is dispatch time for this viz; under batched fan-out the
    sibling group shares one dispatch, so grouped vizzes report the same
    value, and the device sync happens once for all vizzes (see
    ``ApplyResult.latency_s``).  ``steiner_size`` is realized from the
    engine's ExecStats (bags touched by recomputation ∪ root); 0 when the
    result came from the prefetch cache or a bin cube (nothing executed).
    """

    factor: object
    stats: ExecStats
    latency_s: float
    steiner_size: int


@dataclasses.dataclass
class ApplyResult:
    """Outcome of one ``Session.apply``: which vizzes re-rendered and how.
    ``latency_s`` covers the whole fan-out, ending in one device sync."""

    event: object
    affected: tuple[str, ...]
    results: dict[str, InteractionResult]
    queries: dict[str, Query]
    latency_s: float


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
    # lowest-priority tier: compaction-triggered recalibrations run only
    # when no interactive think-time work is pending
    deprioritized: bool = False


class ThinkTimeScheduler:
    """Priority queue of pending calibrations across all (session, viz) pairs.

    Priority is cost-weighted: the task with the cheapest estimated
    remaining work runs first, with recency (most recently interacted) as the
    tie-break; deprioritized (compaction) tasks form a strictly lower tier.
    ``schedule`` replaces a pending task only when the query for that exact
    (session, viz) changed — the *only* preemption.  Exhausting a ``run``
    budget parks the current task without losing position (§4.2.1).
    """

    def __init__(self):
        self._tasks: dict[tuple[str, str], _CalTask] = {}
        self._seq = 0
        self.preemptions = 0     # unfinished tasks replaced by a new query
        self.invalidations = 0   # tasks dropped by close / clear
        self.completed = 0       # tasks fully calibrated
        self.messages = 0        # edges processed across all runs
        self.speculative_queries = 0   # prefetch queries executed during idle
        self.speculative_messages = 0  # messages those queries materialized
        self.policy_decisions = 0      # work items a ThinkTimePolicy attempted
        self.cube_builds = 0           # bin cubes materialized during idle
        self._session_preemptions: dict[str, int] = {}

    def schedule(self, session: str, viz: str, query: Query, engine: CJTEngine,
                 deprioritized: bool = False) -> None:
        key = (session, viz)
        self._seq += 1
        t = self._tasks.get(key)
        if t is not None:
            if t.digest == query.digest:
                t.priority = self._seq  # refresh recency, keep progress
                t.deprioritized = deprioritized
                return
            self.preemptions += 1
            self._session_preemptions[session] = self._session_preemptions.get(session, 0) + 1
        self._tasks[key] = _CalTask(session, viz, query.digest, query, engine,
                                    priority=self._seq, deprioritized=deprioritized)

    def pending(self, session: str | None = None) -> int:
        if session is None:
            return len(self._tasks)
        return sum(1 for t in self._tasks.values() if t.session == session)

    def session_preemptions(self, session: str) -> int:
        return self._session_preemptions.get(session, 0)

    def drop(self, session: str, viz: str | None = None) -> int:
        keys = [k for k in self._tasks if k[0] == session and (viz is None or k[1] == viz)]
        for k in keys:
            del self._tasks[k]
        self.invalidations += len(keys)
        if viz is None:  # whole session gone: a reopened name starts fresh
            self._session_preemptions.pop(session, None)
        return len(keys)

    def clear(self) -> int:
        n = len(self._tasks)
        self._tasks.clear()
        self.invalidations += n
        return n

    def _remaining_cost(self, t: _CalTask) -> float:
        """Σ of ``estimate_edge_cost`` over all directed edges (cached edges
        cost 0, so the estimate shrinks as the pass progresses)."""
        eng, q = t.engine, t.query
        placement = eng.place_predicates(q)
        return sum(eng.estimate_edge_cost(q, u, v, placement) for u, v in eng.jt.directed_edges())

    def _pick(self, cands: list[_CalTask]) -> _CalTask:
        return min(cands, key=lambda t: (t.deprioritized, self._remaining_cost(t), -t.priority))

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

    def speculate(self, session: str, items: list[tuple[str, Query, CJTEngine]]
                  ) -> dict[tuple[str, str], object]:
        """Pre-execute likely-next fan-out queries.

        ``items`` are (viz, derived query, engine) triples for σ values the
        user has not selected yet.  They run per engine through
        ``execute_many`` — the batched absorption path a real event takes —
        with the session:viz producer tag, so their messages land in the
        shared store as a real interaction's would.  Returns
        ``{(viz, query digest): absorbed factor}`` for the session to park.
        """
        out: dict[tuple[str, str], object] = {}
        pending = []
        for eng, group in _group_by_engine((eng, (viz, q)) for viz, q, eng in items):
            results = eng.execute_many(
                [q for _, q in group], sync=False,
                tags=[f"{session}:{viz}" for viz, _ in group],
            )
            for (viz, q), (factor, stats) in zip(group, results):
                out[(viz, q.digest)] = factor
                pending.append(factor.field)
                self.speculative_messages += stats.messages_computed
            self.speculative_queries += len(group)
        synchronize(pending)
        return out

    def stats(self) -> dict:
        return {
            "pending": len(self._tasks),
            "preemptions": self.preemptions,
            "invalidations": self.invalidations,
            "completed": self.completed,
            "messages": self.messages,
            "speculative_queries": self.speculative_queries,
            "speculative_messages": self.speculative_messages,
            "policy_decisions": self.policy_decisions,
            "cube_builds": self.cube_builds,
        }


# ---------------------------------------------------------------------------
# Session
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _VizView:
    spec: VizSpec | None
    base: Query
    group_by: tuple[str, ...]
    measure: tuple[str, str, str] | None = None   # (relation, column, ring)
    toggled: frozenset[str] = frozenset()
    crossfilter: bool = True


@dataclasses.dataclass
class _Prefetched:
    """One parked speculative result.

    ``dist`` is the candidate's rank in :func:`speculate_filters`' nearest-
    first order (0 = the σ value right next to the anchor brush): capacity
    eviction drops the *farthest* entries first.  ``query`` lets
    ``Treant.update`` / ``flush`` invalidate only entries that can see an
    updated relation.
    """

    factor: object
    query: Query
    dist: int


class Session:
    """One user's live dashboard over a shared Treant.

    Holds the crossfilter state and per-viz view state; derives each viz's
    Query on demand (see the module docstring for the derivation contract)
    and executes through the Treant's shared engines and store, so sessions
    and sibling vizzes reuse each other's materialized messages.
    """

    def __init__(self, treant: "Treant", session_id: str,
                 spec: DashboardSpec | None = None, calibrate: bool = True):
        self._treant = treant
        self.id = session_id
        self.spec = spec
        self._views: dict[str, _VizView] = {}
        self._current: dict[str, Query] = {}
        # attr -> (Predicate, source viz or None)
        self._filters: dict[str, tuple[Predicate, str | None]] = {}
        self._undo: list[tuple] = []
        self.undo_depth = 64
        self.events_applied = 0
        # speculative σ prefetch: (viz, query digest) -> _Prefetched entry,
        # filled by think-time policies, served (and popped) by _fan_out
        self._prefetched: dict[tuple[str, str], _Prefetched] = {}
        self.prefetch_capacity = think_time_config().prefetch_capacity
        self.prefetch_hits = 0
        self._last_filter: SetFilter | None = None
        # bin cubes: (viz, cube-query digest) -> _BinCube, plus a per-viz
        # index of which dims have a parked cube.  Unlike _Prefetched entries
        # cubes are NOT popped on hit — one cube serves every later σ on its
        # dimension until data invalidates it.
        self._bin_cubes: dict[tuple[str, str], _BinCube] = {}
        self._cube_dims: dict[str, set[str]] = {}
        # (viz, dim, q.digest) -> cube-query digest (or None): a pure
        # function of frozen queries (digests fold in relation versions)
        self._cube_probe_memo: dict[tuple[str, str, str], str | None] = {}
        self._derive_memo: dict[tuple, dict[str, Query]] = {}
        self.bin_cube_hits = 0
        # online brush-trajectory model feeding PredictiveThinkTime
        self.trajectory = BrushTrajectory()
        # session-default think-time policy; None falls back to the Treant's
        self.policy: ThinkTimePolicy | None = None
        # offline-calibration pins, keyed by pin-time digest: the *effective*
        # (union-carry) queries are pinned, not the per-viz bases —
        # close()/update() release exactly these
        self._pinned_queries: dict[str, Query] = {}
        if spec is not None:
            for v in spec.vizzes:
                base = Query.make(
                    treant.catalog, ring=v.ring, measure=v.measure, group_by=v.group_by,
                    predicates=v.predicates, removed=v.removed,
                )
                self._views[v.name] = _VizView(spec=v, base=base, group_by=tuple(v.group_by),
                                               crossfilter=v.crossfilter)
                self._current[v.name] = base
            if calibrate:  # offline stage: pin the base CJTs (§4.1.1)
                # one calibrate_many per engine: sibling vizzes fuse into
                # union-carry passes and levels batch across the fan-out
                bases = [self._views[v.name].base for v in spec.vizzes]
                for eng, qs in _group_by_engine(
                    (treant.engine_for(b.ring_name, b.measure), b) for b in bases
                ):
                    _, effective = eng.calibrate_many(qs, pin=True)
                    for q in effective:
                        self._pinned_queries[q.digest] = q

    # -- plumbing -------------------------------------------------------------
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

    def add_viz(self, name: str, base: Query, crossfilter: bool = True,
                spec: VizSpec | None = None) -> None:
        """Attach a viz from an explicit base query (legacy bridge)."""
        if name in self._views:
            return
        self._views[name] = _VizView(spec=spec, base=base, group_by=tuple(base.group_by),
                                     crossfilter=crossfilter)
        self._current[name] = base

    def query_of(self, viz: str) -> Query:
        """The viz's latest executed query."""
        self._view(viz)
        return self._current[viz]

    @property
    def vizzes(self) -> tuple[str, ...]:
        return tuple(sorted(self._views))

    # -- query derivation ------------------------------------------------------
    def derive(self, viz: str) -> Query:
        v = self._view(viz)
        q = v.base
        if v.measure is not None:
            rel, col, ring = v.measure
            q = q.with_measure(rel, col, ring=ring)
        q = q.with_group_by(*v.group_by)
        # toggles BEFORE filters: the visibility check below needs the viz's
        # effective removal set
        for rel in sorted(v.toggled):
            q = q.with_relation_toggled(rel)
        if v.crossfilter:
            # the brushing viz keeps its full dimension (source exclusion); a
            # σ on a dimension no relation in the viz's join scope carries is
            # dropped (it is unplaceable)
            q = q.with_filters([
                pred for _attr, (pred, source) in sorted(self._filters.items())
                if source != viz and self._treant.sees_attr(q, pred.attr)
            ])
        return q

    def _predicate_of(self, ev: SetFilter) -> Predicate:
        doms = self.catalog.domains()
        if ev.attr not in doms:
            raise KeyError(f"filter attr {ev.attr!r} not in catalog")
        if ev.values:
            return mask_in(doms[ev.attr], list(ev.values), attr=ev.attr)
        if ev.lo is None or ev.hi is None:
            raise ValueError("SetFilter needs values or a [lo, hi) range")
        return mask_range(doms[ev.attr], ev.lo, ev.hi, attr=ev.attr)

    # -- event application ------------------------------------------------------
    def apply(self, event) -> ApplyResult:
        """Apply one typed event: update state, derive queries, fan out.

        Only vizzes whose derived query digest changed are re-executed; each
        one's pending background calibration is preempted and re-scheduled
        for the new query (no other viz's progress is touched).
        """
        if not self._record(event):
            return ApplyResult(event, (), {}, dict(self._current), 0.0)
        return self._fan_out(event)

    def _record(self, event) -> bool:
        """Validate and apply one event to the declarative state without
        executing anything; False when nothing changed (empty-stack Undo)."""
        if not isinstance(event, Event):
            raise TypeError(f"not a dashboard event: {event!r}")
        snapshot = self._snapshot()
        if isinstance(event, Undo):
            if not self._undo:
                return False
            self._restore(self._undo.pop())
        else:
            self._mutate(event)
            self._undo.append(snapshot)
            del self._undo[: -self.undo_depth]
        self.events_applied += 1
        return True

    def _derive_token(self) -> tuple:
        """Content token of everything :meth:`derive` reads; ``base.digest``
        folds in relation versions, so ingestion invalidates by re-keying."""
        return (
            tuple((a, p.digest, s) for a, (p, s) in sorted(self._filters.items())),
            tuple(
                (n, v.base.digest, v.measure, v.group_by, tuple(sorted(v.toggled)),
                 v.crossfilter)
                for n, v in sorted(self._views.items())
            ),
        )

    def _derived_affected(self) -> tuple[dict[str, Query], tuple[str, ...]]:
        """Re-derive every viz (memoized on the declarative-state token) and
        name the ones whose digest changed."""
        token = self._derive_token()
        derived = self._derive_memo.get(token)
        if derived is None:
            derived = {name: self.derive(name) for name in sorted(self._views)}
            if len(self._derive_memo) > 512:
                self._derive_memo.clear()
            self._derive_memo[token] = derived
        affected = tuple(
            name for name, q in derived.items() if q.digest != self._current[name].digest
        )
        return dict(derived), affected

    def _mutate(self, event) -> None:
        if isinstance(event, SetFilter):
            if event.source is not None:
                self._view(event.source)
            self._filters[event.attr] = (self._predicate_of(event), event.source)
            self._last_filter = event  # speculation anchor (σ prefetch)
            self.trajectory.observe(event)
        elif isinstance(event, ClearFilter):
            self._filters.pop(event.attr, None)
            # don't speculate around a dimension the user just abandoned
            if self._last_filter is not None and self._last_filter.attr == event.attr:
                self._last_filter = None
            self.trajectory.forget(event.attr)
        elif isinstance(event, Drill):
            v = self._view(event.viz)
            if event.attr not in self.catalog.domains():
                raise KeyError(f"drill attr {event.attr!r} not in catalog")
            v.group_by = tuple(dict.fromkeys(v.group_by + (event.attr,)))
        elif isinstance(event, Rollup):
            v = self._view(event.viz)
            if event.attr is None:
                v.group_by = v.group_by[:-1]
            else:
                v.group_by = tuple(a for a in v.group_by if a != event.attr)
        elif isinstance(event, SwapMeasure):
            v = self._view(event.viz)
            v.measure = (event.relation, event.column, event.ring)
        elif isinstance(event, ToggleRelation):
            targets = [event.viz] if event.viz is not None else list(self._views)
            for name in targets:
                v = self._view(name)
                v.toggled = v.toggled ^ {event.relation}

    def _fan_out(self, event) -> ApplyResult:
        derived, affected = self._derived_affected()
        results: dict[str, InteractionResult] = {}
        pending = []
        t0 = time.perf_counter()
        # serve speculatively prefetched results first: the fan-out for this
        # σ already ran during think-time, so the viz costs zero store probes
        # and zero plan executions now
        to_run: list[str] = []
        cube_hits: list[tuple[str, Query, _BinCube, str]] = []
        for name in affected:
            q = derived[name]
            hit = self._prefetched.pop((name, q.digest), None)
            if hit is not None:
                self.prefetch_hits += 1
                results[name] = InteractionResult(hit.factor, ExecStats(prefetch_hits=1), 0.0, 0)
                self._current[name] = q
                self.scheduler.schedule(self.id, name, q,
                                        self._treant.engine_for(q.ring_name, q.measure))
                continue
            # then the bin cubes: a brush on a cube-materialized dimension is
            # an O(bins) slice of the parked γ∪{dim} aggregate, for ANY σ
            match = self._match_bin_cube(name, q, hint=getattr(event, "attr", None))
            if match is not None:
                cube_hits.append((name, q, match[0], match[1]))
            else:
                to_run.append(name)
        if cube_hits:
            engine = self._treant.engine_for(cube_hits[0][1].ring_name, cube_hits[0][1].measure)
            sliced = slice_bin_cubes(
                [(e.factor, dim, [p.mask for p in q.predicates_on(dim)], q.group_by)
                 for _, q, e, dim in cube_hits],
                stats=engine.plans.stats if engine.plans is not None else None,
            )
            for (name, q, _, _), f in zip(cube_hits, sliced):
                self.bin_cube_hits += 1
                results[name] = InteractionResult(f, ExecStats(bin_cube_hits=1), 0.0, 0)
                self._current[name] = q
                pending.append(f.field)
                self.scheduler.schedule(self.id, name, q,
                                        self._treant.engine_for(q.ring_name, q.measure))
        # the rest: one execute_many per engine with batch_fanout (sibling
        # absorptions share a launch), else one execute per viz; the device
        # syncs once
        for engine, names in _group_by_engine(
            (self._treant.engine_for(derived[n].ring_name, derived[n].measure), n)
            for n in to_run
        ):
            td = time.perf_counter()
            if self._treant.batch_fanout and len(names) > 1:
                group = engine.execute_many(
                    [derived[n] for n in names], sync=False,
                    tags=[f"{self.id}:{n}" for n in names],
                )
            else:
                group = []
                for name in names:
                    self.store.tag = f"{self.id}:{name}"
                    try:
                        group.append(engine.execute(derived[name], sync=False))
                    finally:
                        self.store.tag = None
            dt = time.perf_counter() - td
            for name, (factor, stats) in zip(names, group):
                q = derived[name]
                results[name] = InteractionResult(factor, stats, dt, stats.steiner_size)
                self._current[name] = q
                pending.append(factor.field)
                self.scheduler.schedule(self.id, name, q, engine)
        synchronize(pending)
        return ApplyResult(event, affected, results, derived, time.perf_counter() - t0)

    # -- undo state ------------------------------------------------------------
    def _snapshot(self):
        # declarative state only: _current stays untouched on restore so the
        # fan-out sees the re-derived queries as changed and re-renders them
        return (
            dict(self._filters),
            {n: (v.group_by, v.measure, v.toggled) for n, v in self._views.items()},
        )

    def _restore(self, snap) -> None:
        filters, views = snap
        self._filters = dict(filters)
        # undone brush: stop speculating on it — also when the restore
        # reverts to an *older* σ on the same attr, not just to no σ
        lf = self._last_filter
        if lf is not None:
            cur = self._filters.get(lf.attr)
            if cur is None or cur[0].digest != self._predicate_of(lf).digest:
                self._last_filter = None
        for n, (gb, meas, tog) in views.items():
            if n in self._views:
                v = self._views[n]
                v.group_by, v.measure, v.toggled = gb, meas, tog

    # -- imperative bridges ----------------------------------------------------
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
        """Execute an explicit Query as this viz's current view.

        Legacy/SQL escape hatch: bypasses the declarative state (Undo does
        not cover it) but shares the store, plans and scheduler — the viz's
        pending calibration is preempted iff the query changed.
        """
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

    # -- think time ------------------------------------------------------------
    def idle(self, budget_messages: int | None = None, budget_seconds: float | None = None,
             speculate: int = 0, policy: ThinkTimePolicy | None = None) -> int:
        """Spend user think-time on this session, driven by ONE policy.

        The policy (``policy``, else ``self.policy``, else the Treant's
        default — ``DrainCalibration`` unless configured) first drains
        pending calibrations (preemptible: exhausting the budget keeps
        iterator positions and all materialized messages), then, while the
        shared budget has slack, runs its speculative extras:
        ``FixedKPrefetch(k)`` pre-executes the fan-out for the k nearest σ
        neighbors of the last brush; ``PredictiveThinkTime`` builds
        trajectory-ranked bin cubes and direction-biased σ prefetch.  Returns
        the number of calibration edges processed.

        ``speculate=k`` is deprecated: it maps to ``FixedKPrefetch(k)`` and
        warns once per process.
        """
        if speculate:
            warn_deprecated_once(
                "Session.idle(speculate=)",
                "Session.idle(speculate=k) is deprecated; pass "
                "policy=FixedKPrefetch(k) instead",
            )
            if policy is None:
                policy = FixedKPrefetch(speculate)
        if policy is None:
            policy = self.policy or self._treant.think_time_policy
        return policy.run(self, ThinkTimeBudget(messages=budget_messages, seconds=budget_seconds))

    def _speculate(self, k: int) -> int:
        """Pre-execute the fan-out for up to ``k`` neighbor σ values of the
        last SetFilter; park the absorbed results in the prefetch cache."""
        ev = self._last_filter
        if ev is None:
            return 0
        doms = self.catalog.domains()
        return self._speculate_candidates(ev, speculate_filters(ev, doms[ev.attr], k))

    def _speculate_candidates(self, ev: SetFilter, cands: list[SetFilter]) -> int:
        """Pre-execute the fan-out for explicit candidate σ events on
        ``ev.attr`` (candidate rank = list position, nearest/likeliest
        first); park the absorbed results in the prefetch cache."""
        items: list[tuple[str, Query, CJTEngine]] = []
        # (viz, digest) -> (query, candidate rank)
        meta: dict[tuple[str, str], tuple[Query, int]] = {}
        saved = self._filters.get(ev.attr)
        try:
            for dist, cand in enumerate(cands):
                # derive through the real contract with the candidate σ
                # swapped in, so digests match the eventual real event's
                self._filters[ev.attr] = (self._predicate_of(cand), cand.source)
                for name in sorted(self._views):
                    view = self._views[name]
                    if not view.crossfilter or name == cand.source:
                        continue
                    q = self.derive(name)
                    # a ToggleRelation may have removed every relation that
                    # carries the brush attr from this viz's join scope —
                    # executing would crash placing σ on an invisible attr
                    if not self._treant.sees_attr(q, ev.attr):
                        continue
                    key = (name, q.digest)
                    if (
                        q.digest == self._current[name].digest
                        or key in self._prefetched
                        or key in meta
                    ):
                        continue
                    meta[key] = (q, dist)
                    items.append(
                        (name, q, self._treant.engine_for(q.ring_name, q.measure))
                    )
        finally:
            if saved is None:
                self._filters.pop(ev.attr, None)
            else:
                self._filters[ev.attr] = saved
        if not items:
            return 0
        for key, factor in self.scheduler.speculate(self.id, items).items():
            q, dist = meta[key]
            self._prefetched[key] = _Prefetched(factor, q, dist)
        self._evict_prefetched()
        return len(items)

    def _evict_prefetched(self) -> None:
        """Capacity eviction, farthest-from-anchor first.

        Entries park the fan-out for σ values *near* the user's last brush;
        when ``speculate(k)`` overshoots ``prefetch_capacity`` the useful
        entries are exactly the nearest ones, so evict by descending
        speculation distance (ties: oldest insertion first).
        """
        while len(self._prefetched) > self.prefetch_capacity:
            victim = max(
                enumerate(self._prefetched.items()),
                key=lambda e: (e[1][1].dist, -e[0]),
            )[1][0]
            del self._prefetched[victim]

    # -- bin cubes --------------------------------------------------------------
    def _cube_query(self, q: Query, dim: str) -> Query | None:
        """The cube query serving any σ on ``dim`` for a viz whose derived
        query is ``q``: drop the σ on ``dim``, group by γ∪{dim}.  Build and
        probe both derive the key through here, so the digests meet as long
        as only the σ on ``dim`` differs.  Returns None when the dimension
        is unknown, invisible to the viz's join scope (ToggleRelation), or
        the cube would blow the cell budget."""
        doms = self.catalog.domains()
        if dim not in doms or not self._treant.sees_attr(q, dim):
            return None
        gamma = tuple(dict.fromkeys(q.group_by + (dim,)))
        cells = 1
        for a in gamma:
            cells *= doms[a]
        if cells > think_time_config().cube_cell_budget:
            return None
        return q.without_predicate(dim).with_group_by(*gamma)

    def _build_bin_cube(self, viz: str, dim: str) -> bool:
        """Materialize the γ∪{dim} cube for one viz during think-time.

        Executes through the shared engine with this session's producer tag
        (union-carry widening applies: the cube's messages are the wide ones
        sibling calibrations share), then parks the absorbed factor keyed by
        the cube query's digest."""
        q = self.derive(viz)
        cq = self._cube_query(q, dim)
        if cq is None:
            return False
        key = (viz, cq.digest)
        if key in self._bin_cubes:
            # refresh recency: the policy still predicts this cube, so it
            # must outlive the churn of transient-σ builds (LRU, not FIFO).
            # Register the dim on the entry regardless — when dim is already
            # in the viz's γ, several (viz, dim) targets collapse to the SAME
            # cube query (identical digest), and both the probe and the
            # eviction bookkeeping need the full covered-dim set.
            entry = self._bin_cubes.pop(key)
            entry.dims.add(dim)
            self._bin_cubes[key] = entry
            self._cube_dims.setdefault(viz, set()).add(dim)
            return False
        engine = self._treant.engine_for(cq.ring_name, cq.measure)
        self.store.tag = f"{self.id}:{viz}"
        try:
            factor, stats = engine.execute(cq)
        finally:
            self.store.tag = None
        if dim not in factor.attrs:  # γ collapsed the dim away: not sliceable
            return False
        self._bin_cubes[key] = _BinCube(
            factor=factor, query=cq, dim=dim, viz=viz,
            nbytes=factor_nbytes(factor),
        )
        self._cube_dims.setdefault(viz, set()).add(dim)
        self.scheduler.cube_builds += 1
        self.scheduler.speculative_messages += stats.messages_computed
        if engine.plans is not None:
            engine.plans.stats.cube_builds += 1
        self._evict_bin_cubes()
        return True

    def _match_bin_cube(self, viz: str, q: Query, hint: str | None = None):
        """Find a parked cube covering ``q``: for each dim with a cube on
        this viz, rebuild the cube key from the NEW query (only the σ on
        that dim may differ) and return ``(entry, dim)`` on a digest match.
        A σ-less match (the dim was just cleared) works too — the slice is
        then a pure marginalization, so ClearFilter hits.

        ``hint`` (the triggering event's dimension) is probed first: each
        probe costs a Query rebuild + digest, and the brushed dim is the one
        whose cube matches on the first try.  The q.digest → cube-key
        derivation is memoized: revisited dashboard states (backtracks,
        repeated jumps) skip the Query rebuild entirely.
        """
        dims = self._cube_dims.get(viz)
        if not dims:
            return None
        order = sorted(dims)
        if hint is not None and hint in dims:
            order.remove(hint)
            order.insert(0, hint)
        for dim in order:
            memo_key = (viz, dim, q.digest)
            cd = self._cube_probe_memo.get(memo_key, _UNCACHED)
            if cd is _UNCACHED:
                cq = self._cube_query(q, dim)
                cd = None if cq is None else cq.digest
                if len(self._cube_probe_memo) > 4096:
                    self._cube_probe_memo.clear()
                self._cube_probe_memo[memo_key] = cd
            if cd is None:
                continue
            entry = self._bin_cubes.pop((viz, cd), None)
            if entry is None:
                continue
            self._bin_cubes[(viz, cd)] = entry  # LRU: hit refreshes
            return entry, dim
        return None

    def _probe_bin_cube(self, viz: str, q: Query, hint: str | None = None):
        """Match + slice in one step (the single-viz probe used by the
        serving tier and tests; ``_fan_out`` batches its slices instead)."""
        match = self._match_bin_cube(viz, q, hint)
        if match is None:
            return None
        entry, dim = match
        engine = self._treant.engine_for(q.ring_name, q.measure)
        sliced = slice_bin_cube(
            entry.factor, dim,
            [p.mask for p in q.predicates_on(dim)], q.group_by,
            stats=engine.plans.stats if engine.plans is not None else None,
        )
        self.bin_cube_hits += 1
        return sliced

    def _evict_bin_cubes(self) -> None:
        """Capacity eviction, least-recently-used first: probe hits and
        still-predicted rebuild skips refresh recency, so cubes built under
        a transient σ (one-shot digests) age out ahead of the hot ones."""
        cap = think_time_config().cube_capacity
        while len(self._bin_cubes) > cap:
            key = next(iter(self._bin_cubes))
            self._drop_cube(key)

    def _drop_cube(self, key: tuple[str, str]) -> None:
        entry = self._bin_cubes.pop(key, None)
        if entry is None:
            return
        dims = self._cube_dims.get(entry.viz)
        if dims is None:
            return
        still = set()
        for e in self._bin_cubes.values():
            if e.viz == entry.viz:
                still |= e.dims
        for d in entry.dims - still:
            dims.discard(d)
        if not dims:
            self._cube_dims.pop(entry.viz, None)

    def invalidate_bin_cubes(self, changed) -> int:
        """Drop every cube whose query can see one of the ``changed``
        relations (mirrors the prefetch-cache invalidation on update/flush).
        Returns the number of cubes dropped."""
        stale = [
            k for k, e in self._bin_cubes.items()
            if any(self._treant._sees(e.query, r) for r in changed)
        ]
        for k in stale:
            self._drop_cube(k)
        return len(stale)

    @property
    def bin_cube_bytes(self) -> int:
        return sum(e.nbytes for e in self._bin_cubes.values())

    # -- filters / introspection ----------------------------------------------
    @property
    def filters(self) -> Mapping[str, Predicate]:
        return {a: p for a, (p, _) in self._filters.items()}

    def stats(self) -> dict:
        """Per-session scheduler counters plus the shared store/scheduler
        totals (``*_total``: sessions share one store and one scheduler)."""
        return {
            "vizzes": len(self._views),
            "events": self.events_applied,
            "pending_calibrations": self.scheduler.pending(self.id),
            "preemptions": self.scheduler.session_preemptions(self.id),
            "scheduler_messages_total": self.scheduler.messages,
            "cross_viz_hits_total": self.store.cross_tag_hits,
            "undo_depth": len(self._undo),
            "prefetched": len(self._prefetched),
            "prefetch_hits": self.prefetch_hits,
            "speculative_queries_total": self.scheduler.speculative_queries,
            "bin_cubes": len(self._bin_cubes),
            "bin_cube_hits": self.bin_cube_hits,
            "bin_cube_bytes": self.bin_cube_bytes,
            "trajectory": self.trajectory.state(),
        }

    def close(self) -> None:
        """Tear the session down without leaking store state.

        Drops pending calibrations, *unpins* every base CJT pinned at open,
        and evicts the unpinned messages this session's interactions produced
        (producer tags ``"{sid}:*"``).  Untagged offline-calibration messages
        stay cached for other sessions.
        """
        self.scheduler.drop(self.id)
        for q in self._pinned_queries.values():
            self._treant.engine_for(q.ring_name, q.measure).unpin_query(q)
        self._pinned_queries.clear()
        self.store.drop_producer(f"{self.id}:")
        self._prefetched.clear()
        self._bin_cubes.clear()
        self._cube_dims.clear()
        self._treant._sessions.pop(self.id, None)
