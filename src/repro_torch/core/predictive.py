"""Think-time policies: ONE policy object owns the idle budget.

User *think-time* hides the cost of the next interaction.  A
:class:`ThinkTimePolicy` decides, under one shared :class:`ThinkTimeBudget`,
how idle capacity is spent across the think-time work items:

- **calibration drains** (the scheduler's pending CJT passes — always first:
  an uncalibrated viz makes every later interaction slow),
- **per-dimension bin cubes** (:class:`PredictiveThinkTime` only): for a viz
  with group-by γ and a likely-next brush dimension *d*, materialize the
  γ∪{d} aggregate *without* the σ on d.  Any later ``SetFilter`` /
  ``ClearFilter`` on *d* is then served by slicing the cube
  (``Factor.select`` + ⊕-marginalize, exact for every semiring: σ
  zero-annotates non-matching tuples and 0̄ is the ⊕-identity) with zero
  store probes and zero plan executions, for *any* σ on the dimension,
- **residual σ prefetch** (whole-fan-out pre-execution for predicted next σ
  values, direction-biased),
- **background flush** (server tier; it runs before the policy because
  queued stream data makes every other item stale).

Policies: :class:`DrainCalibration` (calibration only, the default),
:class:`FixedKPrefetch` (calibration, then the k-nearest σ prefetch; the
deprecated ``speculate=k`` arguments map onto it) and
:class:`PredictiveThinkTime` (cube builds and prefetch candidates ranked by
a per-session :class:`BrushTrajectory`).

Config: every think-time knob resolves here, once, into a typed
:class:`ThinkTimeConfig` (env override wins, cached,
``reset_think_time_config()`` for tests).  The default cube cell budget is
32 × the union-carry budget (``plans.calibration_union_budget()``), because
a bin cube is a union-carry message set whose widest factor carries the
γ∪{d} product.
"""

from __future__ import annotations

import dataclasses
import os
import time
import warnings
from typing import TYPE_CHECKING

from repro_torch import trace
from .plans import UNION_BUDGET, calibration_union_budget
from .query import Query

if TYPE_CHECKING:  # pragma: no cover — cycle guard (dashboard imports us)
    from .dashboard import Session, SetFilter


# ---------------------------------------------------------------------------
# Typed think-time config (the one place every speculation knob resolves)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ThinkTimeConfig:
    """All think-time/speculation knobs, resolved once with env overrides.

    ``union_budget`` is the resolved union-carry budget (env
    ``REPRO_CALIBRATION_UNION_BUDGET`` → the card's cost profile → static
    512; see ``plans.calibration_union_budget``);
    ``cube_cell_budget`` defaults to ``32 ×`` that budget because the widest
    factor a cube build materializes carries the γ∪{dim} domain product —
    the same quantity the union budget bounds for shared calibration passes,
    minus the per-row ⊗-lane pressure (cubes absorb once, they don't carry
    lanes through the whole fact scan on every message).
    """

    prefetch_capacity: int = 128   # REPRO_PREFETCH_CAPACITY
    prefetch_k: int = 2            # REPRO_PREFETCH_K (predictive residual σ)
    bin_cubes: bool = True         # REPRO_BIN_CUBE (0 disables cube builds)
    cube_builds_per_idle: int = 4  # REPRO_BIN_CUBE_MAX_DIMS
    cube_capacity: int = 64        # REPRO_BIN_CUBE_CAPACITY (per session)
    cube_cell_budget: int = 16384  # REPRO_BIN_CUBE_CELLS (γ∪{dim} ∏ domains)
    union_budget: int = UNION_BUDGET  # resolved REPRO_CALIBRATION_UNION_BUDGET


_UNSET = object()
_config_cache: object = _UNSET


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return int(raw)
    except ValueError:  # pragma: no cover — malformed env
        return default


def _env_bool(name: str, default: bool) -> bool:
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.lower() not in ("0", "false")


def think_time_config(refresh: bool = False) -> ThinkTimeConfig:
    """The resolved (and cached) think-time config; env overrides win."""
    global _config_cache
    if refresh or _config_cache is _UNSET:
        union = calibration_union_budget()
        _config_cache = ThinkTimeConfig(
            prefetch_capacity=_env_int("REPRO_PREFETCH_CAPACITY", 128),
            prefetch_k=_env_int("REPRO_PREFETCH_K", 2),
            bin_cubes=_env_bool("REPRO_BIN_CUBE", True),
            cube_builds_per_idle=_env_int("REPRO_BIN_CUBE_MAX_DIMS", 4),
            cube_capacity=_env_int("REPRO_BIN_CUBE_CAPACITY", 64),
            cube_cell_budget=_env_int("REPRO_BIN_CUBE_CELLS", 32 * union),
            union_budget=union,
        )
    return _config_cache


def reset_think_time_config() -> None:
    """Drop the cached config (tests that flip env knobs call this)."""
    global _config_cache
    _config_cache = _UNSET


# ---------------------------------------------------------------------------
# Deprecation shims (warn exactly once per process)
# ---------------------------------------------------------------------------

_warned: set[str] = set()


def warn_deprecated_once(key: str, message: str) -> None:
    """Emit ``DeprecationWarning`` the FIRST time ``key`` is seen.

    A dashboard session can call ``idle(speculate=k)`` thousands of times a
    minute; one warning is signal, thousands are noise.  Tests pin the
    exactly-once contract via :func:`reset_deprecation_warnings`.
    """
    if key in _warned:
        return
    _warned.add(key)
    warnings.warn(message, DeprecationWarning, stacklevel=3)


def reset_deprecation_warnings() -> None:
    _warned.clear()


# ---------------------------------------------------------------------------
# Budget
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ThinkTimeBudget:
    """One shared budget for a think-time tick.

    ``messages`` bounds calibration edges, ``seconds`` bounds wall time for
    the whole tick (calibration AND speculative work), ``viz`` optionally
    scopes the drain to one viz (the legacy ``Treant.think_time`` contract).
    """

    messages: int | None = None
    seconds: float | None = None
    viz: str | None = None

    def slack(self, t0: float, done_messages: int) -> bool:
        """Is there budget left after the calibration drain?"""
        if self.seconds is not None and time.perf_counter() - t0 >= self.seconds:
            return False
        if self.messages is not None and done_messages >= self.messages:
            return False
        return True

    def seconds_left(self, t0: float) -> bool:
        return (
            self.seconds is None
            or time.perf_counter() - t0 < self.seconds
        )


# ---------------------------------------------------------------------------
# Bin cubes (the parked per-dimension materializations)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _BinCube:
    """One parked γ∪{dim} aggregate for (viz, dim).

    ``query`` is the cube query (viz's derived query minus the σ on ``dim``,
    grouped by γ∪{dim}) — its digest is the park key, and ``Treant.update`` /
    ``flush`` use it to invalidate only cubes that can *see* a changed
    relation.  Unlike ``_Prefetched`` entries, a cube is NOT popped on a hit:
    it serves every subsequent σ on its dimension until invalidated.

    ``dims`` is the full set of brush dimensions this cube covers: when a
    dim is already in the viz's γ, several (viz, dim) targets collapse to
    the SAME cube query (identical digest), and eviction bookkeeping must
    not forget a covered dim just because a *different* cube that happened
    to share it was dropped.
    """

    factor: object
    query: Query
    dim: str
    viz: str
    nbytes: int = 0
    dims: set = dataclasses.field(default_factory=set)

    def __post_init__(self):
        self.dims.add(self.dim)


# ---------------------------------------------------------------------------
# Per-session brush-trajectory model
# ---------------------------------------------------------------------------

class BrushTrajectory:
    """Lightweight online model of one session's brush stream.

    Tracks, with EWMAs (decay ``alpha``):

    - ``direction``: per-attr signed brush drift (+1 = the σ window moves up
      the domain) — biases which σ-prefetch candidates run first;
    - ``dwell``: seconds between brushes — how much think-time a tick can
      expect (surfaced for introspection/benchmarks);
    - ``switch_prob``: probability the NEXT brush lands on a *different*
      dimension — ranks cube dimensions (low switch probability → the
      current dimension dominates);
    - attr/viz recency plus each dimension's last crossfilter source viz —
      the "which viz next" prior (the viz the user is brushing from first).
    """

    def __init__(self, alpha: float = 0.4):
        self.alpha = alpha
        self.direction: dict[str, float] = {}
        self.dwell: float = 0.0
        self.switch_prob: float = 0.5
        self.events: int = 0
        self.last: "SetFilter | None" = None
        self._last_t: float | None = None
        self._attr_recency: list[str] = []   # most recent LAST
        self._viz_recency: list[str] = []    # brush source vizzes, recent LAST
        self._source: dict[str, str | None] = {}

    @staticmethod
    def _anchor(ev: "SetFilter") -> int | None:
        if ev.values:
            return min(ev.values)
        return ev.lo

    def observe(self, ev: "SetFilter", now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        a = self.alpha
        prev = self.last
        if self._last_t is not None:
            gap = max(now - self._last_t, 0.0)
            self.dwell = gap if self.events <= 1 else (
                (1 - a) * self.dwell + a * gap
            )
        if prev is not None:
            switched = 1.0 if prev.attr != ev.attr else 0.0
            self.switch_prob = (1 - a) * self.switch_prob + a * switched
            if prev.attr == ev.attr:
                p0, p1 = self._anchor(prev), self._anchor(ev)
                if p0 is not None and p1 is not None and p1 != p0:
                    step = 1.0 if p1 > p0 else -1.0
                    cur = self.direction.get(ev.attr, 0.0)
                    self.direction[ev.attr] = (1 - a) * cur + a * step
        self.last = ev
        self._last_t = now
        self.events += 1
        if ev.attr in self._attr_recency:
            self._attr_recency.remove(ev.attr)
        self._attr_recency.append(ev.attr)
        self._source[ev.attr] = ev.source
        if ev.source is not None:
            if ev.source in self._viz_recency:
                self._viz_recency.remove(ev.source)
            self._viz_recency.append(ev.source)

    def forget(self, attr: str) -> None:
        """The user abandoned this dimension (ClearFilter): stop predicting
        around it, but keep it in the recency tail — backtracks are common."""
        if self.last is not None and self.last.attr == attr:
            self.last = None

    # -- predictions ----------------------------------------------------------
    def ranked_dims(self) -> list[str]:
        """Brush dimensions by predicted next-brush probability.

        The most recent dimension leads unless the switch probability says
        the user hops dimensions (then the *previous* dimension — the classic
        A/B crossfilter alternation — outranks it).  Older dimensions follow
        most-recent-first: exploratory backtracking revisits recent ground.
        """
        recent = list(reversed(self._attr_recency))
        if len(recent) >= 2 and self.switch_prob > 0.5:
            recent[0], recent[1] = recent[1], recent[0]
        return recent

    def ranked_vizzes(self, names: list[str]) -> list[str]:
        """``names`` reordered by the next-viz prior: crossfilter source
        vizzes of recent brushes first (most recent first), then the rest in
        the given order."""
        srcs = [v for v in reversed(self._viz_recency) if v in names]
        rest = [v for v in names if v not in srcs]
        return srcs + rest

    def source_of(self, attr: str) -> str | None:
        return self._source.get(attr)

    def next_filters(self, domain: int, k: int) -> list["SetFilter"]:
        """Up to ``k`` predicted next σ values for the last-brushed dim.

        The nearest-first alternating candidates of ``speculate_filters``
        reordered by the learned drift: with a positive direction EWMA the
        up-domain neighbors run first (ties keep nearest-first order), so a
        steadily advancing brush gets its next window prefetched at rank 0.
        """
        from .dashboard import speculate_filters  # local: import cycle

        ev = self.last
        if ev is None or k <= 0:
            return []
        cands = speculate_filters(ev, domain, 2 * k)
        drift = self.direction.get(ev.attr, 0.0)
        if abs(drift) > 1e-9:
            anchor = self._anchor(ev) or 0
            sign = 1.0 if drift > 0 else -1.0

            def key(item):
                rank, c = item
                pos = self._anchor(c)
                along = pos is not None and (pos - anchor) * sign > 0
                return (0 if along else 1, rank)

            cands = [c for _, c in sorted(enumerate(cands), key=key)]
        return cands[:k]

    def state(self) -> dict:
        return {
            "events": self.events,
            "dwell_ewma_s": round(self.dwell, 6),
            "switch_prob": round(self.switch_prob, 4),
            "direction": {a: round(v, 4) for a, v in self.direction.items()},
            "ranked_dims": self.ranked_dims(),
        }


# ---------------------------------------------------------------------------
# Policies
# ---------------------------------------------------------------------------

class ThinkTimePolicy:
    """Base policy: drain pending calibration, then (subclass) extras.

    ``run`` is what ``Session.idle`` / ``Treant.think_time`` call with the
    whole budget; the server drains the shared scheduler once globally and
    calls :meth:`extras` per session instead (see ``TreantServer.idle``).
    Returns the number of calibration edges processed, preserving the legacy
    ``idle``/``think_time`` return contract.
    """

    name = "policy"

    def run(self, session: "Session", budget: ThinkTimeBudget) -> int:
        t0 = time.perf_counter()
        with trace.span("think.drain") as sp:
            done = session.scheduler.run(
                budget_messages=budget.messages,
                budget_seconds=budget.seconds,
                session=session.id,
                viz=budget.viz,
            )
            sp.set(edges=done)
        if budget.slack(t0, done):
            self.extras(session, budget, t0)
        return done

    def extras(self, session: "Session", budget: ThinkTimeBudget,
               t0: float) -> None:
        """Speculative work after the calibration drain (default: none)."""


class DrainCalibration(ThinkTimePolicy):
    """Calibration only — the default policy, and exactly the behavior of
    ``Session.idle()`` with no speculation configured."""

    name = "drain"


class FixedKPrefetch(ThinkTimePolicy):
    """The legacy ``speculate=k`` heuristic as a policy: after the drain,
    pre-execute the fan-out for the k nearest neighbor σ values of the last
    brush.  ``Session.idle(speculate=k)`` and ``TreantServer(speculate=k)``
    deprecation-shim onto ``FixedKPrefetch(k)`` — bit-identical behavior."""

    name = "fixed_k"

    def __init__(self, k: int):
        self.k = int(k)

    def extras(self, session: "Session", budget: ThinkTimeBudget,
               t0: float) -> None:
        if self.k > 0:
            session._speculate(self.k)


class PredictiveThinkTime(ThinkTimePolicy):
    """Trajectory-ranked think-time: bin cubes first, then biased σ prefetch.

    Work items, in rank order (each consumes the shared ``seconds`` budget;
    every attempted item counts as one ``policy_decisions`` tick):

    1. **Bin cubes** for (viz, dim) pairs — dims by ``ranked_dims()`` (the
       dimension-switch EWMA), vizzes by ``ranked_vizzes()`` (crossfilter
       source vizzes first), skipping each dim's own source viz (its query
       never carries that σ) and anything over the cube cell budget.  At
       most ``cube_builds_per_idle`` builds per tick.
    2. **Residual σ prefetch** for the last-brushed dimension,
       direction-biased (``next_filters``), covering the cold gap while a
       cube is not (yet) buildable — e.g. the dimension blew the cell
       budget.

    With no brush history the policy degrades to :class:`DrainCalibration`
    exactly — ``idle()`` on a fresh session stays calibration-only.
    """

    name = "predictive"

    def __init__(
        self,
        cube_builds_per_idle: int | None = None,
        prefetch_k: int | None = None,
        config: ThinkTimeConfig | None = None,
    ):
        self._cube_builds = cube_builds_per_idle
        self._prefetch_k = prefetch_k
        self._config = config

    def config(self) -> ThinkTimeConfig:
        return self._config if self._config is not None else think_time_config()

    def cube_targets(self, session: "Session") -> list[tuple[str, str]]:
        """Ranked (viz, dim) cube candidates for this session."""
        traj = session.trajectory
        names = [
            n for n in sorted(session._views)
            if session._views[n].crossfilter
        ]
        out: list[tuple[str, str]] = []
        for dim in traj.ranked_dims():
            src = traj.source_of(dim)
            for viz in traj.ranked_vizzes(names):
                if viz != src:
                    out.append((viz, dim))
        return out

    def extras(self, session: "Session", budget: ThinkTimeBudget,
               t0: float) -> None:
        cfg = self.config()
        traj = session.trajectory
        if traj.last is None and not traj.ranked_dims():
            return
        decisions = 0
        if cfg.bin_cubes:
            cap = (
                self._cube_builds if self._cube_builds is not None
                else cfg.cube_builds_per_idle
            )
            built = 0
            for viz, dim in self.cube_targets(session):
                if built >= cap or not budget.seconds_left(t0):
                    break
                decisions += 1
                if session._build_bin_cube(viz, dim):
                    built += 1
        ev = traj.last
        k = self._prefetch_k if self._prefetch_k is not None else cfg.prefetch_k
        if ev is not None and k > 0 and budget.seconds_left(t0):
            doms = session.catalog.domains()
            if ev.attr in doms:
                cands = traj.next_filters(doms[ev.attr], k)
                if cands:
                    decisions += 1
                    session._speculate_candidates(ev, cands)
        session.scheduler.policy_decisions += decisions
