"""TreantServer: N concurrent dashboard sessions over ONE Treant.

The paper positions Treant as dashboard *middleware*; everything below
``repro_torch.serve`` assumes one :class:`~repro_torch.core.dashboard.Session`
driven synchronously by one caller.  This module turns that single-user
engine into a serving tier:

- **Event queue with micro-batching and backpressure.**  ``submit`` enqueues
  typed dashboard events against a bounded queue.  A newer ``SetFilter`` /
  ``ClearFilter`` on the same dimension (or ``SwapMeasure`` on the same viz)
  from the same session *coalesces* the queued one away — the user moved the
  brush again before the server got to the stale position, so it is never
  executed.  When the queue is full, ``backpressure="drain"`` synchronously
  drains one micro-batch to make room and ``"reject"`` raises
  :class:`QueueFull` (the client retries).

- **Cross-session batched fan-out.**  ``step`` drains one micro-batch with
  per-session fairness (at most one event per session per batch, FIFO among
  sessions), records every event on its session's declarative state, and
  then runs ONE fan-out for the whole batch: identical derived queries
  across sessions dedupe to a single execution (sessions over one shared
  ``DashboardSpec`` brushing the same σ — the common BI case), and the rest
  group through ``CJTEngine.execute_many``, whose ``absorb_batch_key``
  grouping is session-agnostic — so two users brushing *different* σ values
  of the same spec still share one ``level_segment_aggregate`` launch and
  one calibrated message set.  Results are distributed per session
  bit-identically to a serial per-session apply on integer-valued data.

- **Global store byte budget.**  ``max_store_bytes`` bounds the shared
  :class:`~repro_torch.core.calibration.MessageStore`; eviction is priority-
  ordered (pin-state → recency → estimated recompute cost) and never drops
  pinned or in-flight entries — an evicted message recomputes on demand,
  bit-identically, so budgets trade latency for memory, never correctness.

- **Server-driven think-time.**  ``idle`` uses empty-queue capacity to run
  background ``flush()`` ticks (streaming ingest moves off the caller
  thread), drain the shared :class:`ThinkTimeScheduler`, and run the
  configured :class:`~repro_torch.core.predictive.ThinkTimePolicy`'s speculative
  extras per session — σ-prefetch fan-outs and bin cubes both land in a
  *shared* pool any session may hit (a pooled γ∪{dim} cube serves every σ
  on its dimension, not just the parked digest).  The legacy
  ``TreantServer(speculate=k)`` deprecation-shims onto ``FixedKPrefetch(k)``.

Counters surface through ``Treant.cache_stats()['serve']``.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Iterable

from repro_torch.core.calibration import CJTEngine, ExecStats, synchronize
from repro_torch.core.plans import slice_bin_cube
from repro_torch.core.predictive import (
    FixedKPrefetch,
    ThinkTimeBudget,
    ThinkTimePolicy,
    warn_deprecated_once,
)
from repro_torch.core.dashboard import (
    ApplyResult,
    ClearFilter,
    DashboardSpec,
    InteractionResult,
    Session,
    SetFilter,
    SwapMeasure,
    Undo,
    _group_by_engine,
)
from repro_torch.core.query import Query
from repro_torch.core.treant import Treant


class QueueFull(RuntimeError):
    """Raised by ``submit`` under ``backpressure="reject"`` when the bounded
    event queue is at capacity (the client should retry after a beat)."""


@dataclasses.dataclass
class ServeStats:
    """Cumulative serving-tier counters (``cache_stats()['serve']``)."""

    events_submitted: int = 0
    events_processed: int = 0
    batches: int = 0                  # micro-batches drained
    coalesced_events: int = 0         # superseded while queued (never executed)
    rejected_events: int = 0          # QueueFull raises under "reject"
    backpressure_drains: int = 0      # forced drains under "drain"
    queue_peak: int = 0               # high-water queue depth
    cross_session_batch_width: int = 0  # max distinct sessions in one dispatch
    dedup_hits: int = 0               # events served by a sibling's execution
    shared_prefetch_hits: int = 0     # events served from the shared pool
    pool_cube_hits: int = 0           # events sliced from a pooled bin cube
    pool_evictions: int = 0           # shared-pool entries dropped at capacity
    background_flushes: int = 0       # flush() ticks run off the caller thread
    think_time_messages: int = 0      # calibration edges advanced while idle
    errors: int = 0                   # events whose _record raised


@dataclasses.dataclass
class _Queued:
    sid: str
    event: object
    seq: int


@dataclasses.dataclass
class _Pooled:
    """One shared-pool speculative result (any session may hit it).

    ``cost`` estimates what re-materializing the entry would take (rows the
    query's join sees); ``hot`` marks entries hit in the current micro-batch
    so they are never evicted before the batch's siblings finish reading.
    ``dim`` is set on bin-cube entries (the γ∪{dim} aggregate is sliceable
    for ANY σ on that dimension, not just the exact parked digest)."""

    factor: object
    query: Query
    cost: float = 0.0
    hot: bool = False
    dim: str | None = None


class ServerSession:
    """A client's handle on one served session.

    Wraps the underlying :class:`Session` (exposed as ``.session`` for
    reads/introspection); writes go through the server's queue so they batch
    with sibling sessions' events.
    """

    def __init__(self, server: "TreantServer", session: Session):
        self._server = server
        self.session = session
        self.id = session.id
        # per-session results of the last batch this session participated in
        self.last_result: ApplyResult | None = None
        self._pinned_wm = server.treant.catalog.pin_watermark()

    def submit(self, event) -> None:
        self._server.submit(self.id, event)

    def read(self, viz: str) -> InteractionResult:
        return self.session.read(viz)

    def query_of(self, viz: str) -> Query:
        return self.session.query_of(viz)

    def close(self) -> None:
        self._server.close_session(self.id)

    # -- snapshot pinning -----------------------------------------------------
    def _refresh_pin(self) -> None:
        """Advance the commit-log pin to the watermark this session now
        reads; the old snapshot becomes trimmable once nobody holds it."""
        cat = self._server.treant.catalog
        if self._pinned_wm != cat.watermark:
            cat.release_watermark(self._pinned_wm)
            self._pinned_wm = cat.pin_watermark()

    def _release_pin(self) -> None:
        self._server.treant.catalog.release_watermark(self._pinned_wm)


class TreantServer:
    """Admit N concurrent sessions over one Treant/store/plan-cache."""

    def __init__(
        self,
        treant: Treant,
        max_queue: int = 256,
        backpressure: str = "drain",
        max_store_bytes: int | None = None,
        think_budget_messages: int = 64,
        speculate: int = 0,
        pool_capacity: int = 256,
        policy: ThinkTimePolicy | None = None,
    ):
        if backpressure not in ("drain", "reject"):
            raise ValueError(f"unknown backpressure policy {backpressure!r}")
        self.treant = treant
        self.max_queue = max_queue
        self.backpressure = backpressure
        self.think_budget_messages = think_budget_messages
        self.speculate = speculate
        if speculate:
            warn_deprecated_once(
                "TreantServer(speculate=)",
                "TreantServer(speculate=k) is deprecated; pass "
                "policy=FixedKPrefetch(k) instead",
            )
            if policy is None:
                policy = FixedKPrefetch(speculate)
        # None falls back to the Treant's default policy at each idle tick
        self.policy = policy
        self.pool_capacity = pool_capacity
        if max_store_bytes is not None:
            treant.store.max_bytes = max_store_bytes
        treant._server = self
        self._queue: deque[_Queued] = deque()
        self._seq = 0
        self._sessions: dict[str, ServerSession] = {}
        # shared speculative-prefetch pool: query digest -> parked fan-out
        # result; insertion order IS recency order (hits reinsert at the
        # end), and capacity eviction takes the cheapest-to-recompute entry
        # of the coldest window — same policy as the message store's byte
        # budget, minus pins: recency, then recompute cost
        self._pool: dict[str, _Pooled] = {}
        self.stats_ = ServeStats()

    # -- sessions -------------------------------------------------------------
    def open_session(
        self, spec: DashboardSpec, name: str | None = None, calibrate: bool = True
    ) -> ServerSession:
        sess = self.treant.open_session(spec, name=name, calibrate=calibrate)
        handle = ServerSession(self, sess)
        self._sessions[handle.id] = handle
        return handle

    def close_session(self, sid: str) -> None:
        handle = self._sessions.pop(sid, None)
        if handle is None:
            return
        # drop the session's queued events (they will never be served)
        self._queue = deque(q for q in self._queue if q.sid != sid)
        handle._release_pin()
        handle.session.close()

    @property
    def sessions(self) -> tuple[str, ...]:
        return tuple(sorted(self._sessions))

    # -- event queue ----------------------------------------------------------
    def submit(self, sid: str, event) -> None:
        """Enqueue one event; coalesce superseded queued work; backpressure."""
        if sid not in self._sessions:
            raise KeyError(f"no server session {sid!r}")
        self.stats_.events_submitted += 1
        self._coalesce(sid, event)
        if len(self._queue) >= self.max_queue:
            if self.backpressure == "reject":
                self.stats_.rejected_events += 1
                raise QueueFull(
                    f"event queue at capacity ({self.max_queue}); retry"
                )
            self.stats_.backpressure_drains += 1
            self.step()
        self._queue.append(_Queued(sid, event, self._seq))
        self._seq += 1
        self.stats_.queue_peak = max(self.stats_.queue_peak, len(self._queue))

    def _coalesce(self, sid: str, event) -> None:
        """Drop queued same-session events the new one supersedes.

        A newer σ on the same dimension (SetFilter/ClearFilter share the
        last-writer-wins ``_filters[attr]`` slot) or a newer measure on the
        same viz obsoletes the queued event — the stale brush position is
        never executed.  Sessions with a queued ``Undo`` are exempt: each
        applied event pushes an undo snapshot, so dropping one would change
        what Undo reverts to.
        """
        if isinstance(event, (SetFilter, ClearFilter)):
            key = ("filter", event.attr)
        elif isinstance(event, SwapMeasure):
            key = ("measure", event.viz)
        else:
            return
        if any(q.sid == sid and isinstance(q.event, Undo) for q in self._queue):
            return

        def _key(ev):
            if isinstance(ev, (SetFilter, ClearFilter)):
                return ("filter", ev.attr)
            if isinstance(ev, SwapMeasure):
                return ("measure", ev.viz)
            return None

        before = len(self._queue)
        self._queue = deque(
            q for q in self._queue
            if not (q.sid == sid and _key(q.event) == key)
        )
        self.stats_.coalesced_events += before - len(self._queue)

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    # -- micro-batch draining (the cross-session fan-out) ----------------------
    def _next_batch(self) -> list[_Queued]:
        """At most one event per session, FIFO among sessions (fairness: a
        bursty session cannot starve siblings out of a batch)."""
        batch: list[_Queued] = []
        taken: set[str] = set()
        rest: deque[_Queued] = deque()
        while self._queue:
            q = self._queue.popleft()
            if q.sid in taken:
                rest.append(q)
            else:
                taken.add(q.sid)
                batch.append(q)
        self._queue = rest
        return batch

    def step(self) -> int:
        """Drain ONE micro-batch; returns the number of events processed.

        All events are recorded on their sessions' declarative state first,
        then the union of affected (session, viz) pairs executes as one
        shared fan-out: prefetch-pool hits and cross-session duplicates are
        served without execution, and the remainder dispatches through ONE
        ``execute_many`` per engine so sibling sessions' absorptions share
        batched launches and one calibrated message set; the device syncs
        once per batch.
        """
        batch = self._next_batch()
        if not batch:
            return 0
        self.stats_.batches += 1
        # batch boundary: last batch's pool hits lose their eviction shield
        for pooled in self._pool.values():
            pooled.hot = False
        participants: list[tuple[ServerSession, object]] = []
        for q in batch:
            handle = self._sessions.get(q.sid)
            if handle is None:  # closed while queued
                continue
            try:
                changed = handle.session._record(q.event)
            except Exception:
                self.stats_.errors += 1
                continue
            self.stats_.events_processed += 1
            if changed:
                participants.append((handle, q.event))
        self._fan_out(participants)
        for handle, _ in participants:
            handle._refresh_pin()
        return len(batch)

    def _fan_out(self, participants: list[tuple[ServerSession, object]]) -> None:
        # (handle, viz, query) for every re-rendering viz across all sessions
        work: list[tuple[ServerSession, str, Query]] = []
        derived_by_sid: dict[str, dict[str, Query]] = {}
        for handle, _ in participants:
            derived, affected = handle.session._derived_affected()
            derived_by_sid[handle.id] = derived
            for viz in affected:
                work.append((handle, viz, derived[viz]))
        if not work:
            for handle, event in participants:
                handle.last_result = ApplyResult(
                    event, (), {}, dict(handle.session._current), 0.0
                )
            return
        results: dict[tuple[str, str], InteractionResult] = {}
        # 1) prefetch: session-local first (exact _fan_out semantics), then
        #    the server's shared pool (any session may hit another's parked
        #    speculation — digests are session-agnostic), then bin cubes —
        #    session-local and pooled — which cover ANY σ on their dimension
        to_exec: list[tuple[ServerSession, str, Query]] = []
        pool_dims = sorted({
            e.dim for e in self._pool.values() if e.dim is not None
        })
        for handle, viz, q in work:
            sess = handle.session
            hit = sess._prefetched.pop((viz, q.digest), None)
            if hit is not None:
                sess.prefetch_hits += 1
                results[(handle.id, viz)] = InteractionResult(
                    hit.factor, ExecStats(prefetch_hits=1), 0.0, 0
                )
                continue
            pooled = self._pool.get(q.digest)
            if pooled is not None:
                self.stats_.shared_prefetch_hits += 1
                # a hit refreshes recency (reinsert at the warm end) and
                # shields the entry from eviction for the rest of this batch
                del self._pool[q.digest]
                self._pool[q.digest] = pooled
                pooled.hot = True
                results[(handle.id, viz)] = InteractionResult(
                    pooled.factor, ExecStats(prefetch_hits=1), 0.0, 0
                )
                continue
            sliced = sess._probe_bin_cube(viz, q)
            if sliced is not None:
                results[(handle.id, viz)] = InteractionResult(
                    sliced, ExecStats(bin_cube_hits=1), 0.0, 0
                )
                continue
            sliced = self._probe_pool_cube(sess, q, pool_dims)
            if sliced is not None:
                results[(handle.id, viz)] = InteractionResult(
                    sliced, ExecStats(bin_cube_hits=1), 0.0, 0
                )
                continue
            to_exec.append((handle, viz, q))
        # 2) dedupe identical queries across sessions: execute once, share
        #    the factor (the shared-spec same-σ case)
        first_of: dict[str, tuple[ServerSession, str, Query]] = {}
        followers: dict[str, list[tuple[ServerSession, str]]] = {}
        for handle, viz, q in to_exec:
            if q.digest in first_of:
                followers.setdefault(q.digest, []).append((handle, viz))
            else:
                first_of[q.digest] = (handle, viz, q)
        uniques = list(first_of.values())
        # 3) ONE execute_many per engine across ALL sessions: absorb_batch_key
        #    grouping is session-agnostic, so sibling sessions' differing-σ
        #    absorptions ride one batched launch
        executed: dict[str, tuple[object, ExecStats]] = {}
        pending = []
        for engine, items in _group_by_engine(
            (self.treant.engine_for(q.ring_name, q.measure), (handle, viz, q))
            for handle, viz, q in uniques
        ):
            if self.treant.batch_fanout and len(items) > 1:
                group = engine.execute_many(
                    [q for _, _, q in items], sync=False,
                    tags=[f"{h.id}:{viz}" for h, viz, _ in items],
                )
            else:
                group = []
                for handle, viz, q in items:
                    store = self.treant.store
                    store.tag = f"{handle.id}:{viz}"
                    try:
                        group.append(engine.execute(q, sync=False))
                    finally:
                        store.tag = None
            for (handle, viz, q), (factor, stats) in zip(items, group):
                executed[q.digest] = (factor, stats)
                pending.append(factor.field)
                self._schedule(handle, viz, q, engine)
        synchronize(pending)
        # cross-session width: the max of (a) distinct sessions inside one
        # batched launch and (b) distinct sessions sharing one deduped
        # execution — both are "one dispatch served k sessions"
        width = max(
            (st.batch_sessions for _, st in executed.values()), default=0
        )
        for digest, flw in followers.items():
            owners = {h.id for h, _ in flw} | {first_of[digest][0].id}
            width = max(width, len(owners))
        self.stats_.cross_session_batch_width = max(
            self.stats_.cross_session_batch_width, width
        )
        # 4) distribute: leaders
        for digest, (handle, viz, q) in first_of.items():
            factor, stats = executed[digest]
            results[(handle.id, viz)] = InteractionResult(
                factor, stats, 0.0, stats.steiner_size
            )
        #    followers share the leader's factor verbatim (bit-identical by
        #    construction) and re-schedule their own calibration
        for digest, flw in followers.items():
            factor, _ = executed[digest]
            for handle, viz in flw:
                self.stats_.dedup_hits += 1
                results[(handle.id, viz)] = InteractionResult(
                    factor, ExecStats(messages_reused=1), 0.0, 0
                )
        # 5) commit per-session view state; park calibration for every
        #    re-rendered viz that was NOT a leader (leaders scheduled above)
        leaders = {(h.id, v) for h, v, _ in uniques}
        for handle, viz, q in work:
            handle.session._current[viz] = q
            if (handle.id, viz) not in leaders:
                engine = self.treant.engine_for(q.ring_name, q.measure)
                self._schedule(handle, viz, q, engine)
        for handle, event in participants:
            sess = handle.session
            derived = derived_by_sid[handle.id]
            affected = tuple(
                viz for h, viz, _ in work if h.id == handle.id
            )
            handle.last_result = ApplyResult(
                event, affected,
                {viz: results[(handle.id, viz)]
                 for viz in affected if (handle.id, viz) in results},
                derived, 0.0,
            )

    def _schedule(self, handle: ServerSession, viz: str, q: Query,
                  engine: CJTEngine) -> None:
        self.treant.scheduler.schedule(handle.id, viz, q, engine)

    def _probe_pool_cube(self, sess: Session, q: Query, pool_dims):
        """Serve ``q`` from a pooled bin cube (possibly another session's):
        for each dimension with a cube in the pool, rebuild the cube digest
        from the incoming query and slice on a match."""
        for dim in pool_dims:
            cq = sess._cube_query(q, dim)
            if cq is None:
                continue
            entry = self._pool.get(cq.digest)
            if entry is None or entry.dim != dim:
                continue
            del self._pool[cq.digest]  # recency refresh + batch shield
            self._pool[cq.digest] = entry
            entry.hot = True
            self.stats_.pool_cube_hits += 1
            sess.bin_cube_hits += 1
            engine = self.treant.engine_for(q.ring_name, q.measure)
            return slice_bin_cube(
                entry.factor, dim,
                [p.mask for p in q.predicates_on(dim)], q.group_by,
                stats=engine.plans.stats if engine.plans is not None else None,
            )
        return None

    # -- server-driven think-time ----------------------------------------------
    def idle(self, budget_messages: int | None = None) -> int:
        """Spend empty-queue capacity on background work.

        Background flush always runs first (queued stream data makes every
        other think-time item stale), then ONE global scheduler drain under
        ``budget_messages`` (default: the server's configured budget), then
        the think-time policy's speculative extras per session
        (``self.policy``, else the Treant's default) — σ prefetch and/or bin
        cubes, both published into the shared pool so ANY session hitting
        the same digest (or any σ on a pooled cube's dimension) is served.
        Returns the number of calibration edges advanced.
        """
        if self._queue:
            return 0  # queued interactive work always wins
        if any(b.has_pending for b in self.treant._streams.values()):
            self.treant.flush()
            self.stats_.background_flushes += 1
            for handle in self._sessions.values():
                handle._refresh_pin()
        budget = (
            budget_messages if budget_messages is not None
            else self.think_budget_messages
        )
        done = self.treant.scheduler.run(budget_messages=budget)
        self.stats_.think_time_messages += done
        policy = self.policy or self.treant.think_time_policy
        extras_budget = ThinkTimeBudget()
        for sid in sorted(self._sessions):
            sess = self._sessions[sid].session
            policy.extras(sess, extras_budget, time.perf_counter())
            self._absorb_prefetch(sess)
            self._absorb_cubes(sess)
        return done

    def _absorb_prefetch(self, sess: Session) -> None:
        """Publish a session's parked speculative results into the shared
        pool so ANY session hitting the same derived query is served.

        Capacity eviction mirrors the message store's policy: candidates
        come from the cold (insertion/recency) end in windows, and the
        cheapest-to-recompute entry of the window goes first.  Entries hit
        in the current batch are never evicted — a sibling session may read
        the same digest later in the same drain.
        """
        for (_viz, digest), entry in sess._prefetched.items():
            if digest not in self._pool:
                self._pool[digest] = _Pooled(
                    entry.factor, entry.query, cost=self._recompute_cost(entry.query)
                )
        self._evict_pool()

    def _absorb_cubes(self, sess: Session) -> None:
        """Publish a session's parked bin cubes into the shared pool.

        A pooled cube serves any session whose derived query matches the
        cube query modulo the σ on its dimension — the server's fan-out
        probes pool entries carrying ``dim`` by rebuilding the cube digest
        from the incoming query (see ``_probe_pool_cube``)."""
        for (_viz, digest), cube in sess._bin_cubes.items():
            if digest not in self._pool:
                self._pool[digest] = _Pooled(
                    cube.factor, cube.query,
                    cost=self._recompute_cost(cube.query), dim=cube.dim,
                )
        self._evict_pool()

    def _evict_pool(self) -> None:
        WINDOW = 8
        while len(self._pool) > self.pool_capacity:
            window: list[tuple[float, int, str]] = []
            for order, (digest, pooled) in enumerate(self._pool.items()):
                if pooled.hot:
                    continue
                window.append((pooled.cost, order, digest))
                if len(window) >= WINDOW:
                    break
            if not window:
                break  # every entry is hot: admit over capacity this round
            self._pool.pop(min(window)[2])
            self.stats_.pool_evictions += 1

    def _recompute_cost(self, q: Query) -> float:
        """Rows the query's join sees — a proxy for what re-materializing
        the parked fan-out would cost if the entry were evicted.  A relation
        version the catalog no longer holds (``KeyError``) prices at 0."""
        try:
            cat = self.treant.catalog
            return float(sum(
                cat.get(r, q.version_of(r)).num_rows
                for r in self.treant.jt.mapping
                if self.treant._sees(q, r)
            ))
        except KeyError:
            return 0.0

    # -- invalidation (called by Treant._ingest at each commit) ----------------
    def _on_commit(self, changed: Iterable[str]) -> None:
        changed = list(changed)
        self._pool = {
            d: e for d, e in self._pool.items()
            if not any(self.treant._sees(e.query, r) for r in changed)
        }

    # -- introspection ---------------------------------------------------------
    def stats(self) -> dict:
        out = dataclasses.asdict(self.stats_)
        out.update(
            queue_depth=len(self._queue),
            sessions=len(self._sessions),
            pool_entries=len(self._pool),
            store_evictions=self.treant.store.evictions,
            bytes_held=self.treant.store.nbytes,
            bytes_pinned=self.treant.store.pinned_nbytes,
            byte_budget=self.treant.store.max_bytes,
        )
        return out
