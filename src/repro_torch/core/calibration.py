"""CJT message passing, calibration, and signature-keyed message reuse.

This is the algorithmic core of the paper (§3):

- ``CJTEngine.message`` computes Y(u→v) recursively: the ⊗-product of the
  bag's (annotated) relation with all incoming messages except from v,
  ⊕-marginalized to ``separator(u,v) ∪ (γ ∩ subtree_attrs(u))`` — upward
  message passing with group-by carry (§3.3.1).
- Every message is keyed by its **Proposition 2 signature**: a structural
  hash of the annotated subtree behind the edge, computed on the host and
  equal to the JAX package's.  The :class:`MessageStore` is therefore the CJT
  materialization Y, the cross-query/cross-session message cache of §4.2.2,
  and the partial calibration state at once — a cache hit *is* message
  reuse, and the set of misses *is* the Steiner tree of §3.4.2.
- ``calibrate`` = upward + downward passes (Algorithm 1), level by level:
  every message of one calibration level is ⊕-reduced by ONE
  ``level_aggregate`` launch (``PlanCache.run_level``); the per-edge
  iterator form is preemptible for think-time calibration (§4.2.1).
- Σ compensation (§3.4.2) appears as ``MessageStore`` widening: a cached
  message carrying extra γ attrs is narrowed by ⊕-marginalization instead of
  recomputed.

A bag holding exactly one relation with more than ``dense_rows_threshold``
rows takes the factorized sparse path (gather incoming messages at row
codes, ⊗ rowwise, segment-⊕ — the DBMS hash-join/aggregate re-expressed as
the segment-aggregate kernels).  Every other bag — an empty bag (the
paper's Appendix B shortcut views), a bag emptied by R̄ (``removed``), a bag
of several relations, or a relation of at most ``dense_rows_threshold``
rows — takes the dense path: densified base factors ⊗ incoming messages,
contracted by ``PlanCache.run_dense`` (the semiring_contract and
tropical_contract kernels for two-factor matrix products).

- ``execute_many`` (batched fan-out) absorbs sibling queries that share a
  batch signature in one ``PlanCache.run_sparse_batch`` call.
- ``apply_delta`` (delta calibration) maintains a query's cached messages
  across a data update: the n−1 messages directed away from the updated bag
  become old ⊕ ΔY under bumped signatures.
- Custom ``lifts`` (a relation name → a function of the relation giving its
  per-row ring elements, as ``core/ml.py``'s covariance lifts) replace the
  default annotation lift; the lift function is part of every lift and
  lifted-factor cache key, so engines sharing a plan cache never serve each
  other's lifts.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import hashlib
import time
from collections import OrderedDict
from typing import Callable, Iterable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.relational.relation import LRU, Catalog, Delta, Relation, lift_rows
from . import semiring as sr
from .factor import Factor, contract
from .hypertree import JTree
from .plans import (
    AbsorbItem,
    PlanCache,
    absorb_batch_key,
    batch_calibration_default,
    calibration_union_budget,
    expand_rows_field,
    fuse_level_default,
    resolve_device,
    sparse_batch_elems,
    use_plans_default,
)
from .query import Query


def _h(*parts: str) -> str:
    return hashlib.sha1("|".join(parts).encode()).hexdigest()[:20]


def factor_nbytes(f: Factor) -> int:
    return sum(leaf.numel() * leaf.element_size() for leaf in sr.leaves(f.field))


def synchronize(fields) -> None:
    """Wait for the queued device work that produces ``fields`` (no-op on
    the CPU, where torch runs synchronously)."""
    for field in fields:
        for leaf in sr.leaves(field):
            if leaf.is_cuda:
                torch.cuda.synchronize(leaf.device)
                return


# ---------------------------------------------------------------------------
# Message store — the materialized Y + the paper's message-level cache
# ---------------------------------------------------------------------------

class MessageStore:
    """LRU message cache keyed by Prop-2 signatures, with pinning (§4.2.2)."""

    def __init__(self, max_bytes: int | None = None):
        self.max_bytes = max_bytes
        self._data: OrderedDict[str, Factor] = OrderedDict()
        # sig -> pin refcount: several vizzes/sessions pin the same shared
        # message, and one session's close (unpin) must not strip a sibling
        # session's eviction exemption.  Keys behave like the old set.
        self._pinned: dict[str, int] = {}
        # cross-viz sharing accounting: while ``tag`` is set (the dashboard
        # layer sets it to the executing viz name), puts record the producer
        # and hits on another producer's message count as cross-tag hits
        self.tag: str | None = None
        self._producer: dict[str, str] = {}
        self.cross_tag_hits = 0
        # sig -> consumer session ids that have HIT the entry while tagged:
        # close() must not drop an entry a sibling live session still reads
        self._users: dict[str, set[str]] = {}
        # per-entry byte sizes (overwrite-safe nbytes accounting) and
        # recompute-cost hints (``CJTEngine`` passes its ``estimate_edge_cost``
        # miss cost at put time) driving priority eviction
        self._sizes: dict[str, int] = {}
        self._cost: dict[str, float] = {}
        # in-flight protection: while an engine dispatch is open, every sig
        # it touches (get-hit or put) is exempt from eviction — a byte budget
        # must never pull a message out from under the dispatch using it
        self._inflight_depth = 0
        self._inflight: set[str] = set()
        self.evictions = 0
        # (edge, base_sig) -> {γ tuple -> full sig}: Σ-compensation index
        self._widen: dict[str, dict[tuple[str, ...], str]] = {}
        # derived probe index: per base_sig, entries sorted by |γ| (smallest
        # superset narrows cheapest) and a refcount over all widened γ attrs
        # (a probe γ ⊄ supp(refcount) can never match — skip the scan
        # entirely; refcounts make eviction-time removal O(|γ|))
        self._widen_bysize: dict[str, list[tuple[int, tuple[str, ...], str]]] = {}
        self._widen_attrs: dict[str, dict[str, int]] = {}
        # reverse map sig -> (base_sig, γ) so eviction can drop the widen
        # entries too — otherwise the index grows monotonically across
        # version bumps (dead sigs inflating every probe scan)
        self._sig_index: dict[str, tuple[str, tuple[str, ...]]] = {}
        self.hits = 0
        self.misses = 0
        self.widen_hits = 0
        self.widen_scans = 0
        self.widen_scan_steps = 0
        self.nbytes = 0

    @staticmethod
    def full_sig(base_sig: str, gamma: tuple[str, ...]) -> str:
        return f"{base_sig}|g={','.join(gamma)}"

    @contextlib.contextmanager
    def inflight(self):
        """Mark every sig touched inside the block as eviction-exempt.

        Re-entrant (engine entry points nest: execute → message → widen-put);
        the exemption set clears when the outermost dispatch closes."""
        self._inflight_depth += 1
        try:
            yield
        finally:
            self._inflight_depth -= 1
            if self._inflight_depth == 0:
                self._inflight.clear()
                # a dispatch may legitimately overshoot the budget (its own
                # working set is exempt); trim back down now that it closed
                self._evict()

    def _touch(self, sig: str) -> None:
        if self._inflight_depth > 0:
            self._inflight.add(sig)

    def get(self, base_sig: str, gamma: tuple[str, ...]) -> Factor | None:
        sig = self.full_sig(base_sig, gamma)
        f = self._data.get(sig)
        if f is not None:
            self._data.move_to_end(sig)
            self.hits += 1
            self._note_cross_hit(sig)
            self._touch(sig)
            return f
        # Σ compensation: narrow a cached wider-γ message by marginalization.
        # Indexed by |γ|: strict supersets are larger, so the scan starts past
        # size |γ| and visits candidates smallest-first.
        gset = set(gamma)
        attrs = self._widen_attrs.get(base_sig)
        if attrs is not None and all(a in attrs for a in gset):
            bysize = self._widen_bysize.get(base_sig, [])
            self.widen_scans += 1
            start = bisect.bisect_left(bysize, (len(gamma),))
            for _, g2, sig2 in bysize[start:]:
                self.widen_scan_steps += 1
                if gset <= set(g2) and sig2 in self._data:
                    wide = self._data[sig2]
                    narrowed = wide.marginalize(set(g2) - gset)
                    self._note_cross_hit(sig2)
                    self._touch(sig2)
                    self.put(base_sig, gamma, narrowed, cost=self._cost.get(sig2))
                    self.widen_hits += 1
                    return narrowed
        self.misses += 1
        return None

    def _note_cross_hit(self, sig: str) -> None:
        owner = self._producer.get(sig)
        if self.tag is not None and owner is not None and owner != self.tag:
            self.cross_tag_hits += 1
        # consumer refcount: remember which session read this entry (tags are
        # "{session}:{viz}"), so drop_producer can keep shared entries alive
        if self.tag is not None and owner is not None:
            sid = self.tag.split(":", 1)[0]
            if not owner.startswith(f"{sid}:"):
                self._users.setdefault(sig, set()).add(sid)

    def contains(self, base_sig: str, gamma: tuple[str, ...]) -> bool:
        if self.full_sig(base_sig, gamma) in self._data:
            return True
        attrs = self._widen_attrs.get(base_sig)
        if attrs is None or not all(a in attrs for a in gamma):
            return False
        return any(set(gamma) <= set(g2) for g2 in self._widen.get(base_sig, {}))

    def put(self, base_sig: str, gamma: tuple[str, ...], f: Factor,
            pin: bool = False, cost: float | None = None):
        sig = self.full_sig(base_sig, gamma)
        nb = factor_nbytes(f)
        self.nbytes += nb - self._sizes.get(sig, 0)
        self._sizes[sig] = nb
        if cost is not None:
            self._cost[sig] = cost
        self._touch(sig)
        if self.tag is not None:
            self._producer.setdefault(sig, self.tag)
        self._data[sig] = f
        self._data.move_to_end(sig)
        per_base = self._widen.setdefault(base_sig, {})
        if gamma not in per_base:  # full_sig is deterministic: insert once
            bisect.insort(
                self._widen_bysize.setdefault(base_sig, []), (len(gamma), gamma, sig)
            )
            counts = self._widen_attrs.setdefault(base_sig, {})
            for a in gamma:
                counts[a] = counts.get(a, 0) + 1
            self._sig_index[sig] = (base_sig, gamma)
        per_base[gamma] = sig
        if pin:
            self._pinned[sig] = self._pinned.get(sig, 0) + 1
        self._evict()

    def _drop_widen(self, sig: str) -> None:
        """Remove an evicted message's Σ-widening index entries."""
        hit = self._sig_index.pop(sig, None)
        if hit is None:
            return
        base_sig, gamma = hit
        per_base = self._widen.get(base_sig)
        if per_base is None:
            return
        per_base.pop(gamma, None)
        bysize = self._widen_bysize.get(base_sig, [])
        i = bisect.bisect_left(bysize, (len(gamma), gamma, sig))
        if i < len(bysize) and bysize[i] == (len(gamma), gamma, sig):
            bysize.pop(i)
        counts = self._widen_attrs.get(base_sig, {})
        for a in gamma:
            c = counts.get(a, 0) - 1
            if c > 0:
                counts[a] = c
            else:
                counts.pop(a, None)
        if not per_base:
            self._widen.pop(base_sig, None)
            self._widen_bysize.pop(base_sig, None)
            self._widen_attrs.pop(base_sig, None)

    def pin(self, base_sig: str, gamma: tuple[str, ...]):
        sig = self.full_sig(base_sig, gamma)
        self._pinned[sig] = self._pinned.get(sig, 0) + 1

    def is_pinned(self, base_sig: str, gamma: tuple[str, ...]) -> bool:
        """Pinned exactly, or through a pinned wider-γ variant (Σ-widening)."""
        if self.full_sig(base_sig, gamma) in self._pinned:
            return True
        return any(
            set(gamma) <= set(g2) and sig in self._pinned
            for g2, sig in self._widen.get(base_sig, {}).items()
        )

    def unpin(self, base_sig: str, gamma: tuple[str, ...]):
        """Drop one pin reference; the sig stays pinned while other holders
        remain (refcounted — floors at zero)."""
        sig = self.full_sig(base_sig, gamma)
        c = self._pinned.get(sig, 0) - 1
        if c > 0:
            self._pinned[sig] = c
        else:
            self._pinned.pop(sig, None)

    def apply_delta(self, old_base: str, new_base: str, gamma: tuple[str, ...],
                    delta: Factor | None) -> Factor | None:
        """Maintain one message across a data update: new = old ⊕ Δ.

        Looks up the cached message under the *old* signature (Σ-widening
        applies), combines it with the delta factor, and stores the result
        under the bumped *new* signature.  ``delta=None`` means the update is
        value-preserving (a compaction) — the old message is re-keyed
        verbatim.  The old message's direct pin refcount migrates to the new
        generation (the old one stays servable but evictable); a message
        pinned only through a wider-γ variant migrates when that wider query
        is maintained.  Returns None (storing nothing) when there is no
        cached message to maintain.
        """
        old = self.get(old_base, gamma)
        if old is None:
            self.misses -= 1  # probe, not a serving miss
            return None
        new = old if delta is None else old.add(delta)
        # pin BEFORE put so a byte-bounded store cannot evict the new entry
        # inside put()'s eviction sweep
        moved = self._pinned.pop(self.full_sig(old_base, gamma), 0)
        if moved:
            new_sig = self.full_sig(new_base, gamma)
            self._pinned[new_sig] = self._pinned.get(new_sig, 0) + moved
        self.put(new_base, gamma, new, cost=self._cost.get(self.full_sig(old_base, gamma)))
        return new

    @property
    def pinned_nbytes(self) -> int:
        """Bytes held by pinned entries — the floor no budget can go below."""
        return sum(self._sizes.get(s, 0) for s in self._pinned)

    def unpin_all(self):
        self._pinned.clear()

    def _remove(self, sig: str) -> bool:
        """Drop one entry and all its bookkeeping; False when absent."""
        f = self._data.pop(sig, None)
        if f is None:
            return False
        self.nbytes -= self._sizes.pop(sig, factor_nbytes(f))
        self._producer.pop(sig, None)
        self._cost.pop(sig, None)
        self._users.pop(sig, None)
        self._drop_widen(sig)
        return True

    def drop_producer(self, prefix: str) -> int:
        """Session GC: drop unpinned entries whose producer tag starts with
        ``prefix`` (a session passes ``f"{sid}:"``).  Untagged entries
        (offline base calibration) are never dropped here; an entry another
        live session has read is handed to that reader instead.  Returns the
        number of entries dropped."""
        sid = prefix.split(":", 1)[0]
        # this session stops being a consumer of anything it read
        for users in self._users.values():
            users.discard(sid)
        sigs = [s for s, owner in self._producer.items() if owner.startswith(prefix)]
        n = 0
        for sig in sigs:
            survivors = self._users.get(sig)
            if survivors:
                # hand ownership to the (deterministically) first surviving reader
                heir = sorted(survivors)[0]
                survivors.discard(heir)
                self._producer[sig] = f"{heir}:*"
                if not survivors:
                    self._users.pop(sig, None)
                continue
            if sig in self._pinned:
                continue
            if self._remove(sig):
                n += 1
        return n

    def _evict(self):
        """Byte-budget eviction: pin-state → recency → recompute cost.

        Pinned and in-flight entries are exempt outright.  Among the rest,
        candidates are taken from the cold (LRU) end in windows: evicting the
        cheapest-to-recompute entry of the oldest window realizes the
        recency-then-cost ordering without a full-store scan per eviction.
        If every entry is exempt the store stays over budget — correctness
        beats the budget."""
        if self.max_bytes is None or self.nbytes <= self.max_bytes:
            return
        WINDOW = 8
        while self.nbytes > self.max_bytes:
            window: list[tuple[float, int, str]] = []
            for order, sig in enumerate(self._data):
                if sig in self._pinned or sig in self._inflight:
                    continue
                window.append((self._cost.get(sig, 0.0), order, sig))
                if len(window) >= WINDOW:
                    break
            if not window:
                return  # everything left is pinned or in-flight
            _, _, victim = min(window)
            self._remove(victim)
            self.evictions += 1

    def __len__(self):
        return len(self._data)

    def reset_stats(self):
        self.hits = self.misses = self.widen_hits = 0
        self.widen_scans = self.widen_scan_steps = 0

    def snapshot(self):
        """Cheap state snapshot (factors are never mutated) — lets a timer
        warm the caches and then restore the message store."""
        return (
            OrderedDict(self._data),
            {k: dict(v) for k, v in self._widen.items()},
            dict(self._pinned), self.nbytes,
            (self.hits, self.misses, self.widen_hits),
            (dict(self._producer), self.cross_tag_hits),
            (dict(self._sizes), dict(self._cost),
             {k: set(v) for k, v in self._users.items()}, self.evictions),
        )

    def restore(self, snap):
        self._data, self._widen, self._pinned, self.nbytes, stats = (
            OrderedDict(snap[0]), {k: dict(v) for k, v in snap[1].items()},
            dict(snap[2]), snap[3], snap[4],
        )
        self.hits, self.misses, self.widen_hits = stats
        self._producer, self.cross_tag_hits = dict(snap[5][0]), snap[5][1]
        self._sizes = dict(snap[6][0])
        self._cost = dict(snap[6][1])
        self._users = {k: set(v) for k, v in snap[6][2].items()}
        self.evictions = snap[6][3]
        self._widen_bysize = {
            b: sorted((len(g), g, s) for g, s in d.items())
            for b, d in self._widen.items()
        }
        self._widen_attrs = {}
        for b, d in self._widen.items():
            counts = self._widen_attrs.setdefault(b, {})
            for g in d:
                for a in g:
                    counts[a] = counts.get(a, 0) + 1
        self._sig_index = {
            s: (b, g) for b, d in self._widen.items() for g, s in d.items()
        }


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ExecStats:
    messages_computed: int = 0
    messages_reused: int = 0
    rows_scanned: int = 0
    recomputed_edges: list = dataclasses.field(default_factory=list)
    # plan cache: plan builds vs cached re-runs, and how many executions
    # took the segment-kernel route
    plan_traces: int = 0
    plan_hits: int = 0
    kernel_execs: int = 0
    # batched absorption (execute_many): 1 when this query's absorption rode
    # a sibling batch; batch_width is that batch's total width, and
    # batch_sessions counts the distinct sessions that batch served
    batched_absorptions: int = 0
    batch_width: int = 0
    batch_sessions: int = 0
    # result served from the session's speculative-prefetch cache: nothing
    # executed at all (no store probes, no plan dispatch)
    prefetch_hits: int = 0
    # result sliced out of a parked γ∪{dim} bin cube (select + ⊕-marginalize
    # over the brush dimension): no store probes, no plan dispatch either,
    # but unlike a prefetch hit the cube survives to serve the NEXT σ too
    bin_cube_hits: int = 0
    # realized Steiner tree (§3.4.2): bags touched by recomputed messages
    # plus the absorption root — 1 when everything was served from cache
    steiner_size: int = 0
    # level-batched calibration: level groups of >1 message this query's
    # calibration rode (and the widest), plus how many message dispatches the
    # pass issued in total — per-edge: one per computed message; levels: one
    # per level (attributed to its first member)
    level_batched_execs: int = 0
    level_batch_width: int = 0
    calibration_dispatches: int = 0


@dataclasses.dataclass
class DeltaStats:
    """Outcome of one ``CJTEngine.apply_delta`` maintenance pass."""

    delta_rows: int = 0          # |Δ| — rows in the signed delta
    delta_messages: int = 0      # ΔY factors computed (≤ n−1 vs 2(n−1) full)
    edges_maintained: int = 0    # cached messages updated as old ⊕ Δ
    edges_skipped: int = 0       # outward edges with nothing cached to maintain
    fallback: bool = False       # ring cannot absorb the delta (e.g. MIN delete)


@dataclasses.dataclass
class CalibrationPlan:
    """Parked position of one query's level-synchronous calibration pass.

    ``levels`` is the JT's level schedule for ``root`` (upward then downward;
    see ``JTree.calibration_levels``); ``pos``/``offset`` track progress at
    level / intra-level granularity, so the pass can be resumed by either the
    level executor or the per-edge budget stepper — both leave every
    already-materialized message servable (§4.2.1 preemptibility).
    """

    query: Query
    placement: dict
    root: str
    levels: tuple[tuple[tuple[str, str], ...], ...]
    pin: bool = False
    pos: int = 0      # completed levels
    offset: int = 0   # edges completed inside levels[pos]

    @property
    def done(self) -> bool:
        return self.pos >= len(self.levels)

    def edges_left(self) -> int:
        if self.done:
            return 0
        return sum(len(lv) for lv in self.levels[self.pos:]) - self.offset


class CJTEngine:
    """Query execution and calibration over one JT (one dashboard join graph).

    ``device`` (default ``cuda``; raises without a card unless ``"cpu"`` is
    passed) holds the lifts, codes and messages.  Relations of at most
    ``dense_rows_threshold`` rows are densified (dense contraction path);
    bigger ones take the sparse segment path.  ``lifts`` maps a relation
    name to a function ``rel -> per-row field`` that replaces the default
    annotation lift.  ``use_plans=False`` runs the plain reference
    contractions (``_sparse_reference``, ``factor.contract``) instead of the
    plan cache; ``batch_calibration=False`` calibrates edge by edge;
    ``fuse_level_kernel=False`` runs a calibration level group by group
    (``PlanCache.run_message_batch``) instead of in one call.  The three
    default to ``None``: the env knobs ``REPRO_USE_PLANS``,
    ``REPRO_BATCH_CALIBRATION`` and ``REPRO_FUSE_LEVEL_KERNEL`` (on unless
    set to 0); an explicit argument wins.
    """

    def __init__(
        self,
        jt: JTree,
        catalog: Catalog,
        ring: sr.Semiring,
        lifts: Mapping[str, Callable[[Relation], sr.Field]] | None = None,
        store: MessageStore | None = None,
        dense_rows_threshold: int = 0,
        use_plans: bool | None = None,
        plan_cache: PlanCache | None = None,
        batch_calibration: bool | None = None,
        fuse_level_kernel: bool | None = None,
        device: torch.device | str | None = None,
    ):
        if use_plans is None:
            use_plans = use_plans_default()
        if batch_calibration is None:
            batch_calibration = batch_calibration_default()
        if fuse_level_kernel is None:
            fuse_level_kernel = fuse_level_default()
        self.jt = jt
        self.catalog = catalog
        self.ring = ring
        self.lifts = dict(lifts or {})
        self.store = store if store is not None else MessageStore()
        self.dense_rows_threshold = dense_rows_threshold
        if plan_cache is not None:
            if plan_cache.ring.name != ring.name:
                raise ValueError(
                    f"plan_cache ring {plan_cache.ring.name!r} != engine ring {ring.name!r}"
                )
            if device is not None and torch.device(device) != plan_cache.device:
                raise ValueError(f"plan_cache is on {plan_cache.device}, engine on {device}")
            self.device = plan_cache.device
        else:
            self.device = resolve_device(device)
        # an empty cache is falsy (``__len__``): test for None, or a shared
        # cache handed to a fresh engine would be dropped for a private one
        if not use_plans:
            self.plans = None
        else:
            self.plans = plan_cache if plan_cache is not None else PlanCache(ring, self.device)
        # level-batched calibration is inert without plans (per-edge loop);
        # level fusion is inert without level batching
        self.batch_calibration = batch_calibration
        self.fuse_level_kernel = fuse_level_kernel
        # Prop-2 signature memo, LRU-bounded: keyed by (query digest, edge)
        self._sig_memo: LRU = LRU(capacity=8192)
        # σ-placement memo: placement is a pure function of (σ digests, R̄, versions)
        self._placement_memo: LRU = LRU(capacity=1024)

    # -- annotation placement (§3.3, §3.4.2 shrinking) ------------------------
    def place_predicates(self, q: Query) -> dict[str, tuple]:
        """Deterministically place each σ on the cheapest bag containing its
        attr (fewest underlying rows — the paper's shrinking heuristic)."""
        key = (tuple(p.digest for p in q.predicates), q.removed, q.rel_versions)
        hit = self._placement_memo.get(key)
        if hit is not None:
            return hit
        placed: dict[str, list] = {}
        for p in q.predicates:
            cands = self.jt.bags_with_attr(p.attr)
            if not cands:
                raise KeyError(f"predicate attr {p.attr} not in any bag")
            cands = sorted(cands, key=lambda b: (self._bag_rows(q, b), b))
            placed.setdefault(cands[0], []).append(p)
        out = {b: tuple(sorted(ps, key=lambda p: p.digest)) for b, ps in placed.items()}
        self._placement_memo.put(key, out)
        return out

    def _bag_rows(self, q: Query, bag: str) -> int:
        rels = [r for r in self.jt.relations_of(bag) if r not in q.removed]
        if not rels:
            return 1
        return sum(self.catalog.get(r, q.version_of(r)).num_rows for r in rels)

    # -- Proposition 2 signatures ---------------------------------------------
    def bag_state_digest(self, q: Query, bag: str, placement) -> str:
        rels = [r for r in self.jt.relations_of(bag) if r not in q.removed]
        rel_part = ";".join(f"{r}@{q.version_of(r)}" for r in sorted(rels))
        pred_part = ";".join(p.digest for p in placement.get(bag, ()))
        meas = ""
        if q.measure and q.measure[0] in rels:
            meas = f"{q.measure[0]}.{q.measure[1]}"
        return _h("bag", bag, rel_part, pred_part, meas, q.ring_name, q.lift_tag)

    def subtree_sig(self, q: Query, u: str, v: str, placement) -> str:
        """Structural hash of the annotated subtree rooted at u, cut at (u,v);
        memo-keyed by the γ-independent ``Query.sig_key``."""
        key = (q.sig_key, u, v)
        hit = self._sig_memo.get(key)
        if hit is not None:
            return hit
        child_sigs = sorted(
            self.subtree_sig(q, i, u, placement) for i in self.jt.neighbors(u) if i != v
        )
        sig = _h("sub", self.bag_state_digest(q, u, placement), *child_sigs,
                 ",".join(self.jt.separator(u, v)) if v else "")
        self._sig_memo[key] = sig
        return sig

    def gamma_carry(self, q: Query, u: str, v: str) -> tuple[str, ...]:
        """γ attrs that must survive the u→v message beyond the separator.

        A γ attr that no relation left in the query's join scope carries
        (R̄ removed every relation holding it) is carried by no message.  The
        reference keeps it in the carry and its level calibration then fails
        on the attr (ROADMAP Queue 3); an execute that avoids that pass
        answers without the attr in both packages.
        """
        key = (q.group_by, q.removed, "γ", u, v)
        hit = self._sig_memo.get(key)
        if hit is not None:
            return hit
        sub = self.jt.subtree_attrs(u, v)
        sep = set(self.jt.separator(u, v))
        out = tuple(sorted((set(q.group_by) & sub) - sep - self._hidden_attrs(q)))
        self._sig_memo[key] = out
        return out

    def _hidden_attrs(self, q: Query) -> frozenset[str]:
        """The query's γ attrs that no relation outside ``q.removed`` carries."""
        if not q.removed:
            return frozenset()
        visible = set()
        for r in self.jt.mapping:
            if r not in q.removed:
                visible.update(self.catalog.get(r, q.version_of(r)).attrs)
        return frozenset(a for a in q.group_by if a not in visible)

    def _root_attrs(self, q: Query, root: str, keep: Sequence[str]) -> tuple[str, ...]:
        """The attrs of ``keep`` an absorption at ``root`` can produce."""
        avail = set(self.jt.subtree_attrs(root, None)) - self._hidden_attrs(q)
        return tuple(a for a in dict.fromkeys(keep) if a in avail)

    def edge_sig(self, q: Query, u: str, v: str, placement) -> str:
        """Message identity (Prop. 2): u's annotated subtree and the
        separator, NOT v's identity."""
        sep = ",".join(self.jt.separator(u, v))
        return _h("edge", u, sep, self.subtree_sig(q, u, v, placement))

    # -- message passing (§3.3.1) ---------------------------------------------
    def message(self, q: Query, u: str, v: str, placement=None,
                stats: ExecStats | None = None) -> Factor:
        placement = self.place_predicates(q) if placement is None else placement
        base = self.edge_sig(q, u, v, placement)
        gamma = self.gamma_carry(q, u, v)
        cached = self.store.get(base, gamma)
        if cached is not None:
            if stats:
                stats.messages_reused += 1
            return cached
        incoming = [
            self.message(q, i, u, placement, stats) for i in self.jt.neighbors(u) if i != v
        ]
        sep = self.jt.separator(u, v)
        out_attrs = tuple(dict.fromkeys(sep + gamma))
        f = self._bag_contract(q, u, incoming, out_attrs, placement, stats)
        self.store.put(base, gamma, f, cost=self._edge_cost_hint(q, u, out_attrs))
        if stats:
            stats.messages_computed += 1
            stats.recomputed_edges.append((u, v))
        return f

    def _edge_cost_hint(self, q: Query, u: str, out_attrs: tuple[str, ...]) -> float:
        """Recompute-cost hint (source rows + output size) for the store's
        priority eviction under a byte budget."""
        out_size = 1.0
        for a in out_attrs:
            out_size *= self.jt.domains.get(a, 1)
        return self._bag_rows(q, u) + out_size

    def absorb(self, q: Query, root: str, placement=None, stats=None, keep=None) -> Factor:
        """Absorption at root (§3.3.1) then projection to γ (or ``keep``)."""
        placement = self.place_predicates(q) if placement is None else placement
        incoming = [self.message(q, i, root, placement, stats) for i in self.jt.neighbors(root)]
        out_attrs = self._root_attrs(q, root, q.group_by if keep is None else keep)
        return self._bag_contract(q, root, incoming, out_attrs, placement, stats)

    # -- bag-local contraction -------------------------------------------------
    def _bag_rels(self, q: Query, bag: str) -> list[Relation]:
        names = [r for r in self.jt.relations_of(bag) if r not in q.removed]
        return [self.catalog.get(r, q.version_of(r)) for r in names]

    def _bag_contract(self, q: Query, bag: str, incoming: list[Factor],
                      out_attrs: tuple[str, ...], placement, stats=None) -> Factor:
        rels = self._bag_rels(q, bag)
        if stats:
            stats.rows_scanned += sum(r.num_rows for r in rels)
        preds = placement.get(bag, ())
        if len(rels) == 1 and rels[0].num_rows > self.dense_rows_threshold:
            return self._sparse_bag(q, rels[0], incoming, preds, out_attrs, stats)
        return self._dense_bag(q, rels, incoming, preds, out_attrs, stats)

    def _lift_id(self, rel_name: str):
        """Cache-key component naming the lift that produces a relation's
        rows: None for the default lift, the custom function object itself
        otherwise (a shared PlanCache must not serve engine A's lift to
        engine B; keying by the object keeps it alive, so no id reuse)."""
        return self.lifts.get(rel_name)

    def _lift(self, q: Query, rel: Relation) -> sr.Field:
        if self.plans is not None:
            measure = q.measure[1] if q.measure and q.measure[0] == rel.name else None
            key = (rel.key, self.ring.name, measure, q.lift_tag, self._lift_id(rel.name))
            return self.plans.lift_cached(
                key, lambda: self._pad_lift(self._lift_impl(q, rel), rel)
            )
        return self._lift_impl(q, rel)

    def _pad_lift(self, vals: sr.Field, rel: Relation) -> sr.Field:
        """Pad per-row lift values to ``rel.row_bucket`` with the ⊕-identity.

        Identity rows are ⊗-absorbing and aggregate into segment 0 as
        ⊕-no-ops, so padding is exact for every ring.  Only the plans path
        pads — the reference path works on exact ``num_rows`` tensors.
        """
        pad = rel.row_bucket - rel.num_rows
        if pad > 0:
            zeros = self.ring.zeros((pad,), self.device)
            vals = sr.field_map(lambda a, z: torch.cat([a, z], dim=0), vals, zeros)
        return vals

    def _lift_impl(self, q: Query, rel: Relation) -> sr.Field:
        if rel.name in self.lifts:
            return self.lifts[rel.name](rel)
        measure = q.measure[1] if q.measure and q.measure[0] == rel.name else None
        return lift_rows(rel, self.ring, measure, self.device)

    def _base_factor(self, q: Query, rel: Relation) -> Factor:
        """Densified base relation on the engine's device, cached when plans
        are enabled."""
        ring = self.ring
        measure = q.measure[1] if q.measure and q.measure[0] == rel.name else None
        if rel.name in self.lifts:
            if self.plans is None:
                return self._dense_lifted(q, rel)
            key = ("lifted", rel.key, ring.name, q.lift_tag, self._lift_id(rel.name))
            return self.plans.factor_cached(key, lambda: self._dense_lifted(q, rel))
        if self.plans is None:
            return rel.to_factor(ring, measure, self.device)
        key = ("base", rel.key, ring.name, measure)
        return self.plans.factor_cached(key, lambda: rel.to_factor(ring, measure, self.device))

    def _dense_bag(self, q, rels, incoming, preds, out_attrs, stats=None) -> Factor:
        """Dense path: densified relations ⊗ incoming messages, σ, ⊕ to
        ``out_attrs``; an empty bag with no incoming message is 1̄."""
        ring = self.ring
        factors = [self._base_factor(q, r) for r in rels] + list(incoming)
        if not factors:
            return Factor((), ring.ones((), self.device), ring)
        if self.plans is not None:
            return self.plans.run_dense(factors, preds, out_attrs, stats)
        avail = {a for f in factors for a in f.attrs}
        for p in preds:
            # σ on the first factor holding the attr (placement guarantees one)
            i = next(i for i, f in enumerate(factors) if p.attr in f.attrs)
            factors[i] = factors[i].select(p.attr, torch.as_tensor(p.mask, device=self.device))
        return contract(factors, tuple(a for a in out_attrs if a in avail), ring)

    def _dense_lifted(self, q: Query, rel: Relation) -> Factor:
        """A custom-lifted relation densified: its lifted rows ⊕-reduced at
        their own codes (no incoming message, no σ)."""
        vals = self._lift(q, rel)
        if self.plans is not None:
            return self.plans.run_sparse(self.catalog, rel, vals, [], (), tuple(rel.attrs))
        idx, total = rel.flat_codes(rel.attrs)
        field = self.ring.segment_reduce(vals, torch.as_tensor(idx, device=self.device), total)
        shape = tuple(rel.domains[a] for a in rel.attrs)
        field = sr.field_map(lambda leaf: leaf.reshape(shape + tuple(leaf.shape[1:])), field)
        return Factor(tuple(rel.attrs), field, self.ring)

    def _sparse_bag(self, q, rel: Relation, incoming, preds, out_attrs, stats=None) -> Factor:
        """Factorized sparse path: gather ⊗ rowwise, segment-⊕ to out_attrs."""
        vals = self._lift(q, rel)  # leaves: (N, *trailing)
        if self.plans is not None:
            return self.plans.run_sparse(
                self.catalog, rel, vals, incoming, preds, tuple(out_attrs), stats
            )
        return self._sparse_reference(rel, vals, incoming, preds, out_attrs)

    def _sparse_reference(self, rel: Relation, vals: sr.Field, incoming, preds,
                          out_attrs) -> Factor:
        """The plain contraction on exact row counts, with host-built codes."""
        ring = self.ring
        dev = self.device
        n = rel.num_rows
        carried: list[str] = []
        carried_dims: list[int] = []

        for m in incoming:
            shared = [a for a in m.attrs if a in rel.attrs]
            extra = [a for a in m.attrs if a not in rel.attrs]
            mp = m.project_to(tuple(shared + extra))
            dims = [rel.domains[a] for a in shared]
            idx = torch.as_tensor(rel.flat_codes(shared)[0], device=dev)

            def gather(leaf):
                lead = leaf.reshape(
                    (int(np.prod(dims)) if shared else 1,) + tuple(leaf.shape[len(shared):])
                )
                if shared:
                    return lead.index_select(0, idx)
                return lead.expand((n,) + tuple(lead.shape[1:]))

            g = sr.like(mp.field, [gather(leaf) for leaf in sr.leaves(mp.field)])
            want = carried + [a for a in extra if a not in carried]
            vals = ring.mul(
                expand_rows_field(vals, carried, want, ring.trailing),
                expand_rows_field(g, extra, want, ring.trailing),
            )
            carried = want
            carried_dims = [self.jt.domains[a] for a in carried]

        if preds:  # σ: row masks (predicates always reference bag-local attrs)
            row_mask = np.ones((n,), bool)
            for p in preds:
                row_mask &= p.mask[rel.codes[p.attr]]
            rm = torch.as_tensor(row_mask, device=dev)
            vals = sr.like(vals, [
                leaf.masked_fill(~rm.reshape((n,) + (1,) * (leaf.dim() - 1)), z)
                for leaf, z in zip(sr.leaves(vals), ring.zero_values)
            ])

        local_out = [a for a in out_attrs if a in rel.attrs]
        carried_out = [a for a in out_attrs if a not in rel.attrs]
        assert set(carried_out) <= set(carried), (
            f"carried attrs {carried_out} not available (have {carried})"
        )
        idx, total = rel.flat_codes(local_out)
        field = ring.segment_reduce(vals, torch.as_tensor(idx, device=dev), total)
        shape = tuple(rel.domains[a] for a in local_out)
        field = sr.field_map(lambda leaf: leaf.reshape(shape + tuple(leaf.shape[1:])), field)
        return Factor(tuple(local_out) + tuple(carried), field, ring).project_to(out_attrs)

    # -- root choice (§3.3.3) ---------------------------------------------------
    def estimate_edge_cost(self, q: Query, u: str, v: str, placement) -> float:
        """Cost of materializing Y(u→v): 0 when cached, else rows + out size."""
        key = (q.sig_key, q.group_by, "est", u, v)
        hit = self._sig_memo.get(key)
        if hit is None:
            base = self.edge_sig(q, u, v, placement)
            gamma = self.gamma_carry(q, u, v)
            out_attrs = tuple(dict.fromkeys(self.jt.separator(u, v) + gamma))
            out_size = 1.0
            for a in out_attrs:
                out_size *= self.jt.domains[a]
            hit = (self.store.full_sig(base, gamma), base, gamma,
                   self._bag_rows(q, u) + out_size)
            self._sig_memo[key] = hit
        full, base, gamma, miss_cost = hit
        if full in self.store._data or self.store.contains(base, gamma):
            return 0.0
        return miss_cost

    def _bags_by_rows(self, q: Query) -> list[tuple[int, str]]:
        key = ("rootorder", q.rel_versions, q.removed)
        hit = self._placement_memo.get(key)
        if hit is None:
            hit = sorted((self._bag_rows(q, b), b) for b in self.jt.bags)
            self._placement_memo.put(key, hit)
        return hit

    def choose_root(self, q: Query, placement=None) -> str:
        """argmin over bags of (edges to recompute + absorption rows); ties
        break toward fewer rows, then bag name."""
        placement = self.place_predicates(q) if placement is None else placement
        edge_cost: dict[tuple[str, str], float] = {}
        best, best_cost = None, None
        for rows, root in self._bags_by_rows(q):
            if best_cost is not None and rows >= best_cost:
                break
            cost = float(rows)
            for a, b in self.jt.traversal_to_root(root):
                c = edge_cost.get((a, b))
                if c is None:
                    edge_cost[(a, b)] = c = self.estimate_edge_cost(q, a, b, placement)
                cost += c
                if best_cost is not None and cost >= best_cost:
                    break
            else:
                if best_cost is None or cost < best_cost:
                    best, best_cost = root, cost
        return best

    # -- public API ---------------------------------------------------------------
    def execute(self, q: Query, root: str | None = None, sync: bool = True
                ) -> tuple[Factor, ExecStats]:
        """Execute ``q``: message passing to ``root``, absorption,
        γ-projection.  ``sync=True`` waits for the device once, on the result."""
        stats = ExecStats()
        placement = self.place_predicates(q)
        root = root or self.choose_root(q, placement)
        with self.store.inflight():
            f = self.absorb(q, root, placement, stats)
        out = f.project_to(q.group_by)
        touched = {b for edge in stats.recomputed_edges for b in edge}
        stats.steiner_size = len(touched | {root})
        if sync:
            synchronize([out.field])
        return out, stats

    def execute_many(self, queries: Sequence[Query], sync: bool = True,
                     tags: Sequence[str | None] | None = None
                     ) -> list[tuple[Factor, ExecStats]]:
        """Execute several queries, batching structurally identical absorptions.

        The crossfilter fan-out path: each query's message passing runs in
        turn (warm events are pure store hits there), then the root
        absorptions are grouped by :func:`~repro_torch.core.plans.absorb_batch_key`
        and each group of siblings runs as ONE ``PlanCache.run_sparse_batch``
        call — one ``level_segment_aggregate`` launch on the card.
        ``tags[i]`` is the store's producer tag while query i's messages
        materialize.  Batched and one-by-one execution are bit-identical on
        integer-valued data; dense bags and ``use_plans=False`` engines absorb
        one query at a time.
        """
        with self.store.inflight():
            return self._execute_many_inflight(queries, sync, tags)

    def _execute_many_inflight(self, queries, sync=True, tags=None
                               ) -> list[tuple[Factor, ExecStats]]:
        results: list[Factor | None] = [None] * len(queries)
        all_stats: list[ExecStats] = []
        roots: list[str] = []
        deferred: list[tuple[int, AbsorbItem]] = []
        for i, q in enumerate(queries):
            stats = ExecStats()
            all_stats.append(stats)
            placement = self.place_predicates(q)
            root = self.choose_root(q, placement)
            roots.append(root)
            with self._tagged(tags[i] if tags is not None else None):
                incoming = [self.message(q, u, root, placement, stats)
                            for u in self.jt.neighbors(root)]
            out_attrs = self._root_attrs(q, root, q.group_by)
            rels = self._bag_rels(q, root)
            if (len(rels) == 1 and rels[0].num_rows > self.dense_rows_threshold
                    and self.plans is not None and len(queries) > 1):
                stats.rows_scanned += rels[0].num_rows
                deferred.append((i, AbsorbItem(
                    rel=rels[0], vals=self._lift(q, rels[0]), incoming=tuple(incoming),
                    preds=placement.get(root, ()), out_attrs=out_attrs,
                )))
            else:
                results[i] = self._bag_contract(q, root, incoming, out_attrs, placement, stats)
        groups: dict[tuple, list[tuple[int, AbsorbItem]]] = {}
        for i, item in deferred:
            groups.setdefault(absorb_batch_key(self.ring, item), []).append((i, item))
        for group in groups.values():
            for members in self._absorb_chunks(group):
                if len(members) == 1:
                    i, item = members[0]
                    results[i] = self.plans.run_sparse(
                        self.catalog, item.rel, item.vals, list(item.incoming),
                        list(item.preds), item.out_attrs, all_stats[i],
                    )
                    continue
                fs = self.plans.run_sparse_batch(
                    self.catalog, [item for _, item in members],
                    [all_stats[i] for i, _ in members],
                )
                for (i, _), f in zip(members, fs):
                    results[i] = f
                # how many distinct sessions this ONE batch served (tags are
                # "{session}:{viz}")
                if tags is not None:
                    owners = {tags[i].split(":", 1)[0] for i, _ in members
                              if tags[i] is not None}
                    for i, _ in members:
                        all_stats[i].batch_sessions = len(owners)
                    if len(owners) > 1:
                        ps = self.plans.stats
                        ps.cross_session_execs += 1
                        ps.cross_session_width = max(ps.cross_session_width, len(owners))
        outs: list[tuple[Factor, ExecStats]] = []
        for i, q in enumerate(queries):
            out = results[i].project_to(q.group_by)
            stats = all_stats[i]
            touched = {b for edge in stats.recomputed_edges for b in edge}
            stats.steiner_size = len(touched | {roots[i]})
            outs.append((out, stats))
        if sync:
            synchronize([f.field for f, _ in outs])
        return outs

    def _absorb_chunks(self, members: list[tuple[int, AbsorbItem]]
                       ) -> list[list[tuple[int, AbsorbItem]]]:
        """Split one batch group into chunks of at most
        ``sparse_batch_elems()`` rows·width (0: one chunk), keeping at least
        2 members per chunk so siblings still share a launch at any
        fact-table size."""
        budget = sparse_batch_elems()
        if budget <= 0 or len(members) <= 2:
            return [members]
        rows = max(members[0][1].rel.num_rows, 1)
        cap = max(2, budget // rows)
        return [members[j:j + cap] for j in range(0, len(members), cap)]

    def calibrate(self, q: Query, root: str | None = None, pin: bool = False,
                  batch: bool | None = None) -> ExecStats:
        stats = ExecStats()
        if self._batch_enabled(batch):
            plan = self.calibration_plan(q, root=root, pin=pin)
            while not plan.done:
                self.run_calibration_level([plan], [stats])
            return stats
        for _ in self.calibrate_iter(q, root=root, pin=pin, stats=stats):
            pass
        return stats

    def calibrate_iter(self, q: Query, root: str | None = None, pin: bool = False,
                       stats=None) -> Iterable[tuple[str, str]]:
        """Algorithm 1 edge by edge: upward then downward passes; yields after
        each edge.  Abandoning the iterator keeps every materialized message."""
        placement = self.place_predicates(q)
        root = root or self.choose_root(q, placement)
        upward = self.jt.traversal_to_root(root)
        downward = [(v, u) for (u, v) in reversed(upward)]
        stats = stats if stats is not None else ExecStats()
        for (u, v) in upward + downward:
            if pin:
                # pin BEFORE materializing so a tight budget can't evict it
                self.store.pin(self.edge_sig(q, u, v, placement), self.gamma_carry(q, u, v))
            before = stats.messages_computed
            self.message(q, u, v, placement, stats)
            self._count_dispatches(stats, stats.messages_computed - before)
            yield (u, v)

    # -- level-batched calibration (think-time batching, §4.2.1) ---------------
    def _batch_enabled(self, batch: bool | None = None) -> bool:
        if batch is None:
            batch = self.batch_calibration
        return bool(batch) and self.plans is not None

    def _count_dispatches(self, stats: ExecStats | None, k: int) -> None:
        """Account ``k`` calibration message dispatches (per-edge: one per
        computed message; levels: one per level)."""
        if k <= 0:
            return
        if stats is not None:
            stats.calibration_dispatches += k
        if self.plans is not None:
            self.plans.stats.calibration_dispatches += k

    def calibration_plan(self, q: Query, root: str | None = None, pin: bool = False
                         ) -> CalibrationPlan:
        """Derive the level-synchronous schedule for one calibration pass."""
        placement = self.place_predicates(q)
        root = root or self.choose_root(q, placement)
        return CalibrationPlan(q, placement, root, self.jt.calibration_levels(root), pin)

    def step_calibration(self, plan: CalibrationPlan, max_edges: int | None = None,
                         stats=None, deadline: float | None = None) -> int:
        """Advance a parked pass edge by edge (exact budget granularity);
        ``deadline`` (a ``time.perf_counter`` timestamp) is checked after
        every edge."""
        n = 0
        stats = stats if stats is not None else ExecStats()
        with self.store.inflight():
            while not plan.done and (max_edges is None or n < max_edges):
                u, v = plan.levels[plan.pos][plan.offset]
                if plan.pin:
                    base = self.edge_sig(plan.query, u, v, plan.placement)
                    self.store.pin(base, self.gamma_carry(plan.query, u, v))
                before = stats.messages_computed
                self.message(plan.query, u, v, plan.placement, stats)
                self._count_dispatches(stats, stats.messages_computed - before)
                plan.offset += 1
                n += 1
                if plan.offset >= len(plan.levels[plan.pos]):
                    plan.pos += 1
                    plan.offset = 0
                if deadline is not None and time.perf_counter() >= deadline:
                    break
        return n

    @contextlib.contextmanager
    def _tagged(self, tag: str | None):
        """Temporarily set the store's producer tag (cross-viz accounting)."""
        if tag is None:
            yield
            return
        old = self.store.tag
        self.store.tag = tag
        try:
            yield
        finally:
            self.store.tag = old

    def _message_item(self, q: Query, u: str, v: str, placement, stats, tag
                      ) -> AbsorbItem | None:
        """Build the deferred level item for message Y(u→v), or None when
        the bag takes the dense path (then the caller computes directly)."""
        rels = self._bag_rels(q, u)
        if len(rels) != 1 or rels[0].num_rows <= self.dense_rows_threshold:
            return None
        rel = rels[0]
        gamma = self.gamma_carry(q, u, v)
        out_attrs = tuple(dict.fromkeys(self.jt.separator(u, v) + gamma))
        before = stats.messages_computed if stats else 0
        with self._tagged(tag):
            # previous levels put these; recursion recomputes an evicted one
            incoming = tuple(
                self.message(q, i, u, placement, stats) for i in self.jt.neighbors(u) if i != v
            )
        if stats:
            self._count_dispatches(stats, stats.messages_computed - before)
            stats.rows_scanned += rel.num_rows
        return AbsorbItem(
            rel=rel, vals=self._lift(q, rel), incoming=incoming,
            preds=placement.get(u, ()), out_attrs=out_attrs,
        )

    def run_calibration_level(self, plans: Sequence[CalibrationPlan],
                              stats_list: Sequence[ExecStats] | None = None,
                              tags: Sequence[str | None] | None = None) -> int:
        """Advance every unfinished plan by one level, batching across plans.

        Messages inside one level are independent, so the level executes as
        a unit: duplicates across sibling plans (equal Prop-2 signature + γ)
        materialize once, and ALL remaining messages go to ONE
        ``PlanCache.run_level`` call whose kernel-route messages share one
        ``level_aggregate`` launch.  With ``fuse_level_kernel`` off, each
        batch group of the level is its own call instead: one
        ``PlanCache.run_message_batch`` (one launch) per group of several
        messages, ``run_sparse`` for a group of one.  Returns the number of
        edges advanced; a partially-stepped level (``plan.offset``) is
        finished first.
        """
        with self.store.inflight():
            return self._run_level_inflight(plans, stats_list, tags)

    def _run_level_inflight(self, plans, stats_list=None, tags=None) -> int:
        live = [i for i, p in enumerate(plans) if not p.done]
        if not live:
            return 0
        if stats_list is None:
            stats_list = [ExecStats() for _ in plans]
        n = 0
        todo: list[tuple[int, str, str, str, tuple[str, ...]]] = []
        for i in live:
            p = plans[i]
            level = p.levels[p.pos][p.offset:]
            for (u, v) in level:
                base = self.edge_sig(p.query, u, v, p.placement)
                gamma = self.gamma_carry(p.query, u, v)
                if p.pin:
                    self.store.pin(base, gamma)  # pin-before-materialize
                todo.append((i, u, v, base, gamma))
            p.pos += 1
            p.offset = 0
            n += len(level)
        deferred: list[tuple[int, str, str, str, tuple[str, ...], AbsorbItem]] = []
        pending_sigs: set[str] = set()
        for i, u, v, base, gamma in todo:
            st = stats_list[i]
            tag = tags[i] if tags is not None else None
            with self._tagged(tag):
                cached = self.store.get(base, gamma)
            if cached is not None or self.store.full_sig(base, gamma) in pending_sigs:
                # cached, or a sibling plan materializes this exact message below
                st.messages_reused += 1
                continue
            p = plans[i]
            item = self._message_item(p.query, u, v, p.placement, st, tag)
            if item is None:
                # the dense path goes through message(), which re-probes the
                # sig the level probe above already counted — compensate so
                # miss accounting matches the per-edge loop
                self.store.misses -= 1
                before = st.messages_computed
                with self._tagged(tag):
                    self.message(p.query, u, v, p.placement, st)
                self._count_dispatches(st, st.messages_computed - before)
                continue
            pending_sigs.add(self.store.full_sig(base, gamma))
            deferred.append((i, u, v, base, gamma, item))
        if not deferred:
            return n
        groups: dict[tuple, list] = {}
        for rec in deferred:
            groups.setdefault(absorb_batch_key(self.ring, rec[5]), []).append(rec)
        group_list = list(groups.values())

        def store_group(members, fs):
            for (i, u, v, base, gamma, item), f in zip(members, fs):
                st = stats_list[i]
                tag = tags[i] if tags is not None else None
                cost = item.rel.num_rows + float(
                    np.prod([self.jt.domains.get(a, 1) for a in item.out_attrs])
                )
                with self._tagged(tag):
                    self.store.put(base, gamma, f, cost=cost)
                st.messages_computed += 1
                st.recomputed_edges.append((u, v))

        if self.fuse_level_kernel:
            fs_groups = self.plans.run_level(
                self.catalog,
                [[m[5] for m in members] for members in group_list],
                [[stats_list[m[0]] for m in members] for members in group_list],
            )
            self._count_dispatches(stats_list[group_list[0][0][0]], 1)
            for members, fs in zip(group_list, fs_groups):
                store_group(members, fs)
            return n
        for members in group_list:
            sts = [stats_list[m[0]] for m in members]
            if len(members) == 1:
                item = members[0][5]
                fs = [self.plans.run_sparse(
                    self.catalog, item.rel, item.vals, list(item.incoming),
                    list(item.preds), item.out_attrs, sts[0],
                )]
            else:
                fs = self.plans.run_message_batch(self.catalog, [m[5] for m in members], sts)
            self._count_dispatches(sts[0], 1)
            store_group(members, fs)
        return n

    def calibrate_levels_iter(self, q: Query, root: str | None = None, pin: bool = False,
                              stats=None) -> Iterable[tuple[tuple[str, str], ...]]:
        """Level-batched Algorithm 1: yields the edge tuple of each completed
        level (upward levels deepest-first, then downward)."""
        plan = self.calibration_plan(q, root=root, pin=pin)
        stats_list = [stats if stats is not None else ExecStats()]
        while not plan.done:
            level = plan.levels[plan.pos]
            self.run_calibration_level([plan], stats_list)
            yield level

    def _union_carry(self, queries: Sequence[Query]) -> list[Query]:
        """Fuse same-``sig_key`` queries into union-γ calibration passes.

        One message carrying γ₁∪γ₂ serves both queries: Prop-2 base
        signatures are γ-independent and the store narrows a wider cached
        message on lookup (Σ-compensation).  Greedy first-fit, bounded by
        ``calibration_union_budget()`` (read on every call) on the γ-domain
        product of the widest message.
        """
        budget = calibration_union_budget()
        slots: list[tuple[str, Query, tuple[str, ...]]] = []
        for q in queries:
            for j, (sk, rep, union) in enumerate(slots):
                if sk != q.sig_key:
                    continue
                merged = tuple(dict.fromkeys(union + q.group_by))
                lanes = int(np.prod([self.jt.domains.get(a, 1) for a in merged]))
                if merged == union or lanes <= budget:
                    slots[j] = (sk, rep, merged)
                    break
            else:
                slots.append((q.sig_key, q, tuple(q.group_by)))
        out, seen = [], set()
        for _, rep, union in slots:
            eff = rep.with_group_by(*union)
            if eff.digest not in seen:
                seen.add(eff.digest)
                out.append(eff)
        return out

    def calibrate_many(self, queries: Sequence[Query], pin: bool = False,
                       batch: bool | None = None) -> tuple[list[ExecStats], list[Query]]:
        """Calibrate several queries' CJTs together (dashboard offline stage).

        With level batching, sibling queries fuse into union-carry passes that
        share one root and advance level-synchronously, so same-signature
        messages across passes share each level's launch.  Returns ``(stats
        per effective pass, effective queries)``; pins land on the effective
        queries.
        """
        if not queries:
            return [], []
        if not self._batch_enabled(batch):
            return [self.calibrate(q, pin=pin, batch=False) for q in queries], list(queries)
        effective = self._union_carry(queries)
        root = self.choose_root(effective[0])
        plans = [self.calibration_plan(q, root=root, pin=pin) for q in effective]
        stats_list = [ExecStats() for _ in effective]
        while any(not p.done for p in plans):
            self.run_calibration_level(plans, stats_list)
        return stats_list, effective

    def unpin_query(self, q: Query) -> int:
        """Release this query's calibration pins (session GC).  Messages stay
        cached and servable; only the eviction exemption goes.  Returns the
        number of previously pinned edges released."""
        placement = self.place_predicates(q)
        n = 0
        for u, v in self.jt.directed_edges():
            base = self.edge_sig(q, u, v, placement)
            gamma = self.gamma_carry(q, u, v)
            if self.store.full_sig(base, gamma) in self.store._pinned:
                n += 1
            self.store.unpin(base, gamma)
        return n

    # -- delta calibration (data updates) ---------------------------------------
    def delta_message(self, q_new: Query, q_delta: Query, u: str, v: str, placement,
                      via: str | None = None, delta_in: Factor | None = None) -> Factor:
        """ΔY(u→v): the u→v contraction with the changed input swapped for its delta.

        Bag contraction is multilinear in the bag's relations and in each
        incoming message, so replacing exactly the changed input by its
        ⊕-difference yields the ⊕-difference of the output.  ``via=None``
        means u hosts the updated relation and ``q_delta`` (which pins that
        relation to its delta-rows version) drives the contraction; otherwise
        ``delta_in`` is ΔY(via→u) and every other input is a cached message.

        With ``via=None`` the bag goes sparse or dense by the rows of the
        relation's *new* version, as a full recalibration of ``q_new`` would
        route it.  (The reference decides on the delta's own row count, so a
        small delta of a large relation under ``dense_rows_threshold > 0``
        densifies the whole relation's domain product.)
        """
        gamma = self.gamma_carry(q_new, u, v)
        out_attrs = tuple(dict.fromkeys(self.jt.separator(u, v) + gamma))
        incoming = [
            self.message(q_new, i, u, placement)
            for i in self.jt.neighbors(u) if i != v and i != via
        ]
        if via is not None:
            return self._bag_contract(q_new, u, incoming + [delta_in], out_attrs, placement)
        rels, preds = self._bag_rels(q_delta, u), placement.get(u, ())
        full = self._bag_rels(q_new, u)
        if len(full) == 1 and full[0].num_rows > self.dense_rows_threshold:
            return self._sparse_bag(q_delta, rels[0], incoming, preds, out_attrs)
        return self._dense_bag(q_delta, rels, incoming, preds, out_attrs)

    def apply_delta(self, q: Query, delta: Delta) -> tuple[Query, DeltaStats]:
        """Maintain this query's cached messages across a base-data update.

        Returns ``(q_new, stats)``, ``q_new`` being ``q`` re-snapshotted to
        ``delta.new_version``.  Only the n−1 messages directed away from the
        updated bag u₀ change; they are updated as old ⊕ ΔY in u₀-outward
        order and stored under new-version Prop-2 signatures, so a stale
        message never serves a post-update query.  The catalog must already
        hold the new version.  When the ring cannot absorb the delta or a σ
        migrated between bags, nothing is maintained and ``stats.fallback``
        is set: queries then recompute on demand.
        """
        stats = DeltaStats(delta_rows=delta.num_rows)
        q_new = q.with_version(delta.relation, delta.new_version)
        if delta.relation in q.removed or delta.relation not in self.jt.mapping:
            return q_new, stats  # update invisible to this query's CJT
        if q.version_of(delta.relation) != delta.old_version:
            raise ValueError(
                f"delta chains {delta.relation}@{delta.old_version} but the "
                f"query snapshot is @{q.version_of(delta.relation)}"
            )
        if not delta.supported_by(self.ring):
            stats.fallback = True
            return q_new, stats
        self.catalog.put(delta.rows, make_latest=False)
        placement_old = self.place_predicates(q)
        placement_new = self.place_predicates(q_new)
        if placement_old != placement_new:
            # a σ migrated bags: old messages had another annotation layout
            stats.fallback = True
            return q_new, stats
        u0 = self.jt.mapping[delta.relation]
        q_delta = q_new.with_version(delta.relation, delta.rows.version)
        upward = self.jt.traversal_to_root(u0)  # (child, parent): parent is u₀-side
        toward_u0 = {c: p for (c, p) in upward}
        # an empty delta (compaction) is the ⊕-zero: re-key, contract nothing
        empty = delta.num_rows == 0
        dmsgs: dict[tuple[str, str], Factor] = {}
        with self.store.inflight():
            for (c, p) in reversed(upward):  # edges nearest u₀ first
                u, v = p, c  # the changed direction points away from u₀
                d = None
                if not empty:
                    via = None if u == u0 else toward_u0[u]
                    d = self.delta_message(
                        q_new, q_delta, u, v, placement_new,
                        via=via, delta_in=None if via is None else dmsgs[(via, u)],
                    )
                    dmsgs[(u, v)] = d
                    stats.delta_messages += 1
                old_base = self.edge_sig(q, u, v, placement_old)
                new_base = self.edge_sig(q_new, u, v, placement_new)
                gamma = self.gamma_carry(q_new, u, v)
                if self.store.apply_delta(old_base, new_base, gamma, d) is not None:
                    stats.edges_maintained += 1
                else:
                    stats.edges_skipped += 1
        return q_new, stats

    def is_calibrated(self, q: Query) -> bool:
        placement = self.place_predicates(q)
        for u, v in self.jt.directed_edges():
            base = self.edge_sig(q, u, v, placement)
            if not self.store.contains(base, self.gamma_carry(q, u, v)):
                return False
        return True
