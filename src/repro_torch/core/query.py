"""SPJA query IR with the paper's annotation vocabulary (§3.3, Table 1).

A :class:`Query` captures::

    SELECT G, AGG(measure) FROM J WHERE [join cond] AND P GROUP BY G

as annotations over a JT:
  γ  — ``group_by`` attrs (prevent marginalization on the path to the root)
  σ  — ``predicates`` (domain masks; Table 1 σ_id)
  R* — ``rel_versions`` (update relation to a specific version)
  R̄  — ``removed`` (exclude relation from its bag)
  Σ  — compensation is *implicit* here: base messages are separator-only, so
       dropping a γ never blocks reuse; cached wider-γ messages are narrowed
       by ⊕-marginalization on lookup (see MessageStore.widen in
       calibration.py) — the exact effect of the paper's Σ annotation.

Queries are immutable and content-hashable so Proposition 2 signatures can be
derived from them.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
from typing import Mapping, Sequence

from repro_torch.relational.relation import Catalog, Predicate


@dataclasses.dataclass(frozen=True)
class Query:
    ring_name: str = "count"
    measure: tuple[str, str] | None = None            # (relation, column)
    group_by: tuple[str, ...] = ()
    predicates: tuple[Predicate, ...] = ()
    rel_versions: tuple[tuple[str, str], ...] = ()     # resolved (name, version)
    removed: frozenset[str] = frozenset()
    lift_tag: str = ""                                 # cache tag for custom lifts

    # -- constructors --------------------------------------------------------
    @staticmethod
    def make(
        catalog: Catalog,
        ring: str = "count",
        measure: tuple[str, str] | None = None,
        group_by: Sequence[str] = (),
        predicates: Sequence[Predicate] = (),
        versions: Mapping[str, str] | None = None,
        removed: Sequence[str] = (),
        lift_tag: str = "",
    ) -> "Query":
        """Snapshot relation versions so the query is self-contained."""
        versions = dict(versions or {})
        resolved = tuple(
            sorted((n, versions.get(n, catalog.latest_version(n))) for n in catalog.names())
        )
        return Query(
            ring_name=ring,
            measure=measure,
            group_by=tuple(group_by),
            predicates=tuple(sorted(predicates, key=lambda p: p.digest)),
            rel_versions=resolved,
            removed=frozenset(removed),
            lift_tag=lift_tag,
        )

    # -- interaction deltas (§4.1.2) ------------------------------------------
    def with_predicate(self, pred: Predicate) -> "Query":
        kept = tuple(p for p in self.predicates if p.attr != pred.attr)
        return dataclasses.replace(
            self, predicates=tuple(sorted(kept + (pred,), key=lambda p: p.digest))
        )

    def without_predicate(self, attr: str) -> "Query":
        return dataclasses.replace(
            self, predicates=tuple(p for p in self.predicates if p.attr != attr)
        )

    def with_group_by(self, *attrs: str) -> "Query":
        return dataclasses.replace(self, group_by=tuple(dict.fromkeys(attrs)))

    def add_group_by(self, attr: str) -> "Query":
        return self.with_group_by(*(self.group_by + (attr,)))

    def with_version(self, rel: str, version: str) -> "Query":
        vs = tuple(
            (n, version if n == rel else v) for n, v in self.rel_versions
        )
        if rel not in dict(vs):
            vs = tuple(sorted(vs + ((rel, version),)))
        return dataclasses.replace(self, rel_versions=vs)

    def with_removed(self, rel: str) -> "Query":
        return dataclasses.replace(self, removed=self.removed | {rel})

    def with_relation_toggled(self, rel: str) -> "Query":
        """Flip ``rel`` in/out of R̄ (the dashboard ToggleRelation event)."""
        return dataclasses.replace(self, removed=self.removed ^ {rel})

    def with_filters(self, preds: Sequence[Predicate]) -> "Query":
        """Apply several σ at once (one surviving predicate per attr)."""
        q = self
        for p in preds:
            q = q.with_predicate(p)
        return q

    def with_measure(self, rel: str, column: str, ring: str = "sum") -> "Query":
        return dataclasses.replace(self, measure=(rel, column), ring_name=ring)

    # -- accessors ------------------------------------------------------------
    def version_of(self, rel: str) -> str | None:
        return dict(self.rel_versions).get(rel)

    def predicates_on(self, attr: str) -> tuple[Predicate, ...]:
        return tuple(p for p in self.predicates if p.attr == attr)

    @property
    def effective_versions(self) -> tuple[tuple[str, str], ...]:
        """``rel_versions`` restricted to relations the query can see.

        A removed (R̄) relation's version cannot influence the answer, so the
        digest excludes it: version bumps on invisible relations keep the
        digest stable, which is what lets ``Treant.update``/``flush`` keep
        prefetched results and parked calibration progress for queries the
        update cannot reach.
        """
        if not self.removed:
            return self.rel_versions
        return tuple((n, v) for n, v in self.rel_versions if n not in self.removed)

    @functools.cached_property
    def digest(self) -> str:
        # cached: signature derivation hashes this on every edge of every
        # message-passing step (the instance is frozen, so it never changes)
        h = hashlib.sha1()
        h.update(repr((
            self.ring_name, self.measure, self.group_by,
            tuple(p.digest for p in self.predicates),
            self.effective_versions, tuple(sorted(self.removed)), self.lift_tag,
        )).encode())
        return h.hexdigest()[:16]

    @functools.cached_property
    def sig_key(self) -> str:
        """γ-independent digest (``digest`` minus ``group_by``).

        Proposition-2 signatures hash the annotated subtree and the
        separator — never γ (the group-by only selects which carry a message
        keeps).  Signature memos key on this so sibling crossfilter vizzes
        (same σ, different γ) and Drill/Rollup variants share one signature
        derivation instead of recomputing identical hashes per viz.
        """
        h = hashlib.sha1()
        h.update(repr((
            self.ring_name, self.measure,
            tuple(p.digest for p in self.predicates),
            self.effective_versions, tuple(sorted(self.removed)), self.lift_tag,
        )).encode())
        return h.hexdigest()[:16]

    def annotation_summary(self) -> str:  # pragma: no cover — debugging aid
        parts = [f"γ={list(self.group_by)}"]
        parts += [f"σ({p.label or p.attr})" for p in self.predicates]
        parts += [f"R̄({r})" for r in sorted(self.removed)]
        return " ".join(parts)
