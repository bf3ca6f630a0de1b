"""Junction Hypertree (JT) construction and validation (paper §2, §3.2).

A JT is (bags, tree edges, relation mapping X).  For acyclic join graphs the
optimal JT has one bag per relation (paper §2); we build it as the
maximum-weight spanning tree of the attribute-intersection graph
(Bernstein–Goodman: the hypergraph is γ-acyclic iff that MST satisfies the
running-intersection property), then validate vertex/edge coverage + RIP.

Extensions from the paper:
  - **empty bags** (§3.2): custom bags mapped to the identity relation that
    materialize shortcut views (``insert_empty_bag``);
  - **augmentation bags** (§4.3): attach a new relation as a fresh bag on any
    bag covering its join keys (``attach_relation``).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Iterable, Mapping, Sequence


class CyclicSchemaError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class JTree:
    bags: dict[str, tuple[str, ...]]          # bag name -> attrs
    adj: dict[str, tuple[str, ...]]           # bag name -> neighbor names
    mapping: dict[str, str]                   # relation name -> bag name (X)
    domains: dict[str, int]                   # attr -> domain size
    empty_bags: frozenset[str] = frozenset()  # bags mapped to 𝕀

    # -- structure queries ---------------------------------------------------
    # All queries below are pure functions of the (immutable) tree structure
    # and sit on the per-interaction hot path (root choice + signature
    # derivation evaluate them per edge per query), so they memoize into a
    # lazily-created per-instance dict.  insert_empty_bag / attach_relation
    # construct fresh JTree objects, never mutate one, so entries are stable.
    def _memo(self) -> dict:
        memo = self.__dict__.get("_memo_cache")
        if memo is None:
            object.__setattr__(self, "_memo_cache", memo := {})
        return memo

    def neighbors(self, u: str) -> tuple[str, ...]:
        return self.adj[u]

    def separator(self, u: str, v: str) -> tuple[str, ...]:
        memo = self._memo()
        key = ("sep", u, v)
        hit = memo.get(key)
        if hit is None:
            su = set(self.bags[v])
            memo[key] = hit = tuple(a for a in self.bags[u] if a in su)
        return hit

    def relations_of(self, bag: str) -> tuple[str, ...]:
        """X⁻¹(bag)."""
        memo = self._memo()
        key = ("rels", bag)
        hit = memo.get(key)
        if hit is None:
            memo[key] = hit = tuple(
                sorted(r for r, b in self.mapping.items() if b == bag)
            )
        return hit

    def directed_edges(self) -> list[tuple[str, str]]:
        out = []
        for u, nbrs in self.adj.items():
            out.extend((u, v) for v in nbrs)
        return sorted(out)

    def subtree_bags(self, u: str, away_from: str | None) -> tuple[str, ...]:
        """Bags in the subtree rooted at u when edge (u, away_from) is cut."""
        seen = {u} | ({away_from} if away_from else set())
        stack, out = [u], [u]
        while stack:
            x = stack.pop()
            for y in self.adj[x]:
                if y not in seen:
                    seen.add(y)
                    out.append(y)
                    stack.append(y)
        return tuple(out)

    def subtree_attrs(self, u: str, away_from: str | None) -> frozenset[str]:
        memo = self._memo()
        key = ("sattrs", u, away_from)
        hit = memo.get(key)
        if hit is None:
            memo[key] = hit = frozenset(
                a for b in self.subtree_bags(u, away_from) for a in self.bags[b]
            )
        return hit

    def height(self, u: str, away_from: str | None) -> int:
        """Edges on the longest downward path from u when edge (u,
        away_from) is cut: 0 at a leaf, so a message u→away_from is computed
        at calibration level ``height(u, away_from)``."""
        memo = self._memo()
        key = ("height", u, away_from)
        hit = memo.get(key)
        if hit is None:
            memo[key] = hit = max((1 + self.height(w, u) for w in self.adj[u]
                                   if w != away_from), default=0)
        return hit

    def path(self, u: str, v: str) -> list[str]:
        parent = {u: None}
        stack = [u]
        while stack:
            x = stack.pop()
            if x == v:
                break
            for y in self.adj[x]:
                if y not in parent:
                    parent[y] = x
                    stack.append(y)
        out, x = [], v
        while x is not None:
            out.append(x)
            x = parent[x]
        return out[::-1]

    def bags_with_attr(self, attr: str) -> tuple[str, ...]:
        return tuple(sorted(b for b, attrs in self.bags.items() if attr in attrs))

    def traversal_to_root(self, root: str) -> list[tuple[str, str]]:
        """Tra(root): directed edges (child→parent) in upward order (leaves first)."""
        memo = self._memo()
        key = ("tra", root)
        hit = memo.get(key)
        if hit is not None:
            return list(hit)
        order: list[tuple[str, str]] = []

        def visit(u: str, parent: str | None):
            for v in self.adj[u]:
                if v != parent:
                    visit(v, u)
                    order.append((v, u))

        visit(root, None)
        memo[key] = tuple(order)
        return order

    def calibration_levels(self, root: str) -> tuple[tuple[tuple[str, str], ...], ...]:
        """Level-synchronous calibration schedule: upward then downward passes.

        Edges are grouped by the depth of the bag *below* the cut: upward
        level k holds the child→parent edges whose child sits at depth k
        (emitted deepest-first), downward levels mirror them shallowest-first
        with the direction flipped.  All edges inside one level are
        independent — a message's inputs live strictly on the far side of its
        level boundary — so a level can execute as one batched dispatch, and
        abandoning the schedule at any level boundary leaves every completed
        level's messages servable.  Concatenated, the levels enumerate the
        same 2(n−1) directed edges as ``traversal_to_root`` + its reverse.
        """
        memo = self._memo()
        key = ("levels", root)
        hit = memo.get(key)
        if hit is not None:
            return hit
        seen = {root}
        frontier = [root]
        by_depth: list[tuple[tuple[str, str], ...]] = []
        while frontier:
            nxt = []
            for u in frontier:
                for v in self.adj[u]:
                    if v not in seen:
                        seen.add(v)
                        nxt.append((v, u))
            if nxt:
                by_depth.append(tuple(sorted(nxt)))
            frontier = [v for v, _ in nxt]
        # by_depth[k-1] holds the (child at depth k, parent) edges
        upward = list(reversed(by_depth))
        downward = [tuple((p, c) for (c, p) in lvl) for lvl in by_depth]
        memo[key] = hit = tuple(upward + downward)
        return hit

    # -- validation (paper §2: the three JT properties) ----------------------
    def validate(self) -> None:
        names = set(self.bags)
        # tree: connected with |E| = |V| - 1
        n_edges = sum(len(v) for v in self.adj.values()) // 2
        if len(names) > 1 and n_edges != len(names) - 1:
            raise ValueError(f"not a tree: {len(names)} bags, {n_edges} edges")
        if names and len(self.subtree_bags(next(iter(sorted(names))), None)) != len(names):
            raise ValueError("not connected")
        for u, nbrs in self.adj.items():
            for v in nbrs:
                if u not in self.adj[v]:
                    raise ValueError(f"asymmetric edge {u}->{v}")
        # edge coverage: X(R)'s bag covers R's attrs — checked by builder
        # running intersection: per attr, bags containing it form a subtree
        for attr in {a for attrs in self.bags.values() for a in attrs}:
            with_attr = set(self.bags_with_attr(attr))
            start = next(iter(sorted(with_attr)))
            seen = {start}
            stack = [start]
            while stack:
                x = stack.pop()
                for y in self.adj[x]:
                    if y in with_attr and y not in seen:
                        seen.add(y)
                        stack.append(y)
            if seen != with_attr:
                raise ValueError(f"running intersection violated for {attr}")


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------

def is_acyclic(schemas: Mapping[str, Iterable[str]]) -> bool:
    """GYO ear-elimination acyclicity test (paper §2, Example 3)."""
    rels = {n: frozenset(a) for n, a in schemas.items() if a}
    changed = True
    while changed and len(rels) > 1:
        changed = False
        names = sorted(rels)
        for n in names:
            others = [rels[m] for m in rels if m != n]
            # ear: attrs of n either unique to n, or all shared attrs are
            # contained in a single other relation
            shared = rels[n] & frozenset().union(*others) if others else frozenset()
            if any(shared <= o for o in others):
                del rels[n]
                changed = True
                break
    return len(rels) <= 1


def build_join_tree(
    schemas: Mapping[str, Sequence[str]],
    domains: Mapping[str, int],
) -> JTree:
    """One bag per relation; max-weight spanning tree on |attrs∩| (paper §2)."""
    names = sorted(schemas)
    bags = {f"bag:{n}": tuple(schemas[n]) for n in names}
    mapping = {n: f"bag:{n}" for n in names}
    bag_names = sorted(bags)
    # Kruskal on intersection weights (ties broken by name for determinism)
    edges = []
    for u, v in itertools.combinations(bag_names, 2):
        w = len(set(bags[u]) & set(bags[v]))
        edges.append((-w, u, v))
    edges.sort()
    parent = {b: b for b in bag_names}

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    adj: dict[str, list[str]] = {b: [] for b in bag_names}
    for w, u, v in edges:
        if find(u) != find(v):
            parent[find(u)] = find(v)
            adj[u].append(v)
            adj[v].append(u)
    jt = JTree(
        bags=bags,
        adj={b: tuple(sorted(n)) for b, n in adj.items()},
        mapping=mapping,
        domains=dict(domains),
    )
    try:
        jt.validate()
    except ValueError as e:
        if not is_acyclic(schemas):
            raise CyclicSchemaError(
                f"join graph is cyclic; pre-join cycles first (paper §2): {e}"
            ) from e
        raise
    return jt


def insert_empty_bag(
    jt: JTree, name: str, attrs: Sequence[str], host: str, reroute: Sequence[str]
) -> JTree:
    """Insert an empty bag between ``host`` and ``reroute ⊆ neighbors(host)``.

    The empty bag materializes the shortcut view over ``attrs`` (Fig 5b: the
    (Time, Stores) bag between Store_Sales and its dimensions).  ``attrs``
    must cover each rerouted separator so RIP is preserved.
    """
    bag_name = f"bag:{name}"
    assert bag_name not in jt.bags
    attrs = tuple(attrs)
    assert set(attrs) <= set(jt.bags[host]), "empty bag attrs must come from host"
    for v in reroute:
        assert v in jt.adj[host], f"{v} is not a neighbor of {host}"
        assert set(jt.separator(host, v)) <= set(attrs), (
            f"separator({host},{v}) not covered by empty bag"
        )
    bags = dict(jt.bags)
    bags[bag_name] = attrs
    adj = {b: [x for x in nb] for b, nb in jt.adj.items()}
    for v in reroute:
        adj[host].remove(v)
        adj[v].remove(host)
        adj[v].append(bag_name)
    adj[bag_name] = list(reroute) + [host]
    adj[host].append(bag_name)
    out = JTree(
        bags=bags,
        adj={b: tuple(sorted(n)) for b, n in adj.items()},
        mapping=dict(jt.mapping),
        domains=dict(jt.domains),
        empty_bags=jt.empty_bags | {bag_name},
    )
    out.validate()
    return out


def attach_relation(
    jt: JTree, rel_name: str, rel_attrs: Sequence[str], rel_domains: Mapping[str, int]
) -> tuple[JTree, str]:
    """§4.3 augmentation: new bag for ``rel`` attached at a bag covering the
    join keys.  Returns (new JT, new bag name)."""
    rel_attrs = tuple(rel_attrs)
    keys = [a for a in rel_attrs if a in {x for at in jt.bags.values() for x in at}]
    host = None
    for b in sorted(jt.bags):
        if set(keys) <= set(jt.bags[b]):
            host = b
            break
    if host is None:
        raise ValueError(
            f"join keys {keys} span multiple bags; create an empty bag first "
            "(paper Appendix B)"
        )
    bag_name = f"bag:{rel_name}"
    bags = dict(jt.bags)
    bags[bag_name] = rel_attrs
    adj = {b: list(nb) for b, nb in jt.adj.items()}
    adj[bag_name] = [host]
    adj[host] = adj[host] + [bag_name]
    mapping = dict(jt.mapping)
    mapping[rel_name] = bag_name
    domains = dict(jt.domains)
    for a in rel_attrs:
        if a in domains and a in rel_domains and domains[a] != rel_domains[a]:
            raise ValueError(f"domain mismatch for {a}")
        domains[a] = rel_domains.get(a, domains.get(a))
    out = JTree(
        bags=bags,
        adj={b: tuple(sorted(n)) for b, n in adj.items()},
        mapping=mapping,
        domains=domains,
        empty_bags=jt.empty_bags,
    )
    out.validate()
    return out, bag_name


def jt_from_catalog(catalog) -> JTree:
    schemas = {n: catalog.get(n).attrs for n in catalog.names()}
    return build_join_tree(schemas, catalog.domains())
