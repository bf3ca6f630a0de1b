"""Steiner-tree planning between queries (paper §3.4.2).

The signature cache in ``calibration.py`` already *realizes* Steiner-tree
execution (cache misses are exactly the edges inside the tree); this module
makes the tree explicit for planning, introspection and for the property test
"edges recomputed ⊆ directed Steiner tree edges".
"""

from __future__ import annotations

import dataclasses

from .calibration import CJTEngine
from .hypertree import JTree
from .query import Query


def minimal_steiner_tree(jt: JTree, terminals: set[str]) -> tuple[set[str], set[tuple[str, str]]]:
    """Minimal subtree of the JT spanning ``terminals``.

    In a tree this is unique: repeatedly prune non-terminal leaves.
    Returns (nodes, undirected edges as sorted tuples).
    """
    if not terminals:
        return set(), set()
    nodes = set(jt.bags)
    adj = {u: set(jt.adj[u]) for u in nodes}
    changed = True
    while changed:
        changed = False
        for u in sorted(nodes):
            if u not in terminals and len(adj[u]) <= 1:
                for v in adj[u]:
                    adj[v].discard(u)
                nodes.discard(u)
                adj.pop(u)
                changed = True
    edges = {tuple(sorted((u, v))) for u in nodes for v in adj[u]}
    return nodes, edges


@dataclasses.dataclass(frozen=True)
class SteinerPlan:
    terminals: frozenset[str]
    nodes: frozenset[str]
    edges: frozenset[tuple[str, str]]
    root: str

    @property
    def size(self) -> int:
        return len(self.nodes)


def changed_bags(engine: CJTEngine, q_old: Query, q_new: Query) -> set[str]:
    """B_D: bags whose annotation state differs between the two queries."""
    p_old = engine.place_predicates(q_old)
    p_new = engine.place_predicates(q_new)
    out = set()
    for bag in engine.jt.bags:
        if engine.bag_state_digest(q_old, bag, p_old) != engine.bag_state_digest(
            q_new, bag, p_new
        ):
            out.add(bag)
    # γ deltas: a changed group-by attr pins (the closest bag containing) it
    for attr in set(q_old.group_by) ^ set(q_new.group_by):
        cands = engine.jt.bags_with_attr(attr)
        if cands:
            out.add(cands[0])
    return out


def plan(engine: CJTEngine, q_old: Query, q_new: Query) -> SteinerPlan:
    """Plan q_new against the CJT of q_old: B_D → minimal Steiner tree → root.

    Root choice inside the tree follows §3.3.3 (smallest estimated absorb
    cost).  If nothing changed, the plan degenerates to a single bag.
    """
    bd = changed_bags(engine, q_old, q_new)
    if not bd:
        root = engine.choose_root(q_new)
        return SteinerPlan(frozenset(), frozenset({root}), frozenset(), root)
    nodes, edges = minimal_steiner_tree(engine.jt, bd)
    placement = engine.place_predicates(q_new)
    best, best_cost = None, None
    for root in sorted(nodes):
        cost = engine._bag_rows(q_new, root)
        for (u, v) in engine.jt.traversal_to_root(root):
            cost += engine.estimate_edge_cost(q_new, u, v, placement)
        if best_cost is None or cost < best_cost:
            best, best_cost = root, cost
    return SteinerPlan(frozenset(bd), frozenset(nodes), frozenset(edges), best)


def realized_size(stats, root: str | None = None) -> int:
    """Size of the Steiner tree an execution actually realized.

    The engine's cache misses are exactly the tree's directed edges, so the
    realized size is the bag set touched by ``stats.recomputed_edges`` (plus
    the absorption root when known).  ``CJTEngine.execute`` reports the same
    number in ``ExecStats.steiner_size``; this helper exists for tests that
    cross-check the planned tree (``plan``) against the realized one.
    """
    touched = {b for edge in stats.recomputed_edges for b in edge}
    if root is not None:
        touched.add(root)
    return max(len(touched), 1)


def directed_edges_into(plan_: SteinerPlan) -> set[tuple[str, str]]:
    """All directed edges whose messages an execution rooted inside the tree
    may need to recompute (both orientations of tree edges)."""
    out = set()
    for (u, v) in plan_.edges:
        out.add((u, v))
        out.add((v, u))
    return out
