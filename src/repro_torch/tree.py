"""Nested-dict trees of tensors (the port's parameter, gradient and
optimizer-state trees), walked in the reference's pytree order: dict keys
sorted, as ``jax.tree_util`` flattens them."""

from __future__ import annotations


def leaves(tree):
    """Every leaf, keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k])
    else:
        yield tree


def paths(tree, prefix: tuple = ()):
    """``(path, leaf)`` pairs, keys sorted; a path is the tuple of keys."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def from_paths(keys, values) -> dict:
    """The tree whose leaf at ``keys[i]`` is ``values[i]``."""
    out: dict = {}
    for path, v in zip(keys, values):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def map_leaves(fn, *trees):
    """``fn`` over the matching leaves of trees of one structure (dicts,
    lists and tuples); a tree given as ``None`` passes ``None`` for each of
    its leaves."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: map_leaves(fn, *(None if t is None else t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(map_leaves(fn, *(None if t is None else t[i] for t in trees))
                           for i in range(len(first)))
    return fn(*trees)


def unzip(tree, n: int) -> tuple:
    """A tree of n-tuples as n trees."""
    if isinstance(tree, dict):
        parts = {k: unzip(v, n) for k, v in tree.items()}
        return tuple({k: p[i] for k, p in parts.items()} for i in range(n))
    return tree
