"""Port factor algebra held against the JAX package on the same numpy inputs:
contraction, the brute-force oracle, σ select and projection must agree
exactly on integer-valued fields."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import semiring as jsr
from repro.core.factor import Factor as JFactor
from repro.core.factor import contract as jcontract
from repro_torch.core import semiring as tsr
from repro_torch.core.factor import Factor as TFactor
from repro_torch.core.factor import brute_force_join_aggregate, contract, ones_factor

SCHEMAS = [
    [("A", "B"), ("B", "C")],
    [("A", "B"), ("A", "C"), ("A", "D")],          # star (Fig 2)
    [("A", "B"), ("B", "C"), ("C", "D")],          # chain (Ex. 3)
    [("A",), ("A", "B"), ("B",)],
]


def _np_field(name, shape, rng):
    if name == "bool":
        return rng.random(shape) > 0.6
    if name == "moments":
        return tuple(rng.integers(0, 4, shape).astype(np.float32) for _ in range(3))
    return rng.integers(0, 5, shape).astype(np.float32)


def _pair(name, attrs, doms, rng):
    f = _np_field(name, tuple(doms[a] for a in attrs), rng)
    jf = tuple(jnp.asarray(x) for x in f) if isinstance(f, tuple) else jnp.asarray(f)
    tf = tuple(torch.as_tensor(x) for x in f) if isinstance(f, tuple) else torch.as_tensor(f)
    return JFactor(tuple(attrs), jf, jsr.get(name)), TFactor(tuple(attrs), tf, tsr.get(name))


def _same(jf, tf):
    assert jf.attrs == tf.attrs
    for a, b in zip(jax.tree_util.tree_leaves(jf.field), tsr.leaves(tf.field)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("name", ["count", "sum", "tropical_min", "tropical_max", "bool", "moments"])
@pytest.mark.parametrize("schema", SCHEMAS)
def test_contract_matches_reference_and_brute_force(name, schema):
    rng = np.random.default_rng(len(schema) * 7 + len(name))
    attrs = sorted({a for s in schema for a in s})
    doms = {a: int(rng.integers(2, 5)) for a in attrs}
    pairs = [_pair(name, s, doms, rng) for s in schema]
    for keep_mask in (0, 5):
        keep = tuple(a for i, a in enumerate(attrs) if keep_mask >> i & 1)
        got = contract([t for _, t in pairs], keep).project_to(keep)
        _same(jcontract([j for j, _ in pairs], keep).project_to(keep), got)
        want = brute_force_join_aggregate([t for _, t in pairs], keep)
        for a, b in zip(tsr.leaves(got.field), tsr.leaves(want.field)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["sum", "tropical_max", "bool", "moments"])
def test_select_project_align_match_reference(name):
    rng = np.random.default_rng(3)
    doms = {"A": 4, "B": 3, "C": 2}
    jf, tf = _pair(name, ("A", "B", "C"), doms, rng)
    mask = np.array([True, False, True, False])
    _same(jf.select("A", jnp.asarray(mask)), tf.select("A", torch.as_tensor(mask)))
    once = tf.select("A", torch.as_tensor(mask))
    _same(jf.select("A", jnp.asarray(mask)), once.select("A", torch.as_tensor(mask)))
    _same(jf.project_to(("C", "A")), tf.project_to(("C", "A")))
    _same(jf.marginalize(["B"]), tf.marginalize(["B"]))
    _same(jf.align_to(("C", "B", "A"), doms), tf.align_to(("C", "B", "A"), doms))
    jg, tg = _pair(name, ("C", "A"), doms, rng)
    _same(jf.product(jg), tf.product(tg))
    _same(jf.add(jf), tf.add(tf))


def test_ones_factor_is_product_identity():
    rng = np.random.default_rng(4)
    _, tf = _pair("sum", ("A", "B"), {"A": 3, "B": 2}, rng)
    one = ones_factor(tsr.SUM, ("B",), {"B": 2})
    assert torch.equal(tf.product(one).field, tf.field)
