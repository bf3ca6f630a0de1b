"""Port semirings held against the JAX package on the same numpy inputs:
every ring op must agree exactly on integer-valued inputs (no rounding), and
the semiring laws must hold for the port's own fields."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, strategies as st

from repro.core import semiring as jsr
from repro_torch.core import semiring as tsr

NAMES = ["count", "sum", "count_i64", "tropical_min", "tropical_max", "bool", "moments"]


def _np_elem(name, rng, shape):
    if name == "bool":
        return rng.random(shape) > 0.5
    if name == "moments":
        return tuple(rng.integers(0, 5, shape).astype(np.float32) for _ in range(3))
    if name == "count_i64":
        return rng.integers(0, 7, shape).astype(np.int64)
    return rng.integers(0, 7, shape).astype(np.float32)


def _jax(x):
    return tuple(jnp.asarray(l) for l in x) if isinstance(x, tuple) else jnp.asarray(x)


def _torch(x):
    return tuple(torch.as_tensor(l) for l in x) if isinstance(x, tuple) else torch.as_tensor(x)


def _assert_same(jax_field, torch_field):
    jl = jax.tree_util.tree_leaves(jax_field)
    tl = tsr.leaves(torch_field)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        b = b.numpy()
        # the reference's count_i64 is int32 (JAX x64 off); the port's is int64
        if b.dtype == np.int64:
            a = a.astype(np.int64)
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", NAMES)
def test_ring_ops_match_reference(name):
    jr, tr = jsr.get(name), tsr.get(name)
    rng = np.random.default_rng(len(name))
    a, b = _np_elem(name, rng, (4, 5)), _np_elem(name, rng, (4, 5))
    _assert_same(jr.mul(_jax(a), _jax(b)), tr.mul(_torch(a), _torch(b)))
    _assert_same(jr.add(_jax(a), _jax(b)), tr.add(_torch(a), _torch(b)))
    for axes in ((0,), (1,), (0, 1)):
        _assert_same(jr.add_reduce(_jax(a), axes), tr.add_reduce(_torch(a), axes))
    _assert_same(jr.zeros((2, 3)), tr.zeros((2, 3)))
    _assert_same(jr.ones((2, 3)), tr.ones((2, 3)))
    rows = _np_elem(name, rng, (40,))
    ids = rng.integers(0, 6, 40)
    _assert_same(jr.segment_reduce(_jax(rows), jnp.asarray(ids), 7),
                 tr.segment_reduce(_torch(rows), torch.as_tensor(ids), 7))
    assert (jr.has_add_inverse, jr.idempotent_add, jr.is_arithmetic, jr.trailing,
            jr.kernel_segment_op) == (tr.has_add_inverse, tr.idempotent_add,
                                      tr.is_arithmetic, tr.trailing, tr.kernel_segment_op)


def test_count_i64_is_real_int64():
    assert tsr.COUNT_I64.zeros((3,)).dtype == torch.int64


@pytest.mark.parametrize("name", [n for n in NAMES if n != "count_i64"])
@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_semiring_laws(name, seed):
    ring = tsr.get(name)
    rng = np.random.default_rng(seed)
    a, b, c = (_torch(_np_elem(name, rng, (3,))) for _ in range(3))

    def eq(x, y):
        for lx, ly in zip(tsr.leaves(x), tsr.leaves(y)):
            assert torch.equal(lx, ly)

    eq(ring.mul(a, b), ring.mul(b, a))
    eq(ring.add(a, b), ring.add(b, a))
    eq(ring.mul(ring.mul(a, b), c), ring.mul(a, ring.mul(b, c)))
    eq(ring.add(ring.add(a, b), c), ring.add(a, ring.add(b, c)))
    eq(ring.mul(a, ring.add(b, c)), ring.add(ring.mul(a, b), ring.mul(a, c)))
    eq(ring.mul(a, ring.ones((3,))), a)
    eq(ring.add(a, ring.zeros((3,))), a)
    eq(ring.mul(a, ring.zeros((3,))), ring.zeros((3,)))


@pytest.mark.parametrize("name", ["sum", "tropical_min", "tropical_max", "bool", "moments"])
def test_segment_reduce_empty_segments_hold_identity(name):
    ring = tsr.get(name)
    rows = _torch(_np_elem(name, np.random.default_rng(0), (5,)))
    out = ring.segment_reduce(rows, torch.zeros(5, dtype=torch.int32), 3)
    for leaf, z in zip(tsr.leaves(out), tsr.leaves(ring.zeros((2,)))):
        assert torch.equal(leaf[1:], z)


def test_moments_lift_and_finalize_match_reference():
    rng = np.random.default_rng(4)
    x = rng.integers(0, 9, 12).astype(np.float32)
    w = rng.integers(-1, 3, 12).astype(np.float32)
    _assert_same(jsr.moments_lift(jnp.asarray(x), jnp.asarray(w)),
                 tsr.moments_lift(torch.as_tensor(x), torch.as_tensor(w)))
    field = tuple(np.abs(rng.integers(0, 5, 6)).astype(np.float32) for _ in range(3))
    jf = jsr.moments_finalize(_jax(field))
    tf = tsr.moments_finalize(_torch(field))
    for k in ("count", "sum", "mean", "var"):
        np.testing.assert_allclose(np.asarray(jf[k]), tf[k].numpy(), rtol=1e-6)


def test_covariance_ring_matches_reference():
    k = 3
    jr, tr = jsr.make_covariance_ring(k), tsr.make_covariance_ring(k)
    rng = np.random.default_rng(5)
    cols = [rng.integers(0, 4, 6).astype(np.float32) for _ in range(2)]
    ja = jsr.covariance_lift(k, [0, 2], [jnp.asarray(c) for c in cols])
    ta = tsr.covariance_lift(k, [0, 2], [torch.as_tensor(c) for c in cols])
    _assert_same(ja, ta)
    _assert_same(jr.mul(ja, ja), tr.mul(ta, ta))
    _assert_same(jr.add_reduce(ja, (0,)), tr.add_reduce(ta, (0,)))
    assert tr.kernel_segment_op is None and tr.trailing == (0, 1, 2)
