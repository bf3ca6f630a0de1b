"""Commutative semirings over PyTorch tensors.

The paper (§2) annotates tuples with elements of a commutative semiring
(D, ⊕, ⊗, 0, 1); joins multiply annotations, group-bys add them.  A semiring
*element field* is a tensor whose leading dims are "domain" dims (one per
categorical attribute).  Scalar rings (COUNT/SUM/MIN/MAX/BOOL) use a single
tensor; compound rings (AVG/VAR/covariance) use a tuple of tensors, each with
its own trailing statistic dims.

Every ring implements:
  zeros/ones(shape, device)  identity fields for ⊕ / ⊗
  mul(a, b)                  pointwise ⊗ of aligned fields
  add_reduce(a, axes)        ⊕-marginalization over domain axes
  add(a, b)                  pointwise ⊕
  segment_reduce(v, ids, G)  ⊕-aggregation of per-row fields into G groups
  trailing                   number of non-domain trailing dims per leaf

``has_add_inverse``, ``idempotent_add`` and ``kernel_segment_op`` carry the
same meaning as in the JAX package: the last names the ⊕ of the
segment-aggregate kernel ("sum"/"min"/"max"), or None for rings that take the
plain torch path (BOOL, int64 COUNT).  The port also gives it to the
covariance ring (the reference does not): its leaves go to the kernel side
by side, flattened past their rows (``core/plans.py``).  ``kernel_mul``, the
port's own, names the ring's ⊗ where the segment kernels can compute it from
a rowwise recipe: "mul" (×, the arithmetic rings) or "add" (+, the tropical
ones); None elsewhere.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Sequence

import torch

Field = Any  # a tensor, or a tuple of tensors sharing leading domain dims


def leaves(field: Field) -> list[torch.Tensor]:
    """The field's tensors in order (one for scalar rings)."""
    return list(field) if isinstance(field, tuple) else [field]


def like(field: Field, new_leaves: Sequence[torch.Tensor]) -> Field:
    """Rebuild a field with ``field``'s structure from ``new_leaves``."""
    return tuple(new_leaves) if isinstance(field, tuple) else new_leaves[0]


def field_map(fn: Callable, *fields: Field) -> Field:
    return like(fields[0], [fn(*ls) for ls in zip(*(leaves(f) for f in fields))])


@dataclasses.dataclass(frozen=True)
class Semiring:
    """A commutative semiring over tensors (or tuples of tensors)."""

    name: str
    dtype: torch.dtype
    _mul: Callable[[Field, Field], Field]
    _add: Callable[[Field, Field], Field]
    _reduce: Callable[[Field, tuple[int, ...]], Field]
    _zeros: Callable[[tuple[int, ...], torch.device], Field]
    _ones: Callable[[tuple[int, ...], torch.device], Field]
    # per-leaf constant of the ⊕-identity field (masking and padding fill)
    zero_values: tuple = (0.0,)
    trailing: tuple[int, ...] = (0,)
    is_arithmetic: bool = False
    has_add_inverse: bool = False
    idempotent_add: bool = False
    # ⊕-segment reduction over the leading (row) axis; None → index_add_
    # per leaf (valid whenever ⊕ is +)
    _segment: Callable[[Field, torch.Tensor, int], Field] | None = None
    kernel_segment_op: str | None = None
    kernel_mul: str | None = None

    def mul(self, a: Field, b: Field) -> Field:
        return self._mul(a, b)

    def add(self, a: Field, b: Field) -> Field:
        return self._add(a, b)

    def add_reduce(self, a: Field, axes: Sequence[int]) -> Field:
        axes = tuple(axes)
        if not axes:
            return a
        return self._reduce(a, axes)

    def segment_reduce(self, values: Field, segment_ids: torch.Tensor, num_segments: int) -> Field:
        """⊕-aggregate per-row fields into ``num_segments`` dense groups;
        empty groups hold the ⊕-identity."""
        if self._segment is not None:
            return self._segment(values, segment_ids, num_segments)
        return field_map(lambda v: _index_add(v, segment_ids, num_segments), values)

    def zeros(self, shape: Sequence[int], device: torch.device | str = "cpu") -> Field:
        return self._zeros(tuple(shape), torch.device(device))

    def ones(self, shape: Sequence[int], device: torch.device | str = "cpu") -> Field:
        return self._ones(tuple(shape), torch.device(device))

    def leaves(self, a: Field) -> list[torch.Tensor]:
        return leaves(a)

    def domain_shape(self, a: Field) -> tuple[int, ...]:
        leaf = leaves(a)[0]
        t = self.trailing[0]
        return tuple(leaf.shape[: leaf.dim() - t]) if t else tuple(leaf.shape)

    def expand_field(self, a: Field, src_axes: tuple[int, ...], out_shape: tuple[int, ...]) -> Field:
        """Broadcast field with domain dims at positions src_axes into out_shape.

        Domain dims are first permuted into target order (a reshape alone
        would scramble out-of-order attrs).
        """
        order = sorted(range(len(src_axes)), key=lambda i: src_axes[i])
        out = []
        for leaf, t in zip(leaves(a), self.trailing):
            dom_nd = leaf.dim() - t
            leaf = leaf.permute(tuple(order) + tuple(range(dom_nd, leaf.dim())))
            tail = list(leaf.shape[dom_nd:])
            perm_shape = [1] * len(out_shape) + tail
            for pos, i in enumerate(order):
                perm_shape[src_axes[i]] = leaf.shape[pos]
            out.append(leaf.reshape(perm_shape).expand(tuple(out_shape) + tuple(tail)))
        return like(a, out)


def _index_add(v: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros((n,) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device)
    return out.index_add_(0, ids, v)


def _scatter(v: torch.Tensor, ids: torch.Tensor, n: int, reduce: str, fill: float) -> torch.Tensor:
    out = torch.full((n,) + tuple(v.shape[1:]), fill, dtype=v.dtype, device=v.device)
    idx = ids.long().reshape((-1,) + (1,) * (v.dim() - 1)).expand_as(v)
    return out.scatter_reduce_(0, idx, v, reduce=reduce, include_self=True)


# ---------------------------------------------------------------------------
# Scalar arithmetic rings: COUNT / SUM  (ℝ or ℕ, +, ×, 0, 1)
# ---------------------------------------------------------------------------

def _arith(name: str, dtype: torch.dtype) -> Semiring:
    return Semiring(
        name=name,
        dtype=dtype,
        _mul=lambda a, b: a * b,
        _add=lambda a, b: a + b,
        _reduce=lambda a, axes: torch.sum(a, dim=axes),
        _zeros=lambda s, d: torch.zeros(s, dtype=dtype, device=d),
        _ones=lambda s, d: torch.ones(s, dtype=dtype, device=d),
        zero_values=(0,) if not dtype.is_floating_point else (0.0,),
        is_arithmetic=True,
        has_add_inverse=True,
        kernel_segment_op="sum" if dtype == torch.float32 else None,
        kernel_mul="mul",
    )


COUNT = _arith("count", torch.float32)
SUM = _arith("sum", torch.float32)
# exact counts; unlike the JAX package (x64 off there, so int32) this is int64
COUNT_I64 = _arith("count_i64", torch.int64)


# ---------------------------------------------------------------------------
# Tropical rings: MIN / MAX aggregates  (ℝ∪{±∞}, min/max, +, ±∞, 0)
# ---------------------------------------------------------------------------

def _tropical(name: str, is_min: bool) -> Semiring:
    zero = math.inf if is_min else -math.inf
    pick = torch.minimum if is_min else torch.maximum
    red = torch.amin if is_min else torch.amax
    reduce = "amin" if is_min else "amax"
    return Semiring(
        name=name,
        dtype=torch.float32,
        _mul=lambda a, b: a + b,
        _add=pick,
        _reduce=lambda a, axes: red(a, dim=axes),
        _zeros=lambda s, d: torch.full(s, zero, dtype=torch.float32, device=d),
        _ones=lambda s, d: torch.zeros(s, dtype=torch.float32, device=d),
        zero_values=(zero,),
        idempotent_add=True,
        _segment=lambda v, ids, n: _scatter(v, ids, n, reduce, zero),
        kernel_segment_op="min" if is_min else "max",
        kernel_mul="add",
    )


TROPICAL_MIN = _tropical("tropical_min", True)
TROPICAL_MAX = _tropical("tropical_max", False)


# ---------------------------------------------------------------------------
# Boolean ring (∨, ∧): Yannakakis semi-join reductions
# ---------------------------------------------------------------------------

BOOL = Semiring(
    name="bool",
    dtype=torch.bool,
    _mul=torch.logical_and,
    _add=torch.logical_or,
    _reduce=lambda a, axes: torch.any(a, dim=axes),
    _zeros=lambda s, d: torch.zeros(s, dtype=torch.bool, device=d),
    _ones=lambda s, d: torch.ones(s, dtype=torch.bool, device=d),
    zero_values=(False,),
    idempotent_add=True,
    _segment=lambda v, ids, n: _index_add(v.to(torch.int32), ids, n) > 0,
)


# ---------------------------------------------------------------------------
# AVG / VARIANCE ring: elements (c, s, s2); var = s2/c - (s/c)^2  (paper §2)
# ---------------------------------------------------------------------------

def _moments_mul(a, b):
    (c1, s1, q1), (c2, s2, q2) = a, b
    return (c1 * c2, c1 * s2 + c2 * s1, c1 * q2 + c2 * q1 + 2.0 * s1 * s2)


def _leafwise_add(a, b):
    return field_map(torch.add, a, b)


def _leafwise_sum(a, axes):
    return field_map(lambda x: torch.sum(x, dim=axes), a)


MOMENTS = Semiring(
    name="moments",
    dtype=torch.float32,
    _mul=_moments_mul,
    _add=_leafwise_add,
    _reduce=_leafwise_sum,
    _zeros=lambda s, d: tuple(torch.zeros(s, dtype=torch.float32, device=d) for _ in range(3)),
    _ones=lambda s, d: (
        torch.ones(s, dtype=torch.float32, device=d),
        torch.zeros(s, dtype=torch.float32, device=d),
        torch.zeros(s, dtype=torch.float32, device=d),
    ),
    zero_values=(0.0, 0.0, 0.0),
    trailing=(0, 0, 0),
    has_add_inverse=True,
    # ⊕ is leafwise +, so the plan layer stacks (c, s, q) as three f32 value
    # columns and routes all of them through ONE "sum" segment pass
    kernel_segment_op="sum",
)


def moments_lift(value: torch.Tensor, count: torch.Tensor | None = None) -> Field:
    """Lift a measure column: element (c, c·x, c·x²); ``count`` is the row
    multiplicity, so count = -1 is the exact ⊕-inverse."""
    c = torch.ones_like(value) if count is None else count
    return (c, c * value, c * value * value)


def moments_finalize(field: Field) -> dict[str, torch.Tensor]:
    c, s, q = field
    mean = s / torch.clamp(c, min=1.0)
    var = q / torch.clamp(c, min=1.0) - mean * mean
    return {"count": c, "sum": s, "mean": mean, "var": var}


# ---------------------------------------------------------------------------
# Covariance (linear-regression) ring — Schleich et al., paper §4.3.
# Element: (c, s ∈ ℝ^k, Q ∈ ℝ^{k×k}); ⊗: (c1c2, c1·s2 + c2·s1,
# c1·Q2 + c2·Q1 + s1 s2ᵀ + s2 s1ᵀ); ⊕: +.
# ---------------------------------------------------------------------------

def make_covariance_ring(k: int) -> Semiring:
    def mul(a, b):
        (c1, s1, q1), (c2, s2, q2) = a, b
        c = c1 * c2
        s = c1[..., None] * s2 + c2[..., None] * s1
        outer = s1[..., :, None] * s2[..., None, :]
        q = c1[..., None, None] * q2 + c2[..., None, None] * q1 + outer + outer.transpose(-1, -2)
        return (c, s, q)

    return Semiring(
        name=f"covariance[{k}]",
        dtype=torch.float32,
        _mul=mul,
        _add=_leafwise_add,
        _reduce=_leafwise_sum,
        _zeros=lambda s, d: (
            torch.zeros(s, dtype=torch.float32, device=d),
            torch.zeros(s + (k,), dtype=torch.float32, device=d),
            torch.zeros(s + (k, k), dtype=torch.float32, device=d),
        ),
        _ones=lambda s, d: (
            torch.ones(s, dtype=torch.float32, device=d),
            torch.zeros(s + (k,), dtype=torch.float32, device=d),
            torch.zeros(s + (k, k), dtype=torch.float32, device=d),
        ),
        zero_values=(0.0, 0.0, 0.0),
        trailing=(0, 1, 2),
        has_add_inverse=True,
        kernel_segment_op="sum",
    )


def covariance_lift(k: int, feature_ids: Sequence[int], columns: Sequence[torch.Tensor]) -> Field:
    """Lift local feature columns (each (N,)) into the k-dim covariance ring."""
    n = columns[0].shape[0] if columns else 0
    device = columns[0].device if columns else torch.device("cpu")
    c = torch.ones((n,), dtype=torch.float32, device=device)
    s = torch.zeros((n, k), dtype=torch.float32, device=device)
    for fid, col in zip(feature_ids, columns):
        s[:, fid] = col.to(torch.float32)
    q = s[:, :, None] * s[:, None, :]
    return (c, s, q)


REGISTRY: dict[str, Semiring] = {
    r.name: r for r in (COUNT, SUM, COUNT_I64, TROPICAL_MIN, TROPICAL_MAX, BOOL, MOMENTS)
}


def get(name: str) -> Semiring:
    return REGISTRY[name]
