"""Dense semiring factors — the dense form of annotated relations.

A :class:`Factor` stores a semiring field over the full domain product of its
categorical attributes (shape (d1,..,dm) plus any trailing statistic dims of
the ring).  Join ≙ pointwise ⊗ after broadcast alignment; group-by ≙
⊕-reduction over marginalized axes — equations (1)/(2) of the paper.

``contract`` implements early marginalization / variable elimination (§2):
one ``torch.einsum`` for scalar float arithmetic rings, greedy elimination
with pointwise ⊗ / ⊕-reduce otherwise (int64 COUNT included: CUDA has no
int64 matrix product for einsum to call).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping, Sequence

import torch

from . import semiring as sr


@dataclasses.dataclass(frozen=True)
class Factor:
    attrs: tuple[str, ...]
    field: sr.Field
    ring: sr.Semiring

    # -- structure ----------------------------------------------------------
    @property
    def domain_shape(self) -> tuple[int, ...]:
        return self.ring.domain_shape(self.field)

    @property
    def domains(self) -> dict[str, int]:
        return dict(zip(self.attrs, self.domain_shape))

    @property
    def device(self) -> torch.device:
        return sr.leaves(self.field)[0].device

    def axis(self, attr: str) -> int:
        return self.attrs.index(attr)

    def __repr__(self):  # pragma: no cover
        doms = ",".join(f"{a}:{d}" for a, d in self.domains.items())
        return f"Factor[{self.ring.name}]({doms})"

    # -- algebra -------------------------------------------------------------
    def align_to(self, attrs: tuple[str, ...], domains: Mapping[str, int]) -> "Factor":
        """Broadcast this factor's field into the given attr ordering."""
        out_shape = tuple(domains[a] for a in attrs)
        src_axes = tuple(attrs.index(a) for a in self.attrs)
        return Factor(attrs, self.ring.expand_field(self.field, src_axes, out_shape), self.ring)

    def product(self, other: "Factor") -> "Factor":
        assert self.ring.name == other.ring.name, "ring mismatch"
        doms = {**self.domains, **other.domains}
        for a in set(self.attrs) & set(other.attrs):
            if self.domains[a] != other.domains[a]:
                raise ValueError(f"domain mismatch on {a}")
        attrs = tuple(dict.fromkeys(self.attrs + other.attrs))
        a = self.align_to(attrs, doms)
        b = other.align_to(attrs, doms)
        return Factor(attrs, self.ring.mul(a.field, b.field), self.ring)

    def marginalize(self, drop: Iterable[str]) -> "Factor":
        drop = [a for a in drop if a in self.attrs]
        if not drop:
            return self
        axes = tuple(sorted(self.attrs.index(a) for a in drop))
        keep = tuple(a for a in self.attrs if a not in drop)
        return Factor(keep, self.ring.add_reduce(self.field, axes), self.ring)

    def project_to(self, keep: Sequence[str]) -> "Factor":
        out = self.marginalize([a for a in self.attrs if a not in set(keep)])
        keep = tuple(a for a in keep if a in out.attrs)
        if keep == out.attrs:
            return out
        perm = tuple(out.attrs.index(a) for a in keep)
        nd = len(out.attrs)
        field = sr.like(out.field, [
            leaf.permute(perm + tuple(range(nd, nd + t)))
            for leaf, t in zip(sr.leaves(out.field), out.ring.trailing)
        ])
        return Factor(keep, field, out.ring)

    def select(self, attr: str, mask: torch.Tensor) -> "Factor":
        """Apply a predicate as a 0/1 domain mask (σ annotation): non-matching
        cells take the ⊕-identity 0̄ (the paper's footnote 3)."""
        ax = self.axis(attr)
        mshape = [1] * len(self.attrs)
        mshape[ax] = mask.shape[0]
        out = []
        for leaf, z, t in zip(sr.leaves(self.field), self.ring.zero_values, self.ring.trailing):
            m = mask.to(device=leaf.device, dtype=torch.bool).reshape(mshape + [1] * t)
            out.append(leaf.masked_fill(~m, z))
        return Factor(self.attrs, sr.like(self.field, out), self.ring)

    def add(self, other: "Factor") -> "Factor":
        other = other.project_to(self.attrs)
        return Factor(self.attrs, self.ring.add(self.field, other.field), self.ring)

    def scalar(self):
        assert not self.attrs, f"not fully marginalized: {self.attrs}"
        return self.field


def ones_factor(ring: sr.Semiring, attrs: tuple[str, ...], domains: Mapping[str, int],
                device: torch.device | str = "cpu") -> Factor:
    """The identity relation 𝕀 over the given attrs (paper §3.2, empty bags)."""
    return Factor(attrs, ring.ones(tuple(domains[a] for a in attrs), device), ring)


# ---------------------------------------------------------------------------
# Contraction (early marginalization / variable elimination)
# ---------------------------------------------------------------------------

_EINSUM_ALPHABET = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"


def _einsum_contract(factors: Sequence[Factor], keep: tuple[str, ...], ring) -> Factor:
    all_attrs = tuple(dict.fromkeys(a for f in factors for a in f.attrs))
    if len(all_attrs) > len(_EINSUM_ALPHABET):  # pragma: no cover
        raise ValueError("too many attributes for einsum path")
    sym = {a: _EINSUM_ALPHABET[i] for i, a in enumerate(all_attrs)}
    keep = tuple(a for a in keep if a in all_attrs)
    sub = ",".join("".join(sym[a] for a in f.attrs) for f in factors)
    sub += "->" + "".join(sym[a] for a in keep)
    return Factor(keep, torch.einsum(sub, *[f.field for f in factors]), ring)


def _generic_contract(factors: list[Factor], keep: tuple[str, ...], ring) -> Factor:
    """Greedy variable elimination with pointwise ⊗ and ⊕-reduce (§2, Ex. 3)."""
    keep_set = set(keep)
    factors = list(factors)
    elim = [a for f in factors for a in f.attrs if a not in keep_set]
    elim = sorted(dict.fromkeys(elim), key=lambda a: sum(a in f.attrs for f in factors))
    for attr in elim:
        cluster = [f for f in factors if attr in f.attrs]
        rest = [f for f in factors if attr not in f.attrs]
        prod = cluster[0]
        for f in cluster[1:]:
            prod = prod.product(f)
        factors = rest + [prod.marginalize([attr])]
    out = factors[0]
    for f in factors[1:]:
        out = out.product(f)
    return out.project_to(keep)


def contract(
    factors: Sequence[Factor],
    keep: Sequence[str],
    ring: sr.Semiring | None = None,
) -> Factor:
    """⊕-marginalize the ⊗-product of ``factors`` down to ``keep`` attrs."""
    factors = list(factors)
    assert factors, "empty contraction"
    ring = ring or factors[0].ring
    keep = tuple(dict.fromkeys(keep))
    if ring.is_arithmetic and len(ring.trailing) == 1 and ring.dtype.is_floating_point:
        return _einsum_contract(factors, keep, ring)
    return _generic_contract(factors, keep, ring)


def brute_force_join_aggregate(
    factors: Sequence[Factor], keep: Sequence[str], ring: sr.Semiring | None = None
) -> Factor:
    """Oracle: materialize the full ⊗-join, then ⊕-reduce (paper Fig 2c).
    Exponential in the number of attributes — tests only."""
    factors = list(factors)
    full = factors[0]
    for f in factors[1:]:
        full = full.product(f)
    return full.project_to(tuple(dict.fromkeys(keep)))
