"""Shared helpers of the port's parity tests: hand the JAX package's catalog
to the port as plain numpy columns, and compare factors across packages."""

import jax
import numpy as np

from repro_torch.core import semiring as tsr
from repro_torch.relational.relation import catalog_from_arrays


def port_catalog(jax_catalog, round_measures: bool = False):
    """The port's catalog built from the reference catalog's numpy columns
    (latest versions).  ``round_measures`` makes every measure integer-valued
    in both packages' data, so float sums are exact and must match bit for bit."""
    arrays = []
    for name in jax_catalog.names():
        rel = jax_catalog.get(name)
        measures = {k: np.asarray(v) for k, v in rel.measures.items()}
        if round_measures:
            measures = {k: np.round(v / 1000.0).astype(np.float32) for k, v in measures.items()}
        arrays.append(dict(
            name=rel.name, attrs=rel.attrs, codes={a: np.asarray(c) for a, c in rel.codes.items()},
            domains=dict(rel.domains), measures=measures, weights=rel.weights,
            version=rel.version,
        ))
    return catalog_from_arrays(arrays)


def jax_catalog_from_port(port_cat):
    """The reference catalog over the port catalog's (possibly rounded) arrays."""
    from repro.relational.relation import Catalog, Relation

    rels = []
    for name in port_cat.names():
        r = port_cat.get(name)
        rels.append(Relation(
            name=r.name, attrs=r.attrs, codes=dict(r.codes), domains=dict(r.domains),
            measures=dict(r.measures), weights=r.weights, version=r.version,
        ))
    return Catalog(rels)


def leaves_np(field, port: bool):
    if port:
        return [leaf.detach().cpu().numpy() for leaf in tsr.leaves(field)]
    return [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(field)]


def assert_factors_match(jax_factor, port_factor, exact: bool, rtol: float = 1e-5):
    """Equal attrs and fields: bit-identical when ``exact``, else allclose
    with ``rtol`` (float sums in another order)."""
    assert tuple(jax_factor.attrs) == tuple(port_factor.attrs)
    for a, b in zip(leaves_np(jax_factor.field, False), leaves_np(port_factor.field, True)):
        assert a.shape == b.shape
        if b.dtype == np.int64:  # the reference count_i64 is int32
            a = a.astype(np.int64)
        if exact:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=0)
