"""Shared helpers of the port's parity tests: hand the JAX package's catalog
to the port as plain numpy columns, and compare factors across packages."""

import jax
import numpy as np
import pytest

from repro_torch.core import semiring as tsr
from repro_torch.relational.relation import catalog_from_arrays


def port_catalog(jax_catalog, round_measures: bool = False, measure_scale: float = 1000.0):
    """The port's catalog built from the reference catalog's numpy columns
    (latest versions).  ``round_measures`` makes every measure integer-valued
    (``round(v / measure_scale)``) in both packages' data, so float sums are
    exact and must match bit for bit."""
    arrays = []
    for name in jax_catalog.names():
        rel = jax_catalog.get(name)
        measures = {k: np.asarray(v) for k, v in (rel.measures or {}).items()}
        if round_measures:
            measures = {k: np.round(v / measure_scale).astype(np.float32)
                        for k, v in measures.items()}
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


def packages():
    """The two packages side by side, as ``(jax, port)`` namespaces of the
    names a parity scenario calls; ``kw`` goes to every engine and Treant
    (the port runs on the CPU)."""
    import types

    import repro.core as jcore
    import repro.relational.relation as jrel
    import repro.relational.stream as jstream
    import repro_torch.core as tcore
    import repro_torch.relational.relation as trel
    import repro_torch.relational.stream as tstream

    def ns(core, rel, stream, kw, port):
        return types.SimpleNamespace(core=core, sr=core.semiring, rel=rel, stream=stream,
                                     kw=kw, port=port)

    return (ns(jcore, jrel, jstream, {}, False),
            ns(tcore, trel, tstream, {"device": "cpu"}, True))


def star_catalogs(n_fact: int = 300, seed: int = 0):
    """The reference tests' star F(a,b)+m ← S(b,c), T(a,d), U(b,e) as
    ``(jax catalog, port catalog)`` over the same arrays; mixed γ domains
    (10/5/9) and integer measures, so f32 sums are bit-stable."""
    rng = np.random.default_rng(seed)
    doms = {"a": 13, "b": 7, "c": 10, "d": 5, "e": 9}

    def rel(name, attrs, n, measures=None):
        codes = {x: rng.integers(0, doms[x], n).astype(np.int32) for x in attrs}
        return dict(name=name, attrs=attrs, codes=codes, domains=doms,
                    measures=measures(n) if measures else {})

    arrays = [
        rel("F", ("a", "b"), n_fact,
            lambda n: {"m": rng.integers(0, 16, n).astype(np.float32)}),
        rel("S", ("b", "c"), 77), rel("T", ("a", "d"), 29), rel("U", ("b", "e"), 41),
    ]
    tcat = catalog_from_arrays(arrays)
    return jax_catalog_from_port(tcat), tcat


def assert_same_results(jax_results, port_results):
    """Pairs of (factor, ExecStats) from each package: equal computed/reused
    counts and bit-identical factors."""
    assert len(jax_results) == len(port_results)
    for (jf, js), (tf, ts) in zip(jax_results, port_results):
        assert (js.messages_computed, js.messages_reused) == (
            ts.messages_computed, ts.messages_reused)
        assert_factors_match(jf, tf, exact=True)


@pytest.fixture(autouse=True)
def same_union_budget(monkeypatch):
    """Each package resolves its union-carry budget from its own cost
    profile when ``REPRO_CALIBRATION_UNION_BUDGET`` is unset: the reference
    from a CPU profile, the port from the H100 profile
    (``repro_torch/kernels/h100_costs.json``).  Parity tests that open
    sessions or calibrate several queries pin both packages to 512 through
    the env, so both fuse the same union queries (import this fixture)."""
    monkeypatch.setenv("REPRO_CALIBRATION_UNION_BUDGET", "512")
