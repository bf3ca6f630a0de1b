"""The port's domain-sharded chain demo, held against the JAX package.

``tests/test_distributed.py`` runs the reference's ``shard_map`` chain
calibration on 8 forced XLA host devices in a subprocess; the port's runs
in process on a virtual CPU mesh of 8 shards (one process drives every
shard).  Messages must equal the reference's single-device
``calibrate_chain_reference`` on the same numpy factors at the reference
test's tolerances, and one pass must make r − 1 reduce-scatters and r − 1
all-gathers (+1 for the absorption), counted through wrappers of the
port's collectives.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as jdist
from repro_torch.core import distributed as dist

R, D = 6, 64


def _factors(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.random((D, D)).astype(np.float32) for _ in range(R)], rng


@pytest.fixture
def collectives(monkeypatch):
    """Counts of the port's reduce-scatters and all-gathers."""
    counts = {"rs": 0, "ag": 0}
    real_rs, real_ag = dist.reduce_scatter, dist.all_gather

    def rs(partials, mesh):
        counts["rs"] += 1
        return real_rs(partials, mesh)

    def ag(blocks, mesh):
        counts["ag"] += 1
        return real_ag(blocks, mesh)

    monkeypatch.setattr(dist, "reduce_scatter", rs)
    monkeypatch.setattr(dist, "all_gather", ag)
    return counts


@pytest.mark.parametrize("nshards", [2, 8])
def test_sharded_chain_calibration_matches_reference(collectives, nshards):
    mesh = dist.ShardMesh.virtual(nshards, "cpu", axis="data")
    factors_np, _ = _factors()
    fwd_ref, bwd_ref = jdist.calibrate_chain_reference([jnp.asarray(f) for f in factors_np])
    fn = dist.make_chain_calibrate(mesh, "data", R, D)
    fwd, bwd, total = fn(dist.place_chain_factors(mesh, "data", factors_np))
    for i in range(R - 1):
        np.testing.assert_allclose(fwd[i].numpy(), np.asarray(fwd_ref[i]), rtol=1e-4)
        np.testing.assert_allclose(bwd[i].numpy(), np.asarray(bwd_ref[i]), rtol=1e-4)
    v = jnp.ones(D)
    for f in factors_np:
        v = v @ jnp.asarray(f)
    np.testing.assert_allclose(float(total), float(v.sum()), rtol=1e-3)
    # calibration invariant: absorptions agree across bags (port's oracle)
    tf = [torch.from_numpy(f) for f in factors_np]
    absb = dist.chain_absorptions_reference(tf, *dist.calibrate_chain_reference(tf))
    totals = [float(a.sum()) for a in absb]
    assert max(totals) - min(totals) < 1e-3 * max(totals)
    # collective schedule: r-1 reduce-scatters and r-1 all-gathers (+1 in absorption)
    assert collectives == {"rs": R - 1, "ag": R}


def test_sharded_chain_calibrate_multi_matches_per_measure_passes(collectives):
    """Fusing V measures into one pass equals V single-measure chains of the
    reference's oracle, message for message, with one pass's collectives."""
    mesh = dist.ShardMesh.virtual(8, "cpu", axis="data")
    factors_np, rng = _factors()
    V = 3
    leaf_np = rng.random((D, V)).astype(np.float32)
    fnm = dist.make_chain_calibrate_multi(mesh, "data", R, D, V)
    leaf = dist.place_rows(torch.from_numpy(leaf_np), mesh, "data")
    fwd_m, bwd_m, totals = fnm(dist.place_chain_factors(mesh, "data", factors_np), leaf)
    assert collectives == {"rs": R - 1, "ag": R - 1}
    fjs = [jnp.asarray(f) for f in factors_np]
    _, bwd_ref = jdist.calibrate_chain_reference(fjs)
    for j in range(V):
        v = jnp.asarray(leaf_np[:, j])
        for i, f in enumerate(fjs[:-1]):
            v = v @ f
            np.testing.assert_allclose(fwd_m[i][:, j].numpy(), np.asarray(v), rtol=1e-4)
        np.testing.assert_allclose(float(totals[j]), float((v @ fjs[-1]).sum()), rtol=1e-3)
        for i in range(R - 1):
            np.testing.assert_allclose(bwd_m[i][:, j].numpy(), np.asarray(bwd_ref[i]), rtol=1e-4)


def test_chain_specs_allocate_nothing():
    mesh = dist.ShardMesh.virtual(8, "cpu", axis="data")
    factors = dist.chain_factor_specs(mesh, "data", R, D)
    mf, leaf = dist.chain_multi_specs(mesh, "data", R, D, 3)
    assert [tuple(f.shape) for f in factors + mf] == [(D, D)] * (2 * R)
    assert tuple(leaf.shape) == (D, 3)
    assert all(t.device.type == "meta" for t in factors + mf + [leaf])
    with pytest.raises(ValueError, match="not divisible"):
        dist.make_chain_calibrate(dist.ShardMesh.virtual(3, "cpu", axis="data"), "data", R, D)
