"""The port's tropical_contract wrapper held against the JAX package's
Pallas kernel (interpret mode) at the shapes of ``tests/test_kernels.py``.

On the CPU the wrapper runs its plain PyTorch version and launches nothing.
min and max of float32 sums are exact in any order, so the results must be
bit-identical (the reference file states rtol 1e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.tropical_contract.ops import contract as j_contract
from repro.kernels.tropical_contract.ops import contract_op as j_contract_op
from repro_torch.kernels import launch
from repro_torch.kernels.tropical_contract import ops
from repro_torch.kernels.tropical_contract.ref import tropical_contract_ref

SHAPES = [(8, 8, 8), (64, 64, 64), (100, 70, 130), (256, 128, 200)]


@pytest.mark.parametrize("g,b,a", SHAPES)
@pytest.mark.parametrize("is_min", [True, False])
def test_contract_op_matches_pallas_kernel(g, b, a, is_min):
    rng = np.random.default_rng(a)
    m = rng.standard_normal((g, b)).astype(np.float32)
    r = rng.standard_normal((b, a)).astype(np.float32)
    want = j_contract_op(jnp.asarray(m), jnp.asarray(r), is_min=is_min, interpret=True)
    got = ops.contract_op(torch.as_tensor(m), torch.as_tensor(r), is_min=is_min)
    assert got.dtype == torch.float32 and tuple(got.shape) == (g, a)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("is_min", [True, False])
def test_absent_tuples_stay_the_identity_without_nan(is_min):
    """Tropical dense factors hold the ⊕-identity (+inf for min, -inf for
    max) for absent tuples; both operands carry the same sign."""
    ident = np.inf if is_min else -np.inf
    rng = np.random.default_rng(5)
    m = rng.integers(-9, 10, (6, 40)).astype(np.float32)
    r = rng.integers(-9, 10, (40, 3)).astype(np.float32)
    m[rng.random(m.shape) < 0.5] = ident
    r[rng.random(r.shape) < 0.5] = ident
    m[0] = ident  # a row with no tuple at all
    ops.reset_launches()
    got = ops.contract_op(torch.as_tensor(m), torch.as_tensor(r), is_min=is_min)
    assert ops.LAUNCHES == {"tropical_contract": 0}
    want = j_contract_op(jnp.asarray(m), jnp.asarray(r), is_min=is_min, interpret=True)
    assert not torch.isnan(got).any()
    assert (got[0] == ident).all()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("view", ["transposed", "sliced", "transposed_sliced"])
@pytest.mark.parametrize("is_min", [True, False])
def test_contract_op_on_views_matches_pallas_kernel(view, is_min):
    """The dense plan hands over strided views; they read as the same values."""
    rng = np.random.default_rng(23)
    ident = np.inf if is_min else -np.inf
    m = rng.integers(-20, 21, (29, 203)).astype(np.float32)
    m[rng.random(m.shape) < 0.3] = ident
    m, r = torch.as_tensor(m), torch.as_tensor(rng.integers(-20, 21, (203, 5)).astype(np.float32))
    tm, tr = {"transposed": (m.T.contiguous().T, r.T.contiguous().T),
              "sliced": (m[1:, 2:], r[2:, 1:]),
              "transposed_sliced": (m.T.contiguous().T[:, 2:], r[2:])}[view]
    assert not tm.is_contiguous()
    with pytest.raises(ValueError, match="unit-stride"):
        launch.contract_args(m[:, ::2], r[::2], (torch.float32,))
    got = ops.contract_op(tm, tr, is_min=is_min)
    want = j_contract_op(jnp.asarray(tm.numpy()), jnp.asarray(tr.numpy()), is_min=is_min,
                         interpret=True)
    assert torch.equal(got, tropical_contract_ref(tm, tr, is_min))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("is_min", [True, False])
def test_contract_matches_reference_contract(is_min, use_kernel):
    """``contract``: ``use_kernel`` picks the wrapper (the plain version on
    the CPU), ``use_kernel=False`` the plain version; both equal the
    reference's ``contract`` with the same choice (its kernel in interpret
    mode)."""
    rng = np.random.default_rng(9)
    m = rng.standard_normal((20, 33)).astype(np.float32)
    r = rng.standard_normal((33, 5)).astype(np.float32)
    want = j_contract(jnp.asarray(m), jnp.asarray(r), is_min=is_min, use_kernel=use_kernel)
    got = ops.contract(torch.as_tensor(m), torch.as_tensor(r), is_min=is_min,
                       use_kernel=use_kernel)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
