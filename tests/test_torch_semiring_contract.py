"""The port's semiring_contract wrapper held against the JAX package's
Pallas kernel (interpret mode) at the shapes, dtypes and tolerances of
``tests/test_kernels.py``.

On the CPU the wrapper runs its plain PyTorch version and launches nothing.
``test_torch_cuda.py`` holds the CUDA kernel against that plain version on
the card.  Tolerances are the reference file's: rtol 5e-3 / atol 1e-3 for
the shape sweep (float16 inputs), rtol 1e-4 / atol 1e-5 with the σ mask."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, strategies as st

from repro.kernels.semiring_contract.ops import contract_op as j_contract_op
from repro_torch.kernels.semiring_contract import ops

SHAPES = [(8, 8, 8), (64, 64, 64), (100, 70, 130), (256, 128, 200), (1, 300, 5)]


@pytest.mark.parametrize("g,b,a", SHAPES)
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_contract_op_matches_pallas_kernel(g, b, a, dtype):
    rng = np.random.default_rng(g * 1000 + b)
    m = rng.random((g, b)).astype(dtype)
    r = rng.random((b, a)).astype(dtype)
    want = j_contract_op(jnp.asarray(m), jnp.asarray(r), interpret=True)
    got = ops.contract_op(torch.as_tensor(m), torch.as_tensor(r))
    assert got.dtype == torch.float32 and tuple(got.shape) == (g, a)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-3, atol=1e-3)


@settings(max_examples=4, deadline=None)
@given(seed=st.integers(0, 999), g=st.integers(1, 80), b=st.integers(1, 80),
       a=st.integers(1, 80))
def test_contract_op_fused_mask_matches_pallas_kernel(seed, g, b, a):
    rng = np.random.default_rng(seed)
    m = rng.random((g, b)).astype(np.float32)
    r = rng.random((b, a)).astype(np.float32)
    mask = (rng.random(b) > 0.5).astype(np.float32)
    want = j_contract_op(jnp.asarray(m), jnp.asarray(r), jnp.asarray(mask), interpret=True)
    got = ops.contract_op(torch.as_tensor(m), torch.as_tensor(r), torch.as_tensor(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_contract_op_integer_data_is_exact_and_cpu_launches_nothing():
    """Integer-valued float32 data: every summation order gives the same bits."""
    rng = np.random.default_rng(3)
    m = rng.integers(-20, 21, (37, 1000)).astype(np.float32)
    r = rng.integers(-20, 21, (1000, 3)).astype(np.float32)
    mask = rng.random(1000) > 0.3
    ops.reset_launches()
    got = ops.contract_op(torch.as_tensor(m), torch.as_tensor(r), torch.as_tensor(mask))
    assert ops.LAUNCHES == {"semiring_contract": 0}
    want = (m.astype(np.int64) * mask) @ r.astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
