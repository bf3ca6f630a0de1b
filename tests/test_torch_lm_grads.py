"""Whole-model gradients of the port against the reference's: the training
loss of every arch's ``smoke_config`` differentiated by ``torch.autograd``
against ``jax.grad(repro.models.lm.forward_train)``, float32 on both sides,
every parameter leaf random through ``convert.py`` (``tests/_torch_lm.py``).

Gradients are compared, not parameters after an optimizer step: AdamW's
first step moves each weight by about lr·sign(g), so a gradient element
near zero whose sign differs between the packages (or between two BLAS
builds) would show as a 2·lr difference that says nothing about either.

Tolerance per leaf: |port − ref| ≤ 1e-3·|ref| + 5e-4·max|ref of the leaf|.
The float32 CPU runs differ by at most 2.4e-5 of a leaf's largest element
(zamba2's ``dt_bias``; 0.8-3.4e-6 for the other nine), from summation order.
A wrong mask, a dropped lse cotangent or a missing term moves a gradient
by a sizeable part of its leaf's scale.

This file holds the JAX side's ten ``jax.grad`` compiles (about 25 s on one
core), so that they sit on a worker of their own under ``--dist loadfile``.
"""

import jax
import numpy as np
import pytest

from _torch_lm import both_params, make_batch
from repro.configs import get_config as jget_config
from repro.configs.base import smoke_config as jsmoke_config
from repro.models import lm as jlm
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.configs.base import smoke_config
from repro_torch.runtime import step

RTOL, LEAF_ATOL = 1e-3, 5e-4


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], prefix + (k,)))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_forward_train_grads_match_reference(arch):
    jc, tc = jsmoke_config(jget_config(arch)), smoke_config(get_config(arch))
    _, jp, tp = both_params(jc, seed=1)
    batch = make_batch(jc, 2, 32, seed=2, labels=True)

    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.forward_train(p, jc, b), has_aux=True))(jp, batch)

    loss, _, paths, grads = step.loss_and_grads(tc, tp, batch)

    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = _flat(jg)
    assert set(want) == set(paths)
    for path, g in zip(paths, grads):
        ref = np.asarray(want[path])
        assert g.shape == ref.shape, path
        np.testing.assert_allclose(g.numpy(), ref, rtol=RTOL,
                                   atol=LEAF_ATOL * float(np.abs(ref).max()),
                                   err_msg=f"{arch} d{'/'.join(path)}")
        assert np.abs(ref).max() > 0 or not g.any(), path
