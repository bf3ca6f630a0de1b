"""The port's segment-aggregate wrappers held against the JAX package's
Pallas kernels (interpret mode) at the shapes of ``tests/test_kernels.py``.

On the CPU the wrappers run their plain PyTorch versions.  Inputs are
integer-valued floats, so every op — sum included — must agree exactly.
``test_torch_cuda.py`` holds the CUDA kernels against these plain versions
on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segment_aggregate.ops import aggregate_op as j_aggregate_op
from repro.kernels.segment_aggregate.ops import level_aggregate as j_level_aggregate
from repro_torch.kernels.segment_aggregate import ops

SHAPES = [(64, 8, 1), (1000, 64, 3), (77, 13, 5), (4096, 300, 2)]
LEVEL_SPECS = [
    [(64, 8, 1)],                                  # degenerate: one message
    [(64, 8, 2), (100, 13, 2), (256, 64, 2)],      # equal widths
    [(30, 5, 1), (1000, 64, 4), (77, 13, 3)],      # ragged N/G/V
    [(7, 3, 1), (9, 300, 2)],                      # tiny rows, wide segments
]


def _inputs(n, g, v, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, g, n).astype(np.int32)
    vals = rng.integers(-20, 21, (n, v)).astype(np.float32)
    return codes, vals


@pytest.mark.parametrize("n,g,v", SHAPES)
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_aggregate_op_matches_pallas_kernel(n, g, v, op):
    codes, vals = _inputs(n, g, v, n + g)
    want = j_aggregate_op(jnp.asarray(codes), jnp.asarray(vals), g, op=op, interpret=True)
    got = ops.aggregate_op(torch.as_tensor(codes), torch.as_tensor(vals), g, op=op)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_aggregate_op_1d_squeeze():
    got = ops.aggregate_op(torch.tensor([0, 1, 1, 2], dtype=torch.int32),
                           torch.tensor([1.0, 2.0, 3.0, 4.0]), 3)
    assert got.tolist() == [1.0, 5.0, 4.0]


@pytest.mark.parametrize("specs", LEVEL_SPECS, ids=lambda s: f"{len(s)}msg")
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_level_aggregate_matches_pallas_kernel(specs, op):
    seed = sum(n for n, _, _ in specs)
    items = [_inputs(n, g, v, seed + i) + (g,) for i, (n, g, v) in enumerate(specs)]
    want = j_level_aggregate(
        [(jnp.asarray(c), jnp.asarray(x), g) for c, x, g in items], op=op, interpret=True)
    got = ops.level_aggregate(
        [(torch.as_tensor(c), torch.as_tensor(x), g) for c, x, g in items], op=op)
    assert len(got) == len(items)
    for (c, x, g), w, o in zip(items, want, got):
        assert tuple(o.shape) == (g, x.shape[1])
        np.testing.assert_array_equal(np.asarray(w), o.numpy())


def test_level_aggregate_empty_segments_get_identity():
    items = [(torch.tensor([0, 0], dtype=torch.int32), torch.tensor([[1.0], [2.0]]), 4)]
    assert ops.level_aggregate(items, op="sum")[0][:, 0].tolist() == [3.0, 0, 0, 0]
    assert ops.level_aggregate(items, op="min")[0][1:, 0].tolist() == [np.inf] * 3
    assert ops.level_aggregate(items, op="max")[0][1:, 0].tolist() == [-np.inf] * 3


def test_level_kernel_pad_rows_match_nothing():
    codes = torch.tensor([0, -1, 2, -1, 1], dtype=torch.int32)
    vals = torch.tensor([[1.0], [100.0], [3.0], [-100.0], [2.0]])
    for op, want in (("sum", [1.0, 2.0, 3.0]), ("min", [1.0, 2.0, 3.0])):
        assert ops.level_segment_aggregate(codes, vals, 3, op)[:, 0].tolist() == want
