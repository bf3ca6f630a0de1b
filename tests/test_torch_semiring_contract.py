"""The port's semiring_contract wrapper held against the JAX package's
Pallas kernel (interpret mode) at the shapes, dtypes and tolerances of
``tests/test_kernels.py``.

On the CPU the wrapper runs its plain PyTorch version and launches nothing;
the launch geometry the CUDA kernel would get (``kernels/launch.py``) is
checked here as well.
``test_torch_cuda.py`` holds the CUDA kernel against that plain version on
the card.  Tolerances are the reference file's: rtol 5e-3 / atol 1e-3 for
the shape sweep (float16 inputs), rtol 1e-4 / atol 1e-5 with the σ mask."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, strategies as st

from repro.kernels.semiring_contract.ops import contract as j_contract
from repro.kernels.semiring_contract.ops import contract_op as j_contract_op
from repro_torch.kernels import build, launch
from repro_torch.kernels.semiring_contract import ops
from repro_torch.kernels.semiring_contract.ref import semiring_contract_ref

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


# the launch geometry of csrc/contract.cuh, computed in Python
# (repro_torch.kernels.launch): each regime and its boundaries
GEOMETRY_CASES = [
    ((100_000, 16, 1), "tall"), ((100_000, 16, 8), "tall"), ((1, 1, 1), "tall"),
    ((100_000, 1, 8), "tall"), ((7, 64, 32), "tall"), ((7, 65, 32), "wide"),
    ((7, 64, 33), "wide"), ((16, 100_000, 8), "wide"), ((16, 100_000, 1), "wide"),
    ((1, 50_000, 8), "wide"), ((32, 1000, 32), "wide"), ((1024, 3000, 1), "wide"),
    ((33, 100_003, 31), "wide"), ((1, 65, 1), "wide"), ((1025, 3000, 1), "tiled"),
    ((192, 100_000, 8), "tiled"), ((64, 64, 64), "tiled"), ((100, 70, 130), "tiled"),
    ((4000, 100, 300), "tiled"),
]


def _chunks(f: dict) -> list[tuple[int, int]]:
    """The [begin, end) ranges of B the kernel's blocks take: one per block
    along grid_x (wide) or grid_z (tiled); the tall regime does not split."""
    if f["regime"] == launch.TALL:
        return [(0, f["b"])]
    n = f["grid_x"] if f["regime"] == launch.WIDE else f["grid_z"]
    return [(i * f["chunk"], min(f["b"], (i + 1) * f["chunk"])) for i in range(n)]


@pytest.mark.parametrize("shape,regime", GEOMETRY_CASES, ids=[str(s) for s, _ in GEOMETRY_CASES])
def test_contract_geometry_splits_the_contracted_axis_exactly_once(shape, regime):
    g, b, a = shape
    for m_strides in ((b, 1), (1, g)):
        for r_strides in ((a, 1), (1, b)):
            geo = launch.contract_geometry(g, b, a, m_strides, r_strides, 4, True, True)
            f = geo.fields
            assert geo.regime == regime
            assert list(geo.packed) == [f[k] for k in launch.GEOM_FIELDS]
            covered = np.zeros(b, np.int64)
            for lo, hi in _chunks(f):
                assert lo < hi
                covered[lo:hi] += 1
            assert (covered == 1).all()
            blocks = len(_chunks(f))
            assert 0 < f["threads"] <= launch.THREADS and f["smem"] <= 48 * 1024
            if regime == "tall":
                assert blocks == 1 and f["grid_x"] * (f["threads"] // f["p1"]) >= g
                assert f["p0"] * f["p1"] >= a  # output groups cover A
                assert geo.ws == geo.tickets == 0
            elif regime == "wide":
                # up to 8 blocks sum as one cluster; more merge through the
                # workspace, one partial per block
                assert blocks == f["grid_x"] <= launch.WIDE_BLOCKS
                assert f["cluster"] == (blocks if blocks <= launch.WIDE_CLUSTER else 1)
                assert geo.ws == (blocks * g * a if f["cluster"] == 1 and blocks > 1 else 0)
                assert geo.tickets == (1 if geo.ws else 0)  # one for the grid
                tiles, tpad = f["p0"], f["p1"]  # 4x4 tiles, padded to a power of two
                assert tiles <= tpad < 2 * tiles and tpad & (tpad - 1) == 0
                assert tpad <= launch.THREADS and tiles * 16 >= g * a
            else:
                assert blocks == f["grid_z"]
                assert geo.ws == (blocks * g * a if blocks > 1 else 0)
                # one ticket per output tile
                assert geo.tickets == (f["grid_x"] * f["grid_y"] if blocks > 1 else 0)
                assert f["grid_x"] * f["p0"] >= g and f["grid_y"] * f["p1"] >= a


def test_contract_geometry_vector_loads_need_alignment():
    """Staged regimes (tall, tiled) take 16-byte loads along the unit-stride
    axis only where the base and every row start are 16-byte aligned; the
    wide regime takes 4-wide loads of four neighbouring rows of M (columns
    of R) only where those are contiguous and aligned."""
    geo = launch.contract_geometry
    assert geo(100, 16, 8, (16, 1), (8, 1), 4, True, True).fields["m_vec"] == 1
    assert geo(100, 16, 8, (16, 1), (8, 1), 4, False, True).fields["m_vec"] == 0
    assert geo(100, 18, 8, (18, 1), (8, 1), 4, True, True).fields["m_vec"] == 0
    assert geo(100, 18, 8, (18, 1), (8, 1), 2, True, True).fields["m_vec"] == 0
    assert geo(100, 16, 6, (16, 1), (6, 1), 4, True, True).fields["r_vec"] == 0
    assert geo(100, 16, 6, (16, 1), (6, 1), 2, True, True).fields["m_vec"] == 1
    assert geo(100, 16, 8, (16, 1), (8, 1), 2, True, True).fields["half"] == 1
    # wide: M contiguous along G (a transposed view), R along A
    assert geo(16, 1000, 8, (1, 16), (8, 1), 4, True, True).fields["m_vec"] == 1
    assert geo(16, 1000, 8, (1, 16), (8, 1), 4, True, True).fields["r_vec"] == 1
    assert geo(16, 1000, 8, (1000, 1), (8, 1), 4, True, True).fields["m_vec"] == 0
    assert geo(14, 1000, 8, (1, 14), (8, 1), 4, True, True).fields["m_vec"] == 0
    assert geo(16, 1000, 8, (1, 18), (8, 1), 4, True, True).fields["m_vec"] == 0
    assert geo(16, 1000, 6, (1, 16), (6, 1), 4, True, True).fields["r_vec"] == 0
    assert geo(16, 1000, 8, (1, 16), (8, 1), 4, False, False).fields["r_vec"] == 0


def test_contract_geometry_refuses_views_without_a_unit_stride_axis():
    with pytest.raises(ValueError, match="unit-stride"):
        launch.contract_geometry(4, 6, 2, (12, 2), (2, 1), 4, True, True)
    with pytest.raises(ValueError, match="unit-stride"):
        launch.contract_geometry(4, 6, 2, (6, 1), (4, 2), 4, True, True)
    with pytest.raises(ValueError, match="out of range"):
        launch.contract_geometry(4, 0, 2, (1, 4), (2, 1), 4, True, True)
    m = torch.zeros(4, 12)[:, ::2]
    with pytest.raises(ValueError, match="unit-stride"):
        launch.contract_args(m, torch.zeros(6, 2), (torch.float32,))
    with pytest.raises(TypeError):
        launch.contract_args(torch.zeros(4, 6, dtype=torch.float64), torch.zeros(6, 2),
                             (torch.float32,))


@pytest.mark.parametrize("shape,strides,want", [
    ((4, 3), (3, 1), (3, 1)), ((4, 3), (1, 4), (1, 4)), ((4, 3), (6, 2), None),
    ((100, 1), (1, 1), (1, 100)), ((100, 1), (5, 5), (5, 1)), ((1, 5), (1, 1), (5, 1)),
    ((1, 5), (9, 3), (1, 3)), ((1, 1), (7, 3), (1, 1)),
])
def test_unit_strides_of_a_view(shape, strides, want):
    assert launch.unit_strides(shape, strides) == want


def _views(m, r):
    return {
        "transposed": (m.T.contiguous().T, r.T.contiguous().T),
        "sliced": (m[1:, 2:], r[2:, 1:]),
        "transposed_sliced": (m.T.contiguous().T[:, 2:], r[2:]),
    }


@pytest.mark.parametrize("view", ["transposed", "sliced", "transposed_sliced"])
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "mask"])
def test_contract_op_on_views_matches_pallas_kernel(view, masked):
    """The dense plan hands over strided views; on integer-valued data the
    wrapper's answer equals the plain version and the Pallas kernel exactly."""
    rng = np.random.default_rng(17)
    m = torch.as_tensor(rng.integers(-20, 21, (37, 301)).astype(np.float32))
    r = torch.as_tensor(rng.integers(-20, 21, (301, 7)).astype(np.float32))
    tm, tr = _views(m, r)[view]
    mask = torch.as_tensor((rng.random(tm.shape[1]) > 0.4).astype(np.float32)) if masked else None
    assert not tm.is_contiguous()
    got = ops.contract_op(tm, tr, mask)
    want = j_contract_op(jnp.asarray(tm.numpy()), jnp.asarray(tr.numpy()),
                         None if mask is None else jnp.asarray(mask.numpy()), interpret=True)
    assert torch.equal(got, semiring_contract_ref(tm, tr, mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_library_name_hashes_the_shared_contract_header(tmp_path, monkeypatch):
    """Both contract kernels include ``kernels/csrc/contract.cuh``: an edit
    there must rename (and so rebuild) their libraries."""
    shared = tmp_path / "csrc"
    shared.mkdir()
    header = (build.SHARED_CSRC / "contract.cuh").read_text()
    (shared / "contract.cuh").write_text(header)
    monkeypatch.setattr(build, "SHARED_CSRC", shared)
    names = [build.library_path(p, s, sym) for p, s, sym in build.KERNELS
             if p.endswith("_contract")]
    (shared / "contract.cuh").write_text(header + "\n// edited\n")
    edited = [build.library_path(p, s, sym) for p, s, sym in build.KERNELS
              if p.endswith("_contract")]
    assert len(names) == 2 and all(a != b for a, b in zip(names, edited))


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "mask"])
def test_contract_matches_reference_contract(masked):
    """``contract``, the reference's convenience call, on integer-valued
    data (exact): the plain version here, as the reference's off the TPU."""
    rng = np.random.default_rng(7)
    m = rng.integers(-20, 21, (30, 200)).astype(np.float32)
    r = rng.integers(-20, 21, (200, 4)).astype(np.float32)
    mask = (rng.random(200) > 0.5).astype(np.float32) if masked else None
    want = j_contract(jnp.asarray(m), jnp.asarray(r), None if mask is None else jnp.asarray(mask))
    got = ops.contract(torch.as_tensor(m), torch.as_tensor(r),
                       None if mask is None else torch.as_tensor(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
