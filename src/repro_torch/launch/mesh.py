"""Production mesh descriptions (the reference's ``launch/mesh.py``).

The meshes are descriptions (``runtime.compat.Mesh``): building one touches
no device, so the dry-run can lay out the 256- and 512-device meshes on a
host with one card or none.
"""

from __future__ import annotations

from repro_torch.runtime.compat import Mesh, make_mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_host_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A small mesh over the host's devices (one card: 1 × 1)."""
    return make_mesh((data, model), ("data", "model"))
