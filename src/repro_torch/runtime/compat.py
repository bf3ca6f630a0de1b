"""The reference's compat surface on PyTorch: mesh descriptions and FLOP counts.

- ``make_mesh`` describes a named-axes device mesh (axis names and sizes).
  It needs no devices and allocates nothing: the sharding rules read only
  ``shape`` and ``axis_names``, and on one card a placement moves nothing.
- ``cost_analysis`` and ``compiled_flops`` count the operations of a call.
  The reference reads them from an XLA ``Compiled``, which has no PyTorch
  counterpart, so these run the callable under
  ``torch.utils.flop_counter.FlopCounterMode``.  The count covers matrix
  products only (``mm``, ``addmm``, ``bmm``, ``baddbmm``, convolutions,
  attention, and ``mv`` and ``dot`` added here, 2 per multiply-add); XLA's
  ``flops`` also counts elementwise work.  The callable may run on ``meta``
  tensors, which allocate nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import torch
from torch.utils.flop_counter import FlopCounterMode


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A named-axes device mesh, described: ``shape`` maps each axis name to
    its size, in ``axis_names`` order."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    explicit: bool = False

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str], *,
              explicit: bool = False) -> Mesh:
    """The mesh of ``axis_shapes`` over ``axis_names`` (``explicit`` records
    the reference's choice of Explicit over Auto axis types)."""
    axis_shapes, axis_names = tuple(int(s) for s in axis_shapes), tuple(axis_names)
    if len(axis_shapes) != len(axis_names) or len(set(axis_names)) != len(axis_names):
        raise ValueError(f"axis sizes {axis_shapes} and names {axis_names} do not pair up")
    if any(s < 1 for s in axis_shapes):
        raise ValueError(f"axis sizes must be positive, got {axis_shapes}")
    return Mesh(axis_names, axis_shapes, explicit)


def _mv_flop(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    m, n = a_shape
    return 2 * m * n


def _dot_flop(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * a_shape[0]


# FlopCounterMode's own table counts matrix-vector and vector products as 0
_EXTRA_FLOPS = {torch.ops.aten.mv: _mv_flop, torch.ops.aten.dot: _dot_flop}


def cost_analysis(fn, *args, **kwargs) -> Mapping[str, float]:
    """``{"flops": ...}`` of ``fn(*args, **kwargs)``: its matrix-product
    operations, 2 per multiply-add (see the module docstring)."""
    with FlopCounterMode(display=False, custom_mapping=_EXTRA_FLOPS) as counter:
        fn(*args, **kwargs)
    return {"flops": float(counter.get_total_flops())}


def compiled_flops(fn, *args, **kwargs) -> float:
    return float(cost_analysis(fn, *args, **kwargs).get("flops", 0.0))
