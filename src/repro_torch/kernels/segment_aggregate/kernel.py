"""Build, load and launch the Hopper segment-aggregate kernels.

Two hand-written CUDA C++ kernels (``csrc/``) replace the two Pallas TPU
kernels of ``src/repro/kernels/segment_aggregate/kernel.py``:

=========================  =================================================
``segment_aggregate``      kernel.py:62 ``segment_aggregate`` (body ``_kernel``)
``level_segment_aggregate`` kernel.py:125 ``level_segment_aggregate``
                           (body ``_level_kernel``)
=========================  =================================================

Both are built by :mod:`repro_torch.kernels.build` (``nvcc`` for
``sm_90a``, plain C interface, ``ctypes``) and bound by
:class:`repro_torch.kernels.launch.Kernel` on first use.  Both take a table
of messages (``launch.SegTable``), each partitioned by
``launch.segment_geometry`` from its own shape alone.  Nothing here runs
at import time: the CPU tests import this module on a machine with neither
``nvcc`` nor a card.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import launch as _launch
from repro_torch.kernels.launch import Kernel

OP_CODES = {"sum": 0, "min": 1, "max": 2}

_P = ctypes.c_void_p
# (table, recipes, op, workspace); the stream comes last
_ARGTYPES = [_P, _P, ctypes.c_int, _P]
KERNELS = {name: Kernel(name, _ARGTYPES)
           for name in ("segment_aggregate", "level_segment_aggregate")}


def _seg_recipe(recipe) -> _launch.SegRecipe:
    """The C struct of an ``ops.Recipe``: its tensors' addresses and sizes."""
    r = _launch.SegRecipe(lift=recipe.lift.data_ptr(), msgs=len(recipe.messages),
                          preds=len(recipe.preds), add=int(recipe.add))
    for k, (index, table, lanes) in enumerate(recipe.messages):
        r.idx[k] = None if index is None else index.data_ptr()
        r.tab[k], r.lane_col[k], r.cols[k] = table.data_ptr(), lanes.data_ptr(), table.shape[1]
    for p, (codes, mask) in enumerate(recipe.preds):
        r.codes[p], r.mask[p] = codes.data_ptr(), mask.data_ptr()
    return r


def launch(name: str, members: list, op: str, gather_rows: list | None = None) -> int:
    """Launch kernel ``name`` over ``members`` on the current stream of their
    device; return the launches made (one per ``launch.SEG_MAX_MEMBERS``
    members).

    Each member is ``(codes, values, out, geom, order, ordered)``:
    contiguous CUDA tensors of one device, ``codes`` (N,) int32, ``values``
    (N, V) float32 or an ``ops.Recipe`` of V lanes (a fused member: the
    kernel computes its values), ``out`` (G, V) float32 holding the
    ⊕-identity, ``geom`` its ``launch.segment_geometry(N, G, V)``, ``order`` its row order
    (``ops.row_order``) when that geometry is the sort regime, else None,
    and ``ordered`` whether ``values`` arrive in that order (sort only: the
    kernel then reads them in place).  The caller checks all of that.
    ``gather_rows`` (traced calls: each member's, from its
    ``kernels.segment`` record) puts the most of a launch's members on its
    ``kernels.launch`` span.  Raises if a launch is refused.
    """
    packed, recipes, rows = [], [], []
    for j, (codes, values, out, geom, order, ordered) in enumerate(members):
        n, (g, v) = codes.shape[0], out.shape
        fused = not isinstance(values, torch.Tensor)
        values_ptr = None if fused else values.data_ptr()
        if geom.regime == _launch.SEG_SORT:
            geom = _launch.sort_launch(geom, v, order.n_items, order.n_slots, order.n_splits)
            if not geom.blocks:  # no row has a code in [0, G): out keeps the identity
                continue
            packed.append((geom, None if ordered else order.perm.data_ptr(), values_ptr,
                           out.data_ptr(), order.table.data_ptr(), n, g, v, order.n_items,
                           order.n_splits, ordered))
        else:
            packed.append((geom, codes.data_ptr(), values_ptr, out.data_ptr(), None,
                           n, g, v, 0, 0, False))
        recipes.append(_seg_recipe(values) if fused else None)
        if gather_rows is not None:
            rows.append(gather_rows[j])
    if not packed:
        return 0
    device = members[0][0].device
    kern = KERNELS[name]
    launches = _launch.pack_members(packed, recipes)
    per = _launch.SEG_MAX_MEMBERS
    for k, one in enumerate(launches):
        ws = kern.scratch(device, one)[0] if one.ws else None
        fused = None if one.recipes is None else ctypes.addressof(one.recipes)
        span = {} if gather_rows is None else {"gather_rows": max(rows[k * per:(k + 1) * per])}
        kern(device, ctypes.addressof(one.table), fused, OP_CODES[op], ws,
             members=one.table.count, **span)
    return len(launches)
