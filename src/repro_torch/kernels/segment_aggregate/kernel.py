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
:class:`repro_torch.kernels.launch.Kernel` on first use.  Nothing here runs
at import time: the CPU tests import this module on a machine with neither
``nvcc`` nor a card.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.launch import Kernel

OP_CODES = {"sum": 0, "min": 1, "max": 2}

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int]
KERNELS = {name: Kernel(name, _ARGTYPES)
           for name in ("segment_aggregate", "level_segment_aggregate")}


def launch(name: str, codes: torch.Tensor, values: torch.Tensor, out: torch.Tensor,
           op: str) -> None:
    """Launch kernel ``name`` on the current stream of ``codes``' device.

    ``codes`` (N,) int32, ``values`` (N, V) float32 and ``out`` (G, V)
    float32 are contiguous CUDA tensors; ``out`` holds the ⊕-identity.  The
    caller checks all of that.  Raises if the launch is refused.
    """
    n, v = values.shape
    KERNELS[name](codes.device, codes.data_ptr(), values.data_ptr(), out.data_ptr(),
                  n, v, out.shape[0], OP_CODES[op])
