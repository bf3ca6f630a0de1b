"""Build, load and launch the Hopper segment-aggregate kernels.

Two hand-written CUDA C++ kernels (``csrc/``) replace the two Pallas TPU
kernels of ``src/repro/kernels/segment_aggregate/kernel.py``:

=========================  =================================================
``segment_aggregate``      kernel.py:62 ``segment_aggregate`` (body ``_kernel``)
``level_segment_aggregate`` kernel.py:125 ``level_segment_aggregate``
                           (body ``_level_kernel``)
=========================  =================================================

Both are built by :mod:`repro_torch.kernels.build` (``nvcc`` for
``sm_90a``, plain C interface, ``ctypes``) on first use.  Nothing here runs
at import time: the CPU tests import this module on a machine with neither
``nvcc`` nor a card.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

OP_CODES = {"sum": 0, "min": 1, "max": 2}


def _load(name: str) -> ctypes.CDLL:
    lib = build.load(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def launch(name: str, codes: torch.Tensor, values: torch.Tensor, out: torch.Tensor,
           op: str) -> None:
    """Launch kernel ``name`` on the current stream of ``codes``' device.

    ``codes`` (N,) int32, ``values`` (N, V) float32 and ``out`` (G, V)
    float32 are contiguous CUDA tensors; ``out`` holds the ⊕-identity.  The
    caller checks all of that.  Raises if the launch is refused.
    """
    lib = _load(name)
    n, v = values.shape
    g = out.shape[0]
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        rc = getattr(lib, name)(
            codes.data_ptr(), values.data_ptr(), out.data_ptr(),
            n, v, g, OP_CODES[op], stream,
        )
    build.check(lib, name, rc)
