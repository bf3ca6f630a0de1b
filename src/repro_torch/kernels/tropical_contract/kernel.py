"""Launch the Hopper tropical_contract kernel.

The hand-written CUDA C++ kernel ``csrc/tropical_contract.cu`` (body in
``kernels/csrc/contract.cuh``) replaces the Pallas TPU kernel
``src/repro/kernels/tropical_contract/kernel.py:37`` ``tropical_contract``
(body ``_kernel``).  It is built by :mod:`repro_torch.kernels.build` and
bound by :class:`launch.Kernel` on first use; nothing here runs at import
time.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import launch as _launch

_P = ctypes.c_void_p
KERNEL = _launch.Kernel("tropical_contract", [_P, _P, _P, _P, _P, _P, ctypes.c_int])


def launch(m: torch.Tensor, r: torch.Tensor, out: torch.Tensor, scratch: tuple,
           geom: _launch.Geometry, is_min: bool) -> None:
    """Launch on the current stream of ``m``'s device.

    ``m`` (G, B) and ``r`` (B, A) float32 views, ``out`` (G, A) float32
    contiguous, ``scratch`` the pointers of the geometry's workspace and
    tickets, or (None, None): checked by the caller.  Raises if the launch
    is refused.
    """
    KERNEL(m.device, m.data_ptr(), r.data_ptr(), out.data_ptr(), *scratch,
           geom.address, int(is_min))
