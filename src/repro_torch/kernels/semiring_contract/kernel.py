"""Launch the Hopper semiring_contract kernel.

The hand-written CUDA C++ kernel ``csrc/semiring_contract.cu`` (body in
``kernels/csrc/contract.cuh``) replaces the Pallas TPU kernel
``src/repro/kernels/semiring_contract/kernel.py:36`` ``semiring_contract``
(bodies ``_kernel`` and ``_masked_none_kernel``).  It is built by
:mod:`repro_torch.kernels.build` and bound by :class:`launch.Kernel` on
first use; nothing here runs at import time.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import launch as _launch

_P = ctypes.c_void_p
KERNEL = _launch.Kernel("semiring_contract", [_P, _P, _P, _P, _P, _P, _P])


def launch(m: torch.Tensor, r: torch.Tensor, mask: torch.Tensor | None, out: torch.Tensor,
           scratch: tuple, geom: _launch.Geometry) -> None:
    """Launch on the current stream of ``m``'s device.

    ``m`` (G, B) and ``r`` (B, A) views of one float dtype, ``mask`` (B,)
    float32 contiguous or None, ``out`` (G, A) float32 contiguous,
    ``scratch`` the pointers of the geometry's workspace and tickets, or
    (None, None): checked by the caller.  Raises if the launch is refused.
    """
    KERNEL(m.device, m.data_ptr(), r.data_ptr(), None if mask is None else mask.data_ptr(),
           out.data_ptr(), *scratch, geom.address)
