"""Wrapper of the tropical_contract kernel: the call the dense plans make.

Given CPU tensors it computes the plain PyTorch version (``ref.py``); given
CUDA tensors it checks them, takes the cached launch geometry
(:func:`repro_torch.kernels.launch.contract_geometry`), allocates the
output with ``new_empty`` (the kernel writes every output element, starting
from the ⊕-identity), takes the kernel's workspace and tickets, kept per
stream, where the geometry splits B, launches the hand-written kernel on
the current stream and counts the launch in :data:`LAUNCHES`.  M and R may
be any views with one unit-stride axis each; no copy is made.  There is no
fallback: a CUDA input the kernel does not take, a failed build or a
refused launch raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import launch as _launch

from . import kernel
from .ref import tropical_contract_ref

# kernel launches since the last reset_launches()
LAUNCHES = {"tropical_contract": 0}

_DTYPES = (torch.float32,)


def reset_launches() -> None:
    LAUNCHES["tropical_contract"] = 0


def contract_op(m: torch.Tensor, r: torch.Tensor, is_min: bool = True) -> torch.Tensor:
    """``C[g, a] = min_b (M[g, b] + R[b, a])`` (or max): (G, B) × (B, A)
    float32 in, (G, A) float32 out."""
    if m.device.type == "cpu":
        return tropical_contract_ref(m, r, is_min)
    geom = _launch.contract_args(m, r, _DTYPES)
    out = m.new_empty((m.shape[0], r.shape[1]), dtype=torch.float32)
    scratch = kernel.KERNEL.scratch(m.device, geom) if geom.ws else (None, None)
    kernel.launch(m, r, out, scratch, geom, is_min)
    LAUNCHES["tropical_contract"] += 1
    return out
