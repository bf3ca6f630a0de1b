"""Wrapper of the semiring_contract kernel: the call the dense plans make.

Given CPU tensors it computes the plain PyTorch version (``ref.py``); given
CUDA tensors it checks them, takes the cached launch geometry
(:func:`repro_torch.kernels.launch.contract_geometry`), allocates the
output with ``new_empty`` (the kernel writes every output element), takes
the kernel's workspace and tickets, kept per stream, where the geometry
splits B, launches the hand-written kernel on the current stream and counts
the launch in :data:`LAUNCHES`.  M and R may be any views with one
unit-stride axis each; no copy is made.  There is no fallback: a CUDA input
the kernel does not take, a failed build or a refused launch raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import launch as _launch

from . import kernel
from .ref import semiring_contract_ref

# kernel launches since the last reset_launches()
LAUNCHES = {"semiring_contract": 0}

_DTYPES = (torch.float32, torch.float16)


def reset_launches() -> None:
    LAUNCHES["semiring_contract"] = 0


def contract_op(m: torch.Tensor, r: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
    """``C[g, a] = Σ_b M[g, b]·mask[b]·R[b, a]``: (G, B) × (B, A) float32 or
    float16, optional (B,) σ mask on the contracted axis, (G, A) float32 out."""
    if m.device.type == "cpu":
        return semiring_contract_ref(m, r, mask)
    geom = _launch.contract_args(m, r, _DTYPES)
    if mask is not None:
        if mask.device != m.device or mask.shape != (m.shape[1],):
            raise ValueError(f"mask must be ({m.shape[1]},) on {m.device}, got "
                             f"{tuple(mask.shape)} on {mask.device}")
        mask = mask.to(torch.float32).contiguous()
    out = m.new_empty((m.shape[0], r.shape[1]), dtype=torch.float32)
    scratch = kernel.KERNEL.scratch(m.device, geom) if geom.ws else (None, None)
    kernel.launch(m, r, mask, out, scratch, geom)
    LAUNCHES["semiring_contract"] += 1
    return out
