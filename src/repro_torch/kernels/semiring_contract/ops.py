"""Wrapper of the semiring_contract kernel: the call the dense plans make.

Given CPU tensors it computes the plain PyTorch version (``ref.py``); given
CUDA tensors it checks them, allocates the zero-filled output, launches the
hand-written kernel on the current stream and counts the launch in
:data:`LAUNCHES`.  There is no fallback: a CUDA input the kernel does not
take, a failed build or a refused launch raises.
"""

from __future__ import annotations

import torch

from . import kernel
from .ref import semiring_contract_ref

# kernel launches since the last reset_launches()
LAUNCHES = {"semiring_contract": 0}

_INT32_MAX = 2**31 - 1


def reset_launches() -> None:
    LAUNCHES["semiring_contract"] = 0


def contract_op(m: torch.Tensor, r: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
    """``C[g, a] = Σ_b M[g, b]·mask[b]·R[b, a]``: (G, B) × (B, A) float32 or
    float16, optional (B,) σ mask on the contracted axis, (G, A) float32 out."""
    if m.device.type == "cpu":
        return semiring_contract_ref(m, r, mask)
    if r.device != m.device or (mask is not None and mask.device != m.device):
        raise ValueError("m, r and mask must be on the same CUDA device")
    if m.dtype not in (torch.float32, torch.float16) or r.dtype != m.dtype:
        raise TypeError(f"need float32 or float16 m and r of one dtype, got {m.dtype}, {r.dtype}")
    if m.dim() != 2 or r.dim() != 2 or m.shape[1] != r.shape[0]:
        raise ValueError(f"need m (G, B) and r (B, A), got {tuple(m.shape)}, {tuple(r.shape)}")
    g, b = m.shape
    a = r.shape[1]
    if min(g, b, a) < 1 or max(g, b, a) > _INT32_MAX:
        raise ValueError(f"shapes {tuple(m.shape)} x {tuple(r.shape)} are out of range")
    if not (m.is_contiguous() and r.is_contiguous()):
        raise ValueError("m and r must be contiguous")
    if mask is not None:
        if mask.shape != (b,):
            raise ValueError(f"mask must be ({b},), got {tuple(mask.shape)}")
        mask = mask.to(torch.float32).contiguous()
    out = torch.zeros((g, a), dtype=torch.float32, device=m.device)
    kernel.launch(m, r, mask, out)
    LAUNCHES["semiring_contract"] += 1
    return out
