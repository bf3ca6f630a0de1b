"""Wrapper of the tropical_contract kernel: the call the dense plans make.

Given CPU tensors it computes the plain PyTorch version (``ref.py``); given
CUDA tensors it checks them, allocates the output filled with the
⊕-identity, launches the hand-written kernel on the current stream and
counts the launch in :data:`LAUNCHES`.  There is no fallback: a CUDA input
the kernel does not take, a failed build or a refused launch raises.
"""

from __future__ import annotations

import math

import torch

from . import kernel
from .ref import tropical_contract_ref

# kernel launches since the last reset_launches()
LAUNCHES = {"tropical_contract": 0}

_INT32_MAX = 2**31 - 1


def reset_launches() -> None:
    LAUNCHES["tropical_contract"] = 0


def contract_op(m: torch.Tensor, r: torch.Tensor, is_min: bool = True) -> torch.Tensor:
    """``C[g, a] = min_b (M[g, b] + R[b, a])`` (or max): (G, B) × (B, A)
    float32 in, (G, A) float32 out."""
    if m.device.type == "cpu":
        return tropical_contract_ref(m, r, is_min)
    if r.device != m.device:
        raise ValueError(f"m on {m.device} and r on {r.device}: both must be on one CUDA device")
    if m.dtype != torch.float32 or r.dtype != torch.float32:
        raise TypeError(f"need float32 m and r, got {m.dtype}, {r.dtype}")
    if m.dim() != 2 or r.dim() != 2 or m.shape[1] != r.shape[0]:
        raise ValueError(f"need m (G, B) and r (B, A), got {tuple(m.shape)}, {tuple(r.shape)}")
    g, b = m.shape
    a = r.shape[1]
    if min(g, b, a) < 1 or max(g, b, a) > _INT32_MAX:
        raise ValueError(f"shapes {tuple(m.shape)} x {tuple(r.shape)} are out of range")
    if not (m.is_contiguous() and r.is_contiguous()):
        raise ValueError("m and r must be contiguous")
    out = torch.full((g, a), math.inf if is_min else -math.inf, dtype=torch.float32,
                     device=m.device)
    kernel.launch(m, r, out, is_min)
    LAUNCHES["tropical_contract"] += 1
    return out
