"""Plain PyTorch version of the tropical_contract kernel.

It runs wherever the wrapper is handed CPU tensors, and ``chip_smoke.py``
holds the CUDA kernel against it on the card.
"""

from __future__ import annotations

import torch


def tropical_contract_ref(m: torch.Tensor, r: torch.Tensor, is_min: bool = True) -> torch.Tensor:
    """``C[g, a] = min_b (M[g, b] + R[b, a])`` (or max) in float32, through
    the (G, B, A) broadcast slab."""
    slab = m.to(torch.float32)[:, :, None] + r.to(torch.float32)[None, :, :]
    return slab.amin(dim=1) if is_min else slab.amax(dim=1)
