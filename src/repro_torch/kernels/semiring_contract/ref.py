"""Plain PyTorch version of the semiring_contract kernel.

It runs wherever the wrapper is handed CPU tensors, and ``chip_smoke.py``
holds the CUDA kernel against it on the card.
"""

from __future__ import annotations

import torch


def semiring_contract_ref(m: torch.Tensor, r: torch.Tensor,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """``C[g, a] = Σ_b M[g, b]·mask[b]·R[b, a]`` in float32."""
    m = m.to(torch.float32)
    if mask is not None:
        m = m * mask.to(torch.float32)[None, :]
    return m @ r.to(torch.float32)
