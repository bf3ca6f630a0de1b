"""Plain PyTorch versions of the segment-aggregate kernels.

They run wherever the wrapper is handed CPU tensors, and ``chip_smoke.py``
holds the CUDA kernels against them on the card.
"""

from __future__ import annotations

import math

import torch

IDENTITY = {"sum": 0.0, "min": math.inf, "max": -math.inf}


def segment_aggregate_ref(codes: torch.Tensor, values: torch.Tensor, num_segments: int,
                          op: str = "sum") -> torch.Tensor:
    """``out[g] = ⊕_{r: codes[r] == g} values[r]`` over the leading axis;
    empty groups hold the ⊕-identity and codes outside [0, G) match nothing.
    Sums accumulate in float64 and round once to float32, so this version is
    also the accuracy yardstick for the kernels' float32 atomic sums."""
    values = values.to(torch.float32)
    keep = (codes >= 0) & (codes < num_segments)
    if not bool(keep.all()):
        codes, values = codes[keep], values[keep]
    codes = codes.long()
    shape = (num_segments,) + tuple(values.shape[1:])
    if op == "sum":
        out = torch.zeros(shape, dtype=torch.float64, device=values.device)
        return out.index_add_(0, codes, values.double()).float()
    out = torch.full(shape, IDENTITY[op], dtype=torch.float32, device=values.device)
    idx = codes.reshape((-1,) + (1,) * (values.dim() - 1)).expand_as(values)
    reduce = "amin" if op == "min" else "amax"
    return out.scatter_reduce_(0, idx, values, reduce=reduce, include_self=True)


def level_segment_aggregate_ref(codes: torch.Tensor, values: torch.Tensor,
                                total_segments: int, op: str = "sum") -> torch.Tensor:
    """The level kernel's function on its concatenated operands: global
    segment ids, pad rows (code -1) match nothing."""
    return segment_aggregate_ref(codes, values, total_segments, op)
