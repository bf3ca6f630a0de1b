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


def recipe_values(recipe, zero: float) -> torch.Tensor:
    """A recipe's (N, V) float32 values, materialized as the plan layer's
    rowwise stage materializes them: the lift, ⊗ each message's table rows
    (``index_select`` at the row's index, row 0 for a broadcast message)
    at the lanes' columns, in message order, then ``masked_fill`` with
    ``zero`` (0̄) where a σ predicate's mask is false at the row's code."""
    x = recipe.lift.to(torch.float32)[:, None]
    n = x.shape[0]
    for index, table, lanes in recipe.messages:
        rows = table[:1].expand(n, -1) if index is None else table.index_select(0, index)
        g = rows.index_select(1, lanes)
        x = x + g if recipe.add else x * g
    if recipe.preds:
        (codes, mask), *rest = recipe.preds
        keep = mask[codes]
        for codes, mask in rest:
            keep = keep & mask[codes]
        x = x.masked_fill(~keep[:, None], zero)
    return x


def recipe_aggregate_ref(codes: torch.Tensor, recipe, num_segments: int,
                         op: str = "sum") -> torch.Tensor:
    """The segment kernels' function on a fused member: its recipe's values
    materialized (:func:`recipe_values`, 0̄ the ⊕-identity), then
    :func:`segment_aggregate_ref`."""
    return segment_aggregate_ref(codes, recipe_values(recipe, IDENTITY[op]), num_segments, op)
