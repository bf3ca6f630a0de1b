"""Wrappers of the segment-aggregate kernels: the calls the plan layer makes.

A wrapper given CPU tensors computes the plain PyTorch version (``ref.py``);
given CUDA tensors it checks them, allocates the output filled with the
⊕-identity, launches the hand-written kernel on the current stream and
counts the launch in :data:`LAUNCHES`.  There is no fallback: a CUDA input
the kernel does not take, a failed build or a refused launch raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import kernel
from .ref import IDENTITY, level_segment_aggregate_ref, segment_aggregate_ref

# kernel launches since the last reset_launches(), by kernel name
LAUNCHES = {"segment_aggregate": 0, "level_segment_aggregate": 0}

_INT32_MAX = 2**31 - 1


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _checked_out(codes: torch.Tensor, values: torch.Tensor, num_segments: int,
                 op: str) -> torch.Tensor:
    if op not in IDENTITY:
        raise ValueError(f"unknown segment op {op!r}")
    if codes.device.type != "cuda" or values.device != codes.device:
        raise ValueError(f"codes on {codes.device} and values on {values.device}: "
                         "both must be on the same CUDA device")
    if codes.dtype != torch.int32 or values.dtype != torch.float32:
        raise TypeError(f"need int32 codes and float32 values, got {codes.dtype}, {values.dtype}")
    if codes.dim() != 1 or values.dim() != 2 or values.shape[0] != codes.shape[0]:
        raise ValueError(f"need codes (N,) and values (N, V), got {tuple(codes.shape)}, "
                         f"{tuple(values.shape)}")
    if not (codes.is_contiguous() and values.is_contiguous()):
        raise ValueError("codes and values must be contiguous")
    if num_segments <= 0 or num_segments * values.shape[1] > _INT32_MAX:
        raise ValueError(f"output of {num_segments} x {values.shape[1]} is out of range")
    return torch.full((num_segments, values.shape[1]), IDENTITY[op],
                      dtype=torch.float32, device=codes.device)


def aggregate_op(codes: torch.Tensor, values: torch.Tensor, num_segments: int,
                 op: str = "sum") -> torch.Tensor:
    """``out[g, v] = ⊕_{n: codes[n] = g} values[n, v]``, ⊕ ∈ {sum, min, max}.

    ``codes`` (N,) int32 in [0, G); ``values`` (N, V) float32, or (N,) which
    returns (G,).  Empty groups hold the ⊕-identity (0 / +inf / -inf).
    """
    squeeze = values.dim() == 1
    if squeeze:
        values = values[:, None]
    if codes.device.type == "cpu":
        out = segment_aggregate_ref(codes, values, num_segments, op)
    else:
        out = _checked_out(codes, values, num_segments, op)
        if codes.shape[0]:
            kernel.launch("segment_aggregate", codes, values, out, op)
            LAUNCHES["segment_aggregate"] += 1
    return out[:, 0] if squeeze else out


def level_segment_aggregate(codes: torch.Tensor, values: torch.Tensor, total_segments: int,
                            op: str = "sum") -> torch.Tensor:
    """The level kernel on concatenated operands: ``codes`` (ΣN,) int32
    global segment ids (-1 matches nothing), ``values`` (ΣN, V) float32,
    out (total_segments, V)."""
    if codes.device.type == "cpu":
        return level_segment_aggregate_ref(codes, values, total_segments, op)
    out = _checked_out(codes, values, total_segments, op)
    if codes.shape[0]:
        kernel.launch("level_segment_aggregate", codes, values, out, op)
        LAUNCHES["level_segment_aggregate"] += 1
    return out


def level_aggregate(items, op: str = "sum") -> list[torch.Tensor]:
    """Several independent ``(codes, values, num_segments)`` segment
    reductions in ONE ``level_segment_aggregate`` launch.

    Item j is one same-level message: ``codes`` (n_j,) local segment ids in
    [0, g_j), ``values`` (n_j, v_j).  Local ids shift by the running segment
    offset so the messages' outputs are disjoint; values are padded to the
    common width with the ⊕-identity.  Returns the per-item (g_j, v_j) outputs.
    On the CPU the plain version reduces each item on its own (no padding).
    """
    assert items, "level_aggregate of zero messages"
    if items[0][0].device.type == "cpu":
        return [segment_aggregate_ref(codes, values.to(torch.float32), g, op)
                for codes, values, g in items]
    if len(items) == 1:  # nothing to shift, pad or concatenate
        codes, values, g = items[0]
        return [level_segment_aggregate(codes.to(torch.int32).contiguous(),
                                        values.to(torch.float32).contiguous(), g, op)]
    ident = IDENTITY[op]
    v_max = max(v.shape[1] for _, v, _ in items)
    all_codes, all_vals, spans = [], [], []
    seg_off = 0
    for codes, values, g in items:
        all_codes.append(codes.to(torch.int32) + seg_off)
        if values.shape[1] < v_max:
            values = F.pad(values, (0, v_max - values.shape[1]), value=ident)
        all_vals.append(values.to(torch.float32))
        spans.append((seg_off, g))
        seg_off += g
    out = level_segment_aggregate(torch.cat(all_codes), torch.cat(all_vals), seg_off, op)
    return [out[off: off + g, : v.shape[1]] for (off, g), (_, v, _) in zip(spans, items)]
