"""The card's peaks, and the least bytes and FP32 operations of a unit of
the program's work, from its shape record (``repro_torch.trace.record``).

Peaks of one H100 SXM (80 GB HBM3), NVIDIA's data sheet: 3.35 TB/s of HBM
and 67 TFLOP/s of FP32 outside the tensor cores.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def segment_cost(r: dict) -> tuple[int, int]:
    """(bytes, FP32 operations) of one ``kernels.segment`` record: one
    message of segment kernels 1-2, N rows into (G, V).

    Bytes: codes 4N, values N·V·``elem_bytes`` and the output 4GV; values
    in code order read the work-item table (``table_bytes``) in place of
    the codes.  A fused member reads its recipe (``recipe_bytes``: lift,
    index and σ code columns, tables, lane columns, masks) in place of the
    values.  Operations: the ⊕ of each row and lane into its segment, and a
    fused member's ⊗ of each of its ``msgs`` gathered messages."""
    n, g, v = r["n"], r["g"], r["v"]
    values = r["recipe_bytes"] if r.get("fused") else n * v * r["elem_bytes"]
    reads = r["table_bytes"] if r["ordered"] else 4 * n
    ops = n * v * (1 + (r.get("msgs", 0) if r.get("fused") else 0))
    return reads + values + 4 * g * v, ops


def roofline_s(nbytes: float, ops: float) -> float:
    """The least seconds the card takes to move ``nbytes`` and compute
    ``ops``: the slower of its HBM and its FP32 peak."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)
