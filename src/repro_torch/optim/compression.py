"""Int8 gradient compression with error feedback.

The sender quantizes each leaf to int8 with a per-leaf scale, the reduction
runs on int32 partial sums, and the residual quantization error is fed back
into the next step's gradients.

``psum_compressed`` reduces the per-shard gradient trees of a
``repro_torch.core.distributed.ShardMesh`` (the reference reduces inside a
``shard_map`` with ``pmax`` / ``psum``): the shards agree on the largest
scale first, and the int32 quanta are summed in shard order on the mesh's
first device.  Nothing in the training step calls it; it is the
reference's building block, ported as it is.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import tree as T


@dataclasses.dataclass
class CompressionState:
    error: dict  # error-feedback residual per leaf


def _local_scale(x):
    return torch.clamp(x.abs().max(), min=1e-12) / 127.0


def compress_int8(tree, error=None):
    """Quantize each leaf to int8 with a per-leaf scale; returns (q, scales,
    new_error_partial)."""

    def q(leaf, err):
        x = leaf.float() + (err.float() if err is not None else 0.0)
        scale = _local_scale(x)
        qi = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
        return qi, scale, x - qi.float() * scale

    return T.unzip(T.map_leaves(q, tree, error), 3)


def decompress_int8(q_tree, scales):
    return T.map_leaves(lambda q, s: q.float() * s, q_tree, scales)


def psum_compressed(shard_grads: list, mesh, error: list | None = None):
    """Quantize → integer sum over the mesh's shards → dequantize.

    ``shard_grads[i]`` is shard i's gradient tree, on ``mesh.devices[i]``;
    ``error`` the per-shard residuals of the last call, or ``None``.
    Returns (the summed tree on ``mesh.devices[0]``, the new per-shard
    residuals).  Every shard quantizes with the largest shard scale, so all
    dequantize identically.
    """
    k = mesh.size
    if len(shard_grads) != k:
        raise ValueError(f"{len(shard_grads)} gradient trees for a mesh of {k} shards")
    errors = error if error is not None else [None] * k
    root = mesh.devices[0]

    def one(*leaves):
        grads, errs = leaves[:k], leaves[k:]
        xs = [g.float() + (e if e is not None else 0.0) for g, e in zip(grads, errs)]
        scale = torch.stack([_local_scale(x).to(root) for x in xs]).max()
        total, new_err = None, []
        for x in xs:
            s = scale.to(x.device)
            qi = torch.clamp(torch.round(x / s), -127, 127).to(torch.int32)
            total = qi.to(root) if total is None else total + qi.to(root)
            new_err.append(x - qi.float() * s)
        return (total.float() * scale, *new_err)

    out = T.unzip(T.map_leaves(one, *shard_grads, *errors), k + 1)
    return out[0], list(out[1:])
