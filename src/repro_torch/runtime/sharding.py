"""Logical-axis → mesh-axis sharding rules with divisibility fallback.

Every parameter/cache leaf is declared once with logical axes (models/lm.py
``Spec``); this module maps them onto a mesh (``runtime.compat.Mesh``):

  single pod  : (data=16, model=16)          fsdp=(data,)        tensor=model
  multi pod   : (pod=2, data=16, model=16)   fsdp=(pod, data)    tensor=model

Rules are *requests*: a dim whose size is not divisible by the mesh axes it
maps to falls back to replication (e.g. deepseek's 56 q-heads on a 16-way
tensor axis — the flat head projection dim 7168 still shards; granite's
49155-way vocab replicates).  A mesh axis is also never used twice in one
placement (first dim wins).

A ``Placement`` is the reference's ``PartitionSpec``: one entry per dim
(``None``, an axis name, or a tuple of names), trailing ``None``s dropped.
A ``NamedSharding`` pairs it with the mesh and gives a device's shard shape.
The reference's ``ShapeDtypeStruct(..., sharding=...)`` is an
``AbstractTensor``: a ``meta``-device tensor (no storage) and its sharding,
with the bytes one device holds.  On one card a placement moves nothing
(``models.layers.with_sharding`` returns its input); the dry-run reads the
placements for its per-device byte counts.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import torch

from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.lm import Spec, map_specs
from repro_torch.runtime.compat import Mesh


class Placement(tuple):
    """Per-dimension mesh axes of an array, as a ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"Placement{tuple.__repr__(self)}"


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: Mesh
    spec: Placement

    def shard_shape(self, shape) -> tuple[int, ...]:
        """One device's block of an array of ``shape`` under this sharding."""
        if len(self.spec) > len(shape):
            raise ValueError(f"placement {self.spec} has more entries than shape {tuple(shape)}")
        out = []
        for i, dim in enumerate(shape):
            n = _n(self.mesh, _entry_axes(self.spec[i]) if i < len(self.spec) else ())
            if dim % n:
                raise ValueError(f"dim {i} of {tuple(shape)} does not split {n} ways")
            out.append(dim // n)
        return tuple(out)

    def shard_bytes(self, t: torch.Tensor) -> int:
        """One device's bytes of tensor ``t`` (any device, ``meta`` too)."""
        return math.prod(self.shard_shape(tuple(t.shape))) * t.element_size()


@dataclasses.dataclass(frozen=True)
class AbstractTensor:
    """A ``meta``-device tensor with its sharding: the reference's
    ``ShapeDtypeStruct`` with a ``NamedSharding``."""

    tensor: torch.Tensor
    sharding: NamedSharding

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.tensor.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.tensor.dtype

    def shard_shape(self) -> tuple[int, ...]:
        return self.sharding.shard_shape(self.shape)

    @property
    def device_bytes(self) -> int:
        """Bytes of one device's shard."""
        return self.sharding.shard_bytes(self.tensor)


def metas(tree):
    """A tree of ``AbstractTensor``s (dicts, lists, tuples) as its meta
    tensors, for tracing; other leaves pass through."""
    return T.map_leaves(lambda x: x.tensor if isinstance(x, AbstractTensor) else x, tree)


def device_bytes(tree) -> int:
    """Σ of one device's bytes over a tree of ``AbstractTensor``s."""
    return sum(x.device_bytes for x in T.leaves(tree))


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    mesh: Mesh
    table: Mapping[str, tuple[str, ...]]   # logical axis -> mesh axes

    def axes_for(self, logical: Any) -> tuple[str, ...]:
        if logical is None:
            return ()
        return tuple(self.table.get(logical, ()))


def make_rules(mesh: Mesh, shape: ShapeConfig | None = None,
               multi_pod: bool | None = None) -> ShardingRules:
    if multi_pod is None:
        multi_pod = "pod" in mesh.axis_names
    fsdp = ("pod", "data") if multi_pod else ("data",)
    tensor = ("model",)
    table: dict[str, tuple[str, ...]] = {
        # parameters
        "embed": fsdp,
        "vocab": tensor,
        "heads_flat": tensor,
        "kv_flat": tensor,
        "mlp": tensor,
        "experts": tensor,
        "ssm_inner": tensor,
        "layers": (), "group": (),
        # activations / caches
        "act_batch": fsdp,
        "act_seq": (),
        "act_embed": tensor,
        "act_heads": tensor,
        "act_ff": tensor,
        "cache_seq": tensor,
        "kv_heads": (),
        "act_vocab": tensor,
        "act_experts": tensor,
    }
    if shape is not None and shape.kind == "decode" and shape.global_batch < _n(mesh, fsdp):
        # long-context decode (batch=1): nothing to shard on batch; spread the
        # KV cache/sequence over the whole mesh instead.
        table["act_batch"] = ()
        table["cache_seq"] = fsdp + tensor
    return ShardingRules(mesh=mesh, table=table)


def _n(mesh: Mesh, axes: tuple[str, ...]) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def pspec_for(spec_shape: tuple[int, ...], logical_axes: tuple,
              rules: ShardingRules) -> Placement:
    used: set[str] = set()
    entries = []
    for dim, logical in zip(spec_shape, logical_axes):
        axes = [a for a in rules.axes_for(logical) if a not in used]
        if axes and dim % _n(rules.mesh, tuple(axes)) == 0:
            used.update(axes)
            entries.append(tuple(axes) if len(axes) > 1 else axes[0])
        else:
            entries.append(None)
    while entries and entries[-1] is None:
        entries.pop()
    return Placement(*entries)


def sharding_for(spec: Spec, rules: ShardingRules) -> NamedSharding:
    return NamedSharding(rules.mesh, pspec_for(spec.shape, spec.axes, rules))


def tree_shardings(spec_tree, rules: ShardingRules):
    return map_specs(spec_tree, lambda _, s: sharding_for(s, rules))


def _abstract(shape, dtype, sharding: NamedSharding) -> AbstractTensor:
    """A meta tensor of ``dtype`` (a torch dtype or, as the reference passes
    them, its name) with its sharding."""
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return AbstractTensor(torch.empty(shape, dtype=dtype, device="meta"), sharding)


def tree_abstract(spec_tree, rules: ShardingRules, default_dtype):
    def build(_, s: Spec):
        return _abstract(s.shape, s.dtype or default_dtype, sharding_for(s, rules))

    return map_specs(spec_tree, build)


# ---------------------------------------------------------------------------
# Activation placements handed into the forward pass
# ---------------------------------------------------------------------------

def act_specs(cfg: ModelConfig, rules: ShardingRules) -> dict:
    """Shardings of the ``with_sharding`` sites inside the model."""
    r = rules

    def p(*logicals, dims):
        return NamedSharding(r.mesh, pspec_for(dims, logicals, r))

    d = cfg.d_model
    # context-parallel attention: put the tensor axis on the sequence dim of
    # q/k/v instead of heads (deepseek: 56 heads ∤ 16)
    seq_ax = "act_embed" if cfg.attn_seq_shard else "act_seq"
    head_ax = None if cfg.attn_seq_shard else "act_heads"
    resid_ax = "act_embed" if cfg.resid_shard else None
    out = {
        "resid": p("act_batch", "act_seq", resid_ax, dims=(1 << 30, 1 << 30, d)),
        "qkv": p("act_batch", seq_ax, head_ax, None,
                 dims=(1 << 30, 1 << 30, cfg.n_heads, cfg.d_head)),
        "kv": p("act_batch", seq_ax, "kv_heads", None,
                dims=(1 << 30, 1 << 30, cfg.n_kv_heads, cfg.d_head)),
        "ff": p("act_batch", "act_seq", "act_ff", dims=(1 << 30, 1 << 30, cfg.d_ff)),
        "logits": p("act_batch", "act_seq", "act_vocab", dims=(1 << 30, 1 << 30, cfg.vocab)),
    }
    if cfg.moe:
        out["expert_in"] = p(None, "act_experts", None, None,
                             dims=(1 << 30, cfg.moe.n_experts, 1 << 30, d))
        out["expert_ff"] = p(None, "act_experts", None, None,
                             dims=(1 << 30, cfg.moe.n_experts, 1 << 30, cfg.moe.d_ff))
    return out


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, rules: ShardingRules, dtype) -> dict:
    """``AbstractTensor``s (with shardings) for one device batch."""
    b = shape.global_batch
    s = shape.seq_len if shape.kind != "decode" else 1

    def sds(shape_, logicals, dt):
        return _abstract(shape_, dt, NamedSharding(rules.mesh, pspec_for(shape_, logicals, rules)))

    out = {}
    if cfg.input_mode == "embeddings":
        out["embeds"] = sds((b, s, cfg.d_model), ("act_batch", "act_seq", "act_embed"), dtype)
    else:
        out["tokens"] = sds((b, s), ("act_batch", "act_seq"), "int32")
    if cfg.input_mode == "tokens+vision":
        out["vision"] = sds(
            (b, cfg.n_vision_tokens, cfg.d_model), ("act_batch", None, "act_embed"), dtype
        )
    if shape.kind == "train":
        out["labels"] = sds((b, s), ("act_batch", "act_seq"), "int32")
    return out
