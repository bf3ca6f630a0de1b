"""Row-sharded CJT execution over a 1-D mesh of devices, in one process.

Row sharding (the engine path)
------------------------------
Semiring ⊕ is associative, so a bag contraction row-shards cleanly: split
the fact relation's rows across a 1-D mesh (dimension relations and
incoming γ-indexed messages stay replicated), run the rowwise lift →
σ-mask → segment-kernel pipeline per shard on the shard's row block, and
⊕-fold the partials — ``+`` for rings with leafwise + (SUM/COUNT/
MOMENTS), min/max for the tropical rings.  Every cross-shard value is a
factor over the message's output attrs (separator ∪ carried γ); nothing
ever materializes a join.
:mod:`repro_torch.core.plans` builds the sharded plans; this module owns
the mesh, the ring → collective mapping, the row placement and the
per-shard runner.

One process drives every shard, as the JAX package's single controller
drives ``shard_map``: :func:`shard_map` runs the local body once per shard,
in shard order, and :func:`allreduce_field` folds the partials in shard
order onto the mesh's first device.  No ``torch.distributed`` process group
is involved.  A mesh may list one device several times
(:meth:`ShardMesh.virtual`), the counterpart of XLA's forced host devices:
its shards run one after another on that device, and their row blocks are
views of the whole tensor.  On a mesh over distinct cards each shard's
kernels run on its own card, and row blocks are copied there once per
source tensor (:func:`place_rows`).

Domain sharding (chain demo)
----------------------------
The seed demo below shards factors along one attribute's *domain*
instead: forward messages marginalize the sharded attribute (local partial
contraction + reduce-scatter), backward messages marginalize the
replicated one (all-gather + local contraction) — r-1 reduce-scatters and
r-1 all-gathers per calibration pass over a chain of r factors.  It is
kept as a collective-schedule reference; the engine uses row sharding.
"""

from __future__ import annotations

import dataclasses
import os
from contextlib import nullcontext
from typing import Callable, Sequence

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from .factor import Factor

# Name of the 1-D mesh axis the engine row-shards over.
SHARD_AXIS = "shard"


def same_device(a: torch.device | str, b: torch.device | str) -> bool:
    """Whether two device names denote one device (``cuda`` is the current
    card, so it equals ``cuda:<current>``)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda" or a.index == b.index:
        return True
    current = torch.cuda.current_device()
    return (current if a.index is None else a.index) == (current if b.index is None else b.index)


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """A 1-D mesh: one device per shard, in shard order.

    ``devices`` may repeat a device (:meth:`virtual`); the engine's device
    must be ``devices[0]``, where sharded plans fold their partials.
    """

    devices: tuple[torch.device, ...]
    axis: str = SHARD_AXIS

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", tuple(torch.device(d) for d in self.devices))

    @classmethod
    def cards(cls, n: int, axis: str = SHARD_AXIS) -> "ShardMesh":
        """``n`` distinct CUDA cards, ``cuda:0`` … ``cuda:n-1``."""
        if torch.cuda.device_count() < n:
            raise RuntimeError(f"a mesh over {n} cards needs {n} CUDA devices, "
                               f"found {torch.cuda.device_count()}")
        return cls(tuple(torch.device("cuda", i) for i in range(n)), axis)

    @classmethod
    def virtual(cls, n: int, device: torch.device | str = "cuda",
                axis: str = SHARD_AXIS) -> "ShardMesh":
        """``n`` shards on one device: they run one after another there."""
        return cls((torch.device(device),) * n, axis)

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


def shard_devices() -> int:
    """Mesh width requested via ``REPRO_SHARD_DEVICES`` (0/1/unset → off)."""
    try:
        n = int(os.environ.get("REPRO_SHARD_DEVICES", "0"))
    except ValueError:
        return 0
    return n if n > 1 else 0


def make_engine_mesh(devices: int | None = None,
                     device: torch.device | str = "cuda") -> ShardMesh | None:
    """The engine's row-shard mesh over distinct cards, or ``None`` when off.

    ``devices=None`` reads ``REPRO_SHARD_DEVICES``.  Returns ``None`` (run
    unsharded) rather than raising when there are fewer physical devices of
    ``device``'s type than asked for — a host has one CPU device, so this
    never gives virtual shards; pass a :meth:`ShardMesh.virtual` mesh for
    those.
    """
    n = shard_devices() if devices is None else int(devices)
    if n <= 1 or torch.device(device).type != "cuda" or torch.cuda.device_count() < n:
        return None
    return ShardMesh.cards(n)


def ring_collective(ring) -> Callable | None:
    """⊕ of two partial leaves for a ring's γ-indexed partials, or ``None``.

    ``None`` means the ring's ⊕ has no collective here (BOOL: ⊕ = ∨) and
    callers must run the unsharded plan.
    """
    op = getattr(ring, "kernel_segment_op", None)
    if op == "min":
        return torch.minimum
    if op == "max":
        return torch.maximum
    if op == "sum" or getattr(ring, "has_add_inverse", False):
        return torch.add
    return None


def _fold(partials: Sequence, collective: Callable, device: torch.device):
    head = partials[0]
    if head is None:
        return None
    if isinstance(head, Factor):
        field = _fold([p.field for p in partials], collective, device)
        return dataclasses.replace(head, field=field)
    if isinstance(head, (tuple, list)):
        return type(head)(_fold(parts, collective, device) for parts in zip(*partials))
    acc = head.to(device)
    for p in partials[1:]:
        acc = collective(acc, p.to(device))
    return acc


def allreduce_field(partials: Sequence, collective: Callable):
    """⊕-fold per-shard partials leaf by leaf, in shard order, onto the first
    partial's device (the mesh's first device).  ``partials[i]`` is shard
    i's output: a tensor, a factor, or a tuple/list of those."""
    return _fold(partials, collective, _first_device(partials[0]))


def _first_device(x) -> torch.device:
    if isinstance(x, Factor):
        return x.device
    if isinstance(x, (tuple, list)):
        return next(_first_device(y) for y in x if y is not None)
    return x.device


@dataclasses.dataclass(frozen=True)
class RowPlacement:
    """Leading-axis rows split across ``mesh``'s shards (rest replicated)."""

    mesh: ShardMesh
    axis: str = SHARD_AXIS


def row_placement(mesh: ShardMesh, axis: str = SHARD_AXIS) -> RowPlacement:
    """Placement that splits leading-axis rows across the mesh."""
    return RowPlacement(mesh, axis)


# per source tensor, its row blocks copied to other devices than its own:
# keyed weakly, so a cached array (flat codes, padded lifts) is copied once
# and its copies die with it; a block on the tensor's own device is a view
_PLACED = WeakIdKeyDictionary()


def _row_blocks(t: torch.Tensor, mesh: ShardMesh) -> tuple[torch.Tensor, ...]:
    n = mesh.size
    if t.shape[0] % n:
        raise ValueError(f"{t.shape[0]} rows do not split into {n} equal blocks")
    b = t.shape[0] // n
    copies = _PLACED.get(t)
    if copies is None or len(copies) != n:
        copies = [None] * n
    out = []
    for i, dev in enumerate(mesh.devices):
        block = t.narrow(0, i * b, b)
        if not same_device(dev, t.device):
            if copies[i] is None or not same_device(copies[i].device, dev):
                copies[i] = block.to(dev)
            block = copies[i]
        out.append(block)
    if any(c is not None for c in copies):
        _PLACED[t] = copies
    return tuple(out)


def place_rows(field, mesh: ShardMesh, axis: str | None = None) -> tuple:
    """Split every leaf of a row-major pytree (tensors, tuples, ``None``)
    into the mesh's row blocks along ``axis`` (the mesh's own, which is the
    default): returns one pytree per shard, shard ``i``'s on
    ``mesh.devices[i]``.  On a virtual mesh the blocks are views with no
    copy; on distinct cards a source tensor's blocks are copied once and
    reused while it lives, so a cached row array (flat codes, a padded
    lift) is copied on its first sharded dispatch only."""
    if axis is not None and axis != mesh.axis:
        raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {axis!r}")
    if field is None:
        return (None,) * mesh.size
    if isinstance(field, (tuple, list)):
        return _per_shard(type(field), [place_rows(x, mesh) for x in field], mesh.size)
    return _row_blocks(field, mesh)


def _per_shard(kind: type, per_item: list, n: int) -> tuple:
    """Per-item tuples of n shard values → n values of type ``kind``."""
    return tuple(kind(item[i] for item in per_item) for i in range(n))


def _replicate(x, device: torch.device):
    if x is None:
        return None
    if isinstance(x, (tuple, list)):
        return type(x)(_replicate(y, device) for y in x)
    return x.to(device)


def _split(arg, spec, mesh: ShardMesh) -> tuple:
    """One argument → its per-shard values, under a spec prefix: the axis
    name splits rows, ``None`` replicates, a tuple spec maps over a tuple
    argument."""
    if isinstance(spec, tuple):
        return _per_shard(type(arg), [_split(a, s, mesh) for a, s in zip(arg, spec)],
                          mesh.size)
    if spec is None:
        return tuple(_replicate(arg, dev) for dev in mesh.devices)
    return place_rows(arg, mesh, spec)


def shard_map(f: Callable, mesh: ShardMesh, in_specs: tuple) -> Callable:
    """``f`` run once per shard on the shard's arguments, in shard order.

    ``in_specs`` has one entry per positional argument (a prefix of its
    structure): the axis name gives row-major leaves their shard's block,
    ``None`` passes the argument whole (copied to the shard's device when
    that is another).  The returned callable gives the tuple of per-shard
    outputs; the caller ⊕-folds them (:func:`allreduce_field`).  Each
    shard's body runs with its device current, so its kernels launch there.
    """

    def run(*args):
        per_arg = [_split(a, s, mesh) for a, s in zip(args, in_specs)]
        outs = []
        for i, dev in enumerate(mesh.devices):
            ctx = torch.cuda.device(dev) if dev.type == "cuda" else nullcontext()
            with ctx:
                outs.append(f(*(shards[i] for shards in per_arg)))
        return tuple(outs)

    return run


def shard_imbalance(num_rows: int, bucket: int, nshards: int) -> float:
    """Max valid rows per shard / ideal per-shard rows (≥ 1.0 when nonempty).

    Rows are packed low (pad rows carry the ⊕-identity at the top of the
    bucket), so the fullest shard is the first block.
    """
    if nshards <= 1 or num_rows <= 0:
        return 1.0 if num_rows > 0 else 0.0
    block = bucket // nshards
    return min(block, num_rows) * nshards / num_rows


# --------------------------------------------------------------------------
# Domain-sharded chain demo (seed reference; see module docstring)
# --------------------------------------------------------------------------


def reduce_scatter(partials: Sequence[torch.Tensor], mesh: ShardMesh) -> tuple:
    """Σ of the shards' partials, in shard order, split into the mesh's
    blocks along the leading axis (shard i's block on its device)."""
    return place_rows(allreduce_field(partials, torch.add), mesh)


def all_gather(blocks: Sequence[torch.Tensor], mesh: ShardMesh) -> tuple:
    """The shards' blocks concatenated along the leading axis, once per
    shard on the shard's device."""
    return tuple(torch.cat([b.to(dev) for b in blocks]) for dev in mesh.devices)


def calibrate_chain_reference(factors: list[torch.Tensor]) -> tuple[list, list]:
    """Single-device oracle: forward/backward messages of a chain CJT.

    factors[i]: (d_i, d_{i+1}) arithmetic-ring factor between A_i and A_{i+1}.
    Returns (fwd, bwd): fwd[i] over A_{i+1} (message bag_i→bag_{i+1}),
    bwd[i] over A_{i+1} (message bag_{i+1}→bag_i).
    """
    r = len(factors)
    fwd, bwd = [None] * (r - 1), [None] * (r - 1)
    m = torch.ones((factors[0].shape[0],), dtype=factors[0].dtype, device=factors[0].device)
    for i in range(r - 1):
        m = m @ factors[i]              # Σ_{A_i} F_i ⊗ m   → over A_{i+1}
        fwd[i] = m
    m = torch.ones((factors[-1].shape[1],), dtype=factors[0].dtype, device=factors[0].device)
    for i in range(r - 2, -1, -1):
        m = factors[i + 1] @ m          # Σ_{A_{i+2}} F_{i+1} ⊗ m → over A_{i+1}
        bwd[i] = m
    return fwd, bwd


def chain_absorptions_reference(factors, fwd, bwd):
    """Absorption at every bag: the calibrated per-bag views."""
    r = len(factors)
    out = []
    for i in range(r):
        f = factors[i]
        if i > 0:
            f = f * fwd[i - 1][:, None]
        if i < r - 1:
            f = f * bwd[i][None, :]
        out.append(f)
    return out


def _gathered(blocks: Sequence[torch.Tensor], mesh: ShardMesh) -> torch.Tensor:
    """A sharded message as one tensor on the mesh's first device."""
    return torch.cat([b.to(mesh.devices[0]) for b in blocks])


def make_chain_calibrate(mesh: ShardMesh, axis: str, r: int, d: int,
                         dtype: torch.dtype = torch.float32) -> Callable:
    """A sharded calibration fn for a chain of r (d, d) factors.

    Sharding: factor i is (A_i sharded, A_{i+1} replicated); every message is
    sharded along its own attribute.  The fn takes :func:`place_chain_factors`'
    output and returns ``(fwd, bwd, total)``: the messages whole on the
    mesh's first device, and the total count at bag 0.
    """
    n = mesh.shape[axis]
    if d % n:
        raise ValueError(f"domain {d} not divisible by mesh axis {n}")

    def fn(factors):
        devs = mesh.devices
        fwd = []
        m = [torch.ones((d // n,), dtype=dtype, device=dev) for dev in devs]
        for i in range(r - 1):
            partial_msg = [m[s] @ factors[i][s] for s in range(n)]   # (d,) over local A_i rows
            m = reduce_scatter(partial_msg, mesh)                   # (d/n,) over A_{i+1}
            fwd.append(m)
        bwd = []
        m = [torch.ones((d // n,), dtype=dtype, device=dev) for dev in devs]
        for i in range(r - 2, -1, -1):
            full = all_gather(m, mesh)                               # (d,) over A_{i+2}
            m = [factors[i + 1][s] @ full[s] for s in range(n)]      # (d/n,) over A_{i+1}
            bwd.append(m)
        bwd = bwd[::-1]
        # total-count absorption at bag 0 (scalar sanity output)
        if r > 1:
            full_b = all_gather(bwd[0], mesh)
            total_local = [torch.sum(factors[0][s] @ full_b[s]) for s in range(n)]
        else:
            total_local = [torch.sum(factors[0][s]) for s in range(n)]
        total = allreduce_field(total_local, torch.add)
        return ([_gathered(x, mesh) for x in fwd], [_gathered(x, mesh) for x in bwd], total)

    return fn


def make_chain_calibrate_multi(mesh: ShardMesh, axis: str, r: int, d: int,
                               n_measures: int, dtype: torch.dtype = torch.float32) -> Callable:
    """Beyond-paper: fuse V measure semirings into ONE calibration pass.

    Stacking the V annotation columns turns every message matvec into a
    (d/n, d)×(d, V) matmul: factors are read once instead of V times, and
    messages and collectives carry (d/n, V) blocks.  Factor annotations:
    (d/n, d) structural counts shared by all measures; per-measure leaf
    annotations enter at bag 0 as a (d/n, V) block (``place_rows`` of a
    (d, V) tensor).
    """
    n = mesh.shape[axis]
    if d % n:
        raise ValueError(f"domain {d} not divisible by mesh axis {n}")

    def fn(factors, leaf_vals):
        fwd = []
        m = list(leaf_vals)                                          # (d/n, V)
        for i in range(r - 1):
            partial_msg = [torch.einsum("kv,kd->dv", m[s], factors[i][s]) for s in range(n)]
            m = reduce_scatter(partial_msg, mesh)
            fwd.append(m)                                            # (d/n, V)
        bwd = []
        m = [torch.ones((d // n, n_measures), dtype=dtype, device=dev) for dev in mesh.devices]
        for i in range(r - 2, -1, -1):
            full = all_gather(m, mesh)                               # (d, V)
            m = [factors[i + 1][s] @ full[s] for s in range(n)]      # (d/n, V)
            bwd.append(m)
        bwd = bwd[::-1]
        # absorption at the last bag: ⊕ over its own factor too
        total_local = [torch.einsum("kv,k->v", fwd[-1][s], factors[-1][s].sum(dim=1))
                       for s in range(n)]
        totals = allreduce_field(total_local, torch.add)
        return ([_gathered(x, mesh) for x in fwd], [_gathered(x, mesh) for x in bwd], totals)

    return fn


def chain_multi_specs(mesh: ShardMesh, axis: str, r: int, d: int, n_measures: int,
                      dtype: torch.dtype = torch.float32):
    """Shapes of the multi-measure chain's inputs, as ``meta`` tensors (no
    allocation)."""
    factors = [torch.empty((d, d), dtype=dtype, device="meta") for _ in range(r)]
    leaf = torch.empty((d, n_measures), dtype=dtype, device="meta")
    return factors, leaf


def place_chain_factors(mesh: ShardMesh, axis: str, factors_np: list[np.ndarray]) -> list:
    """Each (d, d) factor split into the mesh's row blocks (A_i sharded)."""
    return [place_rows(torch.from_numpy(np.ascontiguousarray(f)).to(mesh.devices[0]), mesh, axis)
            for f in factors_np]


def chain_factor_specs(mesh: ShardMesh, axis: str, r: int, d: int,
                       dtype: torch.dtype = torch.float32):
    """Shapes of the chain's factors, as ``meta`` tensors (no allocation)."""
    return [torch.empty((d, d), dtype=dtype, device="meta") for _ in range(r)]
