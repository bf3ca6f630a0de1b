"""Message plans: cached bag contractions routed through the segment kernels.

Every CJT message is one *bag contraction*: ⊗ the bag's lifted relation with
the incoming messages, apply σ, ⊕-marginalize to the separator ∪ carried γ.
A plan is the Python callable that does this for one contraction
*structure*, cached under the same structural keys as the JAX package's
jitted plans (relation attr order/domains/row bucket, incoming-factor shapes,
ring, out attrs, predicate arity), so ``PlanStats`` keeps its meaning: a new
σ mask, a new relation version or another γ of equal shape re-runs a cached
plan.  PyTorch runs eagerly, so nothing is traced or compiled here.

- **Device-resident inputs.**  Flat row codes live in
  ``Catalog.dev_flat_codes``; per-row lifts, σ masks and densified factors
  are cached here, on the cache's device.
- **Kernel routing.**  The ⊕-segment reduction of every ring whose ⊕ is a
  kernel op (``kernel_segment_op``), whose fields are float32 and whose
  leaves have no trailing dims goes to ``segment_ops.aggregate_op`` (one
  message) or ``segment_ops.level_aggregate`` (one launch for a whole
  calibration level, or for one batch of sibling absorptions in a
  crossfilter fan-out, ``run_sparse_batch``).  MOMENTS stacks its three leaves as value columns.
  On a CUDA device those launch the hand-written kernels, always — there is
  no cost gate; on the CPU the same wrappers run their plain versions.
  BOOL, int64 COUNT and covariance reduce with plain torch on both devices.
- **Dense bags.**  A bag whose relations are densified (no relation, or
  ``dense_rows_threshold``) contracts dense factors.  A two-factor
  contraction whose shared attrs do not survive to the output is a matrix
  product: SUM and COUNT go to ``sc_ops.contract_op`` (semiring_contract),
  TROPICAL_MIN/MAX to ``tc_ops.contract_op`` (tropical_contract).  On a
  CUDA device those launch the hand-written kernels, with no cost gate;
  every other dense contraction runs ``factor.contract`` in plain torch.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.kernels import costs as kernel_costs
from repro_torch.kernels.launch import unit_strides
from repro_torch.kernels.segment_aggregate import ops as seg_ops
from repro_torch.kernels.semiring_contract import ops as sc_ops
from repro_torch.kernels.tropical_contract import ops as tc_ops
from repro_torch.relational.relation import LRU, Predicate

from . import semiring as sr
from .factor import Factor, contract


# widest γ-domain product one union-carry calibration pass may carry when
# neither the env nor the card's cost profile says otherwise (the
# reference's static default)
UNION_BUDGET = 512

# A level launch concatenates its members' rowwise fields (rows × carried γ
# lanes), padded to the widest.  Past ROWWISE_MAX_ELEMS elements (8 GiB of
# float32, a tenth of an 80 GB card: the gathers and products around the
# operands take a few times more) the level plan splits its members over
# several level_segment_aggregate launches; a member past it on its own
# still goes out in one launch (chip_smoke.py's serving phase has one: a
# 336-lane calibration message over 2^23 rows, 11.3 GB of float32).  A
# single contraction past it reduces its rows a block at a time and ⊕-adds
# the partial aggregates (chip_smoke.py's cube phase: a 4,368-lane cuboid
# over 2^23 flights would be 147 GB in one piece).
ROWWISE_MAX_ELEMS = 1 << 31


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """The device an engine runs on: ``cuda`` unless the caller asks for
    another.  Raises when CUDA is asked for (explicitly or by default) and
    no card is present — the caller must pass ``device="cpu"`` then."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def _env_flag(name: str) -> bool:
    return os.environ.get(name, "1").lower() not in ("0", "false")


def use_plans_default() -> bool:
    """Env-gated default for the plan cache (``REPRO_USE_PLANS``; 0 runs the
    plain reference contractions)."""
    return _env_flag("REPRO_USE_PLANS")


def batch_fanout_default() -> bool:
    """Env-gated default for batched crossfilter fan-out
    (``REPRO_BATCH_FANOUT``)."""
    return _env_flag("REPRO_BATCH_FANOUT")


def batch_calibration_default() -> bool:
    """Env-gated default for level-batched calibration passes
    (``REPRO_BATCH_CALIBRATION``).  When off — or when plans are off —
    calibration degrades to the per-edge loop."""
    return _env_flag("REPRO_BATCH_CALIBRATION")


def fuse_level_default() -> bool:
    """Env-gated default for level-fused launches (``REPRO_FUSE_LEVEL_KERNEL``).
    When on — and plans plus level batching are on — every kernel-route
    message of a calibration level shares one ``level_aggregate`` launch;
    when off, each batch group of the level is its own call
    (``PlanCache.run_message_batch``)."""
    return _env_flag("REPRO_FUSE_LEVEL_KERNEL")


def calibration_union_budget() -> int:
    """Max product of γ domain sizes one union-carry calibration query may
    accumulate: ``REPRO_CALIBRATION_UNION_BUDGET``, else the card's measured
    knee from the cost profile (``kernels/costs.py``), else ``UNION_BUDGET``.
    Read on every call, as the reference does."""
    env = os.environ.get("REPRO_CALIBRATION_UNION_BUDGET")
    if env is not None:
        return int(env)
    derived = kernel_costs.derived_union_budget()
    return derived if derived is not None else UNION_BUDGET


def sparse_batch_elems() -> int:
    """Max rows·width volume one batched absorption launch may carry
    (``REPRO_SPARSE_BATCH_ELEMS``; 0 = unbounded; the reference's default
    2^18).  Wider groups split into chunks of at least 2 members."""
    env = os.environ.get("REPRO_SPARSE_BATCH_ELEMS")
    if env is not None:
        return int(env)
    return 1 << 18


def expand_rows_field(field: sr.Field, have: Sequence[str], want: Sequence[str],
                      trailing: Sequence[int]) -> sr.Field:
    """Insert size-1 axes so leaves go (N, *have_dims, *t) → (N, *want_dims, *t).

    ``have`` must be a subsequence of ``want``; trailing statistic dims ride
    along unchanged.
    """
    out = []
    for leaf, _t in zip(sr.leaves(field), trailing):
        cur = list(leaf.shape)
        new_shape = [cur[0]]
        hi = 1
        for a in want:
            if a in have:
                new_shape.append(cur[hi])
                hi += 1
            else:
                new_shape.append(1)
        new_shape += cur[hi:]
        out.append(leaf.reshape(new_shape))
    return sr.like(field, out)


def _field_struct(field: sr.Field) -> tuple:
    return tuple((tuple(leaf.shape), str(leaf.dtype)) for leaf in sr.leaves(field))


@dataclasses.dataclass
class PlanStats:
    """Cumulative plan-cache counters (exposed via ``Treant.cache_stats``)."""

    plans_built: int = 0     # structural misses → new plan callable
    plan_hits: int = 0       # executions served by a cached plan
    kernel_execs: int = 0    # executions whose ⊕-reduction takes the kernel route
    fallback_execs: int = 0  # executions reduced with plain torch
    # batched absorption (run_sparse_batch): one level_aggregate launch each
    batched_execs: int = 0        # batched calls dispatched
    batched_absorptions: int = 0  # absorptions served by those calls (Σ widths)
    batch_width: int = 0          # widest batch observed (max, not a sum)
    # level-batched calibration: groups of >1 same-structure messages inside
    # one level call, and calibration's message dispatches in total
    level_batched_execs: int = 0
    level_batched_messages: int = 0
    level_batch_width: int = 0       # widest group observed (max, not a sum)
    calibration_dispatches: int = 0
    # level-fused launches: every kernel-route message of a calibration level
    # ⊕-reduced by ONE level_aggregate call
    fused_level_launches: int = 0
    fused_level_messages: int = 0
    # cross-session batched fan-out: batched calls whose members span >1
    # session, and the widest distinct-session count observed
    cross_session_execs: int = 0
    cross_session_width: int = 0
    # bin cubes (core/predictive.py): think-time γ∪{dim} materializations
    # built through this engine, and warm brushes served by slicing one
    # (select + ⊕-marginalize — no plan execution, no store probe)
    cube_builds: int = 0
    cube_slices: int = 0

    # counters that are high-water marks, not sums
    MAX_FIELDS = ("batch_width", "level_batch_width", "cross_session_width")

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# bin-cube slicing: σ as select, then ⊕-marginalize the brush dimension away
# ---------------------------------------------------------------------------

_DEVICE_MASKS = LRU(1024)


def _device_mask(mask, device: torch.device) -> torch.Tensor:
    """Content-addressed device copy of a σ mask, keyed by its bytes, shape,
    dtype and device: the same predicate fans out to every sibling viz, so
    without this each viz pays its own host→device copy of an identical
    (tiny) mask."""
    arr = np.ascontiguousarray(np.asarray(mask))
    key = (arr.tobytes(), arr.shape, str(arr.dtype), str(device))
    m = _DEVICE_MASKS.get(key)
    if m is None:
        m = torch.from_numpy(arr.copy()).to(device)
        _DEVICE_MASKS.put(key, m)
    return m


def _slice(cube: Factor, dim: str, masks, group_by) -> Factor:
    f = cube
    for m in masks:
        f = f.select(dim, _device_mask(m, cube.device))
    return f.project_to(tuple(group_by))


def slice_bin_cube(cube: Factor, dim: str, masks, group_by,
                   stats: PlanStats | None = None) -> Factor:
    """Serve a brush from a parked γ∪{dim} bin cube: σ as ``select`` (0̄ is
    the ⊕-identity, so zero-annotating non-matching bins is exact for every
    semiring) then ⊕-marginalize ``dim`` away via ``project_to``.  With no
    masks this serves ``ClearFilter`` (pure marginalization).  O(bins) work
    in plain torch on the cube's device — no store probes, no plan
    executions."""
    f = _slice(cube, dim, masks, group_by)
    if stats is not None:
        stats.cube_slices += 1
    return f


def slice_bin_cubes(items, stats: PlanStats | None = None) -> list[Factor]:
    """Batched :func:`slice_bin_cube`: ``items`` is a list of
    (cube_factor, dim, masks, group_by); returns the sliced factors in
    order."""
    out = [_slice(cube, dim, masks, gb) for cube, dim, masks, gb in items]
    if stats is not None:
        stats.cube_slices += len(items)
    return out


@dataclasses.dataclass(frozen=True)
class _Plan:
    fn: Callable
    uses_kernel: bool
    # level plans only: per-group kernel routing + Σ width of fused groups
    group_kernel: tuple = ()
    fused_messages: int = 0


# ---------------------------------------------------------------------------
# sparse-bag plan: gather ⊗ rowwise → σ row mask → segment-⊕ → reshape
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _SparseMeta:
    """Static facts about one sparse contraction that the level plan needs
    to route its rowwise output through the fused kernel."""

    total: int                       # flattened local-out segment count
    carried_dims: tuple[int, ...]    # γ-carried dims of the rowwise output
    use_kernel: bool


def _sparse_plan_parts(
    ring: sr.Semiring,
    rel_attrs: tuple[str, ...],
    doms: dict[str, int],
    in_attrs_list: tuple[tuple[str, ...], ...],
    pred_attrs: tuple[str, ...],
    out_attrs: tuple[str, ...],
    n: int,
) -> tuple[Callable, Callable, Callable, _SparseMeta]:
    """One contraction as (fn, rowwise, finalize, meta): ``fn`` runs all of
    it; the level plan runs ``rowwise`` per message, hands the segment
    reductions of the whole level to one kernel launch, then ``finalize``."""
    rel_set = set(rel_attrs)
    local_out = tuple(a for a in out_attrs if a in rel_set)
    total = int(np.prod([doms[a] for a in local_out])) if local_out else 1

    # static replay of the carried-γ evolution across incoming messages
    steps: list[tuple[tuple, tuple, tuple, tuple, tuple]] = []
    carried: tuple[str, ...] = ()
    for m_attrs in in_attrs_list:
        shared = tuple(a for a in m_attrs if a in rel_set)
        extra = tuple(a for a in m_attrs if a not in rel_set)
        want = carried + tuple(a for a in extra if a not in carried)
        steps.append((m_attrs, shared, extra, carried, want))
        carried = want
    carried_dims = tuple(doms[a] for a in carried)
    carried_out = [a for a in out_attrs if a not in rel_set]
    assert set(carried_out) <= set(carried), (
        f"carried attrs {carried_out} not available (have {list(carried)})"
    )

    op = ring.kernel_segment_op
    use_kernel = (
        op is not None
        and ring.dtype == torch.float32
        and all(t == 0 for t in ring.trailing)
        and n > 0
    )
    out_shape = tuple(doms[a] for a in local_out)

    def rowwise(vals, in_fields, in_idx, pred_masks, pred_codes):
        rows = sr.leaves(vals)[0].shape[0]
        for (m_attrs, shared, extra, have, want), field, idx in zip(steps, in_fields, in_idx):
            mp = Factor(m_attrs, field, ring).project_to(shared + extra)
            dims = [doms[a] for a in shared]

            def gather(leaf):
                lead = leaf.reshape(
                    (int(np.prod(dims)) if shared else 1,) + tuple(leaf.shape[len(shared):])
                )
                if shared:
                    return lead.index_select(0, idx)
                return lead.expand((rows,) + tuple(lead.shape[1:]))

            g = sr.like(mp.field, [gather(leaf) for leaf in sr.leaves(mp.field)])
            vals = ring.mul(
                expand_rows_field(vals, have, want, ring.trailing),
                expand_rows_field(g, extra, want, ring.trailing),
            )
        if pred_attrs:
            # σ as a rowwise ⊗ with 0̄/1̄: gather each domain mask at the row codes
            rowm = pred_masks[0][pred_codes[0]]
            for mask, codes in zip(pred_masks[1:], pred_codes[1:]):
                rowm = rowm & mask[codes]
            vals = sr.like(vals, [
                leaf.masked_fill(~rowm.reshape((rows,) + (1,) * (leaf.dim() - 1)), z)
                for leaf, z in zip(sr.leaves(vals), ring.zero_values)
            ])
        return vals

    def finalize(field):
        field = sr.field_map(lambda leaf: leaf.reshape(out_shape + tuple(leaf.shape[1:])), field)
        return Factor(local_out + carried, field, ring).project_to(out_attrs)

    lanes = int(np.prod(carried_dims)) if carried_dims else 1

    def reduce(vals, in_fields, in_idx, pred_masks, pred_codes, seg_idx):
        vals = rowwise(vals, in_fields, in_idx, pred_masks, pred_codes)
        if use_kernel:
            return _unstack(seg_ops.aggregate_op(seg_idx, _slab(vals, seg_idx.shape[0]), total,
                                                 op=op), vals, total, carried_dims)
        return ring.segment_reduce(vals, seg_idx, total)

    def fn(vals, in_fields, in_idx, pred_masks, pred_codes, seg_idx):
        # the rowwise field holds rows × carried lanes × the lift's elements
        # per row: past ROWWISE_MAX_ELEMS, reduce a block of rows at a time
        # and ⊕ the partial aggregates
        per_row = lanes * sum(leaf[0].numel() for leaf in sr.leaves(vals))
        step = max(1, ROWWISE_MAX_ELEMS // max(per_row, 1))
        if step >= n:
            return finalize(reduce(vals, in_fields, in_idx, pred_masks, pred_codes, seg_idx))
        field = None
        for lo in range(0, n, step):
            rs = slice(lo, min(n, lo + step))
            part = reduce(sr.field_map(lambda leaf: leaf[rs], vals), in_fields,
                          tuple(None if i is None else i[rs] for i in in_idx), pred_masks,
                          tuple(c[rs] for c in pred_codes), seg_idx[rs])
            field = part if field is None else ring.add(field, part)
        return finalize(field)

    meta = _SparseMeta(total=total, carried_dims=carried_dims, use_kernel=use_kernel)
    return fn, rowwise, finalize, meta


def _slab(vals: sr.Field, n: int) -> torch.Tensor:
    """Rowwise field → one (n, V) value slab; compound rings (MOMENTS) stack
    their equal-shape leaves as extra columns so they share ONE segment pass."""
    ls = [leaf.reshape(n, -1) for leaf in sr.leaves(vals)]
    return (ls[0] if len(ls) == 1 else torch.cat(ls, dim=1)).contiguous()


def _unstack(agg: torch.Tensor, like_field: sr.Field, total: int,
             carried_dims: tuple[int, ...]) -> sr.Field:
    """Split a reduced (total, V) slab back into the field's leaves."""
    k = len(sr.leaves(like_field))
    parts = torch.tensor_split(agg, k, dim=1) if k > 1 else (agg,)
    return sr.like(like_field, [p.reshape((total,) + carried_dims) for p in parts])


def _build_sparse_plan(ring, rel_attrs, doms, in_attrs_list, pred_attrs, out_attrs, n) -> _Plan:
    fn, _, _, meta = _sparse_plan_parts(
        ring, rel_attrs, doms, in_attrs_list, pred_attrs, out_attrs, n
    )
    return _Plan(fn=fn, uses_kernel=meta.use_kernel)


# ---------------------------------------------------------------------------
# batch groups: same-structure contractions that differ only in γ and σ
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AbsorbItem:
    """One pending sparse-bag contraction, deferred so siblings can batch.

    ``rel`` is the (single) relation of the bag, ``vals`` its per-row lift,
    ``incoming`` the messages from every neighbor in play, ``preds`` the σ
    placed on this bag, ``out_attrs`` the contraction's output attrs.
    """

    rel: object                      # relational.Relation
    vals: sr.Field
    incoming: tuple[Factor, ...]
    preds: tuple[Predicate, ...]
    out_attrs: tuple[str, ...]


@dataclasses.dataclass
class _GroupSpec:
    """One canonicalized batch group: members in canonical order plus all
    the statics the level plan builder consumes."""

    items: list
    stats: list | None
    in_canon: tuple
    out_canon: tuple
    member_dims: tuple
    doms: dict
    pred_attrs: tuple
    inverse: dict          # canonical position → caller position
    key: tuple             # version-free plan key

    @property
    def statics(self) -> tuple:
        """The group's entry of ``_level_plan_parts``' ``group_statics``."""
        rel = self.items[0].rel
        return (rel.attrs, self.doms, self.in_canon, self.pred_attrs, self.out_canon,
                rel.row_bucket, self.member_dims)


def _canon_absorption(item: AbsorbItem) -> tuple[tuple, tuple, dict[str, str]]:
    """Canonicalize off-bag (γ-carried) attrs to positional placeholders.

    Two contractions batch iff they differ only in *which* off-bag attr each
    structural slot carries (and its domain size).  Placeholders are assigned
    in first-appearance order scanning incoming messages then out_attrs.
    """
    rel_set = set(item.rel.attrs)
    ph: dict[str, str] = {}

    def c(a: str) -> str:
        if a in rel_set:
            return a
        if a not in ph:
            ph[a] = f"·{len(ph)}"
        return ph[a]

    in_canon = tuple(tuple(c(a) for a in m.attrs) for m in item.incoming)
    out_canon = tuple(c(a) for a in item.out_attrs)
    return in_canon, out_canon, ph


def absorb_batch_key(ring: sr.Semiring, item: AbsorbItem) -> tuple:
    """Grouping key for batchable contractions (the *batch signature*):
    relation version and layout, σ attrs, canonical incoming/out patterns and
    the lift's field structure.  Placeholder domain sizes are absent."""
    in_canon, out_canon, _ = _canon_absorption(item)
    rel = item.rel
    return (
        "sparse_batch", ring.name, rel.key, rel.attrs,
        tuple(rel.domains[a] for a in rel.attrs), rel.num_rows,
        in_canon, tuple(p.attr for p in item.preds), out_canon,
        _field_struct(item.vals),
    )


# ---------------------------------------------------------------------------
# level-fused plan: EVERY group of a calibration level in one call, all
# kernel-route messages sharing a single level_aggregate launch
# ---------------------------------------------------------------------------

def _level_plan_parts(ring: sr.Semiring, group_statics: tuple) -> tuple:
    """The level body as ``(lfn, group_kernel, fused_messages)``.

    ``group_statics[g]`` is ``(rel_attrs, doms, in_canon, pred_attrs,
    out_canon, n, member_dims)``: canonical placeholders, with each member's
    own placeholder sizes in ``member_dims``.  Members of a group run their
    rowwise stage (gather ⊗ σ) one after another, at their own sizes, so no
    padding is needed; every kernel-route member of every group then
    contributes its ``(seg_idx, slab, num_segments)`` to ONE
    ``level_aggregate`` launch — or to several, in member order, when the
    launch's padded operands would pass ``ROWWISE_MAX_ELEMS``.  Other
    members ⊕-reduce with plain torch.
    """
    parts = []
    for (rel_attrs, doms, in_canon, pred_attrs, out_canon, n, member_dims) in group_statics:
        members = [
            _sparse_plan_parts(ring, rel_attrs, {**doms, **md}, in_canon, pred_attrs,
                               out_canon, n)
            for md in member_dims
        ]
        parts.append((members, members[0][3].use_kernel, n))
    group_kernel = tuple(use for _, use, _ in parts)
    fused_messages = sum(len(members) for members, use, _ in parts if use)
    op = ring.kernel_segment_op

    def lfn(groups_args):
        results: list = [[None] * len(members) for members, _, _ in parts]
        pending: list = []     # kernel-route members waiting for the next launch
        rows = width = 0       # their row count and widest slab

        def launch():
            items = [(seg_idx, slab, meta.total) for _, _, _, seg_idx, slab, meta in pending]
            for (g, b, rv, _, _, meta), agg in zip(pending,
                                                   seg_ops.level_aggregate(items, op=op)):
                finalize = parts[g][0][b][2]
                results[g][b] = finalize(_unstack(agg, rv, meta.total, meta.carried_dims))
            pending.clear()

        for g, ((members, use_kernel, n), args) in enumerate(zip(parts, groups_args)):
            vals_list, in_fields_list, in_idx, pred_masks_list, pred_codes, seg_idx = args
            for b, (fn, rowwise, _, meta) in enumerate(members):
                if not use_kernel:
                    results[g][b] = fn(vals_list[b], in_fields_list[b], in_idx,
                                       pred_masks_list[b], pred_codes, seg_idx)
                    continue
                rv = rowwise(vals_list[b], in_fields_list[b], in_idx,
                             pred_masks_list[b], pred_codes)
                slab = _slab(rv, n)
                # the launch's operands are the members' slabs concatenated and
                # padded to the widest: past ROWWISE_MAX_ELEMS, launch what is
                # pending first
                w = max(width, slab.shape[1])
                if pending and (rows + n) * w > ROWWISE_MAX_ELEMS:
                    launch()
                    rows, w = 0, slab.shape[1]
                pending.append((g, b, rv, seg_idx, slab, meta))
                rows, width = rows + n, w
        if pending:
            launch()
        return tuple(tuple(r) for r in results)

    return lfn, group_kernel, fused_messages


def _build_level_plan(ring: sr.Semiring, group_statics: tuple) -> _Plan:
    lfn, group_kernel, fused_messages = _level_plan_parts(ring, group_statics)
    return _Plan(fn=lfn, uses_kernel=any(group_kernel), group_kernel=group_kernel,
                 fused_messages=fused_messages)


# ---------------------------------------------------------------------------
# dense-bag plan: σ selects → contract (matmul-split kernels / plain torch)
# ---------------------------------------------------------------------------

def _matmul_split(structs, out: tuple[str, ...]):
    """Decompose a 2-factor contraction as (free1, contracted) × (contracted,
    free2) if no shared attr survives to the output (no batch dims)."""
    (a1, d1), (a2, d2) = structs
    doms = {**dict(zip(a1, d1)), **dict(zip(a2, d2))}
    shared = tuple(a for a in a1 if a in set(a2))
    out_set = set(out)
    if not shared or (out_set & set(shared)):
        return None
    free1 = tuple(a for a in a1 if a in out_set)
    free2 = tuple(a for a in a2 if a in out_set)
    return shared, free1, free2, doms


def _kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where the contract kernels read it in place (one
    unit-stride axis: a transposed factor is read as it lies), else a copy."""
    return t if unit_strides(t.shape, t.stride()) is not None else t.contiguous()


def _build_dense_plan(
    ring: sr.Semiring,
    structs: tuple[tuple[tuple[str, ...], tuple[int, ...]], ...],
    pred_spec: tuple[tuple[str, int], ...],
    out_attrs: tuple[str, ...],
) -> _Plan:
    avail = {a for attrs, _ in structs for a in attrs}
    out = tuple(a for a in out_attrs if a in avail)
    # tropical MIN/MAX shares the matmul decomposition: its ⊗ is +, so the
    # (free1, shared) × (shared, free2) split maps 1:1 onto tropical_contract
    tropical = ring.kernel_segment_op in ("min", "max")
    split = None
    if (
        (ring.is_arithmetic or tropical)
        and len(ring.trailing) == 1
        and ring.dtype == torch.float32
        and len(structs) == 2
    ):
        split = _matmul_split(structs, out)

    def fn(fields, pred_masks):
        factors = [Factor(attrs, f, ring) for (attrs, _), f in zip(structs, fields)]
        for (attr, fidx), mask in zip(pred_spec, pred_masks):
            factors[fidx] = factors[fidx].select(attr, mask)
        if split is None:
            return contract(factors, out, ring)
        shared, free1, free2, doms = split
        f1sz = int(np.prod([doms[a] for a in free1])) if free1 else 1
        f2sz = int(np.prod([doms[a] for a in free2])) if free2 else 1
        csz = int(np.prod([doms[a] for a in shared]))
        m = _kernel_operand(factors[0].project_to(free1 + shared).field.reshape(f1sz, csz))
        r = _kernel_operand(factors[1].project_to(shared + free2).field.reshape(csz, f2sz))
        if tropical:
            o = tc_ops.contract_op(m, r, is_min=ring.kernel_segment_op == "min")
        else:
            o = sc_ops.contract_op(m, r, None)
        field = o.reshape(tuple(doms[a] for a in free1) + tuple(doms[a] for a in free2))
        return Factor(free1 + free2, field, ring).project_to(out)

    return _Plan(fn=fn, uses_kernel=split is not None)


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------

class PlanCache:
    """Plan cache for bag contractions (one per engine/ring, one device).

    Holds four LRU-bounded caches: plans, per-row lifts, densified factors
    and σ domain masks, the last three on ``device``.  Keys are
    content-addressed by (relation, version, …) or predicate digest, so
    nothing ever needs invalidation.
    """

    def __init__(
        self,
        ring: sr.Semiring,
        device: torch.device | str | None = None,
        plan_capacity: int = 256,
        lift_capacity: int = 128,
        factor_capacity: int = 128,
        mask_capacity: int = 512,
    ):
        self.ring = ring
        self.device = resolve_device(device)
        self._plans = LRU(plan_capacity)
        self._lifts = LRU(lift_capacity)
        self._factors = LRU(factor_capacity)
        self._masks = LRU(mask_capacity)
        self.stats = PlanStats()

    # -- device-resident input caches ---------------------------------------
    def mask_dev(self, pred: Predicate) -> torch.Tensor:
        m = self._masks.get(pred.digest)
        if m is None:
            m = torch.as_tensor(pred.mask, device=self.device)
            self._masks.put(pred.digest, m)
        return m

    def lift_cached(self, key: tuple, compute: Callable[[], sr.Field]) -> sr.Field:
        v = self._lifts.get(key)
        if v is None:
            v = compute()
            self._lifts.put(key, v)
        return v

    def factor_cached(self, key: tuple, compute: Callable[[], Factor]) -> Factor:
        v = self._factors.get(key)
        if v is None:
            v = compute()
            self._factors.put(key, v)
        return v

    # -- plan execution ------------------------------------------------------
    def _account(self, uses_kernel: bool, built: bool, stats) -> None:
        if built:
            self.stats.plans_built += 1
        else:
            self.stats.plan_hits += 1
        if uses_kernel:
            self.stats.kernel_execs += 1
        else:
            self.stats.fallback_execs += 1
        if stats is not None:
            stats.plan_traces += int(built)
            stats.plan_hits += int(not built)
            stats.kernel_execs += int(uses_kernel)

    def sparse_key(self, rel, vals: sr.Field, incoming: Sequence[Factor],
                   preds: Sequence[Predicate], out_attrs: Sequence[str]) -> tuple:
        return (
            "sparse",
            self.ring.name,
            rel.attrs,
            tuple(rel.domains[a] for a in rel.attrs),
            rel.row_bucket,
            tuple((m.attrs, m.domain_shape) for m in incoming),
            tuple(p.attr for p in preds),
            tuple(out_attrs),
            _field_struct(vals),
        )

    def run_sparse(
        self,
        catalog,
        rel,
        vals: sr.Field,
        incoming: Sequence[Factor],
        preds: Sequence[Predicate],
        out_attrs: tuple[str, ...],
        stats=None,
    ) -> Factor:
        key = self.sparse_key(rel, vals, incoming, preds, out_attrs)
        entry = self._plans.get(key)
        built = entry is None
        if built:
            doms = dict(rel.domains)
            for m in incoming:
                doms.update(m.domains)
            entry = _build_sparse_plan(
                self.ring, rel.attrs, doms, tuple(m.attrs for m in incoming),
                tuple(p.attr for p in preds), tuple(out_attrs), rel.row_bucket,
            )
            self._plans.put(key, entry)
        rel_set = set(rel.attrs)
        in_fields, in_idx = [], []
        for m in incoming:
            shared = tuple(a for a in m.attrs if a in rel_set)
            in_fields.append(m.field)
            in_idx.append(catalog.dev_flat_codes(rel, shared, self.device)[0] if shared else None)
        pred_masks = tuple(self.mask_dev(p) for p in preds)
        pred_codes = tuple(catalog.dev_flat_codes(rel, (p.attr,), self.device)[0] for p in preds)
        local_out = tuple(a for a in out_attrs if a in rel_set)
        seg_idx, _ = catalog.dev_flat_codes(rel, local_out, self.device)
        out = entry.fn(vals, tuple(in_fields), tuple(in_idx), pred_masks, pred_codes, seg_idx)
        self._account(entry.uses_kernel, built, stats)
        return out

    def run_level(
        self,
        catalog,
        item_groups: Sequence[Sequence[AbsorbItem]],
        stats_groups: Sequence[Sequence] | None = None,
    ) -> list[list[Factor]]:
        """Execute ALL of one calibration level's batch groups as ONE call.

        ``item_groups`` are the :func:`absorb_batch_key` groups of a level —
        independent by construction (same-level messages never read each
        other).  Every kernel-route message of the level is ⊕-reduced by a
        single ``level_aggregate`` launch.  Returns the per-group factor lists
        in the caller's group and member order.
        """
        specs = [
            self._group_spec(items, stats_groups[i] if stats_groups else None)
            for i, items in enumerate(item_groups)
        ]
        # canonical group order: σ-variants can permute a level's groups
        # without changing its structure
        order = sorted(range(len(specs)), key=lambda i: repr(specs[i].key))
        key = ("level", self.ring.name, tuple(specs[i].key for i in order))
        entry = self._plans.get(key)
        built = entry is None
        if built:
            entry = _build_level_plan(self.ring, tuple(specs[i].statics for i in order))
            self._plans.put(key, entry)
        outs = entry.fn(tuple(self._group_args(catalog, specs[i]) for i in order))
        if entry.uses_kernel:
            self.stats.fused_level_launches += 1
            self.stats.fused_level_messages += entry.fused_messages
        results: list[list[Factor] | None] = [None] * len(specs)
        for pos, i in enumerate(order):
            spec = specs[i]
            width = len(spec.items)
            group_uses_kernel = entry.group_kernel[pos]
            if width > 1:
                self.stats.level_batched_execs += 1
                self.stats.level_batched_messages += width
                self.stats.level_batch_width = max(self.stats.level_batch_width, width)
            group_results = []
            for it, f, stats in zip(spec.items, outs[pos], spec.stats or [None] * width):
                # rename canonical placeholders back to the member's attrs
                group_results.append(Factor(it.out_attrs, f.field, self.ring))
                self._account(group_uses_kernel, built, stats)
                if stats is not None and width > 1:
                    stats.level_batched_execs += 1
                    stats.level_batch_width = max(stats.level_batch_width, width)
                built = False  # one plan build per level call, not per member
            # undo the member sort: caller expects its own member order
            results[i] = [group_results[spec.inverse[o]] for o in range(width)]
        return results  # type: ignore[return-value]

    def run_sparse_batch(
        self,
        catalog,
        items: Sequence[AbsorbItem],
        stats_list: Sequence | None = None,
    ) -> list[Factor]:
        """Execute a group of batch-compatible absorptions as one call.

        Every item shares one :func:`absorb_batch_key` (the caller groups);
        members differ only in γ-carried attrs, σ mask contents and incoming
        factor values.  The call is the level plan of one group: every
        kernel-route member's segment reduction goes to ONE
        ``level_aggregate`` launch.  Results are bit-identical to
        ``run_sparse`` per member on integer-valued data.
        """
        return self._run_batch(catalog, items, stats_list, calibration=False)

    def run_message_batch(
        self,
        catalog,
        items: Sequence[AbsorbItem],
        stats_list: Sequence | None = None,
    ) -> list[Factor]:
        """Execute one batch group of a calibration level as one call (the
        unfused level path, ``fuse_level_kernel=False``).

        A message Y(u→v) is the same bag contraction as an absorption with
        ``out_attrs = separator ∪ γ-carry``, so this is
        :meth:`run_sparse_batch`'s machinery with ``level_batched_*``
        accounting instead of ``batched_*``: one ``level_aggregate`` launch
        per group.
        """
        return self._run_batch(catalog, items, stats_list, calibration=True)

    def _run_batch(self, catalog, items: Sequence[AbsorbItem], stats_list: Sequence | None,
                   calibration: bool) -> list[Factor]:
        assert len(items) >= 2, "batch of one: use run_sparse"
        spec = self._group_spec(items, stats_list)
        entry = self._plans.get(spec.key)
        built = entry is None
        if built:
            entry = _build_level_plan(self.ring, (spec.statics,))
            self._plans.put(spec.key, entry)
        (outs,) = entry.fn((self._group_args(catalog, spec),))
        width = len(spec.items)
        if calibration:
            self.stats.level_batched_execs += 1
            self.stats.level_batched_messages += width
            self.stats.level_batch_width = max(self.stats.level_batch_width, width)
        else:
            self.stats.batched_execs += 1
            self.stats.batched_absorptions += width
            self.stats.batch_width = max(self.stats.batch_width, width)
        results = []
        for it, f, stats in zip(spec.items, outs, spec.stats or [None] * width):
            # rename canonical placeholders back to the member's attrs
            results.append(Factor(it.out_attrs, f.field, self.ring))
            self._account(entry.uses_kernel, built, stats)
            built = False  # one plan build per batched call, not per member
            if stats is None:
                continue
            if calibration:
                stats.level_batched_execs += 1
                stats.level_batch_width = max(stats.level_batch_width, width)
            else:
                stats.batched_absorptions += 1
                stats.batch_width = max(stats.batch_width, width)
        # undo the member sort: caller expects its own member order
        return [results[spec.inverse[o]] for o in range(width)]

    def _group_spec(self, items: Sequence[AbsorbItem], stats_list: Sequence | None) -> _GroupSpec:
        """Canonicalize one batch group: sorted member order, group-max
        placeholder dims and the version-free plan key."""
        rel = items[0].rel
        canons = [_canon_absorption(it) for it in items]
        in_canon, out_canon, _ = canons[0]
        member_dims = []
        for it, (_, _, ph) in zip(items, canons):
            adoms: dict[str, int] = {}
            for m in it.incoming:
                adoms.update(m.domains)
            member_dims.append({p: adoms[a] for a, p in ph.items()})
        # canonical member order (by γ-dim signature): the plan key bakes in
        # the per-member dims positionally
        order = sorted(range(len(items)), key=lambda i: tuple(sorted(member_dims[i].items())))
        items = [items[o] for o in order]
        member_dims = tuple(member_dims[o] for o in order)
        if stats_list is not None:
            stats_list = [stats_list[o] for o in order]
        inverse = {o: i for i, o in enumerate(order)}
        padded = {p: max(md[p] for md in member_dims) for p in (member_dims[0] or {})}
        doms = dict(rel.domains)
        doms.update(padded)
        pred_attrs = tuple(p.attr for p in items[0].preds)
        key = (
            "sparse_batch", self.ring.name, rel.attrs,
            tuple(rel.domains[a] for a in rel.attrs), rel.row_bucket,
            in_canon, pred_attrs, out_canon, _field_struct(items[0].vals),
            tuple(tuple(sorted(md.items())) for md in member_dims),
        )
        return _GroupSpec(
            items=items, stats=stats_list, in_canon=in_canon, out_canon=out_canon,
            member_dims=member_dims, doms=doms, pred_attrs=pred_attrs, inverse=inverse,
            key=key,
        )

    def _group_args(self, catalog, spec: _GroupSpec) -> tuple:
        """Device-resident runtime inputs for one group, in the (vals_list,
        in_fields_list, in_idx, pred_masks_list, pred_codes, seg_idx) layout
        the level plan takes."""
        items = spec.items
        rel = items[0].rel
        rel_set = set(rel.attrs)
        in_idx = tuple(
            catalog.dev_flat_codes(rel, tuple(a for a in m.attrs if a in rel_set), self.device)[0]
            if any(a in rel_set for a in m.attrs) else None
            for m in items[0].incoming
        )
        pred_codes = tuple(
            catalog.dev_flat_codes(rel, (p.attr,), self.device)[0] for p in items[0].preds
        )
        local_out = tuple(a for a in items[0].out_attrs if a in rel_set)
        seg_idx, _ = catalog.dev_flat_codes(rel, local_out, self.device)
        return (
            tuple(it.vals for it in items),
            tuple(tuple(m.field for m in it.incoming) for it in items),
            in_idx,
            tuple(tuple(self.mask_dev(p) for p in it.preds) for it in items),
            pred_codes,
            seg_idx,
        )

    def run_dense(
        self,
        factors: Sequence[Factor],
        preds: Sequence[Predicate],
        out_attrs: tuple[str, ...],
        stats=None,
    ) -> Factor:
        """Contract a dense bag's factors under its σ to ``out_attrs``."""
        structs = tuple((f.attrs, f.domain_shape) for f in factors)
        avail = {a for f in factors for a in f.attrs}
        pred_spec = []
        for p in preds:
            if p.attr not in avail:  # pragma: no cover — placement guarantees
                raise KeyError(f"σ({p.attr}) not available in bag")
            pred_spec.append(
                (p.attr, next(i for i, f in enumerate(factors) if p.attr in f.attrs))
            )
        pred_spec = tuple(pred_spec)
        key = ("dense", self.ring.name, structs, pred_spec, tuple(out_attrs))
        entry = self._plans.get(key)
        built = entry is None
        if built:
            entry = _build_dense_plan(self.ring, structs, pred_spec, tuple(out_attrs))
            self._plans.put(key, entry)
        out = entry.fn(tuple(f.field for f in factors), tuple(self.mask_dev(p) for p in preds))
        self._account(entry.uses_kernel, built, stats)
        return out

    def __len__(self):
        return len(self._plans)

    def reset_stats(self):
        self.stats = PlanStats()
