"""Wrappers of the segment-aggregate kernels: the calls the plan layer makes.

A wrapper given CPU tensors computes the plain PyTorch version (``ref.py``);
given CUDA tensors it checks them, allocates the output filled with the
⊕-identity, launches the hand-written kernel on the current stream and
counts the launch in :data:`LAUNCHES`.  There is no fallback: a CUDA input
the kernel does not take, a failed build or a refused launch raises.

Float sums repeat bit for bit: a message's sum is taken in an order fixed
by its own (codes, values) — whichever wrapper, launch, stream or card
computes it (``csrc/segment_aggregate.cuh``).  A message with many segments
is reduced segment-major over a stable row order (:func:`row_order`), built
with ``torch.sort`` once per codes tensor and kept while that tensor lives
(:func:`cached_row_order`): the plan layer's codes are cached per relation
version and output attributes (``Catalog.dev_flat_codes``), so each order is
built once per version, and once per shard row block (a view of the cached
codes) on a sharded plan.

Such a message's values can also arrive in code order (``ordered=True``:
row i is row ``perm[i]`` of the message): the kernel then reads them in
place, and the bits are those of the same message read through its order.
The plan layer gets them so by permuting its rowwise inputs once per cached
order (:func:`code_order`, :func:`in_code_order`, each copy kept while both
the codes and the input live), so its gather ⊗ σ writes the slab in code
order.  A lift's copies die with the lift, when the plan cache drops it.

A message's values can also come as a :class:`Recipe` instead of a slab:
the lift, the gathered messages and the σ predicates that the plan layer's
rowwise stage would combine into the slab.  The kernels then compute each
value where they would have read it, in the same order, so the output has
the bits of the same message reduced from the slab (``ref.py``'s
:func:`~.ref.recipe_values` materializes a recipe as the rowwise stage
does); no (N, V) field is written.

Sharded composition: both :func:`aggregate_op` and :func:`level_aggregate`
are *shard-local* — under ``repro_torch.core.distributed.shard_map`` they
see the shard's row block (codes and value slab sliced on the leading
axis; segment ids stay global) and produce a full ``(num_segments, v)``
partial that the caller ⊕-folds over the mesh (``+``/min/max; see
``distributed.ring_collective``).  ⊕-identity row padding makes any equal
block split of a padded row bucket exact.  Each shard's call launches on
the shard's device, so a sharded plan launches once per shard.
"""

from __future__ import annotations

import dataclasses
import functools
import weakref

import torch

from repro_torch import trace
from repro_torch.kernels import launch as _launch

from . import kernel
from .ref import IDENTITY, level_segment_aggregate_ref, recipe_values, segment_aggregate_ref

# kernel launches since the last reset_launches(), by kernel name
LAUNCHES = {"segment_aggregate": 0, "level_segment_aggregate": 0}
# messages those launches reduced, by regime (the sort regime by form: read
# through the row order, or in code order), slab members and fused members
MEMBERS = {"thread": 0, "warp": 0, "sort": 0, "sort_ordered": 0}
# ... of them the fused members (a Recipe, no slab), by regime
FUSED_MEMBERS = {"thread": 0, "warp": 0, "sort": 0, "sort_ordered": 0}
# row orders built (row_order calls made by cached_row_order) and inputs
# copied into code order (by in_code_order) since import
ORDER_BUILDS = {"orders": 0, "copies": 0}

_INT32_MAX = 2**31 - 1


def reset_launches() -> None:
    for counts in (LAUNCHES, MEMBERS, FUSED_MEMBERS):
        for name in counts:
            counts[name] = 0


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


@dataclasses.dataclass(frozen=True, eq=False)
class Recipe:
    """A message's (N, V) values given by their parts, as the plan layer's
    rowwise stage combines them (``core/plans.py``): row r's value at lane
    c is ``((lift[r] ⊗ T_1[i_1[r], l_1[c]]) ⊗ T_2[i_2[r], l_2[c]]) ⊗ …``,
    the messages' ⊗ in order, then 0̄ (the ⊕-identity) where some σ
    predicate's mask is false at the row's code.

    ``lift`` (N,) float32; ``messages`` up to ``launch.SEG_MAX_MESSAGES``
    of ``(index, table, lane_cols)``: ``index`` (N,) int32 rows of
    ``table`` (R, C) float32, or None for a broadcast message (row 0), and
    ``lane_cols`` (V,) int32 the column of ``table`` that each lane reads;
    ``preds`` up to ``launch.SEG_MAX_PREDICATES`` of ``(codes, mask)``:
    ``codes`` (N,) int32 into the bool ``mask``; ``add``: ⊗ is + (tropical
    rings), else ×; ``lanes``: V (1 with no message).  Indices and codes
    must lie in their table's rows and mask (the caller's codes do: the
    kernels read them unchecked, as the rowwise stage's gathers would
    have).  Every tensor is contiguous on the codes' device."""

    lift: torch.Tensor
    messages: tuple = ()
    preds: tuple = ()
    add: bool = False
    lanes: int = 1

    @property
    def gathered(self) -> tuple[int, int]:
        """(rows of its largest table read at a row's index, bytes of every
        such table): a broadcast message's table (row 0) is not gathered."""
        tables = [t for i, t, _ in self.messages if i is not None]
        return (max((t.shape[0] for t in tables), default=0),
                sum(t.numel() * t.element_size() for t in tables))

    @property
    def nbytes(self) -> int:
        """Bytes the kernel reads of it: its row columns (lift, indices, σ
        codes), tables, lane columns and masks."""
        tensors = [self.lift, *(t for m in self.messages for t in m if t is not None),
                   *(t for p in self.preds for t in p)]
        return sum(t.numel() * t.element_size() for t in tensors)


def _check_recipe(codes: torch.Tensor, recipe: Recipe, num_segments: int) -> None:
    """Raise, as a slab of the wrong kind would, unless every tensor of
    ``recipe`` is what the kernels read: the dtype, the shape against the
    codes' N and its lanes, contiguous, on the codes' device; at most
    ``launch.SEG_MAX_MESSAGES`` messages and ``SEG_MAX_PREDICATES`` σ
    predicates.  The same checks hold on the CPU, whose plain version
    would read any of it."""
    if codes.dtype != torch.int32 or codes.dim() != 1 or not codes.is_contiguous():
        raise ValueError(f"need contiguous int32 codes (N,), got {codes.dtype} "
                         f"{tuple(codes.shape)}")
    n, v = codes.shape[0], recipe.lanes
    if len(recipe.messages) > _launch.SEG_MAX_MESSAGES:
        raise ValueError(f"a recipe of {len(recipe.messages)} messages: at most "
                         f"{_launch.SEG_MAX_MESSAGES}")
    if len(recipe.preds) > _launch.SEG_MAX_PREDICATES:
        raise ValueError(f"a recipe of {len(recipe.preds)} σ predicates: at most "
                         f"{_launch.SEG_MAX_PREDICATES}")
    if v < 1 or (not recipe.messages and v != 1):
        raise ValueError(f"a recipe of {len(recipe.messages)} messages has {v} lanes")

    def check(t, what, dtype, shape):
        """``shape``: the tensor's, or its number of dims."""
        if t.device != codes.device:
            raise ValueError(f"{what} on {t.device}, codes on {codes.device}")
        if t.dtype != dtype:
            raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
        if (t.dim() != shape) if isinstance(shape, int) else (tuple(t.shape) != shape):
            raise ValueError(f"{what} has shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous")

    check(recipe.lift, "the lift", torch.float32, (n,))
    for k, (index, table, lane_cols) in enumerate(recipe.messages):
        if index is not None:
            check(index, f"message {k}'s index", torch.int32, (n,))
        check(table, f"message {k}'s table", torch.float32, 2)
        check(lane_cols, f"message {k}'s lane columns", torch.int32, (v,))
        if table.numel() == 0 or table.numel() > _INT32_MAX:
            raise ValueError(f"message {k}'s table has shape {tuple(table.shape)}")
    for p, (pcodes, mask) in enumerate(recipe.preds):
        check(pcodes, f"σ predicate {p}'s codes", torch.int32, (n,))
        check(mask, f"σ predicate {p}'s mask", torch.bool, 1)
        if mask.numel() == 0:
            raise ValueError(f"σ predicate {p}'s mask is empty")
    if num_segments <= 0 or num_segments * v > _INT32_MAX:
        raise ValueError(f"output of {num_segments} x {v} is out of range")


def _checked_recipe(codes: torch.Tensor, recipe: Recipe, num_segments: int,
                    op: str) -> torch.Tensor:
    """``_checked_out`` for a fused member (:func:`_check_recipe`)."""
    if op not in IDENTITY:
        raise ValueError(f"unknown segment op {op!r}")
    if codes.device.type != "cuda":
        raise ValueError(f"codes on {codes.device}: the kernels need CUDA codes")
    _check_recipe(codes, recipe, num_segments)
    return torch.full((num_segments, recipe.lanes), IDENTITY[op], dtype=torch.float32,
                      device=codes.device)


@dataclasses.dataclass(frozen=True, eq=False)
class RowOrder:
    """A stable order of a message's rows by code and its sort-regime work.

    ``perm`` (N,) int32 lists the rows by code, rows of one code in row
    order; segment s holds ``perm[offsets[s]:offsets[s + 1]]`` (codes
    outside [0, G) fall before ``offsets[0]`` or after ``offsets[G]``).
    Each segment's rows are cut into pieces of ``piece`` rows, one work item
    each: ``table`` (int32) holds ``n_items`` items (segment, begin, end,
    slot, split) and then, for each of the ``n_splits`` segments of more
    than one piece, (first slot, pieces, segment); a split segment's pieces
    go to ``n_slots`` workspace slots in piece order (slot and split are -1
    for a segment of one piece)."""

    perm: torch.Tensor
    offsets: torch.Tensor
    table: torch.Tensor
    n_items: int
    n_splits: int
    n_slots: int
    piece: int

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.perm, self.offsets, self.table))


def row_order(codes: torch.Tensor, num_segments: int, piece: int) -> RowOrder:
    """Build the :class:`RowOrder` of ``codes`` (N,) int32 on its device:
    one stable ``torch.sort`` and a few scans (one host sync for the item
    count)."""
    return _cut(*_sort(codes, num_segments)[:2], num_segments, piece)


def _sort(codes: torch.Tensor, num_segments: int) -> tuple[torch.Tensor, torch.Tensor, int]:
    """The stable order of ``codes``: (perm (N,), offsets (G + 1,), the
    rows of the longest segment)."""
    dev, g = codes.device, num_segments
    sorted_codes, perm = torch.sort(codes, stable=True)
    offsets = torch.searchsorted(sorted_codes, torch.arange(g + 1, dtype=codes.dtype, device=dev))
    longest = int((offsets[1:] - offsets[:-1]).max()) if g else 0
    return perm.to(torch.int32), offsets.to(torch.int32), longest


def _cut(perm: torch.Tensor, offsets: torch.Tensor, num_segments: int, piece: int) -> RowOrder:
    """The sort regime's work items over a stable order: each segment's
    rows cut into pieces of ``piece`` rows."""
    dev, g = perm.device, num_segments
    offsets = offsets.long()
    counts = offsets[1:] - offsets[:-1]
    pieces = (counts + piece - 1) // piece
    multi = pieces > 1
    split_pieces = pieces[multi]
    n_items, n_splits, n_slots = (int(x) for x in torch.stack(
        [pieces.sum(), multi.sum(), split_pieces.sum()]).tolist())
    seg = torch.repeat_interleave(torch.arange(g, device=dev), pieces, output_size=n_items)
    p = torch.arange(n_items, device=dev) - (torch.cumsum(pieces, 0) - pieces)[seg]
    begin = offsets[seg] + p * piece
    end = torch.minimum(begin + piece, offsets[seg + 1])
    split_first = torch.cumsum(split_pieces, 0) - split_pieces
    split = torch.where(multi, torch.cumsum(multi.long(), 0) - 1, -1)[seg]
    slot = torch.full_like(split, -1)
    if n_splits:
        slot = torch.where(split >= 0, split_first[split.clamp_min(0)] + p, -1)
    items = torch.stack([seg, begin, end, slot, split], 1)
    splits = torch.stack([split_first, split_pieces, torch.nonzero(multi)[:, 0]], 1)
    table = torch.cat([items.flatten(), splits.flatten()]).to(torch.int32)
    return RowOrder(perm=perm, offsets=offsets.to(torch.int32), table=table,
                    n_items=n_items, n_splits=n_splits, n_slots=n_slots, piece=piece)


@dataclasses.dataclass
class _Codes:
    """What is kept for one codes tensor (the base of the views handed in):
    its stable orders by (view, G), each with its work items by piece, and
    its inputs' code-ordered copies by (view, input)."""

    ref: weakref.ref
    orders: dict = dataclasses.field(default_factory=dict)
    copies: dict = dataclasses.field(default_factory=dict)


# id(codes' base tensor) -> _Codes
_ORDERS: dict[int, _Codes] = {}


def _forget(key: int, ref: weakref.ref) -> None:
    entry = _ORDERS.get(key)
    if entry is not None and entry.ref is ref:
        del _ORDERS[key]


def _drop_copy(copies: dict, key: tuple, ref: weakref.ref) -> None:
    hit = copies.get(key)
    if hit is not None and hit[0] is ref:
        del copies[key]


def _entry(codes: torch.Tensor) -> tuple[_Codes, tuple]:
    """The kept entry of ``codes``' base tensor and the view's key."""
    base = codes if codes._base is None else codes._base
    entry = _ORDERS.get(id(base))
    if entry is None or entry.ref() is not base:
        entry = _Codes(weakref.ref(base, functools.partial(_forget, id(base))))
        _ORDERS[id(base)] = entry
    return entry, (codes.storage_offset(), tuple(codes.shape))


def cached_row_order(codes: torch.Tensor, num_segments: int, piece: int) -> RowOrder:
    """:func:`row_order`, kept while ``codes`` (or the tensor it is a view
    of) lives and is not written to: keyed by that tensor's identity, the
    view's offset and shape and the tensor's version counter.  A new
    relation version comes with a new codes tensor, so its order is built
    anew.  One sort serves every piece; pieces of at least the longest
    segment's rows cut the same work items (one per segment), so they share
    them."""
    entry, view = _entry(codes)
    key = view + (num_segments,)
    version, sort, cuts = entry.orders.get(key, (None, None, None))
    if sort is None or version != codes._version:
        sort, cuts = _sort(codes, num_segments), {}
        ORDER_BUILDS["orders"] += 1
        entry.orders[key] = codes._version, sort, cuts
    perm, offsets, longest = sort
    piece = min(piece, max(longest, 1))
    order = cuts.get(piece)
    if order is None:
        order = cuts[piece] = _cut(perm, offsets, num_segments, piece)
    return order


def code_order(codes: torch.Tensor, num_segments: int, v: int) -> RowOrder | None:
    """The (cached) row order that the sort regime reads for a message of
    ``codes`` (N,) into (``num_segments``, ``v``), or None when
    ``launch.segment_geometry`` puts that message in another regime."""
    geom = _launch.segment_geometry(codes.shape[0], num_segments, v)
    if geom.regime != _launch.SEG_SORT:
        return None
    return cached_row_order(codes, num_segments, geom.chunk)


def in_code_order(codes: torch.Tensor, order: RowOrder, tensors) -> tuple:
    """Each of ``tensors`` (N leading rows, or None) in ``order``, the row
    order of ``codes``: ``t[order.perm]``.  A copy is kept while ``codes``
    and ``t`` live and neither is written to, so a plan that reruns on the
    same relation version and lift copies nothing."""
    entry, view = _entry(codes)
    out = []
    for t in tensors:
        if t is None:
            out.append(None)
            continue
        key = view + (id(t),)
        ref, versions, copy = entry.copies.get(key, (None, None, None))
        if ref is None or ref() is not t or versions != (t._version, codes._version):
            copy = t.index_select(0, order.perm)
            ORDER_BUILDS["copies"] += 1
            ref = weakref.ref(t, functools.partial(_drop_copy, entry.copies, key))
            entry.copies[key] = ref, (t._version, codes._version), copy
        out.append(copy)
    return tuple(out)


def cached_bytes() -> dict:
    """Device bytes of the row orders and code-ordered copies kept now."""
    orders = sum(perm.nbytes + offsets.nbytes + sum(o.table.nbytes for o in cuts.values())
                 for e in _ORDERS.values() for _, (perm, offsets, _), cuts in e.orders.values())
    copies = sum(c.numel() * c.element_size() for e in _ORDERS.values()
                 for _, _, c in e.copies.values())
    return {"orders": orders, "copies": copies}


def _launch_members(name: str, items: list, op: str) -> None:
    """Launch kernel ``name`` over checked ``(codes, values, out, ordered)``
    CUDA messages and count its launches and messages."""
    members = []
    gathers = [] if trace.on() else None    # each member's gather_rows, traced
    for codes, values, out, ordered in items:
        n, (g, v) = codes.shape[0], out.shape
        fused = isinstance(values, Recipe)
        geom = _launch.segment_geometry(n, g, v)
        sort = geom.regime == _launch.SEG_SORT
        if ordered and not sort:
            raise ValueError(f"values in code order need the sort regime; N={n} G={g} V={v} "
                             f"is the {geom.name} regime")
        order = cached_row_order(codes, g, geom.chunk) if sort else None
        members.append((codes, values, out, geom, order, ordered))
        form = "sort_ordered" if ordered else geom.name
        MEMBERS[form] += 1
        FUSED_MEMBERS[form] += fused
        if gathers is not None:
            gather_rows, gather_bytes = values.gathered if fused else (0, 0)
            gathers.append(gather_rows)
            trace.record("kernels.segment", kernel=name, n=n, g=g, v=v,
                         elem_bytes=4 if fused else values.element_size(),
                         regime=geom.name, ordered=bool(ordered),
                         n_items=order.n_items if sort else 0,
                         table_bytes=order.table.numel() * order.table.element_size() if sort
                         else 0, fused=fused, msgs=len(values.messages) if fused else 0,
                         preds=len(values.preds) if fused else 0,
                         recipe_bytes=values.nbytes if fused else 0,
                         gather_rows=gather_rows, gather_bytes=gather_bytes)
    LAUNCHES[name] += kernel.launch(name, members, op, gathers)


def _plain(codes: torch.Tensor, values, num_segments: int, op: str,
           ordered: bool) -> torch.Tensor:
    """The plain version; values in code order are reduced at their codes, a
    recipe's materialized first (``ref.recipe_values``)."""
    if isinstance(values, Recipe):
        _check_recipe(codes, values, num_segments)
        values = recipe_values(values, IDENTITY[op])
    if ordered:
        order = code_order(codes, num_segments, values.shape[1])
        if order is None:
            raise ValueError("values in code order need the sort regime")
        codes = codes.index_select(0, order.perm)
    return segment_aggregate_ref(codes, values.to(torch.float32), num_segments, op)


def aggregate_op(codes: torch.Tensor, values, num_segments: int,
                 op: str = "sum", ordered: bool = False) -> torch.Tensor:
    """``out[g, v] = ⊕_{n: codes[n] = g} values[n, v]``, ⊕ ∈ {sum, min, max}.

    ``codes`` (N,) int32 in [0, G); ``values`` (N, V) float32, or (N,) which
    returns (G,), or a :class:`Recipe` of V lanes (a fused member: the
    kernel computes each value; out (G, V)).  Empty groups hold the
    ⊕-identity (0 / +inf / -inf).  ``ordered``: row i of ``values`` (of a
    recipe's row columns) is row ``perm[i]`` of the message, perm the row
    order of ``codes`` (:func:`code_order`, which must be the sort regime's);
    the bits equal those of the message in row order.
    """
    fused = isinstance(values, Recipe)
    squeeze = not fused and values.dim() == 1
    if squeeze:
        values = values[:, None]
    if codes.device.type == "cpu":
        out = _plain(codes, values, num_segments, op, ordered)
    else:
        out = (_checked_recipe if fused else _checked_out)(codes, values, num_segments, op)
        if codes.shape[0]:
            _launch_members("segment_aggregate", [(codes, values, out, ordered)], op)
    return out[:, 0] if squeeze else out


def level_segment_aggregate(codes: torch.Tensor, values: torch.Tensor, total_segments: int,
                            op: str = "sum") -> torch.Tensor:
    """The level kernel on concatenated operands, as one message: ``codes``
    (ΣN,) int32 global segment ids (-1 matches nothing), ``values`` (ΣN, V)
    float32, out (total_segments, V)."""
    if codes.device.type == "cpu":
        return level_segment_aggregate_ref(codes, values, total_segments, op)
    out = _checked_out(codes, values, total_segments, op)
    if codes.shape[0]:
        _launch_members("level_segment_aggregate", [(codes, values, out, False)], op)
    return out


def level_aggregate(items, op: str = "sum") -> list[torch.Tensor]:
    """Several independent ``(codes, values, num_segments)`` segment
    reductions in ONE ``level_segment_aggregate`` launch (one per
    ``launch.SEG_MAX_MEMBERS`` messages).

    Item j is one same-level message: ``codes`` (n_j,) segment ids in
    [0, g_j), ``values`` (n_j, v_j) or a :class:`Recipe` of v_j lanes, and
    optionally a fourth element ``ordered`` (as :func:`aggregate_op`'s).
    Each message is a member of the launch's table with its own tensors and
    partition, so its output has the same bits as ``aggregate_op`` gives it
    alone.  Returns the
    per-item (g_j, v_j) outputs.  On the CPU the plain version reduces each
    item.
    """
    assert items, "level_aggregate of zero messages"
    if items[0][0].device.type == "cpu":
        return [_plain(codes, values, g, op, bool(rest and rest[0]))
                for codes, values, g, *rest in items]
    outs, members = [], []
    for codes, values, g, *rest in items:
        codes = codes.to(torch.int32).contiguous()
        if isinstance(values, Recipe):
            out = _checked_recipe(codes, values, g, op)
        else:
            values = values.to(torch.float32).contiguous()
            out = _checked_out(codes, values, g, op)
        outs.append(out)
        if codes.shape[0]:
            members.append((codes, values, out, bool(rest and rest[0])))
    if members:
        _launch_members("level_segment_aggregate", members, op)
    return outs


def aggregate(codes: torch.Tensor, values: torch.Tensor, num_segments: int, op: str = "sum",
              use_kernel: bool = True) -> torch.Tensor:
    """``aggregate_op`` (the kernel on a CUDA tensor), or with
    ``use_kernel=False`` the plain version (``ref.py``) on any device: the
    caller's choice, never a fallback."""
    if use_kernel:
        return aggregate_op(codes, values, num_segments, op=op)
    return segment_aggregate_ref(codes, values, num_segments, op)
