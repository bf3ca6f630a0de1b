"""The port's segment-aggregate wrappers held against the JAX package's
Pallas kernels (interpret mode) at the shapes of ``tests/test_kernels.py``.

On the CPU the wrappers run their plain PyTorch versions.  Inputs are
integer-valued floats, so every op — sum included — must agree exactly.
``test_torch_cuda.py`` holds the CUDA kernels against these plain versions
on the card."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segment_aggregate.ops import aggregate as j_aggregate
from repro.kernels.segment_aggregate.ops import aggregate_op as j_aggregate_op
from repro.kernels.segment_aggregate.ops import level_aggregate as j_level_aggregate
from repro_torch.kernels.segment_aggregate import ops

SHAPES = [(64, 8, 1), (1000, 64, 3), (77, 13, 5), (4096, 300, 2)]
LEVEL_SPECS = [
    [(64, 8, 1)],                                  # degenerate: one message
    [(64, 8, 2), (100, 13, 2), (256, 64, 2)],      # equal widths
    [(30, 5, 1), (1000, 64, 4), (77, 13, 3)],      # ragged N/G/V
    [(7, 3, 1), (9, 300, 2)],                      # tiny rows, wide segments
]


def _inputs(n, g, v, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, g, n).astype(np.int32)
    vals = rng.integers(-20, 21, (n, v)).astype(np.float32)
    return codes, vals


@pytest.mark.parametrize("n,g,v", SHAPES)
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_aggregate_op_matches_pallas_kernel(n, g, v, op):
    codes, vals = _inputs(n, g, v, n + g)
    want = j_aggregate_op(jnp.asarray(codes), jnp.asarray(vals), g, op=op, interpret=True)
    got = ops.aggregate_op(torch.as_tensor(codes), torch.as_tensor(vals), g, op=op)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_aggregate_op_1d_squeeze():
    got = ops.aggregate_op(torch.tensor([0, 1, 1, 2], dtype=torch.int32),
                           torch.tensor([1.0, 2.0, 3.0, 4.0]), 3)
    assert got.tolist() == [1.0, 5.0, 4.0]


@pytest.mark.parametrize("specs", LEVEL_SPECS, ids=lambda s: f"{len(s)}msg")
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_level_aggregate_matches_pallas_kernel(specs, op):
    seed = sum(n for n, _, _ in specs)
    items = [_inputs(n, g, v, seed + i) + (g,) for i, (n, g, v) in enumerate(specs)]
    want = j_level_aggregate(
        [(jnp.asarray(c), jnp.asarray(x), g) for c, x, g in items], op=op, interpret=True)
    got = ops.level_aggregate(
        [(torch.as_tensor(c), torch.as_tensor(x), g) for c, x, g in items], op=op)
    assert len(got) == len(items)
    for (c, x, g), w, o in zip(items, want, got):
        assert tuple(o.shape) == (g, x.shape[1])
        np.testing.assert_array_equal(np.asarray(w), o.numpy())


def test_level_aggregate_empty_segments_get_identity():
    items = [(torch.tensor([0, 0], dtype=torch.int32), torch.tensor([[1.0], [2.0]]), 4)]
    assert ops.level_aggregate(items, op="sum")[0][:, 0].tolist() == [3.0, 0, 0, 0]
    assert ops.level_aggregate(items, op="min")[0][1:, 0].tolist() == [np.inf] * 3
    assert ops.level_aggregate(items, op="max")[0][1:, 0].tolist() == [-np.inf] * 3


def test_level_kernel_pad_rows_match_nothing():
    codes = torch.tensor([0, -1, 2, -1, 1], dtype=torch.int32)
    vals = torch.tensor([[1.0], [100.0], [3.0], [-100.0], [2.0]])
    for op, want in (("sum", [1.0, 2.0, 3.0]), ("min", [1.0, 2.0, 3.0])):
        assert ops.level_segment_aggregate(codes, vals, 3, op)[:, 0].tolist() == want


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_aggregate_matches_reference_either_way(op, use_kernel):
    """``aggregate``: ``use_kernel`` picks the wrapper (the plain version on
    the CPU), ``use_kernel=False`` the plain version; both equal the
    reference's ``aggregate`` with the same choice (its kernel in interpret
    mode)."""
    codes, vals = _inputs(1000, 64, 3, 11)
    want = j_aggregate(jnp.asarray(codes), jnp.asarray(vals), 64, op=op, use_kernel=use_kernel)
    got = ops.aggregate(torch.as_tensor(codes), torch.as_tensor(vals), 64, op=op,
                        use_kernel=use_kernel)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


# ---------------------------------------------------------------------------
# launch geometry, member tables and row orders of the CUDA kernels (their
# Python side: the CPU reaches it, the card tests run the kernels)
# ---------------------------------------------------------------------------

from repro_torch.kernels import launch  # noqa: E402
from repro_torch.relational import StreamBuffer, schema  # noqa: E402

# (N, G, V) per regime: thread, thread with column tiles, warp, sort; small to
# 2^24 rows
GEOMETRY_SHAPES = [(64, 8, 1), (1 << 23, 6, 1), (1 << 24, 16, 1), (4096, 300, 2), (1000, 7, 300),
                   (1 << 24, 12, 8), (20_000, 20, 100), (1 << 23, 10, 336), (1 << 23, 400, 72),
                   (1 << 23, 100, 200), (1 << 24, 100_000, 1), (1 << 24, 50_000, 3),
                   (1 << 24, 50_000, 8)]


@pytest.mark.parametrize("n,g,v", GEOMETRY_SHAPES)
def test_segment_geometry_partitions_rows_once(n, g, v):
    """Blocks of about ``chunk`` rows cover [0, N) once; column tiles cover
    [0, V) once; shared memory fits the launch; the workspace holds one
    partial per block, tile and cell, and the merge grid has a warp per tile
    and cell, exactly when a tile has several blocks.  Past a warp copy's
    cells the message goes segment-major (sort).  A warp-regime block holds
    a copy of the cells and a lane mask per code for each of its warps."""
    geo = launch.segment_geometry(n, g, v)
    if geo.name == "sort":
        assert g > launch.SEG_THREAD_G and g * v > launch.SEG_WARP_CELLS
        assert geo.chunk == max(32, launch.SEG_PIECE_ELEMS // v)
        return
    assert geo.name == ("thread" if g <= launch.SEG_THREAD_G else "warp")
    starts = [b * geo.chunk for b in range(geo.blocks)]
    ends = [min(n, s + geo.chunk) for s in starts]
    assert starts[0] == 0 and ends[-1] == n
    assert all(e > s for s, e in zip(starts, ends)) and starts[1:] == ends[:-1]
    assert geo.tiles == -(-v // geo.vt) and (geo.tiles - 1) * geo.vt < v
    if geo.name == "thread":
        assert geo.vt == min(v, launch.SEG_THREAD_COLS) and geo.smem == 4 * launch.THREADS * g
    else:
        assert geo.vt == v and g * v <= launch.SEG_WARP_CELLS
        assert geo.smem == 4 * launch.SEG_WARPS * g * (v + 1)
    assert geo.smem <= 96 * 1024
    cells = geo.tiles * g * geo.vt
    assert (geo.ws, geo.merge) == ((cells * geo.blocks, cells) if geo.blocks > 1 else (0, 0))


def test_segment_geometry_reads_no_card(monkeypatch):
    """The partition is a function of (N, G, V) alone: it asks nothing of a
    card (so no SM count), and repeats."""
    def no_card(*args, **kwargs):
        raise AssertionError("segment_geometry asked the card")

    launch.segment_geometry.cache_clear()
    for name in ("get_device_properties", "device_count", "current_device",
                 "is_available"):
        monkeypatch.setattr(torch.cuda, name, no_card)
    first = [launch.segment_geometry(*s) for s in GEOMETRY_SHAPES]
    launch.segment_geometry.cache_clear()
    assert [launch.segment_geometry(*s) for s in GEOMETRY_SHAPES] == first


def _member(n, g, v, seed, index=None):
    """A packed member; a sort member of odd seed has its values in code
    order (no index)."""
    geo = launch.segment_geometry(n, g, v)
    n_items = n_splits = 0
    ordered = geo.name == "sort" and seed % 2 == 1
    if geo.name == "sort":
        codes = torch.as_tensor(_inputs(n, g, v, seed)[0])
        order = ops.row_order(codes, g, geo.chunk)
        geo = launch.sort_launch(geo, v, order.n_items, order.n_slots, order.n_splits)
        n_items, n_splits = order.n_items, order.n_splits
    base = 1000 * (seed + 1)
    return (geo, None if ordered else base + 1, base + 2, base + 3,
            base + 4 if n_items else None, n, g, v, n_items, n_splits, ordered)


MEMBERS = [(30_000, 6, 1), (20_000, 20, 300), (40_000, 300, 2), (20_000, 100, 14),
           (60_000, 5_000, 1), (50_000, 3_000, 3), (20_000, 400, 72), (64, 8, 1)]
OWN_FIELDS = ("index", "values", "out", "items", "n", "chunk", "g", "v", "regime", "vt",
              "tiles", "blocks", "n_items", "n_splits")


def _fields(m):
    return {f: getattr(m, f) for f in OWN_FIELDS}


def test_member_table_does_not_depend_on_the_other_members():
    """A message packed alone, among others, in reverse order or past
    SEG_MAX_MEMBERS (a second launch) keeps every field of its own; only
    its first block (counted within its regime's grid), its workspace
    offset and its first merge warp move, and those follow the members
    before it."""
    members = [_member(n, g, v, i) for i, (n, g, v) in enumerate(MEMBERS)]
    alone = [_fields(launch.pack_members([m])[0].table.m[0]) for m in members]
    (mixed,) = launch.pack_members(members)
    t = mixed.table
    assert t.count == len(members)

    def grid(j):  # a sort member in code order runs in its own grid
        return launch.SEG_SORT_ORDERED if members[j][-1] else members[j][0].regime

    order = sorted(range(len(members)), key=grid)
    blocks, smem = [0] * launch.SEG_GRIDS, [0] * launch.SEG_GRIDS
    count = [0] * (launch.SEG_GRIDS - 1) + [len(members)]
    ws = merge = 0
    for slot, j in enumerate(order):
        geo, r = members[j][0], grid(j)
        m = t.m[slot]
        assert _fields(m) == alone[j]
        assert (m.first_block, m.ws, m.aux) == (blocks[r], ws, merge)
        blocks[r] += geo.blocks * geo.tiles
        smem[r] = max(smem[r], geo.smem)
        count[r] += 1
        ws += geo.ws
        merge += geo.merge
    blocks[launch.SEG_MERGE] = -(-merge // launch.SEG_WARPS)
    assert count == [3, 2, 2, 1, 0, 0, 0, 0, 8]
    assert list(t.members) == count
    assert list(t.first) == [0, 3, 5, 7, 8, 8, 8, 8, 0] and mixed.recipes is None
    assert list(t.grid) == blocks and list(t.smem) == smem
    assert (mixed.grid, mixed.ws) == (sum(blocks), ws)
    (rev,) = launch.pack_members(members[::-1])
    assert (sorted(repr(_fields(rev.table.m[j])) for j in range(len(members)))
            == sorted(repr(a) for a in alone))
    many = launch.pack_members(members * 9)
    assert [x.table.count for x in many] == [launch.SEG_MAX_MEMBERS,
                                            len(members) * 9 - launch.SEG_MAX_MEMBERS]
    flat = sorted(repr(_fields(x.table.m[j])) for x in many for j in range(x.table.count))
    assert flat == sorted(repr(a) for a in alone * 9)


def test_member_table_layout_matches_the_c_struct():
    """``SegMember`` is ``struct segagg::Member`` (96 bytes, field for field:
    four pointers, three 64-bit counts, then 32-bit fields) and the table
    (count, nine arrays over the three regimes, the sort regime in two
    forms, for slab members and again for fused ones, and the merge grid,
    SEG_MAX_MEMBERS members) stays under the 4 KiB of a kernel's
    parameters.  A sort member in code order is flagged by its grid,
    ``SEG_SORT_ORDERED``, and passes no index; a fused member by its grid,
    ``SEG_FUSED`` + that, passes no values and has its ``SegRecipe`` (160
    bytes, ``struct segagg::Recipe``) in the launch's recipes, in table
    order."""
    import ctypes

    assert ctypes.sizeof(launch.SegMember) == 96
    names = [name for name, _ in launch.SegMember._fields_]
    assert names == ["index", "values", "out", "items", "n", "chunk", "ws", "g", "v", "regime",
                     "vt", "tiles", "blocks", "first_block", "aux", "n_items", "n_splits"]
    offsets = [getattr(launch.SegMember, name).offset for name in names]
    assert offsets == [0, 8, 16, 24, 32, 40, 48] + list(range(56, 96, 4))
    assert (launch.SEG_SORT, launch.SEG_SORT_ORDERED, launch.SEG_FUSED, launch.SEG_MERGE) == (
        2, 3, 4, 8)
    (one,) = launch.pack_members([_member(60_000, 5_000, 1, 1)])
    assert one.table.m[0].regime == launch.SEG_SORT_ORDERED and one.table.m[0].index is None
    assert list(one.table.members) == [0, 0, 0, 1, 0, 0, 0, 0, 1]
    (two,) = launch.pack_members([_member(60_000, 5_000, 1, 2)])
    assert two.table.m[0].regime == launch.SEG_SORT and two.table.m[0].index == 3001
    assert list(two.table.members) == [0, 0, 1, 0, 0, 0, 0, 0, 1]
    assert ctypes.sizeof(launch.SegTable) == 8 + 144 + 96 * launch.SEG_MAX_MEMBERS <= 4096 - 16
    assert ctypes.sizeof(launch.SegRecipe) == 160
    assert [getattr(launch.SegRecipe, f).offset for f in ("lift", "idx", "tab", "lane_col",
                                                          "codes", "mask", "cols", "msgs")] == [
        0, 8, 32, 56, 80, 104, 128, 140]
    members = [_member(n, g, v, i) for i, (n, g, v) in enumerate(MEMBERS[:3])]
    recipes = [None, launch.SegRecipe(lift=7, msgs=1), launch.SegRecipe(lift=9)]
    members[1] = members[1][:2] + (None,) + members[1][3:]
    members[2] = members[2][:2] + (None,) + members[2][3:]
    (mixed,) = launch.pack_members(members, recipes)
    t = mixed.table
    assert [t.m[j].regime for j in range(3)] == [
        launch.SEG_THREAD, launch.SEG_FUSED + launch.SEG_THREAD, launch.SEG_FUSED + launch.SEG_WARP]
    assert [t.m[j].values for j in range(3)] == [1002, None, None]
    assert [mixed.recipes.r[j].lift for j in range(2)] == [7, 9]
    assert list(t.first) == [0, 1, 1, 1, 1, 2, 3, 3, 0]


@pytest.mark.parametrize("piece", [1, 3, 64])
def test_row_order_is_stable_with_right_offsets_and_pieces(piece):
    rng = np.random.default_rng(piece)
    codes = rng.integers(-1, 12, 500).astype(np.int32)   # -1 and 11 match nothing
    codes[rng.random(500) < 0.4] = 3                      # one heavy segment
    g = 11
    order = ops.row_order(torch.as_tensor(codes), g, piece)
    perm = order.perm.numpy()
    assert order.perm.dtype == torch.int32 and sorted(perm.tolist()) == list(range(500))
    np.testing.assert_array_equal(perm, np.argsort(codes, kind="stable"))
    inside = codes[(codes >= 0) & (codes < g)]
    want = np.searchsorted(np.sort(codes), np.arange(g + 1))
    np.testing.assert_array_equal(order.offsets.numpy(), want)
    assert np.array_equal(np.diff(want), np.bincount(inside, minlength=g))
    table = order.table.numpy()
    items = table[: order.n_items * 5].reshape(-1, 5)
    splits = table[order.n_items * 5:].reshape(-1, 3)
    assert len(splits) == order.n_splits
    covered = np.zeros(500, np.int32)
    for seg, begin, end, slot, split in items:
        assert want[seg] <= begin < end <= want[seg + 1] and end - begin <= piece
        covered[begin:end] += 1
        if split >= 0:
            first, pieces, of = splits[split]
            assert of == seg and first <= slot < first + pieces
        else:
            assert slot == -1 and want[seg + 1] - want[seg] <= piece
    assert np.array_equal(covered[want[0]: want[g]], np.ones(want[g] - want[0], np.int32))
    assert not covered[: want[0]].any() and not covered[want[g]:].any()
    assert order.n_slots == int(splits[:, 1].sum()) if len(splits) else order.n_slots == 0


def test_cached_row_order_follows_the_codes_tensor():
    """The order is kept per codes tensor: views (a shard's row block) get
    their own, a write to the codes rebuilds it, and a new relation version
    (a delta, an ingest tick, a compaction) comes with new codes from the
    catalog and so with a new order."""
    cat = schema.salesforce(n_opp=5_000, n_user=50, n_camp=20, n_acc=30)
    opp = cat.get("Opp")
    attrs = ("user_id",)
    codes, g = cat.dev_flat_codes(opp, attrs, "cpu")
    built = ops.ORDER_BUILDS["orders"]
    first = ops.cached_row_order(codes, g, 64)
    assert ops.cached_row_order(codes, g, 64) is first
    half = codes.shape[0] // 2
    block = ops.cached_row_order(codes[half:], g, 64)
    assert block is not first and ops.cached_row_order(codes[half:], g, 64) is block
    np.testing.assert_array_equal(block.perm.numpy(),
                                  np.argsort(codes[half:].numpy(), kind="stable"))
    assert ops.ORDER_BUILDS["orders"] == built + 2
    rng = np.random.default_rng(0)

    def rows(n):
        return ({a: rng.integers(0, cat.domains()[a], n).astype(np.int32) for a in opp.attrs},
                {m: rng.random(n).astype(np.float32) for m in opp.measures})

    delta, _ = opp.append_rows(*rows(40))                  # a delta
    buf = StreamBuffer(delta)
    buf.append(*rows(30))
    buf.delete(np.arange(delta.num_rows + 30) % 7 == 0)
    tick, _ = buf.coalesce()                               # an ingest tick, tombstones kept
    compacted, _ = tick.compact()                          # a compaction
    assert compacted.num_rows < tick.num_rows
    seen = [codes]
    for rel in (delta, tick, compacted):
        cat.put(rel)
        new_codes, _ = cat.dev_flat_codes(rel, attrs, "cpu")
        assert all(new_codes is not c for c in seen)
        seen.append(new_codes)
        before = ops.ORDER_BUILDS["orders"]
        order = ops.cached_row_order(new_codes, g, 64)
        assert ops.ORDER_BUILDS["orders"] == before + 1
        np.testing.assert_array_equal(order.perm.numpy(),
                                      np.argsort(new_codes.numpy(), kind="stable"))
    assert ops.cached_row_order(codes, g, 64) is first
    codes[0] = (int(codes[0]) + 1) % g
    again = ops.cached_row_order(codes, g, 64)
    assert again is not first
    np.testing.assert_array_equal(again.perm.numpy(), np.argsort(codes.numpy(), kind="stable"))


# ---------------------------------------------------------------------------
# code-ordered slabs: the plan layer permutes its rowwise inputs once per
# cached row order, so the slab of a sort-regime message arrives in code order
# ---------------------------------------------------------------------------

from repro_torch.core import Query, Treant  # noqa: E402
from repro_torch.core import plans  # noqa: E402
from repro_torch.core import semiring as tsr  # noqa: E402

RINGS = {"sum": tsr.SUM, "moments": tsr.MOMENTS, "tropical_max": tsr.TROPICAL_MAX}


def _contraction(ring, seed, n=6_000, groups=3_000):
    """A sparse contraction whose segment reduction is the sort regime:
    relation attrs (a, b, c), an incoming message over (b, x) with x carried
    (3 lanes), σ on c, out (a, x): G = ``groups``, V = 3 lanes × leaves."""
    rng = np.random.default_rng(seed)
    doms = {"a": groups, "b": 50, "c": 7, "x": 3}
    a = torch.as_tensor(rng.integers(0, groups, n).astype(np.int32))
    b = torch.as_tensor(rng.integers(0, 50, n).astype(np.int32))
    c = torch.as_tensor(rng.integers(0, 7, n).astype(np.int32))
    lift = torch.as_tensor(rng.gamma(2.0, 3.0, n).astype(np.float32))
    msg = torch.as_tensor(rng.gamma(2.0, 3.0, (50, 3)).astype(np.float32))
    if ring is tsr.MOMENTS:
        vals, field = (torch.ones(n), lift, lift * lift), (torch.ones(50, 3), msg, msg * msg)
    else:
        vals, field = lift, msg
    parts = plans._sparse_plan_parts(ring, ("a", "b", "c"), doms, (("b", "x"),), ("c",),
                                     ("a", "x"), n)
    mask = torch.as_tensor(rng.random(7) < 0.7)
    return parts, (vals, (field,), (b,), (mask,), (c,), a)


@pytest.mark.parametrize("ring", list(RINGS))
def test_rowwise_in_code_order_is_the_gathered_slab_permuted(ring):
    """The rowwise stage over the permuted inputs (the lift's leaves, the
    gather indices, the σ row codes) equals the gathered slabs permuted by
    the row order, exactly; they reduce with the same bits as the gathered
    route; a rerun copies nothing.  On the CPU the plan's own route
    (``ordered`` None) takes no order: only the card's kernel reads one."""
    (fn, slab, _, meta), (vals, fields, idx, masks, pcodes, seg) = _contraction(RINGS[ring], 5)
    assert meta.use_kernel and meta.code_order
    before = dict(ops.ORDER_BUILDS)
    rv, gathered, in_order = slab(vals, fields, idx, masks, pcodes, seg, ordered=False)
    assert not in_order
    _, default, in_order = slab(vals, fields, idx, masks, pcodes, seg)
    assert not in_order and ops.ORDER_BUILDS == before
    assert all(torch.equal(x, y) for x, y in zip(default, gathered))
    rv_o, ordered, in_order = slab(vals, fields, idx, masks, pcodes, seg, ordered=True)
    assert in_order and ops.ORDER_BUILDS["copies"] > before["copies"]
    assert len(ordered) == len(gathered) == len(tsr.leaves(rv))
    order = ops.code_order(seg, meta.total, gathered[0].shape[1])
    for x, x_o in zip(gathered, ordered):
        assert torch.equal(x_o, x[order.perm.long()])
    for leaf, leaf_o in zip(tsr.leaves(rv), tsr.leaves(rv_o)):
        assert torch.equal(leaf_o, leaf[order.perm.long()])
    copies = ops.ORDER_BUILDS["copies"]
    slab(vals, fields, idx, masks, pcodes, seg, ordered=True)
    assert ops.ORDER_BUILDS["copies"] == copies
    op = RINGS[ring].kernel_segment_op
    for x, x_o in zip(gathered, ordered):
        want = ops.aggregate_op(seg, x, meta.total, op)
        assert torch.equal(ops.aggregate_op(seg, x_o, meta.total, op, ordered=True), want)
        assert torch.equal(ops.level_aggregate([(seg, x_o, meta.total, True)], op=op)[0], want)
    fn_g = plans._sparse_plan_parts(
        RINGS[ring], ("a", "b", "c"), {"a": 3_000, "b": 50, "c": 7, "x": 3}, (("b", "x"),),
        ("c",), ("a", "x"), 6_000, code_order=False)[0]
    for x, y in zip(tsr.leaves(fn(vals, fields, idx, masks, pcodes, seg).field),
                    tsr.leaves(fn_g(vals, fields, idx, masks, pcodes, seg).field)):
        assert torch.equal(x, y)


def test_code_order_wrappers_refuse_other_regimes():
    """Values in code order exist only for the sort regime: a thread- or
    warp-regime message given as ordered raises."""
    codes, vals = (torch.as_tensor(a) for a in _inputs(4096, 300, 2, 3))
    assert ops.code_order(codes, 300, 2) is None
    with pytest.raises(ValueError, match="sort regime"):
        ops.aggregate_op(codes, vals, 300, ordered=True)


def test_slab_and_unstack_round_trip_with_trailing_dims():
    """``_slab`` flattens each leaf past its rows into a (rows, V) slab of
    its own, a view of a contiguous leaf; ``_unstack`` gives each reduced
    slab back its leaf's shape (covariance: c (n, L), s (n, L, k), Q (n, L,
    k, k))."""
    rng = np.random.default_rng(2)
    n, lanes, k = 37, 3, 4
    leaves = tuple(torch.as_tensor(rng.standard_normal(s).astype(np.float32))
                   for s in ((n, lanes), (n, lanes, k), (n, lanes, k, k)))
    flat = plans._slab(leaves, n)
    assert [x.shape for x in flat] == [(n, lanes), (n, lanes * k), (n, lanes * k * k)]
    assert all(x.data_ptr() == leaf.data_ptr() for x, leaf in zip(flat, leaves))
    back = plans._unstack(flat, leaves, n)
    assert all(torch.equal(a, b) for a, b in zip(back, leaves))
    one = plans._unstack(plans._slab(leaves[1], n), leaves[1], n)
    assert torch.equal(one, leaves[1])
    strided = leaves[2].transpose(2, 3)
    (x,) = plans._slab(strided, n)
    assert x.is_contiguous() and torch.equal(x, strided.reshape(n, -1))


def test_covariance_ring_takes_the_kernel_route_on_the_card_only():
    """The covariance ring's segment ⊕ goes to the segment kernels (each
    leaf a member of its own) on a CUDA device; on the CPU it keeps its float32
    ``index_add_``, as the reference's ``segment_sum``; its slabs stay in
    row order (a permuted copy of its wide lift per order would cost its
    whole width)."""
    ring = tsr.make_covariance_ring(3)
    assert ring.kernel_segment_op == "sum"
    *_, meta = plans._sparse_plan_parts(ring, ("a",), {"a": 4_000}, (), (), ("a",), 64)
    assert meta.use_kernel and not meta.code_order
    assert not meta.kernel_on(torch.zeros(4, dtype=torch.int32))
    assert meta.kernel_on(torch.zeros(4, dtype=torch.int32, device="meta"))


def test_warm_interaction_builds_no_order_and_no_copy():
    """On the CPU the plans build no row order and no code-ordered copy (the
    plain version reads neither), for a first calibration with sort-regime
    messages (codes of 2,000 users), the same interaction again, and a
    fresh Treant over the same catalog; the answers are the same bits."""
    cat = schema.salesforce(n_opp=6_000, n_user=2_000, n_camp=40, n_acc=60)
    warm = dict(ops.ORDER_BUILDS)
    t = Treant(cat, ring=tsr.SUM, device="cpu")
    q = Query.make(cat, ring="sum", measure=("Opp", "amount")).with_group_by("user_id")
    t.register_dashboard("by_user", q)
    first = t.interact("anna", "by_user", q.with_group_by("camp_type"))
    again = t.interact("anna", "by_user", q.with_group_by("camp_type"))
    t.register_dashboard("by_user_again", q)
    fresh = Treant(cat, ring=tsr.SUM, device="cpu")
    fresh.register_dashboard("by_user", q)
    other = fresh.interact("anna", "by_user", q.with_group_by("camp_type"))
    assert ops.ORDER_BUILDS == warm
    assert torch.equal(first.factor.field, again.factor.field)
    assert torch.equal(first.factor.field, other.factor.field)


# ---------------------------------------------------------------------------
# fused members: a recipe (lift, gathered messages, σ) instead of a slab
# ---------------------------------------------------------------------------

from repro_torch.kernels.segment_aggregate import ref as seg_ref  # noqa: E402

FUSE_RINGS = {"sum": tsr.SUM, "count": tsr.COUNT, "tropical_min": tsr.TROPICAL_MIN,
              "tropical_max": tsr.TROPICAL_MAX}


def _star(ring, seed, n=3_000, groups=17):
    """A sparse contraction of the brush's form: relation (a, b, c, d), a
    message over (b, x) and one over (y, d) carrying x and y, a broadcast
    message over e, σ on c and d, out (a, x, y, e): 5 × 3 × 4 lanes."""
    rng = np.random.default_rng(seed)
    doms = {"a": groups, "b": 40, "c": 7, "d": 30, "x": 5, "y": 3, "e": 4}
    codes = [torch.as_tensor(rng.integers(0, doms[k], n).astype(np.int32)) for k in "abcd"]
    f32 = lambda *s: torch.as_tensor(rng.gamma(2.0, 3.0, s).astype(np.float32))  # noqa: E731
    parts = plans._sparse_plan_parts(ring, ("a", "b", "c", "d"), doms,
                                     (("b", "x"), ("y", "d"), ("e",)), ("c", "d"),
                                     ("a", "x", "y", "e"), n)
    masks = (torch.as_tensor(rng.random(7) < 0.7), torch.as_tensor(rng.random(30) < 0.8))
    a, b, c, d = codes
    return parts, (f32(n), (f32(40, 5), f32(3, 30), f32(4)), (b, d, None), masks, (c, d), a)


@pytest.mark.parametrize("ring", list(FUSE_RINGS))
def test_recipe_plain_version_is_rowwise_then_the_reference(ring):
    """The plan's recipe of a contraction, materialized by ``ref.py``
    (``recipe_values``), is the rowwise stage's slab bit for bit, in row
    order and in code order, so the wrappers' plain version of a fused
    member (``recipe_aggregate_ref``) equals ``rowwise`` followed by
    ``segment_aggregate_ref``."""
    r = FUSE_RINGS[ring]
    op = r.kernel_segment_op
    for groups in (17, 3_000):
        (fn, slab, _, meta), args = _star(r, 11, groups=groups)
        seg = args[-1]
        assert meta.recipe is not None and not meta.fused_on(seg)
        for ordered in (False, True):
            _, (values,), in_order = slab(*args, ordered=ordered)
            rc, rc_in_order = meta.recipe(*args, ordered=ordered)
            assert rc_in_order == in_order == (ordered and groups == 3_000)
            assert rc.lanes == 60 and len(rc.messages) == 3 and rc.messages[2][0] is None
            assert torch.equal(seg_ref.recipe_values(rc, seg_ref.IDENTITY[op]), values)
            codes = ops.code_order(seg, meta.total, 60).perm.long() if in_order else None
            codes = seg if codes is None else seg[codes]
            want = seg_ref.segment_aggregate_ref(codes, values, meta.total, op)
            assert torch.equal(seg_ref.recipe_aggregate_ref(codes, rc, meta.total, op), want)
            assert torch.equal(ops.aggregate_op(seg, rc, meta.total, op, ordered=in_order), want)
            assert torch.equal(ops.level_aggregate([(seg, rc, meta.total, in_order)], op)[0],
                               want)


@pytest.mark.parametrize("ring,messages,preds,fuses", [
    ("sum", 3, 3, True), ("count", 2, 0, True), ("tropical_min", 1, 2, True),
    ("tropical_max", 0, 1, True), ("moments", 1, 1, False), ("covariance", 1, 1, False),
    ("bool", 1, 1, False), ("count_i64", 1, 1, False), ("sum", 4, 0, False),
    ("sum", 2, 4, False), ("sum", 0, 0, False)])
def test_recipe_route_reads_the_ring_and_the_counts(ring, messages, preds, fuses):
    """SUM, float32 COUNT, MIN and MAX hand the kernels a recipe; MOMENTS,
    covariance, BOOL, int64 COUNT, messages or σ predicates past the
    kernels' ``SEG_MAX_MESSAGES`` / ``SEG_MAX_PREDICATES``, and a lift with
    neither (its slab is the lift) keep the slab."""
    r = tsr.make_covariance_ring(3) if ring == "covariance" else getattr(tsr, ring.upper())
    assert plans.recipe_route(r, messages, preds) is fuses


def test_wrapper_rejects_a_malformed_recipe():
    """On the CPU, whose plain version would read any of it, the wrappers
    refuse a recipe the kernels would not take: a lift of another dtype, a
    tensor of the wrong shape or not contiguous, more messages or σ
    predicates than the kernels hold, lanes without a message."""
    (_, _, _, meta), args = _star(tsr.SUM, 2)
    seg, total = args[-1], meta.total
    rc, _ = meta.recipe(*args)
    (idx, table, lanes), *rest = rc.messages
    bad = [(TypeError, dict(lift=rc.lift.double())),
           (ValueError, dict(lift=rc.lift[:-1])),
           (ValueError, dict(messages=((idx, table.t(), lanes), *rest))),
           (TypeError, dict(messages=((idx.long(), table, lanes), *rest))),
           (ValueError, dict(messages=rc.messages + rc.messages[:1])),
           (ValueError, dict(preds=rc.preds * 2)),
           (TypeError, dict(preds=((rc.preds[0][0], rc.preds[0][1].int()),))),
           (ValueError, dict(messages=(), lanes=60))]
    for error, change in bad:
        broken = dataclasses.replace(rc, **change)
        with pytest.raises(error):
            ops.aggregate_op(seg, broken, total)
        with pytest.raises(error):
            ops.level_aggregate([(seg, broken, total)])
