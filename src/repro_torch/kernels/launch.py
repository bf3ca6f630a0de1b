"""The host side of every kernel launch, shared by the four kernel wrappers.

A wrapper call is on the main path's critical path: the contract kernels run
for a few microseconds on the card, so what the host spends before the
launch is most of what a call costs.  This module keeps that small:

- :class:`Kernel` binds a C entry point once, with its ``argtypes``, on
  first use, and keeps it; a call enters no device context when the
  tensor's device is already current and reads the raw stream without
  building a ``torch.cuda.Stream``.  It keeps the split contraction's
  workspace and tickets per (device, stream).
- :func:`contract_geometry` computes the launch geometry of the two contract
  kernels (regime, grid, block, shared memory, split of the contracted
  axis, workspace) once per (shapes, strides, element size, alignment) and
  caches it; the C entry point reads it from a host array and launches.
- :func:`segment_geometry` does the same for the two segment kernels, per
  message from its (rows, segments, columns) alone, and :func:`pack_members`
  lays a launch's messages out in the C member table (:class:`SegTable`).

The geometry lives here, in Python, so the CPU tests reach it.

Nothing here builds or loads a library at import time.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch import trace

from . import build

_P = ctypes.c_void_p
_INT32_MAX = 2**31 - 1


class Kernel:
    """One C entry point ``symbol(args..., stream) -> cudaError_t``, bound on
    first use and kept, with the scratch of its split launches."""

    def __init__(self, symbol: str, argtypes: list):
        self.symbol = symbol
        self.argtypes = [*argtypes, _P]  # the stream comes last
        self._fn = None
        self._lib = None
        self._stream = None
        self._scratch: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}

    def scratch(self, device: torch.device, geom: Geometry | SegLaunch) -> tuple[int, int]:
        """Data pointers of the float32 workspace and the int32 tickets that
        ``geom`` needs (its ``ws`` and ``tickets``), kept for launches on the
        current stream of ``device``.

        They are keyed by (device, stream).  Launches on one stream run in
        order, so a launch's partials are read and its tickets reset (by its
        last block) before the next launch on that stream starts; launches
        on two streams never share them.  A CUDA graph keeps the scratch of
        the stream it was captured on, so it is not replayed while that
        stream launches the same kernel.  The workspace comes from
        ``torch.empty``, the tickets from ``torch.zeros``; both grow on
        demand."""
        key = device.index, torch._C._cuda_getCurrentRawStream(device.index)
        ws, tickets = self._scratch.get(key, (None, None))
        if ws is None or ws.numel() < geom.ws:
            ws = torch.empty(geom.ws, dtype=torch.float32, device=device)
        if tickets is None or tickets.numel() < geom.tickets:
            tickets = torch.zeros(geom.tickets, dtype=torch.int32, device=device)
        self._scratch[key] = ws, tickets
        return ws.data_ptr(), tickets.data_ptr()

    def _bind(self):
        lib = build.load(self.symbol)
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._lib, self._fn = lib, fn
        self._stream = torch._C._cuda_getCurrentRawStream
        return fn

    def __call__(self, device: torch.device, *args, members: int = 1, **attrs) -> None:
        """Launch on the current stream of ``device``; raise on a CUDA error.
        ``members`` (the messages of a segment launch's table) and ``attrs``
        are recorded on the launch's ``kernels.launch`` span."""
        fn = self._fn or self._bind()
        index = device.index
        with trace.span("kernels.launch", symbol=self.symbol, members=members, **attrs):
            if torch.cuda.current_device() == index:
                rc = fn(*args, self._stream(index))
            else:
                with torch.cuda.device(index):
                    rc = fn(*args, self._stream(index))
        if rc:
            build.check(self._lib, self.symbol, rc)


# ---------------------------------------------------------------------------
# launch geometry of semiring_contract and tropical_contract
# ---------------------------------------------------------------------------

TALL, WIDE, TILED = 0, 1, 2
REGIMES = ("tall", "wide", "tiled")
THREADS = 256
TALL_MAX_B = 64          # the tall regime reads a whole M row per thread
TALL_MAX_A = 32          # ... and keeps at most 4 groups of 8 outputs per row
WIDE_MAX_OUT = 1024      # G·A cap of the wide regime: ≤ 256 4×4 register tiles
WIDE_BLOCKS = 2 * 132    # two blocks per SM of an H100
WIDE_MIN_CHUNK = 64      # contracted columns per wide block, at least
WIDE_CLUSTER = 8         # up to this many wide blocks form one cluster (DSMEM sum)
TILED_K = 32
TILED_TARGET_BLOCKS = 132 * 8
# field order of struct Geom in csrc/contract.cuh
GEOM_FIELDS = ("regime", "g", "b", "a", "smg", "smb", "srb", "sra", "half", "m_vec", "r_vec",
               "grid_x", "grid_y", "grid_z", "threads", "smem", "kt", "chunk", "p0", "p1",
               "cluster", "lane_fast")


@dataclasses.dataclass(frozen=True)
class Geometry:
    """One contract launch: every field of ``struct Geom``, the workspace and
    tickets it needs (float32 partials and int32 counters, 0 for none), the
    packed host array and its address, which the C entry point reads."""

    fields: dict
    ws: int
    tickets: int
    packed: ctypes.Array
    address: int

    @property
    def regime(self) -> str:
        return REGIMES[self.fields["regime"]]


def unit_strides(shape, strides) -> tuple[int, int] | None:
    """``(s0, s1)`` of a 2-D view with one of them 1, or None when neither
    axis is unit-stride.  A long axis of stride 1 is the one read along; a
    size-1 axis counts as unit-stride, and its stride as the other axis's
    length."""
    (n0, n1), (s0, s1) = shape, strides
    if n1 > 1 and s1 == 1:
        return (s0 if n0 > 1 else n1), 1
    if n0 > 1 and s0 == 1:
        return 1, (s1 if n1 > 1 else n0)
    if n1 == 1:
        return (s0 if n0 > 1 else 1), 1
    if n0 == 1:
        return 1, s1
    return None


def _vec_ok(outer: int, ld: int, elem: int, aligned: bool) -> bool:
    """16-byte loads along the unit-stride axis: the base is 16-byte aligned
    and so is every row along the other axis."""
    return aligned and (outer == 1 or (ld * elem) % 16 == 0)


def _cdiv(x: int, y: int) -> int:
    return -(-x // y)


@functools.lru_cache(maxsize=1024)
def contract_geometry(g: int, b: int, a: int, m_strides: tuple, r_strides: tuple, elem: int,
                      m_aligned: bool, r_aligned: bool) -> Geometry:
    """The launch of a (G, B) × (B, A) contraction whose M and R have the
    given strides and element size (4 or 2 bytes); ``*_aligned``: the data
    pointer is a multiple of 16.  Raises ``ValueError`` on a shape or layout
    the kernels do not take."""
    if min(g, b, a) < 1 or max(g, b, a) > _INT32_MAX:
        raise ValueError(f"shapes ({g}, {b}) x ({b}, {a}) are out of range")
    ms, rs = unit_strides((g, b), m_strides), unit_strides((b, a), r_strides)
    if ms is None or rs is None:
        raise ValueError(f"m strides {m_strides} and r strides {r_strides}: each operand needs "
                         "one unit-stride axis")
    smg, smb = ms
    srb, sra = rs
    m_rows = smb == 1   # M read along B (row-major); else along G
    r_rows = sra == 1   # R read along A (row-major); else along B
    m_vec = _vec_ok(g if m_rows else b, smg if m_rows else smb, elem, m_aligned)
    r_vec = _vec_ok(b if r_rows else a, srb if r_rows else sra, elem, r_aligned)
    vec = 16 // elem
    f = dict(g=g, b=b, a=a, smg=smg, smb=smb, srb=srb, sra=sra, half=int(elem == 2),
             grid_y=1, grid_z=1, kt=0, chunk=b, p0=0, p1=0, cluster=0, lane_fast=0)
    ws = tickets = 0
    if b <= TALL_MAX_B and a <= TALL_MAX_A:
        ta = 1 if a == 1 else 4 if a <= 4 else 8  # outputs per thread
        ag = _cdiv(a, ta)
        rows = THREADS // ag
        f.update(regime=TALL, grid_x=_cdiv(g, rows), threads=rows * ag, smem=4 * (b * a + b),
                 p0=ta, p1=ag)
    elif g * a <= WIDE_MAX_OUT:
        tiles = _cdiv(g, 4) * _cdiv(a, 4)  # 4x4 register tiles, at most 256
        tpad = 1
        while tpad < tiles:
            tpad *= 2
        lanes = THREADS // tpad
        # lane sums left after the in-warp shuffles (lane_fast: the lanes of a
        # tile are neighbouring threads; else its lanes are tpad apart)
        groups = lanes // (min(lanes, 32) if m_rows else max(1, 32 // tpad))
        blocks = min(WIDE_BLOCKS, _cdiv(b, WIDE_MIN_CHUNK))
        chunk = _cdiv(b, blocks)
        blocks = _cdiv(b, chunk)
        # a few blocks form one cluster and sum through DSMEM, with no ticket;
        # many blocks merge through the workspace (clusters of 8 there were
        # slower: tools/contract_sweep.py)
        cluster = blocks if blocks <= WIDE_CLUSTER else 1
        out = g * a
        merge = out * max(1, THREADS // out)
        f.update(regime=WIDE, grid_x=blocks, threads=THREADS, chunk=chunk,
                 smem=4 * max(groups * tpad * 16 + out, merge), p0=tiles, p1=tpad,
                 cluster=cluster, lane_fast=int(m_rows))
        ws = blocks // cluster * out if blocks > cluster else 0
        tickets = int(ws > 0)  # one for the whole grid
        # 4-wide loads of four neighbouring rows of M (columns of R)
        m_vec = m_aligned and smg == 1 and g % 4 == 0 and smb % 4 == 0
        r_vec = r_aligned and sra == 1 and a % 4 == 0 and srb % 4 == 0
    else:
        ta = 1
        while ta < a and ta < 32:
            ta *= 2
        tg = 1
        while tg < g and tg * ta < THREADS:
            tg *= 2
        gx, gy = _cdiv(g, tg), _cdiv(a, ta)
        ksteps = _cdiv(b, TILED_K)
        splits = 1
        if gx * gy < TILED_TARGET_BLOCKS:
            splits = min(_cdiv(TILED_TARGET_BLOCKS, gx * gy), ksteps)
        kper = _cdiv(ksteps, splits) * TILED_K
        splits = _cdiv(b, kper)
        if gx > _INT32_MAX or gy > 65535 or splits > 65535:
            raise ValueError(f"shapes ({g}, {b}) x ({b}, {a}) exceed the grid")
        # an output tile starts at a multiple of tg rows and ta columns
        m_vec = m_vec and (m_rows or tg % vec == 0)
        r_vec = r_vec and (not r_rows or ta % vec == 0)
        f.update(regime=TILED, grid_x=gx, grid_y=gy, grid_z=splits, threads=tg * ta,
                 kt=TILED_K, chunk=kper, smem=4 * TILED_K * (tg + 1 + ta + 1), p0=tg, p1=ta)
        ws = splits * g * a if splits > 1 else 0
        tickets = gx * gy if ws else 0  # one per output tile
    f.update(m_vec=int(m_vec), r_vec=int(r_vec))
    packed = (ctypes.c_longlong * len(GEOM_FIELDS))(*(f[k] for k in GEOM_FIELDS))
    return Geometry(fields=f, ws=ws, tickets=tickets, packed=packed,
                    address=ctypes.addressof(packed))


def contract_args(m: torch.Tensor, r: torch.Tensor, dtypes: tuple) -> Geometry:
    """Check a CUDA contract call's operands and return its geometry: ``m``
    (G, B) and ``r`` (B, A) on one device, of one dtype in ``dtypes``, each
    with one unit-stride axis.  No copy is made: any other layout raises."""
    if r.device != m.device:
        raise ValueError(f"m on {m.device} and r on {r.device}: both must be on one CUDA device")
    if m.dtype not in dtypes or r.dtype != m.dtype:
        raise TypeError(f"need m and r of one dtype in {dtypes}, got {m.dtype}, {r.dtype}")
    if m.dim() != 2 or r.dim() != 2 or m.shape[1] != r.shape[0]:
        raise ValueError(f"need m (G, B) and r (B, A), got {tuple(m.shape)}, {tuple(r.shape)}")
    (g, b), a = m.shape, r.shape[1]
    return contract_geometry(g, b, a, m.stride(), r.stride(), m.element_size(),
                             m.data_ptr() % 16 == 0, r.data_ptr() % 16 == 0)


# ---------------------------------------------------------------------------
# launch geometry of segment_aggregate and level_segment_aggregate
# ---------------------------------------------------------------------------

SEG_THREAD, SEG_WARP, SEG_SORT, SEG_SORT_ORDERED, SEG_FUSED, SEG_MERGE = 0, 1, 2, 3, 4, 8
SEG_REGIMES = ("thread", "warp", "sort")
SEG_GRIDS = 9               # segagg::kGrids: a grid per regime (sort in two forms) for slab
                            # members, the same four for fused members (SEG_FUSED + r), then merge
SEG_WARPS = THREADS // 32
SEG_THREAD_G = 96           # G of one thread's copy (one column): 256 copies fill 96 KiB
SEG_THREAD_COLS = 256       # columns of a thread-regime tile: one per thread, at most
SEG_WARP_CELLS = 1472       # G·V of one warp's copy: 8 copies and their code tags fit 94 KiB
SEG_MIN_ROWS = 2048         # rows per block, at least
SEG_TARGET_BLOCKS = 1024    # blocks a long message (per column tile) is cut into
SEG_MERGE_CELLS = 1 << 20   # block partials of one warp-regime message, at most
SEG_PIECE_ELEMS = 1 << 15   # sort: values per piece of a segment
SEG_MAX_MEMBERS = 40        # segagg::kMaxMembers
SEG_MAX_MESSAGES = 3        # segagg::kMaxMsgs: gathered messages of a recipe
SEG_MAX_PREDICATES = 3      # segagg::kMaxPreds: σ predicates of a recipe


@dataclasses.dataclass(frozen=True)
class SegGeometry:
    """One message's part of a segment launch (see csrc/segment_aggregate.cuh).

    ``chunk`` is the rows per block, about (thread, warp: the blocks take
    the rows grid-stride), or per piece of a segment (sort); ``blocks`` the
    blocks per column tile; ``ws`` the float32 partials the merge grid
    combines and ``merge`` its warps for this message (0 for none).  A sort
    message's blocks and partials follow from its row order
    (:func:`sort_launch`), so they are 0 here."""

    regime: int
    vt: int
    tiles: int
    chunk: int
    blocks: int
    smem: int
    ws: int
    merge: int

    @property
    def name(self) -> str:
        return SEG_REGIMES[self.regime]


@functools.lru_cache(maxsize=4096)
def segment_geometry(n: int, g: int, v: int) -> SegGeometry:
    """The regime and partition of one message of ``n`` rows, ``g``
    segments and ``v`` columns: a function of those three numbers alone,
    never of the card, the stream or the launch's other messages, so the
    order of every float sum is fixed by the message itself."""
    if min(n, g, v) < 1 or max(n, g * v) > _INT32_MAX:
        raise ValueError(f"segment reduction of {n} rows into {g} x {v} is out of range")
    if g <= SEG_THREAD_G:
        regime, vt, smem = SEG_THREAD, min(v, SEG_THREAD_COLS), 4 * THREADS * g
        cap = SEG_TARGET_BLOCKS
    elif g * v <= SEG_WARP_CELLS:  # a copy of the cells and a lane mask per code, per warp
        regime, vt, smem = SEG_WARP, v, 4 * SEG_WARPS * g * (v + 1)
        cap = max(1, min(SEG_TARGET_BLOCKS, SEG_MERGE_CELLS // (g * v)))
    else:  # more cells than a warp's copy holds: segment-major
        return SegGeometry(SEG_SORT, v, 1, max(32, SEG_PIECE_ELEMS // v), 0, 0, 0, 0)
    tiles = _cdiv(v, vt)
    blocks = min(cap, _cdiv(n, SEG_MIN_ROWS))
    chunk = _cdiv(n, blocks)
    blocks = _cdiv(n, chunk)
    cells = tiles * g * vt
    return SegGeometry(regime, vt, tiles, chunk, blocks, smem,
                       cells * blocks if blocks > 1 else 0, cells if blocks > 1 else 0)


def sort_launch(geom: SegGeometry, v: int, n_items: int, n_slots: int,
                n_splits: int) -> SegGeometry:
    """A sort message's geometry once its row order is known: one warp per
    work item, the pieces of split segments in the workspace, one merge warp
    per (split segment, column)."""
    return dataclasses.replace(geom, blocks=_cdiv(n_items, SEG_WARPS), ws=n_slots * v,
                               merge=n_splits * v)


class SegMember(ctypes.Structure):
    """``struct segagg::Member``, field for field."""

    _fields_ = [("index", _P), ("values", _P), ("out", _P), ("items", _P),
                ("n", ctypes.c_longlong), ("chunk", ctypes.c_longlong),
                ("ws", ctypes.c_longlong),
                ("g", ctypes.c_int), ("v", ctypes.c_int), ("regime", ctypes.c_int),
                ("vt", ctypes.c_int), ("tiles", ctypes.c_int), ("blocks", ctypes.c_int),
                ("first_block", ctypes.c_int), ("aux", ctypes.c_int),
                ("n_items", ctypes.c_int), ("n_splits", ctypes.c_int)]


class SegTable(ctypes.Structure):
    """``struct segagg::Table``: the kernel's by-value parameter.  Members
    are grouped by grid; per grid (thread, warp, sort through the row
    order, sort in code order, for slab members and then for fused ones,
    then the merge grid over all members), the index of its first member,
    its member count, grid and dynamic shared memory."""

    _fields_ = [("count", ctypes.c_int), ("pad", ctypes.c_int),
                ("first", ctypes.c_int * SEG_GRIDS), ("members", ctypes.c_int * SEG_GRIDS),
                ("grid", ctypes.c_int * SEG_GRIDS), ("smem", ctypes.c_int * SEG_GRIDS),
                ("m", SegMember * SEG_MAX_MEMBERS)]


class SegRecipe(ctypes.Structure):
    """``struct segagg::Recipe``, field for field: a fused member's lift,
    its gathered messages (index, table, lane columns, table width) and its
    σ predicates (codes, domain mask), ``add`` for a ⊗ of +."""

    _fields_ = [("lift", _P), ("idx", _P * SEG_MAX_MESSAGES), ("tab", _P * SEG_MAX_MESSAGES),
                ("lane_col", _P * SEG_MAX_MESSAGES), ("codes", _P * SEG_MAX_PREDICATES),
                ("mask", _P * SEG_MAX_PREDICATES), ("cols", ctypes.c_int * SEG_MAX_MESSAGES),
                ("msgs", ctypes.c_int), ("preds", ctypes.c_int), ("add", ctypes.c_int),
                ("pad", ctypes.c_int)]


class SegRecipes(ctypes.Structure):
    """``struct segagg::Recipes``: the fused grids' second by-value
    parameter, the recipes of a launch's fused members in table order."""

    _fields_ = [("r", SegRecipe * SEG_MAX_MEMBERS)]


@dataclasses.dataclass(frozen=True)
class SegLaunch:
    """One packed launch: the table, its fused members' recipes (None when
    it has none), its blocks over all grids, the most dynamic shared memory
    of one of them and its float32 workspace (0 for none; ``tickets`` is
    :meth:`Kernel.scratch`'s, and 0)."""

    table: SegTable
    recipes: SegRecipes | None
    grid: int
    smem: int
    ws: int
    tickets: int = 0


def pack_members(members, recipes=None) -> list[SegLaunch]:
    """Lay messages out in member tables, at most ``SEG_MAX_MEMBERS`` per
    launch, in order.  Each member is ``(geom, index_ptr, values_ptr,
    out_ptr, items_ptr, n, g, v, n_items, n_splits, ordered)`` with the
    geometry of :func:`segment_geometry` (or :func:`sort_launch`);
    ``ordered`` (sort only, with no index) marks values that arrive in code
    order: that member runs in the grid ``SEG_SORT_ORDERED``.  ``recipes``
    (one per member, None for a slab member) gives a fused member's
    :class:`SegRecipe`: it passes no values and runs in its regime's fused
    grid, ``SEG_FUSED`` + the grid it would take.  In a table the members
    are grouped by grid (stably: each grid runs once); a member gets its
    grid's next blocks, the next stretch of the workspace and the merge
    grid's next warps, and nothing else of it depends on the others."""
    recipes = [None] * len(members) if recipes is None else list(recipes)

    def grid_of(j) -> int:
        member = members[j]
        grid = SEG_SORT_ORDERED if member[-1] else member[0].regime
        return grid + SEG_FUSED if recipes[j] is not None else grid

    launches = []
    for lo in range(0, len(members), SEG_MAX_MEMBERS):
        group = sorted(range(lo, min(len(members), lo + SEG_MAX_MEMBERS)), key=grid_of)
        table = SegTable(count=len(group))
        fused = SegRecipes() if any(recipes[j] is not None for j in group) else None
        blocks, smem = [0] * SEG_GRIDS, [0] * SEG_GRIDS
        count = [0] * (SEG_GRIDS - 1) + [len(group)]
        ws = merge = nfused = 0
        for j, i in enumerate(group):
            geom, index, values, out, items, n, g, v, n_items, n_splits, _ = members[i]
            r = grid_of(i)
            if recipes[i] is not None:
                fused.r[nfused] = recipes[i]
                nfused += 1
            table.m[j] = SegMember(
                index=index, values=values, out=out, items=items, n=n, chunk=geom.chunk, ws=ws,
                g=g, v=v, regime=r, vt=geom.vt, tiles=geom.tiles, blocks=geom.blocks,
                first_block=blocks[r], aux=merge, n_items=n_items, n_splits=n_splits)
            blocks[r] += geom.blocks * geom.tiles
            smem[r] = max(smem[r], geom.smem)
            count[r] += 1
            ws += geom.ws
            merge += geom.merge
        blocks[SEG_MERGE] = _cdiv(merge, SEG_WARPS)
        if max(blocks) > _INT32_MAX or merge > _INT32_MAX:
            raise ValueError(f"a segment launch of {max(blocks)} blocks exceeds the grid")
        table.first[:] = [sum(count[:r]) for r in range(SEG_GRIDS - 1)] + [0]
        table.members[:], table.grid[:], table.smem[:] = count, blocks, smem
        launches.append(SegLaunch(table, fused, sum(blocks), max(smem), ws))
    return launches
