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
  The geometry lives here, in Python, so the CPU tests reach it.

Nothing here builds or loads a library at import time.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

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

    def scratch(self, device: torch.device, geom: Geometry) -> tuple[int, int]:
        """Data pointers of the float32 workspace and the int32 tickets that
        ``geom`` needs, kept for launches on the current stream of ``device``.

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

    def __call__(self, device: torch.device, *args) -> None:
        """Launch on the current stream of ``device``; raise on a CUDA error."""
        fn = self._fn or self._bind()
        index = device.index
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
