"""Data cubes over CJTs (paper Appendix D).

A cuboid is just a group-by query; the CJT message cache makes the cube
lattice cheap: calibrating pivot queries with k group-by attributes makes all
(k+1)-attribute cuboids Steiner-tree-local.  ``build_cube`` materializes the
lattice up to ``h`` attrs, reusing messages throughout, and reports the same
cost split as Fig 24 (calibration time against per-cuboid query time).
``CJTEngine.execute`` waits for the device on its result, and the
calibration time ends in a device sync too, so both sides of the split
cover their device work.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Sequence

import torch

from .calibration import CJTEngine
from .factor import Factor
from .query import Query


@dataclasses.dataclass
class CubeReport:
    pivot_k: int
    calibrate_s: float
    cuboids: dict[tuple[str, ...], Factor]
    query_s: dict[tuple[str, ...], float]
    messages_computed: int
    store_bytes: int

    @property
    def total_query_s(self) -> float:
        return sum(self.query_s.values())


def build_cube(
    engine: CJTEngine,
    base_query: Query,
    dims: Sequence[str],
    h: int,
    pivot_k: int | None = None,
) -> CubeReport:
    """Materialize all cuboids over ``dims`` with ≤ h group-by attrs.

    ``pivot_k``: calibrate all pivot queries with k attrs first (Appendix
    D.2's space/time dial).  k=0 calibrates only the base query.
    """
    pivot_k = 0 if pivot_k is None else pivot_k
    t0 = time.perf_counter()
    n_before = len(engine.store)
    engine.calibrate(base_query)
    for combo in itertools.combinations(sorted(dims), pivot_k) if pivot_k else ():
        engine.calibrate(base_query.with_group_by(*combo))
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    calibrate_s = time.perf_counter() - t0

    cuboids: dict[tuple[str, ...], Factor] = {}
    query_s: dict[tuple[str, ...], float] = {}
    for r in range(h + 1):
        for combo in itertools.combinations(sorted(dims), r):
            q = base_query.with_group_by(*combo)
            t1 = time.perf_counter()
            f, _ = engine.execute(q)
            query_s[combo] = time.perf_counter() - t1
            cuboids[combo] = f
    return CubeReport(
        pivot_k=pivot_k,
        calibrate_s=calibrate_s,
        cuboids=cuboids,
        query_s=query_s,
        messages_computed=len(engine.store) - n_before,
        store_bytes=engine.store.nbytes,
    )


def naive_cube_cost(engine_factory, base_query: Query, dims: Sequence[str], h: int):
    """No-sharing baseline: every cuboid recomputed with a cold store."""
    times = {}
    out = {}
    for r in range(h + 1):
        for combo in itertools.combinations(sorted(dims), r):
            eng = engine_factory()
            q = base_query.with_group_by(*combo)
            t1 = time.perf_counter()
            f, _ = eng.execute(q)
            times[combo] = time.perf_counter() - t1
            out[combo] = f
    return out, times
