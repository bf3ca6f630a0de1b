"""The system under test, ``repro_torch``, as the harness drives it: its
catalog built from the benchmark's tables, its typed events made from the
harness's plain ones, and its kernel launch counters."""

from __future__ import annotations

import numpy as np


def catalog(tables):
    """The port's ``Catalog`` of the benchmark's tables (public constructors)."""
    from repro_torch.relational.relation import Catalog, Relation

    return Catalog([
        Relation(name=t.name, attrs=tuple(t.attrs),
                 codes={a: np.asarray(c, np.int32) for a, c in t.codes.items()},
                 domains=dict(tables.domains),
                 measures={m: np.asarray(v, np.float32) for m, v in t.measures.items()})
        for t in tables.tables.values()
    ])


def spec(vizzes: list[dict]):
    from repro_torch.core import DashboardSpec, VizSpec

    return DashboardSpec(vizzes=tuple(
        VizSpec(v["name"], measure=tuple(v["measure"]), ring=v["ring"],
                group_by=tuple(v.get("group_by", ())))
        for v in vizzes
    ))


def event(ev: dict):
    """The port's typed event for one plain event."""
    from repro_torch.core import dashboard as D

    kind = ev["kind"]
    if kind == "set_filter":
        if ev.get("values"):
            return D.SetFilter(ev["attr"], values=tuple(ev["values"]), source=ev.get("source"))
        return D.SetFilter(ev["attr"], lo=ev["lo"], hi=ev["hi"], source=ev.get("source"))
    if kind == "clear_filter":
        return D.ClearFilter(ev["attr"])
    if kind == "drill":
        return D.Drill(ev["viz"], ev["attr"])
    if kind == "rollup":
        return D.Rollup(ev["viz"], ev.get("attr"))
    raise ValueError(f"unknown event kind {kind!r}")


def policy(entry: dict | None):
    """A think-time policy of ``repro_torch.core`` by class name and args."""
    if not entry:
        return None
    import repro_torch.core as core

    return getattr(core, entry["policy"])(*entry.get("args", ()))


def launches() -> int:
    """Kernel launches so far: segment kernels 1-2 and contract kernels 3-4."""
    from repro_torch.kernels.segment_aggregate import ops as seg
    from repro_torch.kernels.semiring_contract import ops as semi
    from repro_torch.kernels.tropical_contract import ops as trop

    return sum(seg.LAUNCHES.values()) + sum(semi.LAUNCHES.values()) + sum(trop.LAUNCHES.values())
