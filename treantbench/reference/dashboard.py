"""The reference's own model of a dashboard session's declarative state.

It reads the same plain events the harness hands the program and derives
each viz's :class:`~.join.VizQuery` itself:

- a filter is one σ per attribute (an IN-list or a half-open range), set
  by ``set_filter`` and dropped by ``clear_filter``; it applies to every
  viz but the one that brushed it (its ``source``);
- ``drill`` appends an attribute to a viz's group-by, ``rollup`` drops
  one (default: the last).

A viz is rendered by an event exactly when its query changed since it was
last rendered.
"""

from __future__ import annotations

import numpy as np

from .join import VizQuery


class DashState:
    def __init__(self, vizzes: list[dict], domains: dict):
        """``vizzes``: the traffic's viz entries."""
        self.domains = domains
        self.views = {
            v["name"]: {"ring": v["ring"], "measure": tuple(v["measure"]),
                        "group_by": tuple(v.get("group_by", ()))}
            for v in vizzes
        }
        self.filters: dict[str, tuple[np.ndarray, str | None]] = {}
        self.shown = {name: self.query(name).key() for name in self.views}

    def _mask(self, ev: dict) -> np.ndarray:
        m = np.zeros(self.domains[ev["attr"]], bool)
        if ev.get("values"):
            m[list(ev["values"])] = True
        else:
            m[ev["lo"]:ev["hi"]] = True
        return m

    def apply(self, ev: dict) -> None:
        kind = ev["kind"]
        if kind == "set_filter":
            self.filters[ev["attr"]] = (self._mask(ev), ev.get("source"))
        elif kind == "clear_filter":
            self.filters.pop(ev["attr"], None)
        elif kind == "drill":
            v = self.views[ev["viz"]]
            v["group_by"] = tuple(dict.fromkeys(v["group_by"] + (ev["attr"],)))
        elif kind == "rollup":
            v = self.views[ev["viz"]]
            a = ev.get("attr")
            v["group_by"] = (v["group_by"][:-1] if a is None
                             else tuple(g for g in v["group_by"] if g != a))
        else:
            raise ValueError(f"unknown event kind {kind!r}")

    def query(self, viz: str) -> VizQuery:
        v = self.views[viz]
        filters = tuple((attr, mask) for attr, (mask, source) in sorted(self.filters.items())
                        if source != viz)
        return VizQuery(v["ring"], v["measure"], v["group_by"], filters)

    def render(self) -> dict[str, VizQuery]:
        """The vizzes whose query changed since last shown, with their
        queries; marks them shown."""
        out = {}
        for name in sorted(self.views):
            q = self.query(name)
            if q.key() != self.shown[name]:
                out[name] = q
                self.shown[name] = q.key()
        return out
