"""The general event generator: one analyst's events, drawn from a seed
under the weights and parameters of a traffic mix's ``"events"`` entry.

Kinds (each a weight in ``"weights"``):

- ``range_drag``: a range on the current brush dimension; moves the last
  range by 1-2 positions, or starts a range of 1 to a third of the domain;
- ``in_jump``: an IN-list of ``in_values`` [lo, hi] distinct values on the
  current brush dimension;
- ``clear``: clears the current brush dimension's filter;
- ``switch_dim``: makes another brush dimension current and starts a range
  on it;
- ``drill``: a viz of ``drill_vizzes`` rolls up its drilled attribute if it
  has one, or else drills into one of ``drill_dims`` it lacks.

A brush on dimension ``d`` names ``brush_dims[d]`` as its source viz.  The
generator reads the session's current state from the reference's model
(:class:`treantbench.reference.dashboard.DashState`), which the caller
advances with every event, so the same seed gives the same events.

Every seed gets the same work: the shape of the stream (kinds, dimensions,
vizzes, drilled attributes, range widths, drag steps, IN-list
lengths) is drawn from the mix's fixed ``shape_seed``, and only the values
(where a range sits, which values an IN-list holds) from the run's seed.
"""

from __future__ import annotations

import numpy as np


class EventGenerator:
    def __init__(self, spec: dict, vizzes: list[dict], domains: dict, seed: int, stream: int):
        self.p = spec
        self.domains = domains
        self.rng = np.random.default_rng([spec["shape_seed"], stream])   # the shape
        self.values = np.random.default_rng([seed, stream])
        names = sorted(spec["weights"])
        w = np.array([spec["weights"][k] for k in names], np.float64)
        self.kinds, self.cum = names, np.cumsum(w / w.sum())
        self.dims = list(spec["brush_dims"])
        self.dim = spec.get("start_dim", self.dims[0])
        self.base_gb = {v["name"]: tuple(v.get("group_by", ())) for v in vizzes}
        self.ranges: dict[str, tuple[int, int]] = {}

    def _pick(self, seq):
        return seq[int(self.rng.integers(0, len(seq)))]

    def _range(self, dim: str) -> dict:
        d = self.domains[dim]
        width = int(self.rng.integers(1, max(1, d // 3) + 1))
        lo = int(self.values.integers(0, d - width + 1))
        return self._set_range(dim, lo, lo + width)

    def _set_range(self, dim: str, lo: int, hi: int) -> dict:
        self.ranges[dim] = (lo, hi)
        return {"kind": "set_filter", "attr": dim, "lo": lo, "hi": hi,
                "source": self.p["brush_dims"][dim]}

    def _in_list(self, dim: str) -> dict:
        lo, hi = self.p.get("in_values", [1, 3])
        k = int(self.rng.integers(lo, hi + 1))
        vals = sorted(int(v) for v in self.values.choice(self.domains[dim], k, replace=False))
        self.ranges.pop(dim, None)
        return {"kind": "set_filter", "attr": dim, "values": vals,
                "source": self.p["brush_dims"][dim]}

    def next(self, state) -> dict:
        kind = self.kinds[int(np.searchsorted(self.cum, self.rng.random(), side="right"))]
        if kind == "range_drag":
            d = self.domains[self.dim]
            cur = state.filters.get(self.dim)
            last = self.ranges.get(self.dim)
            if cur is not None and last is not None and cur[0][last[0]:last[1]].all() \
                    and cur[0].sum() == last[1] - last[0]:
                step = int(self.rng.integers(1, 3)) * (1 if self.rng.random() < 0.5 else -1)
                lo = min(max(last[0] + step, 0), d - (last[1] - last[0]))
                return self._set_range(self.dim, lo, lo + last[1] - last[0])
            return self._range(self.dim)
        if kind == "in_jump":
            return self._in_list(self.dim)
        if kind == "clear":
            return {"kind": "clear_filter", "attr": self.dim}
        if kind == "switch_dim":
            self.dim = self._pick([d for d in self.dims if d != self.dim])
            return self._range(self.dim)
        if kind == "drill":
            viz = self._pick(self.p["drill_vizzes"])
            gb = state.views[viz]["group_by"]
            extra = [a for a in gb if a not in self.base_gb[viz]]
            if extra:
                return {"kind": "rollup", "viz": viz, "attr": extra[-1]}
            attr = self._pick([a for a in self.p["drill_dims"] if a not in gb])
            return {"kind": "drill", "viz": viz, "attr": attr}
        raise ValueError(f"unknown event kind {kind!r}")
