"""SPJA answers over the join of the benchmark's tables, in plain PyTorch.

Every attribute of the join is gathered once to the fact's rows (each
non-fact relation is joined on a key that is unique in it); an answer is
then a masked ⊕-reduction of the fact rows into the group-by cells, in
float64, so it is exact up to the float64 rounding of a sum.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch



@dataclasses.dataclass(frozen=True)
class VizQuery:
    """One viz's logical query: ring, measure (relation, column), group-by
    and the filters that apply ((attr, bool mask over its domain) pairs)."""

    ring: str
    measure: tuple[str, str]
    group_by: tuple[str, ...]
    filters: tuple[tuple[str, np.ndarray], ...]

    def key(self) -> tuple:
        return (self.ring, self.measure, self.group_by,
                tuple((a, m.tobytes()) for a, m in self.filters))


class JoinedFact:
    """The fact table with every joined attribute gathered to its rows."""

    def __init__(self, tables, device="cpu"):
        self.domains = dict(tables.domains)
        self.fact = tables.fact
        self.device = torch.device(device)
        dev = self.device
        fact = tables[tables.fact]
        cols = {a: torch.as_tensor(np.asarray(c), device=dev).to(torch.int64)
                for a, c in fact.codes.items()}
        meas = {(self.fact, m): torch.as_tensor(np.asarray(v), device=dev)
                for m, v in fact.measures.items()}
        # rows whose key finds no row of a relation drop out of the join
        self.mask = torch.ones(fact.num_rows, dtype=torch.bool, device=dev)
        for rel in self._join_order(tables.joins):
            key, _ = tables.joins[rel]
            t = tables[rel]
            keys = np.asarray(t.codes[key], np.int64)
            if np.unique(keys).size != keys.size:
                raise ValueError(f"{rel}.{key} is not a key: the reference joins on keys")
            pos = np.full(self.domains[key], -1, np.int64)
            pos[keys] = np.arange(keys.size)
            at = torch.as_tensor(pos, device=dev)[cols[key]]
            self.mask &= at >= 0
            at = at.clamp(min=0)
            for a in t.attrs:
                if a != key and a not in cols:
                    cols[a] = torch.as_tensor(np.asarray(t.codes[a], np.int64), device=dev)[at]
            for m, v in t.measures.items():
                meas[(rel, m)] = torch.as_tensor(np.asarray(v), device=dev)[at]
        self.cols = cols
        self.measures = meas

    def _join_order(self, joins: dict) -> list[str]:
        order, done = [], {self.fact}
        while len(order) < len(joins):
            ready = sorted(r for r, (_, p) in joins.items() if p in done and r not in done)
            if not ready:
                raise ValueError("the joins do not form a tree under the fact")
            order += ready
            done.update(ready)
        return order

    def answer(self, q: VizQuery, dtype: torch.dtype = torch.float64,
               inputs: torch.dtype | None = None) -> tuple[tuple[str, ...], torch.Tensor]:
        """``(group-by attrs, dense answer)`` of ``q``.  Sums accumulate in
        ``dtype``; ``inputs`` rounds each measure value to that type first
        (the controls pass lower precisions)."""
        if q.ring != "sum":
            raise ValueError(f"no reference for ring {q.ring!r}")
        shape = tuple(self.domains[a] for a in q.group_by)
        mask = self.mask.clone()
        for attr, m in q.filters:
            mask &= torch.as_tensor(m, device=self.device)[self.cols[attr]]
        idx = torch.zeros(mask.shape[0], dtype=torch.int64, device=self.device)
        for a in q.group_by:
            idx = idx * self.domains[a] + self.cols[a]
        idx = idx[mask]
        vals = self.measures[tuple(q.measure)][mask]
        vals = (vals if inputs is None else vals.to(inputs)).to(dtype)
        size = int(np.prod(shape)) if shape else 1
        out = torch.zeros(size, dtype=dtype, device=self.device).index_add_(0, idx, vals)
        return q.group_by, out.reshape(shape)
