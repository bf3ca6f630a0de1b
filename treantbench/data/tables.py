"""Plain tables shared by the program's catalog and the reference."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Table:
    """One relation: int32 code columns and float32 measure columns."""

    name: str
    attrs: tuple[str, ...]
    codes: dict[str, np.ndarray]
    measures: dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    @property
    def num_rows(self) -> int:
        return int(self.codes[self.attrs[0]].shape[0])


@dataclasses.dataclass
class Tables:
    """A deployment's data: its relations, attribute domains, the fact
    relation and each other relation's join (key attribute, parent)."""

    tables: dict[str, Table]
    domains: dict[str, int]
    fact: str
    joins: dict[str, tuple[str, str]]  # relation -> (key attr, parent relation)

    def __getitem__(self, name: str) -> Table:
        return self.tables[name]


def zipf_p(domain: int, s: float) -> np.ndarray:
    """P(rank r) ∝ r^-s over ranks 1..``domain`` (uniform for ``s`` = 0)."""
    p = 1.0 / np.arange(1, domain + 1, dtype=np.float64) ** s
    return p / p.sum()
