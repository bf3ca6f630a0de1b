"""Sparse annotated relations (dictionary-encoded COO) and the catalog.

A relation is a set of dictionary-encoded attribute code columns plus numeric
measure columns, held as numpy arrays on the host.  ``lift_rows`` turns a
relation into per-row semiring fields on a device (COUNT → 1̄, SUM → measure,
MOMENTS → (1,x,x²), tropical → value, …); ``Relation.to_factor`` densifies by
segment ⊕-aggregation.

Digests (``Relation.digest``, ``Predicate.digest``) are sha1 hashes over
host data and equal the JAX package's, so message signatures agree between
the two packages.  Data updates (``append_rows``/``delete_rows``, ``Delta``)
are not ported yet.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
from collections import OrderedDict, deque
from contextlib import contextmanager
from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core import semiring as sr
from repro_torch.core.factor import Factor


def row_bucket(n: int) -> int:
    """Next power of two ≥ ``n`` (min 64) — the padded row count plans use.

    Pad rows carry the ring's ⊕-identity (⊗-absorbing) and aggregate into
    segment 0, so results are bit-identical to the unpadded contraction.
    """
    return 64 if n <= 64 else 1 << int(n - 1).bit_length()


def _digest_array(a: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


class LRU:
    """Tiny bounded mapping with least-recently-used eviction."""

    def __init__(self, capacity: int):
        assert capacity > 0
        self.capacity = capacity
        self._data: OrderedDict = OrderedDict()

    def get(self, key, default=None):
        try:
            self._data.move_to_end(key)
            return self._data[key]
        except KeyError:
            return default

    def put(self, key, value):
        self._data[key] = value
        self._data.move_to_end(key)
        while len(self._data) > self.capacity:
            self._data.popitem(last=False)

    __setitem__ = put

    def __contains__(self, key):
        return key in self._data

    def __len__(self):
        return len(self._data)

    def clear(self):
        self._data.clear()


@dataclasses.dataclass(frozen=True)
class Predicate:
    """σ annotation: a boolean mask over one attribute's domain (paper §3.3).
    Hashable by content digest so message signatures (Prop. 2) can include it."""

    attr: str
    mask: np.ndarray  # bool (domain,)
    label: str = ""

    @functools.cached_property
    def digest(self) -> str:
        return f"{self.attr}:{_digest_array(self.mask)}"

    def __hash__(self):
        return hash(self.digest)

    def __eq__(self, other):
        return isinstance(other, Predicate) and self.digest == other.digest


def mask_in(domain: int, values: Sequence[int], attr: str = "", label: str = "") -> Predicate:
    m = np.zeros((domain,), bool)
    m[np.asarray(list(values), np.int64)] = True
    return Predicate(attr=attr, mask=m, label=label or f"{attr} IN {list(values)[:4]}")


def mask_range(domain: int, lo: int, hi: int, attr: str = "", label: str = "") -> Predicate:
    m = np.zeros((domain,), bool)
    m[lo:hi] = True
    return Predicate(attr=attr, mask=m, label=label or f"{lo}<={attr}<{hi}")


@dataclasses.dataclass(frozen=True)
class Relation:
    """Dictionary-encoded sparse annotated relation."""

    name: str
    attrs: tuple[str, ...]
    codes: Mapping[str, np.ndarray]        # attr -> int32 (N,)
    domains: Mapping[str, int]             # attr -> domain size
    measures: Mapping[str, np.ndarray] = dataclasses.field(default_factory=dict)
    weights: np.ndarray | None = None      # explicit multiplicity annotation
    version: str = "v0"

    @property
    def num_rows(self) -> int:
        return 0 if not self.attrs else int(self.codes[self.attrs[0]].shape[0])

    @property
    def key(self) -> tuple[str, str]:
        return (self.name, self.version)

    @property
    def digest(self) -> str:
        h = hashlib.sha1()
        h.update(self.name.encode())
        h.update(self.version.encode())
        return h.hexdigest()[:16]

    def with_version(self, version: str, **updates) -> "Relation":
        return dataclasses.replace(self, version=version, **updates)

    @property
    def row_bucket(self) -> int:
        """Padded row count for shape-stable plan keys (see :func:`row_bucket`)."""
        return row_bucket(self.num_rows)

    def flat_codes(self, attrs: Sequence[str]) -> tuple[np.ndarray, int]:
        attrs = list(attrs)
        if not attrs:
            return np.zeros((self.num_rows,), np.int64), 1
        dims = [self.domains[a] for a in attrs]
        idx = np.ravel_multi_index(
            tuple(self.codes[a].astype(np.int64) for a in attrs), dims
        )
        return idx, int(np.prod(dims))

    def to_factor(self, ring: sr.Semiring, measure: str | None = None,
                  device: torch.device | str = "cpu") -> Factor:
        rows = lift_rows(self, ring, measure, device)
        idx, total = self.flat_codes(self.attrs)
        field = ring.segment_reduce(rows, torch.as_tensor(idx, device=device), total)
        shape = tuple(self.domains[a] for a in self.attrs)
        field = sr.field_map(lambda leaf: leaf.reshape(shape + tuple(leaf.shape[1:])), field)
        return Factor(tuple(self.attrs), field, ring)


def lift_rows(rel: Relation, ring: sr.Semiring, measure: str | None = None,
              device: torch.device | str = "cpu") -> sr.Field:
    """Per-row semiring elements for a relation (paper §2 annotation lift)."""
    n = rel.num_rows
    w = (
        torch.as_tensor(np.asarray(rel.weights, np.float32), device=device)
        if rel.weights is not None
        else torch.ones((n,), dtype=torch.float32, device=device)
    )

    def column() -> torch.Tensor:
        return torch.as_tensor(np.asarray(rel.measures[measure], np.float32), device=device)

    if ring.name in ("count", "count_i64"):
        return w.to(ring.dtype)
    if ring.name == "sum":
        col = column() if measure else torch.ones((n,), dtype=torch.float32, device=device)
        return col * w
    if ring.name == "moments":
        if measure is None:  # relation doesn't carry the measure → ⊗-identity ⊙ count
            return (w, torch.zeros_like(w), torch.zeros_like(w))
        return sr.moments_lift(column(), w)
    if ring.name in ("tropical_min", "tropical_max"):
        if measure is None:
            return torch.zeros((n,), dtype=torch.float32, device=device)  # ⊗-identity
        return column()
    if ring.name == "bool":
        return torch.ones((n,), dtype=torch.bool, device=device)
    raise KeyError(f"no default lift for ring {ring.name}")


class Catalog:
    """Versioned relation store — the stand-in for DBMS tables.

    Readers resolve relations through the committed watermark (``_latest``);
    writers stage versions with ``put(make_latest=False)`` and advance every
    staged pointer at once with :meth:`commit`.  ``commit_log`` keeps the
    committed snapshots, trimmed to :attr:`commit_retention` except from the
    oldest pinned watermark on.
    """

    def __init__(self, relations: Sequence[Relation] = ()):
        self._store: dict[tuple[str, str], Relation] = {}
        self._latest: dict[str, str] = {}
        self._watermark = 0
        self.commit_retention = 128
        self.commit_log: deque[tuple[int, dict[str, str]]] = deque()
        self._wm_pins: dict[int, int] = {}
        # device-resident flat codes keyed by (relation, version, attrs, device)
        self._dev_codes: LRU = LRU(capacity=512)
        for r in relations:
            self.put(r)

    def dev_flat_codes(self, rel: Relation, attrs: Sequence[str],
                       device: torch.device | str) -> tuple[torch.Tensor, int]:
        """``rel.flat_codes(attrs)`` as an int32 tensor on ``device``, cached.

        Codes are zero-padded to ``rel.row_bucket``: pad rows aggregate at
        index 0 but carry ⊕-identity lift values, so they contribute nothing.
        """
        device = torch.device(device)
        key = (rel.name, rel.version, tuple(attrs), str(device))
        hit = self._dev_codes.get(key)
        if hit is None:
            idx, total = rel.flat_codes(attrs)
            if total > np.iinfo(np.int32).max:  # pragma: no cover — huge domains
                raise ValueError(f"flat domain {total} overflows int32 codes")
            out = np.zeros((rel.row_bucket,), np.int32)
            out[: idx.size] = idx
            hit = (torch.from_numpy(out).to(device), total)
            self._dev_codes.put(key, hit)
        return hit

    def put(self, rel: Relation, make_latest: bool = True) -> None:
        """Store a relation version; ``make_latest=True`` is a single-relation
        commit and advances the watermark."""
        self._store[(rel.name, rel.version)] = rel
        if make_latest or rel.name not in self._latest:
            self._latest[rel.name] = rel.version
            self._advance_watermark()

    def commit(self, versions: Mapping[str, str]) -> int:
        """Atomically advance the latest pointer of every listed (staged)
        relation under ONE watermark bump.  Returns the new watermark."""
        for name, version in versions.items():
            if (name, version) not in self._store:
                raise KeyError(f"commit of unstaged version {name}@{version}")
        for name, version in versions.items():
            self._latest[name] = version
        if versions:
            self._advance_watermark()
        return self._watermark

    @property
    def watermark(self) -> int:
        return self._watermark

    def _advance_watermark(self) -> None:
        self._watermark += 1
        self.commit_log.append((self._watermark, dict(self._latest)))
        self._trim_commit_log()

    def pin_watermark(self, wm: int | None = None) -> int:
        """Hold watermark ``wm`` (default: current) and every later snapshot
        open across trimming until released (refcounted)."""
        wm = self._watermark if wm is None else wm
        self._wm_pins[wm] = self._wm_pins.get(wm, 0) + 1
        return wm

    def release_watermark(self, wm: int) -> None:
        c = self._wm_pins.get(wm, 0) - 1
        if c > 0:
            self._wm_pins[wm] = c
        else:
            self._wm_pins.pop(wm, None)
        self._trim_commit_log()

    @contextmanager
    def snapshot_read(self):
        """Scope a read against a pinned ``(watermark, versions)`` snapshot."""
        wm = self.pin_watermark()
        try:
            yield (wm, dict(self._latest))
        finally:
            self.release_watermark(wm)

    def _trim_commit_log(self) -> None:
        floor = min(self._wm_pins) if self._wm_pins else None
        while len(self.commit_log) > self.commit_retention:
            wm0, _ = self.commit_log[0]
            if floor is not None and wm0 >= floor:
                break
            self.commit_log.popleft()

    def get(self, name: str, version: str | None = None) -> Relation:
        v = version or self._latest[name]
        return self._store[(name, v)]

    def names(self) -> list[str]:
        return sorted(self._latest)

    def latest_version(self, name: str) -> str:
        return self._latest[name]

    def domains(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for (name, _), rel in self._store.items():
            for a, d in rel.domains.items():
                if a in out and out[a] != d:
                    raise ValueError(f"inconsistent domain for {a}")
                out[a] = d
        return out


def catalog_from_arrays(relations: Sequence[Mapping]) -> Catalog:
    """Build a catalog from plain numpy columns.

    Each entry holds ``name``, ``attrs``, ``codes`` (attr → int array),
    ``domains`` (attr → size) and optionally ``measures`` (column → array),
    ``weights`` and ``version``.  Codes become int32 and measures float32,
    as the schema generators store them.
    """
    rels = []
    for r in relations:
        rels.append(Relation(
            name=r["name"],
            attrs=tuple(r["attrs"]),
            codes={a: np.asarray(c, np.int32) for a, c in r["codes"].items()},
            domains=dict(r["domains"]),
            measures={k: np.asarray(v, np.float32) for k, v in (r.get("measures") or {}).items()},
            weights=None if r.get("weights") is None else np.asarray(r["weights"], np.float32),
            version=r.get("version", "v0"),
        ))
    return Catalog(rels)
