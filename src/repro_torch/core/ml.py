"""Factorized ML over CJTs (paper §4.3): linear regression via the covariance
semiring, plus 2-bag augmentation.

Training a linear model over a join is one semiring aggregation: lift each
relation's local features into the covariance ring (c, s, Q), message-pass to
a scalar element, and solve the normal equations from Q.  Augmenting with a
relation r(key, v) attaches a new bag at a bag containing ``key`` and uses r
as the message-passing root — the Steiner tree is exactly {host, r}, so every
base message is reused and each candidate costs ONE message (the paper's 10×
over per-model factorized retraining).

The lifts build (c, s, Q) on the engine's device from the relation's codes
and measures (a categorical feature is a one-hot block of columns, set by a
scatter).  The covariance ring's leaves have trailing dims, so its segment
reductions take the plain torch path in both packages (no segment kernel).
The normal equations are solved on the host in float64.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Sequence

import numpy as np
import torch

from repro_torch.relational.relation import Catalog, Relation
from . import semiring as sr
from .calibration import CJTEngine, ExecStats, MessageStore
from .hypertree import JTree, attach_relation, jt_from_catalog
from .plans import resolve_device
from .query import Query


@dataclasses.dataclass(frozen=True)
class FeatureSpec:
    relation: str
    column: str              # measure column, or attr name if categorical
    categorical: bool = False

    def slots(self, catalog: Catalog) -> int:
        if not self.categorical:
            return 1
        return catalog.get(self.relation).domains[self.column]

    @property
    def tag(self) -> str:
        return f"{self.relation}.{self.column}{'#cat' if self.categorical else ''}"


@dataclasses.dataclass
class FitResult:
    weights: np.ndarray
    r2: float
    sse: float
    sst: float
    stats: ExecStats


class FactorizedLinearRegression:
    """Ridge linear regression over an acyclic join, factorized via CJT.

    Feature layout in the covariance ring: [intercept, features..., aug_slot,
    target].  ``aug_slot`` is reserved so every augmentation candidate shares
    the ring (and therefore the message signatures) of the base model.
    Every engine runs on ``device`` (default ``cuda``; pass ``"cpu"``
    without a card).
    """

    def __init__(
        self,
        catalog: Catalog,
        features: Sequence[FeatureSpec],
        target: FeatureSpec,
        jt: JTree | None = None,
        ridge: float = 1e-3,
        store: MessageStore | None = None,
        device: torch.device | str | None = None,
    ):
        self.catalog = catalog
        self.jt = jt or jt_from_catalog(catalog)
        self.features = list(features)
        self.target = target
        self.ridge = ridge
        self.device = resolve_device(device)
        # global slot layout
        self.slot_of: dict[str, tuple[int, int]] = {}
        idx = 0
        self.slot_of["__intercept__"] = (idx, idx + 1); idx += 1
        for f in self.features:
            n = f.slots(catalog)
            self.slot_of[f.tag] = (idx, idx + n); idx += n
        self.slot_of["__aug__"] = (idx, idx + 1); idx += 1
        self.slot_of["__target__"] = (idx, idx + 1); idx += 1
        self.k = idx
        self.ring = sr.make_covariance_ring(self.k)
        self.store = store if store is not None else MessageStore()
        self.lift_tag = hashlib.sha1(
            ("|".join(sorted(self.slot_of)) + f"k={self.k}").encode()
        ).hexdigest()[:12]
        self.engine = self._engine(self.jt, catalog, self._lifts(catalog), self.store)

    def _engine(self, jt: JTree, catalog: Catalog, lifts: dict, store: MessageStore) -> CJTEngine:
        return CJTEngine(jt, catalog, self.ring, lifts=lifts, store=store, device=self.device)

    # -- lifting -----------------------------------------------------------------
    def _lifts(self, catalog: Catalog) -> dict:
        return {n: self._make_lift(n) for n in catalog.names()}

    def _relation_features(self, rel_name: str) -> list[tuple[FeatureSpec, tuple[int, int]]]:
        out = []
        for f in self.features:
            if f.relation == rel_name:
                out.append((f, self.slot_of[f.tag]))
        return out

    def _column(self, values: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, np.float32), device=self.device)

    def _field(self, s: torch.Tensor) -> sr.Field:
        c = torch.ones((s.shape[0],), dtype=torch.float32, device=self.device)
        return (c, s, s[:, :, None] * s[:, None, :])

    def _make_lift(self, rel_name: str):
        feats = self._relation_features(rel_name)
        is_target_rel = self.target.relation == rel_name
        is_intercept_rel = is_target_rel  # intercept rides on the target relation
        t_lo, _ = self.slot_of["__target__"]
        i_lo, _ = self.slot_of["__intercept__"]
        k = self.k

        def lift(rel: Relation) -> sr.Field:
            s = torch.zeros((rel.num_rows, k), dtype=torch.float32, device=self.device)
            if is_intercept_rel:
                s[:, i_lo] = 1.0
            for spec, (lo, _hi) in feats:
                if spec.categorical:
                    codes = torch.as_tensor(rel.codes[spec.column], device=self.device)
                    s.scatter_(1, (codes.long() + lo)[:, None], 1.0)
                else:
                    s[:, lo] = self._column(rel.measures[spec.column])
            if is_target_rel:
                s[:, t_lo] = self._column(rel.measures[self.target.column])
            return self._field(s)

        return lift

    def _aug_lift(self, column: str):
        a_lo, _ = self.slot_of["__aug__"]
        k = self.k

        def lift(rel: Relation) -> sr.Field:
            s = torch.zeros((rel.num_rows, k), dtype=torch.float32, device=self.device)
            s[:, a_lo] = self._column(rel.measures[column])
            return self._field(s)

        return lift

    # -- solving ------------------------------------------------------------------
    def _feature_slots(self, with_aug: bool) -> list[int]:
        idx = list(range(*self.slot_of["__intercept__"]))
        for f in self.features:
            idx.extend(range(*self.slot_of[f.tag]))
        if with_aug:
            idx.extend(range(*self.slot_of["__aug__"]))
        return idx

    def _solve(self, element, with_aug: bool, stats: ExecStats) -> FitResult:
        c, s, q = [x.detach().cpu().numpy().astype(np.float64) for x in element]
        t = self.slot_of["__target__"][0]
        F = self._feature_slots(with_aug)
        A = q[np.ix_(F, F)] + self.ridge * np.eye(len(F))
        b = q[F, t]
        w = np.linalg.solve(A, b)
        sse = float(q[t, t] - 2.0 * w @ b + w @ (q[np.ix_(F, F)] @ w))
        sst = float(q[t, t] - (s[t] ** 2) / max(c, 1.0))
        r2 = 1.0 - sse / max(sst, 1e-12)
        return FitResult(weights=w, r2=r2, sse=sse, sst=sst, stats=stats)

    def _base_query(self, catalog: Catalog | None = None) -> Query:
        return Query.make(
            catalog or self.catalog, ring=self.ring.name, lift_tag=self.lift_tag
        )

    def fit(self) -> FitResult:
        q = self._base_query()
        factor, stats = self.engine.execute(q)
        return self._solve(factor.field, with_aug=False, stats=stats)

    def calibrate(self) -> ExecStats:
        """Calibrate the base CJT so augmentations become single-message."""
        return self.engine.calibrate(self._base_query(), pin=True)

    # -- augmentation (§4.3, Fig 11) --------------------------------------------------
    def _augmented(self, aug: Relation, column: str, store: MessageStore
                   ) -> tuple[CJTEngine, Query, str]:
        """JT' = JT + bag(aug) attached at a host covering the join key, its
        catalog and lifts, and an engine over them sharing ``store``."""
        jt2, bag = attach_relation(self.jt, aug.name, aug.attrs, aug.domains)
        cat2 = Catalog([self.catalog.get(n) for n in self.catalog.names()] + [aug])
        lifts = self._lifts(self.catalog)
        lifts[aug.name] = self._aug_lift(column)
        return self._engine(jt2, cat2, lifts, store), self._base_query(cat2), bag

    def fit_augmented(self, aug: Relation, column: str = "v") -> FitResult:
        """Join a candidate augmentation relation and refit.

        Roots message passing at the new bag; all base messages are reused
        via the shared store.
        """
        eng2, q, bag = self._augmented(aug, column, self.store)
        stats = ExecStats()
        factor = eng2.absorb(q, bag, stats=stats)
        return self._solve(factor.field, with_aug=True, stats=stats)

    def fit_unfactorized_baseline(self, aug: Relation | None = None, column: str = "v") -> FitResult:
        """``Fac`` baseline: full message passing with a cold store each time."""
        if aug is None:
            eng = self._engine(self.jt, self.catalog, self._lifts(self.catalog), MessageStore())
            factor, stats = eng.execute(self._base_query())
            return self._solve(factor.field, with_aug=False, stats=stats)
        eng2, q, bag = self._augmented(aug, column, MessageStore())
        stats = ExecStats()
        factor = eng2.absorb(q, bag, stats=stats)
        return self._solve(factor.field, with_aug=True, stats=stats)
