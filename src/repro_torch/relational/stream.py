"""Streaming ingestion: per-relation micro-batch coalescing.

The paper's premise is dashboards over *live* joins: materialization pays off
only if sustained write traffic is absorbed without recalibrating CJTs per
row-batch.  A :class:`StreamBuffer` accumulates append/delete micro-batches
for one relation and, at each tick (``Treant.flush``), coalesces everything
pending into **one** signed :class:`~repro_torch.relational.relation.Delta` — one
version bump and one ``apply_delta`` sweep of the n−1 outward messages per
tick, however many micro-batches arrived.

Coalescing rules:

- Rows appended *and* deleted within the same tick cancel: they never enter
  the delta (and never the relation) at all.
- Deleted pre-existing rows are **tombstoned** — kept physically at weight 0
  (the exact ⊕-zero under every group-ring lift) — and contribute negated
  original weights to the delta.  Keeping the rows makes the mixed delta
  absorbable by idempotent rings too (MIN/MAX/BOOL: lifts ignore weights,
  ⊕ is idempotent), so inverse-free rings do NOT fall back every tick.
- The buffer carries the tombstone ledger; once ``tombstone_fraction``
  crosses the compaction threshold, ``Treant.flush`` reclaims the rows via
  ``Relation.compact`` (a real recalibration for idempotent rings, scheduled
  at lowest priority — group rings just re-key).

Delete masks index the *current logical rows*: the buffered relation's rows
(tombstones included — re-deleting one is a no-op) followed by every row
appended in this tick, in arrival order.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .relation import Delta, Relation, _delta_suffix


@dataclasses.dataclass
class StreamStats:
    """Cumulative per-buffer ingest accounting (across ticks)."""

    batches: int = 0          # micro-batches accepted (append + delete calls)
    rows_appended: int = 0    # appended rows that survived into a delta
    rows_deleted: int = 0     # pre-existing rows tombstoned
    rows_cancelled: int = 0   # same-tick append+delete pairs (never materialized)
    ticks: int = 0            # coalesce() calls that produced a delta
    compactions: int = 0      # tombstone reclaims


class CompactionPolicy:
    """Per-relation compaction threshold learned from the observed delete mix.

    One global compaction threshold mis-serves mixed workloads: an
    append-mostly relation should tolerate a deep tombstone ledger (compaction
    recalibrates idempotent rings — expensive, so defer), while a
    delete-heavy relation should reclaim early (its ledger grows every tick
    and each tombstone inflates every message contraction over the ring).

    The policy keeps an EWMA of each relation's per-tick delete fraction
    ``n_del / (n_del + n_app)`` and maps it to a threshold around the
    configured base: delete fraction 0 → ``1.5 × base`` (defer), delete
    fraction 1 → ``0.5 × base`` (eager), linear in between, clamped to
    ``[0.5 × base, min(0.9, 1.5 × base)]``.  A relation with no observations
    keeps the base threshold, and ``base <= 0`` still means "compact on any
    tombstone" regardless of the mix.
    """

    def __init__(self, alpha: float = 0.25):
        self.alpha = alpha
        self._ewma: dict[str, float] = {}

    def observe(self, relation: str, n_app: int, n_del: int) -> None:
        """Fold one tick's delete mix into the relation's EWMA."""
        total = n_app + n_del
        if total <= 0:
            return
        frac = n_del / total
        prev = self._ewma.get(relation)
        self._ewma[relation] = (
            frac if prev is None else (1 - self.alpha) * prev + self.alpha * frac
        )

    def delete_mix(self, relation: str) -> float | None:
        """The learned EWMA delete fraction, or None before any observation."""
        return self._ewma.get(relation)

    def threshold(self, relation: str, base: float) -> float:
        if base <= 0:
            return base
        mix = self._ewma.get(relation)
        if mix is None:
            return base
        return min(0.9, base * (1.5 - mix))

    def state(self, base: float) -> dict[str, dict[str, float]]:
        """Learned per-relation posture for introspection/benching: the EWMA
        delete mix and the effective threshold derived from ``base``.  Only
        relations with at least one observation appear (sorted by name)."""
        return {
            name: {"ewma": ewma, "threshold": self.threshold(name, base)}
            for name, ewma in sorted(self._ewma.items())
        }


class StreamBuffer:
    """Accumulates one relation's pending micro-batches between ticks."""

    def __init__(self, rel: Relation):
        self._base = rel
        self._tombstones = rel.tombstone_count
        self.stats = StreamStats()
        self._reset_pending()

    def _reset_pending(self) -> None:
        self._app_codes: dict[str, list[np.ndarray]] = {a: [] for a in self._base.attrs}
        self._app_meas: dict[str, list[np.ndarray]] = {m: [] for m in self._base.measures}
        self._app_w: list[np.ndarray] = []
        self._app_del: list[np.ndarray] = []  # per-batch delete marks
        self._n_app = 0
        self._del_base: np.ndarray | None = None

    # -- introspection --------------------------------------------------------
    @property
    def relation(self) -> str:
        return self._base.name

    @property
    def base(self) -> Relation:
        """The relation version this buffer's pending batches chain from."""
        return self._base

    @property
    def pending_appends(self) -> int:
        return self._n_app

    @property
    def pending_deletes(self) -> int:
        n = 0 if self._del_base is None else int(self._del_base.sum())
        return n + sum(int(d.sum()) for d in self._app_del)

    @property
    def has_pending(self) -> bool:
        return self._n_app > 0 or (
            self._del_base is not None and bool(self._del_base.any())
        )

    def tombstone_fraction(self) -> float:
        """Fraction of the current base version's rows that are tombstones."""
        return self._tombstones / max(1, self._base.num_rows)

    # -- ingestion ------------------------------------------------------------
    def append(
        self,
        codes,
        measures=None,
        weights=None,
    ) -> int:
        """Queue an append micro-batch; returns the number of rows queued."""
        base = self._base
        measures = dict(measures or {})
        if set(codes) != set(base.attrs):
            raise ValueError(
                f"append codes {sorted(codes)} != attrs {sorted(base.attrs)}"
            )
        if set(measures) != set(base.measures):
            raise ValueError("appended rows must supply every measure column")
        arrs = {a: np.asarray(codes[a], np.int32) for a in base.attrs}
        n = arrs[base.attrs[0]].shape[0] if base.attrs else 0
        if n == 0:
            return 0
        for a in base.attrs:
            self._app_codes[a].append(arrs[a])
        for m in base.measures:
            self._app_meas[m].append(
                np.asarray(measures[m], base.measures[m].dtype)
            )
        self._app_w.append(
            np.asarray(weights, np.float32) if weights is not None
            else np.ones((n,), np.float32)
        )
        self._app_del.append(np.zeros((n,), bool))
        self._n_app += n
        self.stats.batches += 1
        return n

    def delete(self, row_mask) -> int:
        """Queue a delete micro-batch over the current logical rows.

        The mask covers ``base.num_rows + pending_appends`` rows: the base
        version's physical rows (tombstones included; re-deleting one is
        ignored) followed by this tick's appended rows in arrival order.
        Returns the number of rows newly marked.
        """
        row_mask = np.asarray(row_mask, bool)
        nb = self._base.num_rows
        expect = nb + self._n_app
        if row_mask.shape != (expect,):
            raise ValueError(f"mask shape {row_mask.shape} != ({expect},)")
        marked = 0
        base_part = row_mask[:nb].copy()
        if self._base.weights is not None:
            base_part &= np.asarray(self._base.weights, np.float32) != 0.0
        if self._del_base is None:
            if base_part.any():
                self._del_base = base_part
                marked += int(base_part.sum())
        else:
            newly = base_part & ~self._del_base
            self._del_base |= base_part
            marked += int(newly.sum())
        off = nb
        for d in self._app_del:
            part = row_mask[off:off + d.shape[0]]
            marked += int((part & ~d).sum())
            d |= part
            off += d.shape[0]
        self.stats.batches += 1
        return marked

    # -- tick boundary --------------------------------------------------------
    def coalesce(self, version: str | None = None) -> tuple[Relation, Delta | None]:
        """Collapse all pending micro-batches into one relation version and
        ONE signed delta; rebases the buffer onto the new version.

        Returns ``(base, None)`` when nothing pending survives (including the
        case where every appended row was deleted again within the tick).
        """
        base = self._base
        nb = base.num_rows
        # surviving appends
        if self._n_app:
            app_keep = ~np.concatenate(self._app_del)
            cancelled = int((~app_keep).sum())
            surv_codes = {
                a: np.concatenate(self._app_codes[a])[app_keep] for a in base.attrs
            }
            surv_meas = {
                m: np.concatenate(self._app_meas[m])[app_keep] for m in base.measures
            }
            surv_w = np.concatenate(self._app_w)[app_keep]
            n_surv = int(app_keep.sum())
        else:
            cancelled = n_surv = 0
            surv_codes = {a: np.zeros((0,), np.int32) for a in base.attrs}
            surv_meas = {m: np.zeros((0,), base.measures[m].dtype)
                         for m in base.measures}
            surv_w = np.zeros((0,), np.float32)
        del_mask = (
            self._del_base if self._del_base is not None
            else np.zeros((nb,), bool)
        )
        n_del = int(del_mask.sum())
        self._reset_pending()
        self.stats.rows_cancelled += cancelled
        if n_surv == 0 and n_del == 0:
            return base, None

        base_w = base._materialized_weights()
        delta_codes = {
            a: np.concatenate([surv_codes[a],
                               np.asarray(base.codes[a], np.int32)[del_mask]])
            for a in base.attrs
        }
        delta_meas = {
            m: np.concatenate([surv_meas[m], base.measures[m][del_mask]])
            for m in base.measures
        }
        delta_w = np.concatenate([surv_w, -base_w[del_mask]])
        suffix = _delta_suffix(base.version, "s", delta_codes, delta_meas, delta_w)
        new_version = version or f"{base.version}+{suffix}"
        delta_rows = dataclasses.replace(
            base, codes=delta_codes, measures=delta_meas, weights=delta_w,
            version=f"{base.version}Δ{suffix}",
        )
        # new relation: base rows (deleted ones tombstoned at weight 0)
        # followed by the surviving appends
        new_w = base_w.copy()
        new_w[del_mask] = 0.0
        keep_weights = (
            base.weights is not None or n_del > 0
            or bool((surv_w != 1.0).any())
        )
        new_rel = dataclasses.replace(
            base,
            codes={a: np.concatenate([np.asarray(base.codes[a], np.int32),
                                      surv_codes[a]]) for a in base.attrs},
            measures={m: np.concatenate([base.measures[m], surv_meas[m]])
                      for m in base.measures},
            weights=np.concatenate([new_w, surv_w]) if keep_weights else None,
            version=new_version,
        )
        kind = "append" if n_del == 0 else ("delete" if n_surv == 0 else "mixed")
        delta = Delta(
            relation=base.name, old_version=base.version,
            new_version=new_version, rows=delta_rows, kind=kind,
            tombstoned=n_del > 0,
        )
        self._base = new_rel
        self._tombstones += n_del
        self.stats.rows_appended += n_surv
        self.stats.rows_deleted += n_del
        self.stats.ticks += 1
        return new_rel, delta

    def rebase(self, rel: Relation) -> None:
        """Point the buffer at an externally produced version (compaction).

        Only valid between ticks — pending micro-batches index the old
        version's rows, so rebasing would silently misalign them.
        """
        if self.has_pending:
            raise ValueError("cannot rebase a buffer with pending micro-batches")
        self._base = rel
        self._tombstones = rel.tombstone_count
        self._reset_pending()
        self.stats.compactions += 1
