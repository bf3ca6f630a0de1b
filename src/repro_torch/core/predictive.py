"""Think-time policies: ONE policy object owns the idle budget.

User *think-time* hides the cost of the next interaction.  A
:class:`ThinkTimePolicy` decides, under one shared :class:`ThinkTimeBudget`,
how idle capacity is spent.  This slice ports the base policy and
:class:`DrainCalibration` (drain the scheduler's pending CJT passes, the
default); the speculative policies (σ prefetch, bin cubes) are not ported
yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover — cycle guard (dashboard imports us)
    from .dashboard import Session


@dataclasses.dataclass(frozen=True)
class ThinkTimeBudget:
    """One shared budget for a think-time tick.

    ``messages`` bounds calibration edges, ``seconds`` bounds wall time for
    the whole tick, ``viz`` optionally scopes the drain to one viz (the
    legacy ``Treant.think_time`` contract).
    """

    messages: int | None = None
    seconds: float | None = None
    viz: str | None = None

    def slack(self, t0: float, done_messages: int) -> bool:
        """Is there budget left after the calibration drain?"""
        if self.seconds is not None and time.perf_counter() - t0 >= self.seconds:
            return False
        if self.messages is not None and done_messages >= self.messages:
            return False
        return True


class ThinkTimePolicy:
    """Base policy: drain pending calibration, then (subclass) extras.
    Returns the number of calibration edges processed."""

    name = "policy"

    def run(self, session: "Session", budget: ThinkTimeBudget) -> int:
        t0 = time.perf_counter()
        done = session.scheduler.run(
            budget_messages=budget.messages,
            budget_seconds=budget.seconds,
            session=session.id,
            viz=budget.viz,
        )
        if budget.slack(t0, done):
            self.extras(session, budget, t0)
        return done

    def extras(self, session: "Session", budget: ThinkTimeBudget, t0: float) -> None:
        """Speculative work after the calibration drain (default: none)."""


class DrainCalibration(ThinkTimePolicy):
    """Calibration only — the default policy."""

    name = "drain"
