"""Measured cost profile of the card → data-driven defaults for the plan layer.

``tools/union_budget_sweep.py`` runs union-carry calibration on the card at
several budgets and writes the knee into ``h100_costs.json`` beside this
module.  This module is the consumer: ``plans.calibration_union_budget()``
defaults to the profile's ``derived.calibration_union_budget`` instead of a
hand-picked constant.  An explicit ``REPRO_CALIBRATION_UNION_BUDGET`` always
wins; with no readable profile the static default applies, so nothing here
is load-bearing for correctness.

Profile resolution order:
  1. ``REPRO_KERNEL_COSTS`` env var — path to a profile JSON ("" disables).
  2. ``h100_costs.json`` beside this module (the committed H100 profile).

The JAX package's profile also derives ``plan_kernel_cost``, the work
ceiling past which its plans route a reduction to the lax path instead of a
Pallas kernel (``REPRO_PLAN_KERNEL_COST``, ``REPRO_PALLAS``).  The port has
no counterpart: a torch op may not stand in for a kernel, so on the card
every kernel-route reduction launches its kernel and there is no
kernel-against-torch route to gate.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

PROFILE_ENV = "REPRO_KERNEL_COSTS"
DEFAULT_PROFILE = Path(__file__).resolve().parent / "h100_costs.json"

_UNSET = object()
_cache: object = _UNSET


def profile_path() -> Path | None:
    env = os.environ.get(PROFILE_ENV)
    if env is not None:
        return Path(env) if env else None
    return DEFAULT_PROFILE


def load_profile(refresh: bool = False) -> dict | None:
    """The parsed cost profile, or None if absent or unreadable.

    Cached after the first read; ``refresh=True`` — or :func:`reset_cache` —
    re-reads, which tests use after monkeypatching ``REPRO_KERNEL_COSTS``.
    """
    global _cache
    if refresh or _cache is _UNSET:
        _cache = None
        path = profile_path()
        if path is not None and path.is_file():
            try:
                with open(path) as f:
                    _cache = json.load(f)
            except (OSError, ValueError):
                _cache = None
    return _cache  # type: ignore[return-value]


def reset_cache() -> None:
    global _cache
    _cache = _UNSET


def _derived(key: str) -> int | None:
    prof = load_profile()
    if not isinstance(prof, dict):
        return None
    val = (prof.get("derived") or {}).get(key)
    if isinstance(val, (int, float)) and val > 0:
        return int(val)
    return None


def derived_union_budget() -> int | None:
    """Measured γ-product budget for union-carry calibration queries."""
    return _derived("calibration_union_budget")
