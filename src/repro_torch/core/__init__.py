"""Calibrated Junction Hypertrees (CJT) and the Treant dashboard accelerator,
in PyTorch.

Exports resolve on first use, so importing ``repro_torch.relational`` (whose
relations need ``core.semiring`` and ``core.factor``) never triggers the
engine modules, which in turn import the relational layer.
"""

import importlib

_EXPORTS = {
    "semiring": None,
    "steiner": None,
    "Factor": "factor",
    "contract": "factor",
    "brute_force_join_aggregate": "factor",
    "ones_factor": "factor",
    "JTree": "hypertree",
    "build_join_tree": "hypertree",
    "jt_from_catalog": "hypertree",
    "is_acyclic": "hypertree",
    "insert_empty_bag": "hypertree",
    "CyclicSchemaError": "hypertree",
    "Query": "query",
    "CalibrationPlan": "calibration",
    "CJTEngine": "calibration",
    "MessageStore": "calibration",
    "ExecStats": "calibration",
    "PlanCache": "plans",
    "PlanStats": "plans",
    "DrainCalibration": "predictive",
    "ThinkTimeBudget": "predictive",
    "ThinkTimePolicy": "predictive",
    "InteractionResult": "dashboard",
    "Session": "dashboard",
    "ThinkTimeScheduler": "dashboard",
    "Treant": "treant",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = _EXPORTS[name]
    if module is None:
        return importlib.import_module(f"{__name__}.{name}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
