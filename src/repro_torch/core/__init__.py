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
    "DeltaStats": "calibration",
    "PlanCache": "plans",
    "PlanStats": "plans",
    "slice_bin_cube": "plans",
    "slice_bin_cubes": "plans",
    "BrushTrajectory": "predictive",
    "DrainCalibration": "predictive",
    "FixedKPrefetch": "predictive",
    "PredictiveThinkTime": "predictive",
    "ThinkTimeBudget": "predictive",
    "ThinkTimeConfig": "predictive",
    "ThinkTimePolicy": "predictive",
    "reset_deprecation_warnings": "predictive",
    "reset_think_time_config": "predictive",
    "think_time_config": "predictive",
    "ApplyResult": "dashboard",
    "ClearFilter": "dashboard",
    "DashboardSpec": "dashboard",
    "Drill": "dashboard",
    "InteractionResult": "dashboard",
    "Rollup": "dashboard",
    "Session": "dashboard",
    "SetFilter": "dashboard",
    "SwapMeasure": "dashboard",
    "ThinkTimeScheduler": "dashboard",
    "ToggleRelation": "dashboard",
    "Undo": "dashboard",
    "VizSpec": "dashboard",
    "speculate_filters": "dashboard",
    "FlushResult": "treant",
    "IngestStats": "treant",
    "Treant": "treant",
    "UpdateResult": "treant",
    "FactorizedLinearRegression": "ml",
    "FeatureSpec": "ml",
    "FitResult": "ml",
    "build_cube": "cube",
    "naive_cube_cost": "cube",
    "CubeReport": "cube",
    "attach_relation": "hypertree",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = _EXPORTS[name]
    if module is None:
        return importlib.import_module(f"{__name__}.{name}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
