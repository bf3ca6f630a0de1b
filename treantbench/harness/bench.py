"""Find a cell's configuration, traffic mix and metric readers by name."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config_of(bench: dict, name: str, root: Path = ROOT) -> dict:
    """A configuration, by its ``file`` in ``BENCHMARK.json``."""
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic_of(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    """The traffic mix ``traffic/<name>.json``: parameters the general
    driver (:mod:`.loop`) and event generator (:mod:`.events`) read."""
    return json.loads((bench_dir / "traffic" / f"{name}.json").read_text())


def generator_of(config: dict):
    """The frozen data generator module ``data/<generator>.py``."""
    return importlib.import_module(f"treantbench.data.{config['generator']}")


def metrics_for(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metric entries a run of ``workload`` reports: end-to-end ones
    without the trace, per-layer ones with it."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if workload in m.get("workloads", [workload])]


def metric(name: str, bench_dir: Path = BENCH_DIR):
    """The module ``metrics/<name>.py``: its ``read(run)`` and its ``CASE``,
    (a synthetic run, the value ``read`` must give on it)."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("treantbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(name: str, bench_dir: Path = BENCH_DIR):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    return metric(name, bench_dir).read


def limits_of(workload: str, bench_dir: Path = BENCH_DIR) -> dict:
    """The limit of each number compared, ``limits/<workload>.json``."""
    return json.loads((bench_dir / "limits" / f"{workload}.json").read_text())
