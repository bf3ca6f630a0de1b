"""``run.py``'s main: one run of one cell, printed as one JSON line."""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from . import bench, check, loop
from .trace import Tracer

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list[str]:
    """Top-level names of loaded modules (default: ``sys.modules``) that the
    benchmark may not load, each compared whole (``repro_torch`` is not
    ``repro``)."""
    names = list(sys.modules) if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def percentile(values: list[float], q: float) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(values, np.float64), q))


def spread(values: list[float]) -> list[float]:
    """min, quartiles, 95th percentile and max."""
    return [percentile(values, q) for q in (0, 25, 50, 75, 95, 100)] if values else []


def read_metrics(run, entries: list[dict]) -> dict:
    """Each metric of ``entries`` by its reader, ``metrics/<name>.py``; a
    reader that finds nothing leaves its metric out."""
    out = {}
    for m in entries:
        value = bench.reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0,
                   help="also read the controls (the reference at lower precisions); "
                        "not for timed runs")
    return p.parse_args(argv)


def execute(workload: str, seed: int, seconds: float, trace: bool, control: bool,
            device: str, t_start: float, *, shrink=None, max_events=None,
            prepare=None) -> tuple[dict, list[str]]:
    """One run of ``workload`` on ``device``: (the result line, the notes for
    standard error).  ``shrink(config, mix)``, ``max_events`` and
    ``prepare(treant, session)`` are for CPU tests."""
    import torch

    spec = bench.load_benchmark()
    cell = bench.cell(spec, workload)
    config = bench.config_of(spec, cell["config"])
    mix = bench.traffic_of(cell["traffic"])
    limits = bench.limits_of(workload)
    if shrink is not None:
        shrink(config, mix)
    cuda = device == "cuda"
    tables = bench.generator_of(config).generate(config, seed)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    run = loop.run_cell(torch, tables, mix, config, seed, seconds, device, t_start,
                        tracer=Tracer(torch) if trace else None, max_events=max_events,
                        prepare=prepare)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fact = check.reference(tables, device)
    readings = check.compare(torch, fact, run.checks, run.render_mismatch)
    controlled = ({c: check.compare(torch, fact, run.checks, 0, control=c)
                   for c in check.CONTROLS}
                  if control else None)
    ref_s = time.perf_counter() - t0
    del fact
    entries = bench.metrics_for(spec, workload, trace)
    metrics = read_metrics(run, entries)
    lat = [(e.t1 - e.t0) * 1e3 for e in run.events]
    notes = [f"setup marks_s {json.dumps(run.marks)} window_start_s {run.setup_s}",
             f"event_ms quartiles {spread(lat)}",
             f"events {len(run.events)} median_ms {percentile(lat, 50) if lat else 0} "
             f"window_s {run.window_s} idles {len(run.idles)} "
             f"reference_s {ref_s} answers {readings['answers_compared']} allocated_end_gib "
             f"{run.allocated_end / 2**30} peak_gib {run.peak_bytes / 2**30}"]
    if controlled is not None:
        notes.append("control " + json.dumps(controlled))
    notes += [f"check {k} {readings[k]!r} limit {v!r}" for k, v in limits.items()]
    device_entry = {"platform": "gpu" if cuda else "cpu",
                    "kind": torch.cuda.get_device_name(0) if cuda else "cpu", "count": 1,
                    "memory_peak_bytes": run.peak_bytes}
    line = {"correct": all(readings[k] <= v for k, v in limits.items()),
            "attempted": len(run.events), "failed": 0,
            "metrics": metrics, "device": device_entry}
    if trace and run.trace is not None:
        device_entry["busy_s"] = run.trace["busy_s"]
        device_entry["window_s"] = run.trace["window_s"]
        line["breakdown"] = run.trace["breakdown"]
    if controlled is not None:
        line["control"] = controlled
    line["check"] = {k: {"value": readings[k], "limit": v} for k, v in limits.items()}
    return line, notes


def main(argv, t_start: float) -> int:
    args = parse(argv)
    import torch

    chips = bench.cell(bench.load_benchmark(), args.workload)["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"treantbench: needs {chips} CUDA device(s); found {found}", file=sys.stderr)
        return 3
    from repro_torch.kernels import build

    build.build()
    line, notes = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                          bool(args.control), "cuda", t_start)
    bad = forbidden_modules()
    if bad:
        print(f"treantbench: modules that must not load were loaded: {bad}", file=sys.stderr)
        return 4
    for n in notes:
        print(n, file=sys.stderr)
    print(json.dumps(line))
    return 0
