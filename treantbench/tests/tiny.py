"""Tiny sizes for CPU tests of the harness: the fact's rows cut by 1000
(at least 64), two bin cubes a think time, a short warm-up."""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def shrink(config: dict, mix: dict) -> None:
    for k, n in config["rows"].items():
        config["rows"][k] = n if n < 1000 else max(64, n // 1000)
    if mix.get("idle"):
        mix["idle"]["args"] = [2, 1]
    mix["warm_steps"] = min(mix.get("warm_steps", 0), 6)


def execute(workload: str, seed: int = 2**31 + 12345, events: int = 12, prepare=None,
            control: bool = False):
    """One run at tiny sizes on the CPU, ``events`` events long."""
    from treantbench.harness import cli

    return cli.execute(workload, seed, 1e9, False, control, "cpu", time.perf_counter(),
                       shrink=shrink, max_events=events, prepare=prepare)
