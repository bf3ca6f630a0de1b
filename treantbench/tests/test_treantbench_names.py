"""``BENCHMARK.json`` keeps to the benchmark's contract: its keys, names,
units and texts, and every file a cell is found by."""

from __future__ import annotations

import json
import re

from treantbench.tests import tiny  # noqa: F401
from treantbench.harness import bench

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./\-]{1,200}")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def _text(s: str) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_names_units_and_texts():
    b = bench.load_benchmark()
    assert set(b) == KEYS
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert all(_text(w) for w in b["command"]) and len(b["command"]) <= 32
    for p in b["paths"]:
        assert PATH.fullmatch(p) and not p.startswith("/") and ".." not in p
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.fullmatch(c["name"]) and _text(c["source"]) and _text(c["why"])
        assert all(NAME.fullmatch(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith(tuple(f"{p}/" for p in b["paths"]))
        names.append(c["name"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.fullmatch(w["name"]) and NAME.fullmatch(w["traffic"]) and _text(w["why"])
        assert w["config"] in names and w["chips"] == 1
        names.append(w["name"])
    cells = {w["name"] for w in b["workloads"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
        names.append(m["name"])
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _text(m["layer"]) and m["moves"] in {e["name"] for e in b["end_to_end"]}
    assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    assert len(json.dumps(b)) < 64 * 1024


def test_every_cell_finds_its_files():
    b = bench.load_benchmark()
    for w in b["workloads"]:
        config = bench.config_of(b, w["config"])
        assert config["name"] == w["config"]
        assert (bench.BENCH_DIR / "data" / f"{config['generator']}.py").exists()
        assert bench.traffic_of(w["traffic"])["dashboard"]
        assert set(bench.limits_of(w["name"])) == {"sum_rel_gap", "answer_mismatch",
                                                   "render_mismatch"}
        reports = [m["name"] for m in b["end_to_end"] if w["name"] in m.get("workloads",
                                                                              [w["name"]])]
        assert "setup_s" in reports and len(reports) >= 2
        assert bench.metrics_for(b, w["name"], trace=True)
