"""A configuration, a traffic mix and a per-layer metric are added by files
and entries alone: the harness finds them by name in a copy of its folder."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from treantbench.tests import tiny  # noqa: F401
from treantbench.harness import bench
from treantbench.harness.loop import EventRec, Run


def test_new_files_are_found_by_name(tmp_path):
    folder = tmp_path / "treantbench"
    shutil.copytree(bench.BENCH_DIR, folder, ignore=shutil.ignore_patterns("__pycache__"))
    spec = bench.load_benchmark()
    config = json.loads((folder / "configs" / "flights-bts-2019.json").read_text())
    config["name"] = "flight-small"
    config["rows"]["Flights"] = 5000
    (folder / "configs" / "flight-small.json").write_text(json.dumps(config))
    mix = json.loads((folder / "traffic" / "brush.json").read_text())
    mix["events"]["weights"] = {"in_jump": 1.0}
    (folder / "traffic" / "jumps.json").write_text(json.dumps(mix))
    (folder / "metrics" / "cjt.rendered_per_event.py").write_text(
        "def CASE():\n    from treantbench.tests import synthetic\n\n"
        "    return synthetic.run(), 5 / 2\n\n\n"
        "def read(run):\n    return sum(e.rendered for e in run.events) / len(run.events)\n")
    (folder / "limits" / "flight-small.jumps.json").write_text(
        json.dumps({"sum_rel_gap": 1e-4, "answer_mismatch": 0, "render_mismatch": 0}))
    spec["configs"].append({"name": "flight-small", "source": "x",
                            "file": "treantbench/configs/flight-small.json", "reduced": [],
                            "why": "x"})
    spec["workloads"].append({"name": "flight-small.jumps", "config": "flight-small",
                              "traffic": "jumps", "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "cjt.rendered_per_event", "unit": "vizzes/event",
                              "better": "lower", "source": "program_counter", "layer": "x",
                              "moves": "event_p95_ms", "workloads": ["flight-small.jumps"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    b = bench.load_benchmark(tmp_path)
    cell = bench.cell(b, "flight-small.jumps")
    assert bench.config_of(b, cell["config"], tmp_path)["rows"]["Flights"] == 5000
    assert bench.traffic_of(cell["traffic"], folder)["events"]["weights"] == {"in_jump": 1.0}
    assert bench.limits_of(cell["name"], folder)["answer_mismatch"] == 0
    entries = bench.metrics_for(b, cell["name"], trace=True)
    assert [m["name"] for m in entries] == ["cjt.rendered_per_event"]
    run = Run(events=[EventRec("set_filter", 0, 1, 0, 0, 6, 0, 0, 0)])
    assert bench.reader("cjt.rendered_per_event", folder)(run) == 6


def test_new_reader_and_its_case_pass_the_metric_tests(tmp_path):
    """A metric added as a reader file with its ``CASE`` and a ``per_layer``
    entry passes the metric and name tests of a copy, no other file edited."""
    folder = tmp_path / "treantbench"
    shutil.copytree(bench.BENCH_DIR, folder, ignore=shutil.ignore_patterns("__pycache__"))
    spec = bench.load_benchmark()
    (folder / "metrics" / "plans.recipes_per_event.py").write_text(
        '"""Events that rendered, per event (a reader added as a file)."""\n\n'
        "def CASE():\n    from treantbench.tests import synthetic\n\n"
        "    return synthetic.run(), 1.0\n\n\n"
        "def read(run):\n    return sum(e.rendered > 0 for e in run.events) / len(run.events)\n")
    spec["per_layer"].append({"name": "plans.recipes_per_event", "unit": "events/event",
                              "better": "lower", "source": "program_counter", "layer": "plans",
                              "moves": "event_p95_ms", "workloads": ["flight.brush"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    tests = folder / "tests"
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-rA", "-p", "no:cacheprovider",
         str(tests / "test_treantbench_metrics.py"), str(tests / "test_treantbench_names.py")],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env={**os.environ, "PYTHONPATH": str(tmp_path)})
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "PASSED" in out.stdout and "test_reader_value[plans.recipes_per_event]" in out.stdout
