"""Each per-layer metric's reader on synthetic counters, spans and traces."""

from __future__ import annotations

import pytest

from treantbench.tests import tiny  # noqa: F401
from treantbench.harness import bench
from treantbench.harness.loop import EventRec, Run
from treantbench.harness.trace import summarize


def _run(trace: bool = True) -> Run:
    run = Run(window_s=2.0, plans_built=3, peak_bytes=3 * 2**30, setup_s=12.5)
    run.events = [EventRec("set_filter", 0, 1, computed=2, reused=6, rendered=4, launches=5,
                           cube_hits=1, prefetch_hits=1),
                  EventRec("drill", 1, 2, computed=4, reused=0, rendered=1, launches=1,
                           cube_hits=0, prefetch_hits=0)]
    run.idles = [(0.0, 0.25), (1.0, 1.05)]
    if trace:
        kernels = [("void segment_aggregate_kernel<0, 2>", 100, 400),
                   ("void level_segment_aggregate_kernel<0, 3>", 1100, 1300),
                   ("gather", 400, 600), ("void segment_aggregate_kernel<0, 1>", 2500, 2600)]
        spans = [("tb.event.set_filter", 50, 1000), ("tb.event.drill", 1050, 2000),
                 ("tb.idle", 2050, 3000)]
        run.trace = summarize(kernels, spans, 0.004)
    return run


EXPECTED = {
    "cjt.computed_per_event": 3.0,
    "cjt.reuse_share": 50.0,
    "plans.builds_per_event": 1.5,
    "kernels.launches_per_event": 3.0,
    "think.idle_ms_per_event": 150.0,
    "think.served_share": 40.0,
    "kernels.segment_ms_per_event": (0.3 + 0.2) / 2,
    "device.idle_share": 100 * (1 - 0.0008 / 0.004),
    "event_p95_ms": 1000.0,
    "events_per_s": 1.0,
    "device_peak_gib": 3.0,
    "setup_s": 12.5,
}


def test_every_metric_has_a_reader_and_a_case():
    b = bench.load_benchmark()
    names = {m["name"] for m in b["per_layer"] + b["end_to_end"]}
    readers = {f.stem for f in (bench.BENCH_DIR / "metrics").glob("*.py")}
    assert names <= readers and readers == set(EXPECTED)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_value(name):
    assert bench.reader(name)(_run()) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", ["kernels.segment_ms_per_event", "device.idle_share"])
def test_trace_readers_read_nothing_without_a_trace(name):
    assert bench.reader(name)(_run(trace=False)) is None


def test_breakdown_labels_idle_gaps_by_span():
    t = _run().trace
    assert t["busy_s"] == pytest.approx(0.0008)
    gaps = dict((n, s) for n, s in t["breakdown"]["idle_gaps"])
    assert gaps["tb.idle"] == pytest.approx(0.0004)    # 2600 -> 3000
    assert t["breakdown"]["device_ops"][0][0].startswith("void segment_aggregate_kernel<0, 2>")
    assert len(t["breakdown"]["idle_gaps"]) <= 10
