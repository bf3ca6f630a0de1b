"""Each metric's reader on its own ``CASE()``: a synthetic run of counters,
spans, a reduced trace and program records (``tests/synthetic.py``), and
the value the reader must give on it."""

from __future__ import annotations

import pytest

from treantbench.tests import tiny  # noqa: F401
from treantbench.harness import bench
from treantbench.harness.loop import Run
from treantbench.tests import synthetic


def readers(bench_dir=bench.BENCH_DIR) -> list[str]:
    return sorted(f.stem for f in (bench_dir / "metrics").glob("*.py"))


def test_every_metric_has_a_reader_and_a_case():
    b = bench.load_benchmark()
    names = {m["name"] for m in b["per_layer"] + b["end_to_end"]}
    assert names <= set(readers())
    for name in readers():
        module = bench.metric(name)
        # the fixture is built when a test asks for it, not when a run loads the reader
        assert not hasattr(module, "synthetic"), name
        run, value = module.CASE()
        assert isinstance(run, Run) and isinstance(value, (int, float)), name


@pytest.mark.parametrize("name", readers())
def test_reader_value(name):
    module = bench.metric(name)
    run, value = module.CASE()
    assert module.read(run) == pytest.approx(value)


@pytest.mark.parametrize("name", ["kernels.segment_ms_per_event", "device.idle_share",
                                  "kernels.segment_roofline_share", "think.cube_ms_per_event",
                                  "think.prefetch_ms_per_event"])
def test_trace_readers_read_nothing_without_a_trace(name):
    assert bench.reader(name)(synthetic.run(traced=False)) is None


def test_breakdown_labels_idle_gaps_by_span():
    t = synthetic.run().trace
    assert t["busy_s"] == pytest.approx(0.0008)
    gaps = dict((n, s) for n, s in t["breakdown"]["idle_gaps"])
    assert gaps["tb.idle"] == pytest.approx(0.0004)    # 2600 -> 3000
    # 600 -> 1100, under an event: the innermost span open, not the event's range
    assert ["session.apply", pytest.approx(0.0005)] in t["breakdown"]["idle_gaps"]
    assert t["breakdown"]["device_ops"][0][0].startswith("void segment_aggregate_kernel<0, 2>")
    assert len(t["breakdown"]["idle_gaps"]) <= 10


def test_device_ops_belong_to_the_innermost_program_range_at_launch():
    t = synthetic.run().trace
    owner = {corr: (None if i is None else t["spans"][i][0])
             for _, _, _, corr, i in t["kernels"]}
    # launched under kernels.launch; after it closed, under plans.contraction;
    # under session.apply though another thread had cjt.message open; under tb.idle alone
    assert owner == {1: "kernels.launch", 2: "plans.contraction", 3: "session.apply", 4: None}
    names = [s[0] for s in t["spans"]]
    assert "aten::index_select" not in names and names.count("tb.event.set_filter") == 1
    parent = {s[0]: (None if s[4] is None else t["spans"][s[4]][0]) for s in t["spans"]}
    assert parent["kernels.launch"] == "plans.contraction"
    assert parent["plans.contraction"] == "session.apply"
    assert parent["cjt.message"] is None
    assert {r[4] for r in t["runtime"]} == {1, 2, 3, 4}

