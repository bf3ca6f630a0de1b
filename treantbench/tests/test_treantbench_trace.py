"""The traced slice's tracer, and the roofline's byte count
(``harness/roofline.py``) against the one of ``tools/trace_cell.py``, which
keeps a copy of it: the two may not drift apart while both exist."""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import torch

from repro_torch import trace as program_trace
from treantbench.harness import roofline, trace
from treantbench.tests import synthetic


class _CpuTorch:
    """What the tracer calls of ``torch``, on the CPU."""

    class cuda:
        @staticmethod
        def synchronize():
            pass

    @staticmethod
    def zeros(*shape, device):
        return torch.zeros(*shape)


class _CpuTracer(trace.Tracer):
    def _profiler(self):
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CPU])


def test_program_spans_are_kept_over_the_slice_alone():
    """Spans and records are made only while the profiler records: before
    and after the slice a traced window keeps nothing."""
    tracer = _CpuTracer(_CpuTorch)
    tracer.warm()
    assert not program_trace.on()
    with program_trace.span("think.cube_build"):
        pass
    tracer.at(1.0, 9.0)                 # before a third of the window
    tracer.at(3.0, 9.0)                 # the slice starts
    with program_trace.span("think.prefetch"):
        program_trace.record("kernels.segment", n=1)
    tracer.at(6.0, 9.0)                 # and ends
    with program_trace.span("think.cube_build"):
        pass
    out = tracer.finish()
    assert [(r.get("name"), r.get("kind"), r["prof"]) for r in out["records"]] == [
        ("think.prefetch", None, True), (None, "kernels.segment", True)]
    assert [s[0] for s in out["spans"]] == ["think.prefetch"]
    assert program_trace.take() == []


def test_segment_bytes_agree_with_the_trace_tool(monkeypatch):
    """``harness/roofline.py`` and ``tools/trace_cell.py`` count a segment
    message's bytes alike, slab or fused, in row or code order, against one
    HBM peak."""
    monkeypatch.setattr(sys, "path", list(sys.path))   # the tool prepends to it
    path = Path(__file__).resolve().parents[2] / "tools" / "trace_cell.py"
    spec = importlib.util.spec_from_file_location("trace_cell_for_bytes", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    records = [r for r in synthetic.RECORDS if r["kind"] == "kernels.segment"]
    records += [dict(r, ordered=True, table_bytes=12_345) for r in records]
    for r in records:
        assert roofline.segment_cost(r)[0] == tool.segment_bytes(r), r
    assert roofline.HBM_BYTES_PER_S == tool.HBM_BYTES_PER_S
