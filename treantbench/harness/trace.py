"""The traced slice of a window: ``torch.profiler`` from a third of the
window for at most ``SLICE_S`` seconds (never past two thirds), stopped and
started only between events.  Reduced to the device's busy time
(the union of its kernels and copies), the slice's length, the device
operations and idle gaps that took most time, and the kernels and the
harness's spans (``tb.*`` ranges) that metric readers read."""

from __future__ import annotations

import time

SLICE_S = 3.0
TOP = 10


class Tracer:
    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.t0 = self.t1 = None
        self.done = False

    def _profiler(self):
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def warm(self) -> None:
        """Start and stop the profiler once in set-up (its first start
        initializes the device tracer)."""
        with self._profiler():
            self.torch.zeros(1, device="cuda").add_(1)
            self.torch.cuda.synchronize()

    def at(self, now: float, seconds: float) -> None:
        lo = seconds / 3
        hi = min(lo + SLICE_S, 2 * seconds / 3)
        if self.prof is None and not self.done and now >= lo:
            self.torch.cuda.synchronize()
            self.prof = self._profiler()
            self.prof.__enter__()
            self.t0 = time.perf_counter()
        elif self.prof is not None and not self.done and now >= hi:
            self._stop()

    def _stop(self) -> None:
        self.torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.done = True

    def finish(self) -> dict | None:
        if self.prof is None:
            return None
        if not self.done:
            self._stop()
        return reduce(self.prof.events(), self.t1 - self.t0)


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce(events, window_s: float) -> dict:
    """Kernels (device events), spans (``tb.*`` host ranges), busy seconds,
    the window, and the breakdown, from the profiler's events (µs)."""
    from torch.autograd import DeviceType

    kernels, spans = [], []
    for e in events:
        if e.name.startswith("tb."):
            if e.device_type != DeviceType.CUDA:   # the device copy is an annotation
                spans.append((e.name, e.time_range.start, e.time_range.end))
        elif e.device_type == DeviceType.CUDA:
            kernels.append((e.name, e.time_range.start, e.time_range.end))
    return summarize(kernels, spans, window_s)


def summarize(kernels: list, spans: list, window_s: float) -> dict:
    busy = union([(s, e) for _, s, e in kernels])
    by_name: dict[str, float] = {}
    for name, s, e in kernels:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    gaps = []
    if spans:
        lo, hi = min(s for _, s, _ in spans), max(e for _, _, e in spans)
        cur = lo
        for s, e in busy:
            if s >= hi:
                break
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if cur < hi:
            gaps.append((cur, hi))
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    by_length = sorted(spans, key=lambda x: x[2] - x[1])
    idle = [[next((n for n, a, b in by_length if a <= (s + e) / 2 <= b), "harness"),
             (e - s) / 1e6] for s, e in longest]
    return {
        "busy_s": sum(e - s for s, e in busy) / 1e6,
        "window_s": window_s,
        "kernels": kernels,
        "spans": spans,
        "breakdown": {
            "device_ops": sorted(([n[:160], s] for n, s in by_name.items()),
                                 key=lambda r: -r[1])[:TOP],
            "idle_gaps": idle,
        },
    }
