"""The traced slice of a window: ``torch.profiler`` from a third of the
window for at most ``SLICE_S`` seconds (never past two thirds), stopped and
started only between events.  The program's spans and shape records
(``repro_torch.trace``) are on while the profiler records, and only then:
the rest of a traced window runs as an untraced one does, and keeps nothing
that grows with its length.

The profiler's events are reduced to what metric readers read (times in µs
on the profiler's clock):

- ``spans``: ``(name, start, end, thread, parent)``, the harness's ranges
  (``tb.*``) and the program's (names starting ``session.``, ``think.``,
  ``cjt.``, ``plans.``, ``kernels.``), ``parent`` the index of the range
  that encloses it on its thread, or None;
- ``runtime``: ``(name, start, end, thread, correlation id)``, the CUDA
  runtime and driver calls (names starting ``cu``);
- ``kernels``: ``(name, start, end, correlation id, owner)``, every device
  op (kernels, copies, sets), ``owner`` the index in ``spans`` of the
  innermost program range open on the launching thread when the runtime
  call with the op's correlation id started, or None;
- ``records``: the program's span and shape records of the slice;
- ``busy_s`` (the union of device ops), ``window_s`` (the slice) and the
  ``breakdown`` (the device ops and idle gaps that took most time).
"""

from __future__ import annotations

import bisect
import time

SLICE_S = 3.0
TOP = 10
PROGRAM = ("session.", "think.", "cjt.", "plans.", "kernels.")


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
        initializes the device tracer), and drop any program record made
        before the window."""
        from repro_torch import trace

        with self._profiler():
            self.torch.zeros(1, device="cuda").add_(1)
            self.torch.cuda.synchronize()
        trace.take()

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
        from repro_torch import trace

        if self.prof is None:
            return None
        if not self.done:
            self._stop()
        out = reduce(self.prof.profiler.kineto_results.events(), self.t1 - self.t0)
        out["records"] = trace.take()
        return out


def is_program(name: str) -> bool:
    return name.startswith(PROGRAM)


def is_runtime(name: str) -> bool:
    """A CUDA API call (``cudaLaunchKernel``, ``cuLaunchKernel``,
    ``cudaMemcpyAsync``, ...): its correlation id is its device op's."""
    return name.startswith("cu") and "::" not in name


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce(events, window_s: float) -> dict:
    """The trace (module docstring) from the profiler's kineto events."""
    from torch.autograd import DeviceType

    ranges, runtime, device = [], [], []
    for k in events:
        name = k.name()
        s = k.start_ns() / 1e3
        e = s + k.duration_ns() / 1e3
        if k.device_type() == DeviceType.CUDA:
            # kernels, copies and sets; not the device copies of annotations
            if not k.is_user_annotation() and not name.startswith("tb."):
                device.append((name, s, e, k.correlation_id()))
        elif name.startswith("tb.") or is_program(name):
            ranges.append((name, s, e, k.start_thread_id()))
        elif is_runtime(name):
            runtime.append((name, s, e, k.start_thread_id(), k.correlation_id()))
    spans = nest(ranges)
    out = summarize(attribute(device, spans, runtime), spans, window_s)
    out["runtime"] = runtime
    return out


def nest(ranges: list[tuple]) -> list[tuple]:
    """``(name, start, end, thread, parent)`` for each range, in order of
    start (outer first), ``parent`` the enclosing range on its thread."""
    out: list[tuple] = []
    stacks: dict[int, list[int]] = {}
    for name, s, e, tid in sorted(ranges, key=lambda r: (r[1], -r[2])):
        stack = stacks.setdefault(tid, [])
        while stack and out[stack[-1]][2] < s:
            stack.pop()
        out.append((name, s, e, tid, stack[-1] if stack else None))
        stack.append(len(out) - 1)
    return out


def innermost_program(spans: list[tuple], starts: dict, tid: int, t: float) -> int | None:
    """The index of the innermost program range open on thread ``tid`` at
    ``t``, or None; ``starts[tid]`` lists (start, index) of its ranges."""
    own = starts.get(tid)
    if not own:
        return None
    i = bisect.bisect_right(own, (t, float("inf"))) - 1
    j = own[i][1] if i >= 0 else None
    while j is not None and (spans[j][2] < t or not is_program(spans[j][0])):
        j = spans[j][4]
    return j


def attribute(device: list[tuple], spans: list[tuple], runtime: list[tuple]) -> list[tuple]:
    """``(name, start, end, correlation id, owner)`` for each device op."""
    starts: dict[int, list] = {}
    for i, (_, s, _, tid, _) in enumerate(spans):
        starts.setdefault(tid, []).append((s, i))
    launch = {corr: (s, tid) for _, s, _, tid, corr in runtime}
    out = []
    for name, s, e, corr in device:
        site = launch.get(corr)
        owner = innermost_program(spans, starts, site[1], site[0]) if site else None
        out.append((name, s, e, corr, owner))
    return out


def summarize(kernels: list, spans: list, window_s: float) -> dict:
    busy = union([(k[1], k[2]) for k in kernels])
    by_name: dict[str, float] = {}
    for name, s, e, *_ in kernels:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    gaps = []
    if spans:
        lo, hi = min(sp[1] for sp in spans), max(sp[2] for sp in spans)
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
    idle = [[next((sp[0] for sp in by_length if sp[1] <= (s + e) / 2 <= sp[2]), "harness"),
             (e - s) / 1e6] for s, e in longest]
    return {
        "busy_s": sum(e - s for s, e in busy) / 1e6,
        "window_s": window_s,
        "kernels": kernels,
        "spans": spans,
        "records": [],
        "breakdown": {
            "device_ops": sorted(([n[:160], s] for n, s in by_name.items()),
                                 key=lambda r: -r[1])[:TOP],
            "idle_gaps": idle,
        },
    }
