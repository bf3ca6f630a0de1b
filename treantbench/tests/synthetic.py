"""A synthetic run that every metric reader's ``CASE`` is built from: two
events' counters and think-time spans, and a traced slice reduced by
:func:`treantbench.harness.trace.reduce` from made-up profiler events, with
the program's span and shape records."""

from __future__ import annotations

from treantbench.harness import trace
from treantbench.harness.loop import EventRec, Run

MAIN, OTHER = 1, 2       # the launching thread and another one


class Event:
    """A profiler (kineto) event as :func:`trace.reduce` reads it; times in
    µs."""

    def __init__(self, name, start, end, tid=MAIN, corr=0, cuda=False, annotation=False):
        self._v = (name, start, end, tid, corr, cuda, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return int(self._v[1] * 1000)

    def duration_ns(self):
        return int((self._v[2] - self._v[1]) * 1000)

    def start_thread_id(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self._v[5] else DeviceType.CPU

    def is_user_annotation(self):
        return self._v[6]


def events() -> list[Event]:
    """Two events and a think time on the main thread; a program range open
    on another thread while the level kernel is launched; each device op
    launched by a runtime call with its correlation id."""
    return [
        Event("tb.event.set_filter", 50, 1000),
        Event("tb.event.set_filter", 50, 1000, cuda=True, annotation=True),
        Event("session.apply", 60, 990),
        Event("plans.contraction", 80, 700),
        Event("kernels.launch", 90, 150),
        Event("cuLaunchKernel", 95, 99, corr=1),
        Event("aten::index_select", 290, 320),
        Event("cudaLaunchKernel", 300, 305, corr=2),
        Event("void segment_aggregate_kernel<0, 2>", 100, 400, corr=1, cuda=True),
        Event("gather", 400, 600, corr=2, cuda=True),
        Event("tb.event.drill", 1050, 2000),
        Event("session.apply", 1060, 1990),
        Event("cjt.message", 1000, 1100, tid=OTHER),
        Event("cuLaunchKernel", 1080, 1085, corr=3),
        Event("void level_segment_aggregate_kernel<0, 3>", 1100, 1300, corr=3, cuda=True),
        Event("tb.idle", 2050, 3000),
        Event("cuLaunchKernel", 2060, 2065, corr=4),
        Event("think.cube_build", 2100, 2400),
        Event("think.prefetch", 2450, 2500),
        Event("void segment_aggregate_kernel<0, 1>", 2500, 2600, corr=4, cuda=True),
    ]


RECORDS = [
    # a slab message: 4N + N·V·4 + 4GV bytes, N·V adds
    {"kind": "kernels.segment", "span": 0, "root": 0, "prof": True, "kernel": "k", "n": 1000,
     "g": 10, "v": 2, "elem_bytes": 4, "regime": "thread", "ordered": False, "n_items": 0,
     "table_bytes": 0, "fused": False, "msgs": 0, "preds": 0, "recipe_bytes": 0},
    # a fused member: its recipe in place of the values, N·V·(1 + msgs) operations
    {"kind": "kernels.segment", "span": 0, "root": 0, "prof": True, "kernel": "k",
     "n": 1_000_000, "g": 17, "v": 100, "elem_bytes": 4, "regime": "thread", "ordered": False,
     "n_items": 0, "table_bytes": 0, "fused": True, "msgs": 2, "preds": 1,
     "recipe_bytes": 8_000_000},
    # made while no profiler recorded: outside the slice
    {"kind": "kernels.segment", "span": 0, "root": 0, "prof": False, "kernel": "k",
     "n": 10**9, "g": 1, "v": 1, "elem_bytes": 4, "regime": "thread", "ordered": False,
     "n_items": 0, "table_bytes": 0, "fused": False, "msgs": 0, "preds": 0, "recipe_bytes": 0},
]


def run(traced: bool = True) -> Run:
    """The synthetic run; ``traced`` false leaves out the slice and the
    program's records, as a ``--trace 0`` run has them."""
    r = Run(window_s=2.0, plans_built=3, peak_bytes=3 * 2**30, setup_s=12.5)
    r.events = [EventRec("set_filter", 0, 1, computed=2, reused=6, rendered=4, launches=5,
                         cube_hits=1, prefetch_hits=1),
                EventRec("drill", 1, 2, computed=4, reused=0, rendered=1, launches=1,
                         cube_hits=0, prefetch_hits=0)]
    r.idles = [(0.0, 0.25), (1.0, 1.05)]
    if traced:
        r.trace = trace.reduce(events(), 0.004)
        r.trace["records"] = [dict(x) for x in RECORDS]
    return r
