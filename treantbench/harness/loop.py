"""The general driver: one closed-loop session over a cell's deployment.

One analyst's events are applied back to back through ``Session.apply``
(each timed from the call to a device sync).  A mix may add think time
(``"idle"``: a ``Session.idle`` under a policy after every event, inside
the window).  Set-up (data, catalog, ``open_session``, the mix's
``context`` events and ``warm_steps`` events) is done before the window;
the window then runs for ``seconds``.  The rendered factors of a seeded
reservoir of the window's events (:class:`.check.Reservoir`) are kept (a
device copy) for the comparison with the reference after the window
closes; no other work of the window grows with its length.  Set-up ends
with ``gc.freeze()``: the objects made by then (tables, catalog, plans,
the session) leave the collector's generations, so its full passes inside
the window walk only what the window makes (``gc.unfreeze()`` when it
closes).
"""

from __future__ import annotations

import dataclasses
import gc
import time
from contextlib import nullcontext

from treantbench.reference.dashboard import DashState

from . import check, program
from .events import EventGenerator


@dataclasses.dataclass
class EventRec:
    kind: str
    t0: float
    t1: float
    computed: int
    reused: int
    rendered: int
    launches: int
    cube_hits: int
    prefetch_hits: int


@dataclasses.dataclass
class Check:
    """What one sampled event rendered, beside what the reference says it
    had to render: ``queries`` (viz → the reference's query) and
    ``outputs`` (viz → (attrs, factor copy))."""

    queries: dict
    outputs: dict


@dataclasses.dataclass
class Run:
    setup_s: float = 0.0
    marks: dict = dataclasses.field(default_factory=dict)   # set-up phases, s from start
    window_s: float = 0.0
    peak_bytes: int = 0
    allocated_end: int = 0
    events: list = dataclasses.field(default_factory=list)
    idles: list = dataclasses.field(default_factory=list)   # think time: (t0, t1)
    checks: list = dataclasses.field(default_factory=list)   # the sample, in event order
    render_mismatch: int = 0
    plans_built: int = 0
    trace: dict | None = None


def record_function(torch, name: str, on: bool):
    """A ``torch.profiler`` range named ``name`` when tracing, else nothing."""
    return torch.profiler.record_function(name) if on else nullcontext()


def run_cell(torch, tables, mix: dict, config: dict, seed: int, seconds: float,
             device: str, t_start: float, tracer=None, max_events: int | None = None,
             prepare=None) -> Run:
    """Run one cell; ``tracer`` (trace runs) profiles a slice of the window.
    ``max_events`` ends the window after that many events instead (tests);
    ``prepare(treant, session)`` runs after set-up (tests plant faults)."""
    from repro_torch.core import Treant
    from repro_torch.core import semiring as sr

    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    run = Run()
    run.marks["data"] = time.perf_counter() - t_start
    vizzes = mix["dashboard"]
    cat = program.catalog(tables)
    t = Treant(cat, ring=sr.SUM, device=device, **config.get("program", {}))
    sess = t.open_session(program.spec(vizzes), name="analyst")
    sync()
    run.marks["open_session"] = time.perf_counter() - t_start
    policy = program.policy(mix.get("idle"))
    state = DashState(vizzes, tables.domains)
    gen = EventGenerator(mix["events"], vizzes, tables.domains, seed, stream=1)
    traced = tracer is not None
    sample = check.Reservoir(seed)

    def do_event(ev: dict, timed: bool) -> None:
        state.apply(ev)
        expected = state.render()
        pe = program.event(ev)
        with record_function(torch, f"tb.event.{ev['kind']}", traced):
            l0 = program.launches()
            t0 = time.perf_counter()
            res = sess.apply(pe)
            sync()
            t1 = time.perf_counter()
            l1 = program.launches()
        if set(res.results) != set(expected):
            run.render_mismatch += 1
        if not timed:
            return
        sample.offer(lambda: Check(expected, {v: (tuple(r.factor.attrs), r.factor.field.clone())
                                              for v, r in res.results.items()}))
        st = [r.stats for r in res.results.values()]
        run.events.append(EventRec(
            ev["kind"], t0, t1, sum(s.messages_computed for s in st),
            sum(s.messages_reused for s in st), len(st), l1 - l0,
            sum(s.bin_cube_hits for s in st), sum(s.prefetch_hits for s in st)))
        if policy is not None:
            with record_function(torch, "tb.idle", traced):
                t0 = time.perf_counter()
                sess.idle(policy=policy)
                sync()
                run.idles.append((t0, time.perf_counter()))

    for ev in mix.get("context", []):
        do_event(ev, timed=False)
    for _ in range(mix.get("warm_steps", 0)):
        do_event(gen.next(state), timed=False)
    sync()
    run.marks["warm"] = time.perf_counter() - t_start
    if prepare is not None:
        prepare(t, sess)
    if tracer is not None:
        tracer.warm()
    plans0 = _plans_built(t)
    sync()
    gc.collect()
    gc.freeze()
    w0 = time.perf_counter()
    run.setup_s = w0 - t_start
    while True:
        now = time.perf_counter() - w0
        if (now >= seconds) if max_events is None else (len(run.events) >= max_events):
            break
        if tracer is not None:
            tracer.at(now, seconds)
        do_event(gen.next(state), timed=True)
    sync()
    run.window_s = time.perf_counter() - w0
    gc.unfreeze()
    run.checks = sample.checks()
    if tracer is not None:
        run.trace = tracer.finish()
    run.plans_built = _plans_built(t) - plans0
    run.peak_bytes = torch.cuda.max_memory_allocated() if cuda else 0
    run.allocated_end = torch.cuda.memory_allocated() if cuda else 0
    sess.close()
    del sess, t, cat
    return run


def _plans_built(t) -> int:
    return int(t.cache_stats()["plans"]["plans_built"])
