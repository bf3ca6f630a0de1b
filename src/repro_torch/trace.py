"""Program spans and shape records: what the port itself says about where
its time goes.

A **span** names one stretch of work at a layer boundary of the program.
Its name says the layer: ``session.*`` (a dashboard session's event or
think time, ``core/dashboard.py``), ``think.*`` (think-time work items,
``core/predictive.py`` and the session's cube builds and prefetch),
``cjt.*`` (the CJT engine, ``core/calibration.py``), ``plans.*`` (a bag
contraction's plan and its stages, ``core/plans.py``) and ``kernels.*``
(a hand-written kernel's launch, ``kernels/launch.py``).  A **shape
record** (:func:`record`) keeps the shapes of one unit of work (a sparse
contraction's member, a segment kernel's message), from which a reader
computes the bytes it moves with a formula of its own.

Tracing is on while :func:`enable` holds or while a ``torch.profiler``
records.  Off, :func:`span` returns one shared no-op object after reading
two globals: no allocation, no clock read, no profiler range.  A call site
computes costly attributes only under ``if trace.on():``.  On, a span

- opens a profiler range of the same name while a profiler records, so it
  sits in the profiler's event list on the kernels' clock and each kernel or
  copy launched under it links to it (or to an operator inside it) by
  correlation id.  The range is an operator range, not a user annotation:
  it adds no device-side annotation event to the trace;
- appends a record to :data:`RECORDS`: ``id``, ``parent`` (the innermost
  span open, or 0), ``root`` (the outermost one, so every
  span under one ``session.apply`` or ``session.idle`` shares its id),
  ``name``, ``t0`` / ``t1`` (``time.perf_counter_ns``), ``prof`` (whether a
  profiler recorded it) and ``attrs``.

Spans nest in the order they open: the program opens them from one thread.

A shape record is ``{"kind", "span", "root", "prof", **shape}``, ``span``
the innermost open span.  :func:`take` hands the records over and clears
them; nothing is written to a file (the profiler writes the timeline).
"""

from __future__ import annotations

import itertools
import time

import torch
from torch.autograd import profiler as _profiler

# every span and shape record since the last take(), in the order made
RECORDS: list[dict] = []

_enabled = False
_ids = itertools.count(1)
_STACK: list[dict] = []    # the open spans, innermost last
# an operator range: a user annotation (torch.profiler.record_function) would
# also add a device-side annotation event over the kernels it encloses
_range = torch._C._profiler._RecordFunctionFast


def enable() -> None:
    """Record spans and shape records until :func:`disable`, profiler or not."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def on() -> bool:
    """Whether spans and shape records are being kept now."""
    return _enabled or _profiler._is_profiler_enabled


def take() -> list[dict]:
    """The records kept so far, which are then dropped."""
    out = RECORDS[:]
    del RECORDS[:len(out)]
    return out


class _Off:
    """The span while tracing is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("rec", "range")

    def __init__(self, name: str, attrs: dict):
        self.rec = {"id": 0, "parent": 0, "root": 0, "name": name, "t0": 0, "t1": 0,
                    "prof": False, "attrs": attrs}
        self.range = None

    def __enter__(self):
        rec = self.rec
        rec["id"] = ident = next(_ids)
        rec["parent"] = _STACK[-1]["id"] if _STACK else 0
        rec["root"] = _STACK[0]["id"] if _STACK else ident
        if _profiler._is_profiler_enabled:
            rec["prof"] = True
            self.range = _range(rec["name"])
            self.range.__enter__()
        _STACK.append(rec)
        RECORDS.append(rec)
        rec["t0"] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.rec["t1"] = time.perf_counter_ns()
        if _STACK and _STACK[-1] is self.rec:
            _STACK.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        return False

    def set(self, **attrs) -> None:
        """Add attributes known only once the work has run."""
        self.rec["attrs"].update(attrs)


def span(name: str, **attrs):
    """A context manager around one stretch of the program's work (see the
    module docstring); ``.set(**attrs)`` adds attributes from inside."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, attrs)


def record(kind: str, **shape) -> None:
    """Keep one shape record (only while tracing is on)."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return
    RECORDS.append({"kind": kind, "span": _STACK[-1]["id"] if _STACK else 0,
                    "root": _STACK[0]["id"] if _STACK else 0,
                    "prof": _profiler._is_profiler_enabled, **shape})
