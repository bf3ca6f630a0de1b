"""Where one benchmark cell's time goes, by the program's own spans.

Runs a cell of ``treantbench`` (``BENCHMARK.json``) as ``treantbench/run.py``
does, through ``treantbench.harness.loop.run_cell``, with a tracer of its
own in the harness's place: program spans (:mod:`repro_torch.trace`) are on
for the whole window, and ``torch.profiler`` records the harness's slice
(from a third of the window, 3 s).  It edits nothing of the harness and
skips the comparison with the reference.

Prints one JSON line of the end-to-end metrics (the harness's readers) and
writes the report, ``<out>/<workload>.<seed>.<mode>.json``, and its text,
``.txt``:

- per span name: count, host self time (duration less child spans, over the
  window) and device time (over the slice) per event, self and inclusive.
  A device op is put down, through its launch's correlation id, to the
  innermost program span open on the host thread that launched it;
- device time outside program spans, by the harness range (``tb.*``) open
  at its launch, or none, and by the operator that launched it;
- device time by (device op, innermost span, the operator called under that
  span): the call sites of the device-to-device copies and of
  ``masked_fill``;
- every device idle gap in the slice, put down to the innermost program
  span (else harness range) open on the host at its midpoint;
- event latency p50 / p95 by class (whether the event ran a contraction
  over the largest relation's rows, and the widest carried γ lanes there)
  and the classes of the slowest quarter;
- think time per event split into drain, cube builds and prefetch;
- byte shares against 3.35 TB/s: sparse contractions (``plans.member``
  records: inputs read once over real rows, the output written once) over
  the device time of ``plans.contraction``, and segment kernels 1-2
  (``kernels.segment`` records: ``chip_smoke.py``'s ``bound_ms`` and
  ``ordered_bound_ms`` bytes, a fused member's recipe in place of its
  values) over their device time.  A fused member has no rowwise stage: its
  device time is kernel 1-2 time under its ``plans.reduce``, inside its
  ``plans.contraction``.

Modes (``--mode``): ``slice`` (the report), ``off`` (no span, no profiler),
``spans`` (``trace.enable()`` over the window, no profiler) and ``window``
(a profiler over the whole window; end-to-end metrics only).  The last
three give what tracing costs.

Usage, on a CUDA card from the checkout's root::

    python3 tools/trace_cell.py --workload flight.brush --seed 1 [--seconds 51]
        [--mode slice] [--out artifacts/trace_cell]

``--device cpu --rows-divisor 1000`` rehearses the run on the CPU at a tiny
size (no device op is seen there).
"""

from __future__ import annotations

import argparse
import bisect
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

HBM_BYTES_PER_S = 3.35e12          # one H100 SXM, NVIDIA's data sheet
PROGRAM = ("session.", "think.", "cjt.", "plans.", "kernels.")
SLICE_S = 3.0
SEGMENT_KERNEL = "segment_aggregate"


def is_program(name: str) -> bool:
    return name.startswith(PROGRAM)


class SpanTracer:
    """The harness's ``warm`` / ``at`` / ``finish`` calls: spans on over the
    window (modes slice, spans), a profiler over the slice (slice) or the
    window (window)."""

    def __init__(self, torch, mode: str, device: str):
        from repro_torch import trace

        self.torch, self.trace, self.mode, self.device = torch, trace, mode, device
        self.prof = None
        self.done = False
        self.t0 = self.t1 = 0
        self.records: list[dict] = []

    def _sync(self):
        if self.device == "cuda":
            self.torch.cuda.synchronize()

    def _profiler(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def warm(self) -> None:
        if self.mode in ("slice", "window"):
            with self._profiler():   # the first start initializes the device tracer
                self.torch.zeros(1, device=self.device).add_(1)
                self._sync()
        self.trace.take()
        if self.mode in ("slice", "spans"):
            self.trace.enable()

    def at(self, now: float, seconds: float) -> None:
        if self.mode not in ("slice", "window") or self.done:
            return
        lo = seconds / 3 if self.mode == "slice" else 0.0
        hi = min(lo + SLICE_S, 2 * seconds / 3) if self.mode == "slice" else float("inf")
        if self.prof is None and now >= lo:
            self._sync()
            self.prof = self._profiler()
            self.prof.__enter__()
            self.t0 = time.perf_counter_ns()
        elif self.prof is not None and now >= hi:
            self._stop()

    def _stop(self) -> None:
        self._sync()
        self.t1 = time.perf_counter_ns()
        self.prof.__exit__(None, None, None)
        self.done = True

    def finish(self):
        if self.prof is not None and not self.done:
            self._stop()
        self.trace.disable()
        self.records = self.trace.take()
        return None


# ---------------------------------------------------------------------------
# the profiler's events
# ---------------------------------------------------------------------------

class Host:
    """The host events of one thread, nested: operator ranges (program
    spans, harness ranges, aten operators) with parent links."""

    def __init__(self, events: list):
        self.ev = sorted(events, key=lambda e: (e["t0"], -e["t1"]))
        self.starts = [e["t0"] for e in self.ev]
        stack: list = []
        for e in self.ev:
            while stack and stack[-1]["t1"] < e["t0"]:
                stack.pop()
            e["parent"] = stack[-1] if stack else None
            stack.append(e)

    def innermost(self, t: int):
        """The innermost range open at ``t``: the last one to start by then,
        or the nearest of its ancestors still open."""
        i = bisect.bisect_right(self.starts, t) - 1
        e = self.ev[i] if i >= 0 else None
        while e is not None and e["t1"] < t:
            e = e["parent"]
        return e


def where(e):
    """(innermost program span, the operator called under it, innermost
    harness range) of a host event and its ancestors."""
    span = call = harness = None
    while e is not None:
        name = e["name"]
        if is_program(name):
            if span is None:
                span = e
        elif name.startswith("tb."):
            if harness is None:
                harness = e
        elif span is None:
            call = name
        e = e["parent"]
    return span, call, harness


def kineto_events(prof) -> tuple[dict, list, dict]:
    """(host ranges by thread, device ops, runtime calls by correlation id)
    from the profiler's kineto events; times in ns on the profiler's
    clock."""
    from torch.autograd import DeviceType

    threads: dict[int, list] = {}
    device, runtime = [], {}
    for k in prof.profiler.kineto_results.events():
        t0 = k.start_ns()
        rec = {"name": k.name(), "t0": t0, "t1": t0 + k.duration_ns(),
               "corr": k.correlation_id()}
        if k.device_type() == DeviceType.CUDA:
            # kernels, copies and sets; not the device copies of annotations
            if not k.is_user_annotation() and not rec["name"].startswith("tb."):
                device.append(rec)
        elif is_runtime(rec["name"]):
            rec["tid"] = k.start_thread_id()
            runtime[rec["corr"]] = rec
        else:
            threads.setdefault(k.start_thread_id(), []).append(rec)
    return {tid: Host(evs) for tid, evs in threads.items()}, device, runtime


def is_runtime(name: str) -> bool:
    """A CUDA API call (``cudaLaunchKernel``, ``cuLaunchKernel``,
    ``cudaMemcpyAsync``, ...): its correlation id is the device op's own."""
    return name.startswith("cu") and "::" not in name


def launch_site(d: dict, hosts: dict, runtime: dict):
    """The innermost host range open at device op ``d``'s launch: the
    runtime call that launched it carries the op's correlation id."""
    r = runtime.get(d["corr"])
    if r is None or r["tid"] not in hosts:
        return None
    return hosts[r["tid"]].innermost(r["t0"])


def union(intervals):
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------

def member_bytes(r: dict) -> int:
    """A sparse contraction member's least bytes: the lift, every gather
    and σ code column and the segment codes read once over real rows, each
    incoming message read once, the output written once."""
    cols = r["gather_cols"] + r["sigma_cols"] + 1
    return (r["num_rows"] * (r["lift_row_bytes"] + cols * r["code_bytes"])
            + (sum(r["in_elems"]) + r["out_elems"]) * r["value_bytes"])


def segment_bytes(r: dict) -> int:
    """``chip_smoke.py``'s ``bound_ms`` bytes (codes 4N, values N·V, the
    output 4GV), or ``ordered_bound_ms``'s (values, the work-item table, the
    output) for values in code order; a fused member reads its recipe
    (``recipe_bytes``: lift, index and σ code columns, tables, lane columns,
    masks) in place of the values."""
    out = r["g"] * r["v"] * 4
    values = r["recipe_bytes"] if r.get("fused") else r["n"] * r["v"] * r["elem_bytes"]
    if r["ordered"]:
        return values + r["table_bytes"] + out
    return r["n"] * 4 + values + out


def pct(values, q):
    import numpy as np

    return float(np.percentile(np.asarray(values, np.float64), q)) if values else None


def span_tree(records: list[dict]):
    spans = {r["id"]: r for r in records if "name" in r}
    children: dict[int, list] = {}
    for r in spans.values():
        children.setdefault(r["parent"], []).append(r)
    return spans, children


def host_side(records: list[dict], n_events: int) -> dict:
    """Per span name over the window: count, inclusive and self host ms per
    event."""
    spans, children = span_tree(records)
    out: dict[str, dict] = {}
    for r in spans.values():
        dur = r["t1"] - r["t0"]
        kids = sum(c["t1"] - c["t0"] for c in children.get(r["id"], ()))
        o = out.setdefault(r["name"], {"count": 0, "host_ms": 0.0, "host_self_ms": 0.0})
        o["count"] += 1
        o["host_ms"] += dur / 1e6
        o["host_self_ms"] += (dur - kids) / 1e6
    for o in out.values():
        o["per_event"] = o["count"] / max(n_events, 1)
        o["host_ms_per_event"] = o["host_ms"] / max(n_events, 1)
        o["host_self_ms_per_event"] = o["host_self_ms"] / max(n_events, 1)
    return out


def event_classes(run, records: list[dict]) -> dict:
    """Each window event's class (from its ``session.apply`` span's shape
    records) and latency p50 / p95 by class, with the slowest quarter's
    classes and kinds."""
    spans, _ = span_tree(records)
    roots = sorted((r for r in spans.values() if r["name"] == "session.apply"),
                   key=lambda r: r["t0"])
    members = [r for r in records if r.get("kind") == "plans.member"]
    fact_rows = max((m["num_rows"] for m in members), default=0)
    fact = {m["rel"] for m in members if m["num_rows"] == fact_rows}
    lanes: dict[int, int] = {}
    total: dict[int, list] = {}     # root -> [fact members, their lanes summed]
    for m in members:
        if m["rel"] in fact:
            lanes[m["root"]] = max(lanes.get(m["root"], 0), m["lanes"])
            t = total.setdefault(m["root"], [0, 0])
            t[0] += 1
            t[1] += m["lanes"]
    rows = []
    for ev, root in zip(run.events, roots):
        cls = f"fact lanes {lanes[root['id']]}" if root["id"] in lanes else "no fact contraction"
        rows.append((cls, ev.kind, (ev.t1 - ev.t0) * 1e3, *total.get(root["id"], (0, 0))))
    lat = [r[2] for r in rows]
    p75 = pct(lat, 75)
    out = {"fact": sorted(fact), "fact_rows": fact_rows, "events": len(rows),
           "matched": len(roots) == len(run.events), "p50_ms": pct(lat, 50),
           "p75_ms": p75, "p95_ms": pct(lat, 95), "classes": {}, "slow_quarter": {}}
    for cls in sorted({r[0] for r in rows}):
        rs = [r for r in rows if r[0] == cls]
        xs = [r[2] for r in rs]
        out["classes"][cls] = {"events": len(xs), "p50_ms": pct(xs, 50), "p95_ms": pct(xs, 95),
                               "mean_ms": statistics.fmean(xs),
                               "fact_members": statistics.fmean(r[3] for r in rs),
                               "fact_lanes": statistics.fmean(r[4] for r in rs)}
    for c, kind, x, _, _ in rows:
        if p75 is not None and x >= p75:
            key = f"{c} | {kind}"
            out["slow_quarter"][key] = out["slow_quarter"].get(key, 0) + 1
    return out


def think_split(records: list[dict], n_events: int) -> dict | None:
    """Think time per event (host, ms): ``session.idle`` and its drain, cube
    builds and prefetch, over the window."""
    spans, _ = span_tree(records)
    idle = [r for r in spans.values() if r["name"] == "session.idle"]
    if not idle:
        return None
    out = {"idle_ms_per_event": sum(r["t1"] - r["t0"] for r in idle) / 1e6 / max(n_events, 1)}
    for name in ("think.drain", "think.cube_build", "think.prefetch"):
        rs = [r for r in spans.values() if r["name"] == name]
        out[name] = {"count_per_event": len(rs) / max(n_events, 1),
                     "ms_per_event": sum(r["t1"] - r["t0"] for r in rs) / 1e6 / max(n_events, 1)}
    builds = [r for r in spans.values() if r["name"] == "think.cube_build"]
    out["think.cube_build"]["built_per_event"] = (
        sum(1 for r in builds if r["attrs"].get("built")) / max(n_events, 1))
    return out


def device_side(prof, records: list[dict]) -> dict:
    hosts, device, runtime = kineto_events(prof)
    main = max(hosts, key=lambda t: sum(1 for e in hosts[t].ev if is_program(e["name"])),
               default=None)
    n_events = sum(1 for h in hosts.values() for e in h.ev if e["name"] == "session.apply")
    per_span: dict[str, dict] = {}
    outside: dict[str, float] = {}
    sites: dict[tuple, float] = {}
    unlinked = 0
    seg_total = seg_linked = 0
    for d in device:
        dur = (d["t1"] - d["t0"]) / 1e6
        site = launch_site(d, hosts, runtime)
        unlinked += site is None
        span, call, harness = where(site)
        if SEGMENT_KERNEL in d["name"]:
            seg_total += 1
            seg_linked += int(span is not None and span["name"] == "kernels.launch")
        short = d["name"][:60]
        if span is None:
            key = f"{harness['name'] if harness else 'none'} | {call or d['name'][:40]}"
            outside[key] = outside.get(key, 0.0) + dur
            sites[(short, harness["name"] if harness else "none", call)] = sites.get(
                (short, harness["name"] if harness else "none", call), 0.0) + dur
            continue
        sites[(short, span["name"], call)] = sites.get((short, span["name"], call), 0.0) + dur
        per_span.setdefault(span["name"], {"self_ms": 0.0, "incl_ms": 0.0})["self_ms"] += dur
        seen = set()
        e = span
        while e is not None:
            if is_program(e["name"]) and e["name"] not in seen:
                seen.add(e["name"])
                per_span.setdefault(e["name"], {"self_ms": 0.0, "incl_ms": 0.0})["incl_ms"] += dur
            e = e["parent"]
    busy = union([(d["t0"], d["t1"]) for d in device])
    busy_ms = sum(e - s for s, e in busy) / 1e6
    all_host = [e for h in hosts.values() for e in h.ev]
    lo = min((e["t0"] for e in all_host), default=0)
    hi = max((e["t1"] for e in all_host), default=0)
    gaps, cur = [], lo
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if cur < hi:
        gaps.append((cur, hi))
    by_gap: dict[str, dict] = {}
    top = []
    for s, e in gaps:
        span, call, harness = where(hosts[main].innermost((s + e) // 2) if main else None)
        label = span["name"] if span else (harness["name"] if harness else "none")
        g = by_gap.setdefault(label, {"count": 0, "ms": 0.0, "max_ms": 0.0})
        ms = (e - s) / 1e6
        g["count"] += 1
        g["ms"] += ms
        g["max_ms"] = max(g["max_ms"], ms)
        top.append((ms, label, call))
    top.sort(key=lambda g: -g[0])
    outside_ms = sum(outside.values())
    # byte shares over the slice: shape records made while the profiler recorded
    members = [r for r in records if r.get("kind") == "plans.member" and r["prof"]]
    segs = [r for r in records if r.get("kind") == "kernels.segment" and r["prof"]]
    contraction_ms = per_span.get("plans.contraction", {}).get("incl_ms", 0.0)
    seg_ms = sum((d["t1"] - d["t0"]) / 1e6 for d in device if SEGMENT_KERNEL in d["name"])
    m_bytes = sum(member_bytes(r) for r in members)
    s_bytes = sum(segment_bytes(r) for r in segs)
    n = max(n_events, 1)
    return {
        "events_in_slice": n_events,
        "slice_ms": (hi - lo) / 1e6, "busy_ms": busy_ms,
        "idle_share": 100.0 * (1 - busy_ms / ((hi - lo) / 1e6)) if hi > lo else None,
        "device_ops": len(device), "unlinked_ops": unlinked,
        "outside_program_ms": outside_ms,
        "outside_program_share": 100.0 * outside_ms / busy_ms if busy_ms else None,
        "outside": dict(sorted(outside.items(), key=lambda kv: -kv[1])[:20]),
        "segment_launches": seg_total, "segment_linked_to_kernels_launch": seg_linked,
        "spans": {k: {"self_ms_per_event": v["self_ms"] / n, "incl_ms_per_event": v["incl_ms"] / n}
                  for k, v in sorted(per_span.items(), key=lambda kv: -kv[1]["self_ms"])},
        "sites": [[op, span, call, ms] for (op, span, call), ms in
                  sorted(sites.items(), key=lambda kv: -kv[1])[:40]],
        "gaps": {k: v for k, v in sorted(by_gap.items(), key=lambda kv: -kv[1]["ms"])},
        "gaps_top": [[ms, label, call] for ms, label, call in top[:15]],
        "contraction": {"members": len(members), "bytes": m_bytes, "device_ms": contraction_ms,
                        "hbm_share": (100.0 * m_bytes / HBM_BYTES_PER_S * 1e3 / contraction_ms
                                      if contraction_ms else None)},
        "segment": {"members": len(segs), "bytes": s_bytes, "device_ms": seg_ms,
                    "hbm_share": (100.0 * s_bytes / HBM_BYTES_PER_S * 1e3 / seg_ms
                                  if seg_ms else None)},
    }


def card() -> dict:
    import torch

    if not torch.cuda.is_available():
        return {"name": "cpu", "power_limit": None}
    try:
        limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        limit = None
    return {"name": torch.cuda.get_device_name(0), "power_limit": limit}


def num(x) -> str:
    return "n/a" if x is None else f"{x:.3f}"


def text(rep: dict) -> str:
    lines = [f"{rep['workload']} seed {rep['seed']} mode {rep['mode']} on {rep['card']}",
             f"end to end: {json.dumps(rep['end_to_end'])}"]
    ev = rep.get("events")
    if ev:
        lines.append(f"events {ev['events']} (spans matched {ev['matched']}) p50 {ev['p50_ms']:.2f} "
                     f"p75 {ev['p75_ms']:.2f} p95 {ev['p95_ms']:.2f} ms; fact {ev['fact']}")
        for cls, c in ev["classes"].items():
            lines.append(f"  {cls:28s} n {c['events']:5d} p50 {c['p50_ms']:8.2f} "
                         f"p95 {c['p95_ms']:8.2f} mean {c['mean_ms']:8.2f} fact members "
                         f"{c['fact_members']:6.2f} lanes summed {c['fact_lanes']:8.1f}")
        lines.append("  slowest quarter: " + json.dumps(ev["slow_quarter"]))
    if rep.get("think"):
        lines.append("think: " + json.dumps(rep["think"]))
    host = rep.get("host", {})
    dev = rep.get("device")
    lines.append(f"{'span':24s} {'count/ev':>9s} {'host ms/ev':>10s} {'self':>8s} "
                 f"{'dev self':>9s} {'dev incl':>9s}")
    for name, h in sorted(host.items(), key=lambda kv: -kv[1]["host_ms_per_event"]):
        d = (dev or {}).get("spans", {}).get(name, {})
        lines.append(f"{name:24s} {h['per_event']:9.3f} {h['host_ms_per_event']:10.3f} "
                     f"{h['host_self_ms_per_event']:8.3f} {d.get('self_ms_per_event', 0):9.3f} "
                     f"{d.get('incl_ms_per_event', 0):9.3f}")
    if dev:
        lines.append(f"slice {dev['slice_ms']:.1f} ms, busy {dev['busy_ms']:.1f}, idle "
                     f"{num(dev['idle_share'])} %, events {dev['events_in_slice']}, device ops "
                     f"{dev['device_ops']} ({dev['unlinked_ops']} with no launch found)")
        lines.append(f"outside program spans: {dev['outside_program_ms']:.2f} ms "
                     f"({num(dev['outside_program_share'])} % of busy): "
                     + json.dumps({k: round(v, 3) for k, v in dev['outside'].items()}))
        lines.append(f"segment launches {dev['segment_launches']}, linked to kernels.launch "
                     f"{dev['segment_linked_to_kernels_launch']}")
        lines.append("device time by (op, span, call), ms:")
        for op, span, call, ms in dev["sites"][:25]:
            lines.append(f"  {ms:9.2f}  {span:22s} {str(call):28s} {op}")
        lines.append("idle gaps by span: " + json.dumps(
            {k: {kk: round(vv, 3) for kk, vv in v.items()} for k, v in dev["gaps"].items()}))
        lines.append("longest gaps: " + json.dumps([[round(ms, 3), s, c]
                                                    for ms, s, c in dev["gaps_top"]]))
        for k in ("contraction", "segment"):
            b = dev[k]
            lines.append(f"{k}: {b['members']} members, {b['bytes'] / 1e9:.3f} GB over "
                         f"{b['device_ms']:.2f} ms: {num(b['hbm_share'])} % of 3.35 TB/s")
    return "\n".join(lines)


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--mode", choices=("slice", "off", "spans", "window"), default="slice")
    p.add_argument("--out", default="artifacts/trace_cell")
    p.add_argument("--device", default="cuda")
    p.add_argument("--rows-divisor", type=int, default=1,
                   help="divide each table's rows (a CPU rehearsal at a tiny size)")
    args = p.parse_args(argv)
    import torch

    from treantbench.harness import bench, loop

    if args.device == "cuda":
        from repro_torch.kernels import build

        build.build()
    spec = bench.load_benchmark()
    cell = bench.cell(spec, args.workload)
    config = bench.config_of(spec, cell["config"])
    mix = bench.traffic_of(cell["traffic"])
    if args.rows_divisor > 1:
        config["rows"] = {k: max(64, n // args.rows_divisor) for k, n in config["rows"].items()}
    tables = bench.generator_of(config).generate(config, args.seed)
    if args.device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    tracer = SpanTracer(torch, args.mode, args.device)
    run = loop.run_cell(torch, tables, mix, config, args.seed, args.seconds, args.device,
                        T_START, tracer=tracer)
    e2e = {}
    for m in spec["end_to_end"]:
        if args.workload in m.get("workloads", [args.workload]):
            e2e[m["name"]] = bench.reader(m["name"])(run)
    rep = {"workload": args.workload, "seed": args.seed, "mode": args.mode, "card": card(),
           "seconds": args.seconds, "end_to_end": e2e, "window_events": len(run.events)}
    if args.mode == "slice":
        t0 = time.perf_counter()
        rep["host"] = host_side(tracer.records, len(run.events))
        rep["events"] = event_classes(run, tracer.records)
        rep["think"] = think_split(tracer.records, len(run.events))
        rep["device"] = device_side(tracer.prof, tracer.records) if tracer.prof else None
        rep["report_s"] = time.perf_counter() - t0
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    stem = f"{args.workload}.{args.seed}.{args.mode}"
    (out / f"{stem}.json").write_text(json.dumps(rep, indent=1, default=str))
    if args.mode == "slice":
        (out / f"{stem}.txt").write_text(text(rep) + "\n")
    print(json.dumps({"workload": args.workload, "seed": args.seed, "mode": args.mode,
                      "card": rep["card"], "end_to_end": e2e, "events": len(run.events)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
