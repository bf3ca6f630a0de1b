#!/usr/bin/env python3
"""Measure the union-carry budget's knee on the card.

    python3 tools/union_budget_sweep.py [--reps 5]

The union-carry budget (``REPRO_CALIBRATION_UNION_BUDGET``,
``plans.calibration_union_budget``) caps the γ-domain product one fused
calibration pass may carry; the bin-cube cell budget is 32 × it.  For each
budget in ``BUDGETS`` the script runs ``chip_smoke.py``'s exploration
workload (phase 12: ``schema.flight(n_flights=7_400_000)``, its eight
vizzes): a fresh Treant with ``PredictiveThinkTime(16, 2)`` opens the
session (synced), then one leg-B pass — the two context filters and, per
brush dimension, the anchor, the jump and the clear, ``idle()`` (synced)
after each event.  Per run it records ``open_session`` ms, the summed
``idle()`` ms, the summed fan-out ms of the jumps and clears, whether
every jump and clear was served from bin cubes (no plan execution), the
messages computed (store puts) and ``torch.cuda.max_memory_allocated`` of
``open_session`` and of the whole run.  Runs go budget by budget within a
repetition, ``--reps`` repetitions, after one warm-up run.

The knee is read from the two metrics the budget sets: ``open_session``
time (the union-carry calibration it bounds) and ``open_session``'s peak
device memory.  Among the budgets whose every run serves every jump and
clear from bin cubes (the think-time contract ``chip_smoke.py`` phase 12
checks: the cube cell budget is 32 × the union budget, and a smaller one
leaves the widest viz without cubes), it is the smallest whose median
``open_session`` ms and whose ``open_session`` peak are each within 10 % of
the best eligible.  The summed ``idle()`` ms is recorded beside them but
left out of the rule: it times the bin-cube builds, whose dependence on
the budget (through the 32 × cell budget) the eligibility clause already
holds, and it is paced by ``cube_builds_per_idle``, so a budget that only
shifts work between ``idle()`` calls would decide the knee through noise.
With no eligible budget the profile keeps 512.  The script
writes every run to ``chiprun_out/union_budget_sweep.json`` and the
resulting profile, with the card's name, power limit and the sweep, to
``chiprun_out/h100_costs.json``; committed as
``src/repro_torch/kernels/h100_costs.json`` it is the port's default budget
(``repro_torch/kernels/costs.py``).
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BUDGETS = (32, 64, 128, 256, 512, 1024)
KNEE_SLACK = 0.10       # a budget within 10 % of the best is as good


def knee(open_ms: dict[int, float], open_peak: dict[int, float], eligible: set[int]) -> int:
    """The smallest eligible budget whose median ``open_session`` ms and
    ``open_session`` peak are each within ``KNEE_SLACK`` of the best
    eligible; 512 if none is eligible."""
    if not eligible:
        return 512
    best_ms = min(open_ms[b] for b in eligible)
    best_peak = min(open_peak[b] for b in eligible)
    return min(b for b in eligible if open_ms[b] <= best_ms * (1.0 + KNEE_SLACK)
               and open_peak[b] <= best_peak * (1.0 + KNEE_SLACK))


def spread(xs: list[float]) -> dict:
    return dict(median=statistics.median(xs), min=min(xs), max=max(xs))


def one_run(torch, cs, L, core, cat, jt, budget: int) -> dict:
    """One ``open_session`` and one leg-B pass at ``budget``."""
    os.environ["REPRO_CALIBRATION_UNION_BUDGET"] = str(budget)
    core.reset_think_time_config()
    puts = [0]
    real_put = L.MessageStore.put

    def put(self, *args, **kwargs):
        puts[0] += 1
        return real_put(self, *args, **kwargs)

    L.MessageStore.put = put
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t = L.Treant(cat, ring=L.sr.SUM, jt=jt, device="cuda",
                     policy=L.PredictiveThinkTime(cube_builds_per_idle=16, prefetch_k=2))
        t0 = time.perf_counter()
        sess = t.open_session(cs.explore_spec(L), name="sweep")
        torch.cuda.synchronize()
        open_ms = (time.perf_counter() - t0) * 1e3
        open_puts, open_peak = puts[0], torch.cuda.max_memory_allocated() / 2**20
        events = [(ev, False) for ev in cs.explore_context(L)]
        for anchor, follows in cs.explore_events(L, cat.domains()):
            events += [(anchor, False)] + [(ev, True) for ev in follows]
        idle_ms = fanout_ms = 0.0
        served = True
        for ev, followup in events:
            execs0 = cs._plan_execs(t)
            res = sess.apply(ev)
            torch.cuda.synchronize()
            if followup:
                fanout_ms += res.latency_s * 1e3
                served &= (cs._plan_execs(t) == execs0 and all(
                    r.stats.bin_cube_hits for r in res.results.values()))
            t0 = time.perf_counter()
            sess.idle()
            torch.cuda.synchronize()
            idle_ms += (time.perf_counter() - t0) * 1e3
        sess.close()
    finally:
        L.MessageStore.put = real_put
    return dict(budget=budget, open_ms=open_ms, idle_ms=idle_ms,
                fanout_ms=fanout_ms, cube_served=served, messages_open=open_puts,
                messages=puts[0], open_peak_mib=open_peak,
                peak_mib=torch.cuda.max_memory_allocated() / 2**20)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("union_budget_sweep: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import types

    import chip_smoke as cs
    from repro_torch import core
    from repro_torch.core import (
        ClearFilter, DashboardSpec, MessageStore, PredictiveThinkTime, SetFilter, Treant, VizSpec,
        jt_from_catalog,
    )
    from repro_torch.core import semiring as sr
    from repro_torch.kernels import build
    from repro_torch.relational import schema

    L = types.SimpleNamespace(Treant=Treant, MessageStore=MessageStore, sr=sr,
                              DashboardSpec=DashboardSpec, VizSpec=VizSpec,
                              SetFilter=SetFilter, ClearFilter=ClearFilter,
                              PredictiveThinkTime=PredictiveThinkTime)
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    build.build()
    cat = schema.flight(n_flights=cs.EXPLORE_FLIGHTS)
    jt = jt_from_catalog(cat)
    one_run(torch, cs, L, core, cat, jt, 512)  # warm-up: uploads, first launches
    runs = []
    for rep in range(args.reps):
        for b in BUDGETS:
            r = one_run(torch, cs, L, core, cat, jt, b)
            r["rep"] = rep
            runs.append(r)
            print(f"rep {rep} budget {b:5d}: open_session {r['open_ms']:9.3f} ms, idle "
                  f"{r['idle_ms']:9.3f} ms, jump/clear fan-out "
                  f"{r['fanout_ms']:8.3f} ms, cube-served {r['cube_served']}, messages "
                  f"{r['messages_open']} / {r['messages']}, peak {r['open_peak_mib']:.1f} / "
                  f"{r['peak_mib']:.1f} MiB", flush=True)
    table = {}
    for b in BUDGETS:
        mine = [r for r in runs if r["budget"] == b]
        table[b] = dict(open_ms=spread([r["open_ms"] for r in mine]),
                        idle_ms=spread([r["idle_ms"] for r in mine]),
                        fanout_ms=spread([r["fanout_ms"] for r in mine]),
                        cube_served=all(r["cube_served"] for r in mine),
                        messages=sorted({r["messages"] for r in mine}),
                        messages_open=sorted({r["messages_open"] for r in mine}),
                        open_peak_mib=max(r["open_peak_mib"] for r in mine),
                        peak_mib=max(r["peak_mib"] for r in mine))
    eligible = {b for b, t in table.items() if t["cube_served"]}
    chosen = knee({b: t["open_ms"]["median"] for b, t in table.items()},
                  {b: t["open_peak_mib"] for b, t in table.items()}, eligible)
    print(f"{'budget':>6} {'open ms (med, min-max)':>30} {'idle ms (med, min-max)':>30} "
          f"{'fan-out ms':>10} {'served':>6} {'messages':>9} "
          f"{'open peak':>9} {'peak MiB':>9}")
    for b, t in table.items():
        o, i = t["open_ms"], t["idle_ms"]
        print(f"{b:6d} {o['median']:10.3f} ({o['min']:8.3f}-{o['max']:8.3f}) "
              f"{i['median']:10.3f} ({i['min']:8.3f}-{i['max']:8.3f}) "
              f"{t['fanout_ms']['median']:10.3f} "
              f"{str(t['cube_served']):>6} {t['messages'][-1]:9d} {t['open_peak_mib']:9.1f} "
              f"{t['peak_mib']:9.1f}")
    print(f"knee: {chosen} (eligible: {sorted(eligible)}; the smallest eligible budget whose "
          f"median open_session ms and open_session peak are each within {KNEE_SLACK:.0%} of "
          f"the best eligible)", flush=True)
    name, _, power = card.partition(",")
    profile = {
        "derived": {"calibration_union_budget": chosen},
        "provenance": {
            "card": name.strip(), "power_limit": power.strip(),
            "tool": "tools/union_budget_sweep.py",
            "date": datetime.datetime.now(datetime.timezone.utc).date().isoformat(),
            "workload": f"chip_smoke.py phase 12: open_session and one leg-B pass, "
                        f"schema.flight(n_flights={cs.EXPLORE_FLIGHTS})",
            "rule": f"among budgets whose leg-B pass serves every jump and clear from bin "
                    f"cubes, the smallest whose median open_session ms and open_session peak "
                    f"device memory are each within {KNEE_SLACK:.0%} of the best; 512 if none",
            "eligible": sorted(eligible),
            "budgets": list(BUDGETS), "reps": args.reps,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "median_open_session_ms": {str(b): t["open_ms"]["median"] for b, t in table.items()},
            "open_session_peak_mib": {str(b): t["open_peak_mib"] for b, t in table.items()},
            "median_idle_ms": {str(b): t["idle_ms"]["median"] for b, t in table.items()},
        },
    }
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "union_budget_sweep.json").write_text(json.dumps(
        dict(card=card, runs=runs, table={str(b): t for b, t in table.items()}, knee=chosen),
        indent=1))
    (out / "h100_costs.json").write_text(json.dumps(profile, indent=1) + "\n")
    print(json.dumps(profile))
    return 0


if __name__ == "__main__":
    sys.exit(main())
