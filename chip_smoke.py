#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card and the
CUDA toolkit.  Phases:

1. print the card's name and power limit (``nvidia-smi``);
2. build the hand-written CUDA kernels from ``src/repro_torch/kernels/*/csrc``
   (one ``nvcc`` per source, all at once) and print the build time;
3. kernel phase: ``aggregate_op`` and ``level_aggregate`` against their plain
   PyTorch versions on the card, for sum/min/max, at small shapes and at the
   main path's shapes (N = 2^24 rows, G up to 100 000, V in {1, 3, 8}),
   with empty segments and -1 pad rows.  Min/max and sums of integer-valued
   data must match exactly; gamma-valued sums to rtol 1e-5.  Each shape is
   timed: kernel, memory bound at 3.35 TB/s, plain version, and one
   ``index_add_`` / ``scatter_reduce_`` call on the same inputs;
4. slice phase: the quickstart sequence at a deployment's size
   (``schema.salesforce`` with every table x50: 10M opportunities, Opp row
   bucket 2^24) on ``cuda``: two dashboard registrations, the role filter,
   think-time, the title drill-down, the SQL interaction and a MAX query.
   Launch counts are reset just before the timed run and read just after;
   both kernels must have launched.  Answers must equal the same sequence
   run by the port on the CPU and a numpy brute force over the join (rtol
   1e-5 for float sums, exact for MAX), with equal message counts.  One
   more run under ``torch.profiler`` gives device time by kernel;
5. time each kernel on the inputs of its largest launch in the slice.

The line before the last is the ``nvidia-smi`` line, the one before it the
``{"kernels": [...]}`` record; the last line is
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before the
last line.  Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate (data sheet)
SCALE = 50                         # x the generator's default table sizes
KERNEL_SOURCES = {
    "segment_aggregate": (
        "src/repro_torch/kernels/segment_aggregate/csrc/segment_aggregate.cu",
        "src/repro/kernels/segment_aggregate/kernel.py:62",
    ),
    "level_segment_aggregate": (
        "src/repro_torch/kernels/segment_aggregate/csrc/level_segment_aggregate.cu",
        "src/repro/kernels/segment_aggregate/kernel.py:125",
    ),
}


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def time_ms(fn, reps: int = 10, rounds: int = 5) -> float:
    """Median over ``rounds`` of the mean time of ``reps`` calls (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out)


def bound_ms(n: int, v: int, g: int) -> float:
    """Least time on the card: read codes (4N) and values (4NV) once, write
    the output (4GV) once, at the device memory rate."""
    return (n * 4 + n * v * 4 + g * v * 4) / HBM_BYTES_PER_S * 1e3


def library_call(codes, values, g, op):
    """One PyTorch call computing the same function (never used by the port)."""
    import torch

    if op == "sum":
        out = torch.zeros((g, values.shape[1]), dtype=torch.float32, device=values.device)
        return lambda: out.zero_().index_add_(0, codes, values)
    idx = codes.long()[:, None].expand_as(values)
    fill = float("inf") if op == "min" else float("-inf")
    out = torch.full((g, values.shape[1]), fill, dtype=torch.float32, device=values.device)
    reduce = "amin" if op == "min" else "amax"
    return lambda: out.fill_(fill).scatter_reduce_(0, idx, values, reduce=reduce,
                                                    include_self=True)


def max_abs_err(a, b) -> float:
    import torch

    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    diff = torch.where(same, torch.zeros_like(a), (a - b).abs())
    return float(diff.max()) if diff.numel() else 0.0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_phase(torch, ops, ref, report: dict) -> None:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def ints(n, v, lo=-20, hi=21):
        return torch.randint(lo, hi, (n, v), generator=gen, device=dev).float()

    def codes_for(n, g):
        return torch.randint(0, g, (n,), generator=gen, device=dev, dtype=torch.int32)

    def op_values(x, op):
        if op == "sum":
            return x
        return x.masked_fill(x == 0, float("inf") if op == "min" else float("-inf"))

    rows = []
    small = [(64, 8, 1), (1000, 64, 3), (77, 13, 5), (4096, 300, 2), (100, 50, 2)]
    main = [(1 << 24, 100_000, 1), (1 << 24, 50_000, 3), (1 << 24, 12, 8), (1 << 24, 16, 1)]
    for n, g, v in small + main:
        codes = codes_for(n, g if (n, g, v) != (100, 50, 2) else 10)  # last small: empty segments
        base = ints(n, v)
        base[torch.rand(n, generator=gen, device=dev) < 0.3] = 0.0
        for op in ("sum", "min", "max"):
            x = op_values(base, op)
            got = ops.aggregate_op(codes, x, g, op)
            want = ref.segment_aggregate_ref(codes, x, g, op)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"aggregate_op {op} N={n} G={g} V={v} disagrees")
            if (n, g, v) in main:
                rows.append(dict(
                    kernel="segment_aggregate", n=n, g=g, v=v, op=op, data="integer",
                    ms=time_ms(lambda: ops.aggregate_op(codes, x, g, op)),
                    plain_ms=time_ms(lambda: ref.segment_aggregate_ref(codes, x, g, op), 3, 3),
                    library_ms=time_ms(library_call(codes, x, g, op)),
                    bound_ms=bound_ms(n, v, g),
                ))
    # gamma-valued sums: float32 atomics against the float64-accumulated plain version
    for n, g, v in main:
        codes = codes_for(n, g)
        x = torch.distributions.Gamma(torch.tensor(2.0, device=dev),
                                      torch.tensor(1 / 5000.0, device=dev)).sample((n, v))
        got = ops.aggregate_op(codes, x, g, "sum")
        torch.testing.assert_close(got, ref.segment_aggregate_ref(codes, x, g, "sum"),
                                   rtol=1e-5, atol=0)
    # level kernel: several messages, ragged widths, -1 pad rows, empty segments
    specs_small = [(30, 5, 1), (1000, 64, 4), (77, 13, 3), (9, 300, 2)]
    specs_main = [(1 << 24, 50_000, 8), (1 << 24, 25_000, 8)]
    for specs in (specs_small, specs_main):
        for op in ("sum", "min", "max"):
            items = [(codes_for(n, g), op_values(ints(n, v), op), g) for n, g, v in specs]
            outs = ops.level_aggregate(items, op=op)
            torch.cuda.synchronize()
            for (c, x, g), o in zip(items, outs):
                check(torch.equal(o, ref.segment_aggregate_ref(c, x, g, op)),
                      f"level_aggregate {op} {specs} disagrees")
            if specs is specs_main:
                cat_codes = torch.cat([c + off for (c, _, _), off in
                                       zip(items, (0, specs[0][1]))])
                cat_vals = torch.cat([x for _, x, _ in items])
                total = sum(g for _, g, _ in specs)
                n_all = cat_codes.shape[0]
                rows.append(dict(
                    kernel="level_segment_aggregate", n=n_all, g=total, v=8, op=op,
                    data="integer",
                    ms=time_ms(lambda: ops.level_segment_aggregate(cat_codes, cat_vals, total, op)),
                    plain_ms=time_ms(lambda: ref.level_segment_aggregate_ref(
                        cat_codes, cat_vals, total, op), 3, 3),
                    library_ms=time_ms(library_call(cat_codes, cat_vals, total, op)),
                    bound_ms=bound_ms(n_all, 8, total),
                ))
    padded = torch.tensor([0, -1, 2, -1, 0], dtype=torch.int32, device=dev)
    vals = torch.tensor([[1.0], [100.0], [3.0], [-100.0], [2.0]], device=dev)
    check(ops.level_segment_aggregate(padded, vals, 4, "sum")[:, 0].tolist()
          == [3.0, 0.0, 3.0, 0.0], "level kernel does not skip -1 pad rows")
    for r in rows:
        print(f"  {r['kernel']:24s} {r['op']:3s} N={r['n']:>9d} G={r['g']:>6d} V={r['v']} "
              f"kernel {r['ms']:.4f} ms  bound {r['bound_ms']:.4f} ms  "
              f"plain {r['plain_ms']:.4f} ms  library {r['library_ms']:.4f} ms", flush=True)
    report["kernel_phase"] = rows


# ---------------------------------------------------------------------------
# phase 4: the quickstart slice at a deployment's size
# ---------------------------------------------------------------------------

SQL = ("SELECT camp_type, SUM(amount) FROM Opp WHERE state IN (1,2,3) "
       "GROUP BY camp_type")


def quickstart(torch, rt, cat, device: str) -> dict:
    """The quickstart's calls on one device; returns answers, counts, times."""
    Treant, Query, sr, mask_in, parse = rt

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    t = Treant(cat, ring=sr.SUM, device=device)
    total = Query.make(cat, ring="sum", measure=("Opp", "amount"))
    pie = total.with_group_by("camp_type")
    t0 = time.perf_counter()
    cal = [t.register_dashboard("pipeline_total", total),
           t.register_dashboard("pipeline_by_campaign", pie)]
    sync()
    offline_s = time.perf_counter() - t0
    q1 = pie.with_predicate(mask_in(cat.domains()["role_name"], [1], attr="role_name"))
    res = [("role_filter", t.interact("anna", "pipeline_by_campaign", q1))]
    t0 = time.perf_counter()
    thought = t.think_time("anna", "pipeline_by_campaign")
    sync()
    think_s = time.perf_counter() - t0
    res.append(("add_group_by_title",
                t.interact("anna", "pipeline_by_campaign", q1.add_group_by("title"))))
    res.append(("sql_state_filter", t.interact("anna", "pipeline_by_campaign", parse(SQL, cat))))
    qm = Query.make(cat, ring="tropical_max", measure=("Opp", "amount"), group_by=("stage",))
    t0 = time.perf_counter()
    f, st = t.engine_for("tropical_max").execute(qm)
    max_s = time.perf_counter() - t0
    answers = {name: r.factor.field.cpu() for name, r in res}
    answers["max_by_stage"] = f.field.cpu()
    counts = [(s.messages_computed, s.messages_reused, s.calibration_dispatches) for s in cal]
    counts += [(r.stats.messages_computed, r.stats.messages_reused) for _, r in res]
    counts += [(st.messages_computed, st.messages_reused), ("think_edges", thought)]
    return dict(
        answers=answers, counts=counts, offline_s=offline_s, think_s=think_s,
        latency_s={name: r.latency_s for name, r in res} | {"max_by_stage": max_s},
        plans=t.cache_stats()["plans"],
    )


def brute_force(np, cat) -> dict:
    """The same answers from numpy over the materialized join."""
    opp, user, camp, acc = (cat.get(n) for n in ("Opp", "User", "Camp", "Acc"))
    amount = opp.measures["amount"].astype(np.float64)
    ctype = camp.codes["camp_type"][opp.codes["camp_id"]]
    role = user.codes["role_id"][opp.codes["user_id"]]  # Role maps role_id → role_name 1:1
    title = user.codes["title"][opp.codes["user_id"]]
    state = acc.codes["state"][opp.codes["acc_id"]]
    sel = role == 1
    in_state = np.isin(state, [1, 2, 3])
    mx = np.full(6, -np.inf)
    np.maximum.at(mx, opp.codes["stage"], opp.measures["amount"])
    return {
        "role_filter": np.bincount(ctype[sel], amount[sel], 8),
        "add_group_by_title": np.bincount(ctype[sel] * 12 + title[sel], amount[sel],
                                          96).reshape(8, 12),
        "sql_state_filter": np.bincount(ctype[in_state], amount[in_state], 8),
        "max_by_stage": mx.astype(np.float32),
    }


def slice_phase(torch, np, ops, kernel, rt, schema, report: dict) -> dict:
    t0 = time.perf_counter()
    cat = schema.salesforce(n_opp=200_000 * SCALE, n_user=2_000 * SCALE,
                            n_camp=500 * SCALE, n_acc=1_000 * SCALE)
    print(f"slice: catalog of {cat.get('Opp').num_rows} opportunities "
          f"(row bucket {cat.get('Opp').row_bucket}) in {time.perf_counter() - t0:.1f} s",
          flush=True)
    # warm-up run on the card: records every launch's shape and keeps the
    # inputs of each kernel's largest launch for the timing phase
    captured: dict = {}
    shapes: list = []
    real_launch = kernel.launch

    def recording_launch(name, codes, values, out, op):
        shapes.append((name, int(values.shape[0]), int(values.shape[1]), int(out.shape[0]), op))
        if name not in captured or values.numel() > captured[name][1].numel():
            captured[name] = (codes.clone(), values.clone(), int(out.shape[0]), op)
        real_launch(name, codes, values, out, op)

    kernel.launch = recording_launch
    try:
        quickstart(torch, rt, cat, "cuda")
    finally:
        kernel.launch = real_launch
    ops.reset_launches()
    gpu = quickstart(torch, rt, cat, "cuda")
    launches = dict(ops.LAUNCHES)
    print(f"slice: launches on the main path {launches}", flush=True)
    for name in KERNEL_SOURCES:
        check(launches[name] > 0, f"{name} never launched on the main path")
    t0 = time.perf_counter()
    cpu = quickstart(torch, rt, cat, "cpu")
    cpu_s = time.perf_counter() - t0
    want = brute_force(np, cat)
    check(gpu["counts"] == cpu["counts"],
          f"message counts differ: cuda {gpu['counts']} cpu {cpu['counts']}")
    for name, ref_answer in want.items():
        g, c = gpu["answers"][name], cpu["answers"][name]
        check(bool(torch.isfinite(g).all()), f"{name}: non-finite answer on cuda")
        if name == "max_by_stage":
            check(torch.equal(g, c) and np.array_equal(g.numpy(), ref_answer),
                  f"{name}: MAX differs")
        else:
            torch.testing.assert_close(g, c, rtol=1e-5, atol=0)
            np.testing.assert_allclose(g.numpy(), ref_answer, rtol=1e-5)
    for key in ("calibration_dispatches", "fused_level_launches", "kernel_execs",
                "plans_built", "plan_hits"):
        check(gpu["plans"][key] == cpu["plans"][key], f"plan counter {key} differs")
    print(f"slice: offline calibration {gpu['offline_s'] * 1e3:.1f} ms on cuda "
          f"({cpu['offline_s'] * 1e3:.1f} ms on the CPU); think-time {gpu['think_s'] * 1e3:.1f} ms",
          flush=True)
    for name, s in gpu["latency_s"].items():
        print(f"slice: {name:20s} {s * 1e3:8.3f} ms on cuda  "
              f"({cpu['latency_s'][name] * 1e3:.3f} ms on the CPU)", flush=True)
    print(f"slice: answers equal the CPU run and the numpy brute force; counts equal "
          f"{gpu['counts']}; CPU run took {cpu_s:.1f} s", flush=True)
    report["slice"] = dict(
        n_opp=cat.get("Opp").num_rows, launches=launches, counts=gpu["counts"],
        offline_ms=gpu["offline_s"] * 1e3, think_ms=gpu["think_s"] * 1e3,
        latency_ms={k: v * 1e3 for k, v in gpu["latency_s"].items()},
        cpu_offline_ms=cpu["offline_s"] * 1e3,
        cpu_latency_ms={k: v * 1e3 for k, v in cpu["latency_s"].items()},
        plans=gpu["plans"], launch_shapes=shapes,
    )
    profile_phase(torch, rt, cat, report)
    return dict(captured=captured, launches=launches)


def profile_phase(torch, rt, cat, report: dict) -> None:
    """One more run on the card under ``torch.profiler``: device time by
    kernel (and copy) and the device's busy share of the run's wall time
    (the profiler slows the host, so the share is a lower bound)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        quickstart(torch, rt, cat, "cuda")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        spans.append((evt.time_range.start, evt.time_range.end))
        ms, calls = by_name.get(evt.name, (0.0, 0))
        by_name[evt.name] = (ms + evt.time_range.elapsed_us() / 1e3, calls + 1)
    busy_us, reach = 0, None
    for start, end in sorted(spans):  # union of the device spans
        if reach is None or start > reach:
            busy_us, reach = busy_us + end - start, end
        elif end > reach:
            busy_us, reach = busy_us + end - reach, end
    rows = sorted(({"name": k, "device_ms": ms, "calls": n} for k, (ms, n) in by_name.items()),
                  key=lambda r: -r["device_ms"])
    report["profile"] = dict(wall_ms=wall_ms, device_busy_ms=busy_us / 1e3, top=rows[:15])
    if not rows:
        print("profile: the trace holds no device time (busy share not measured)", flush=True)
        return
    print(f"profile: quickstart on cuda {wall_ms:.1f} ms wall under the profiler, device busy "
          f"{busy_us / 1e3:.1f} ms ({100 * busy_us / 1e3 / wall_ms:.1f}%)", flush=True)
    for r in rows[:8]:
        print(f"profile:   {r['device_ms']:8.3f} ms  {r['calls']:5d} calls  {r['name'][:90]}",
              flush=True)


def kernel_records(torch, ops, ref, sliced: dict) -> list[dict]:
    """Time each kernel on the inputs of its largest main-path launch."""
    wrappers = {"segment_aggregate": (ops.aggregate_op, ref.segment_aggregate_ref),
                "level_segment_aggregate": (ops.level_segment_aggregate,
                                            ref.level_segment_aggregate_ref)}
    records = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        codes, values, g, op = sliced["captured"][name]
        run, plain = wrappers[name]
        got, want = run(codes, values, g, op), plain(codes, values, g, op)
        torch.cuda.synchronize()
        if op == "sum":
            torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
        else:
            check(torch.equal(got, want), f"{name} disagrees on its main-path inputs")
        n, v = values.shape
        records.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sliced["launches"][name],
            "max_abs_err": max_abs_err(got, want),
            "ms": time_ms(lambda: run(codes, values, g, op)),
            "plain_ms": time_ms(lambda: plain(codes, values, g, op), 3, 3),
            "bound_ms": bound_ms(n, v, g), "bound_by": "bytes",
            "library_ms": time_ms(library_call(codes, values, g, op)),
            "shape": {"n": n, "v": v, "g": g, "op": op},
        })
    return records


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from the root of a checkout (src/repro_torch is missing)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import numpy as np

    from repro_torch.core import Query, Treant
    from repro_torch.core import semiring as sr
    from repro_torch.kernels.segment_aggregate import kernel, ops, ref
    from repro_torch.relational import schema
    from repro_torch.relational.relation import mask_in
    from repro_torch.relational.sql import parse

    report: dict = {}
    try:
        card = card_line()
        print(f"card: {card}", flush=True)
        report["card"] = card
        t0 = time.perf_counter()
        kernel.build()
        report["build_s"] = time.perf_counter() - t0
        print(f"build: {report['build_s']:.1f} s", flush=True)
        print("kernel phase:", flush=True)
        kernel_phase(torch, ops, ref, report)
        sliced = slice_phase(torch, np, ops, kernel, (Treant, Query, sr, mask_in, parse),
                             schema, report)
        records = kernel_records(torch, ops, ref, sliced)
    except (SmokeFailure, AssertionError) as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    report["kernels"] = records
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=str))
    print(json.dumps({"kernels": [{k: v for k, v in r.items() if k != "shape"}
                                  for r in records]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
