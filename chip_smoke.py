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
   ``index_add_`` / ``scatter_reduce_`` call on the same inputs.  Then
   ``semiring_contract`` (float32, float16, σ mask) and ``tropical_contract``
   (min, max, ±inf absent tuples) against their plain versions at
   ``tests/test_kernels.py``'s shapes and at the tall and wide regimes'
   record shapes, M also as a transposed view, on integer-valued data:
   exact; each call timed beside its bound, its plain version and
   ``torch.matmul``.  Two calls on gamma-valued data must give the same
   bits.  Then the host cost of one contract wrapper call, step by step;
4. slice phase: the quickstart sequence at a deployment's size
   (``schema.salesforce`` with every table x50: 10M opportunities, Opp row
   bucket 2^24) on ``cuda``: two dashboard registrations, the role filter,
   think-time, the title drill-down, the SQL interaction and a MAX query.
   Launch counts are reset just before the timed run and read just after;
   both segment kernels must have launched.  Answers must equal the same
   sequence run by the port on the CPU and a numpy brute force over the
   join (rtol 1e-5 for float sums, exact for MAX), with equal message
   counts.  One more run under ``torch.profiler`` gives device time by kernel;
5. dense phase: the same sequence on the same catalog with
   ``dense_rows_threshold=100_000``, so every dimension bag (User, Role,
   Camp, Acc) is dense.  Counts reset before, read after: both contract
   kernels must have launched.  Answers must equal the slice phase's sparse
   answers (rtol 1e-5 for sums, exact for MAX); message and plan counts must
   equal the port's own dense run on the CPU.  Profiled like the slice, and
   the dense ``User`` factor's ``project_to`` before each launch is timed;
6. Fig 21 phase: ``schema.tpcds_star(n_sales=10_000_000)``, COUNT and
   TROPICAL_MAX engines with and without the empty bag ``TimeStores``
   (store_key, time_key): equal (store_key, time_key) answers, equal to a
   numpy brute force, and the contract kernel of the ring launched;
7. R̄ phase: one query with ``removed=("Acc",)`` on the dense Treant, held
   against a numpy brute force over the join without Acc;
8. the contract kernels at every shape the dense and Fig 21 phases
   launched: checked against the plain version, timed beside their bound,
   the plain version and ``torch.matmul`` (float32, TF32 off; kernel 4 has
   no single PyTorch call);
9. time each kernel on the inputs of its largest main-path launch;
10. session phase, on a fresh copy of the slice's catalog (10M
    opportunities): ``Treant.open_session`` with five linked vizzes (SUM by
    stage, state, camp_type and title; MAX by stage) and seven typed events
    (two SetFilters, a Drill, a SwapMeasure to MIN, a ToggleRelation, Undo,
    ClearFilter) with ``idle()`` between them.  Per event it prints the
    fan-out latency, the vizzes re-rendered, the batch group widths, the
    ``level_segment_aggregate`` launches (one per batch group) and
    ``batched_execs``; one group must be at least 2 wide;
11. ingest phase, the same session: four ``flush`` ticks on Opp (four
    append micro-batches of 0.5 % of the fact each, one delete micro-batch
    tombstoning 0.1 % of the live rows and cancelling two fresh appends),
    a User append and a User delete through ``Treant.update`` between ticks
    2 and 3, and one compaction at tick 3; then a dense Treant
    (``dense_rows_threshold=100_000``) takes a Role append, which must launch
    ``semiring_contract``, and one Opp tick.  Per step it prints the latency,
    the messages maintained, the fallbacks, the launches and
    ``torch.cuda.memory_allocated`` / ``max_memory_allocated``; every tick
    must launch ``segment_aggregate``.  Every viz rendered or read in phases
    10-11 must equal a cold engine over its query's versions (rtol 1e-5 for
    sums, exact for MIN/MAX), and the whole sequence at x5 (1M
    opportunities) must give the same counts and answers on cuda and on the
    CPU.  Launch counts of the two phases join the kernel records
    (``launches_session``, ``launches_ingest``);
12. exploration phase: ``schema.flight(n_flights=7_400_000)`` (a year of US
    domestic flights, Flights row bucket 2^23), ``benchmarks/bench_explore.py``'s
    eight vizzes, two context filters and, per brush dimension, an anchor,
    a 3-value jump and a ClearFilter, ``idle()`` after every event, on two
    Treants: leg A with ``FixedKPrefetch(2)``, leg B with
    ``PredictiveThinkTime(16, 2)``, one warm pass then two timed passes in
    turns.  Per event: fan-out latency (synced), prefetch and cube hits,
    plan executions, store probes; per ``idle()``: think time, cube builds,
    ``bin_cube_bytes`` and the peak device memory of each build.  Every
    timed leg-B event must be cube-served with no plan execution and no
    store probe; timed answers equal cold engines on the card.  The warm
    pass runs once more at full size with every segment-kernel launch held
    against its plain version on the same tensors (float sums to a relative
    max(1e-5, 4·√n·2^-24) for a segment of n rows), and a
    level-plan call must have split its launch in two or more (the operands
    past ``plans.ROWWISE_MAX_ELEMS``).  The warm pass at 300,000 flights
    gives the same counters and answers on cuda and on the CPU;
13. serving phase, on the same catalog: ``benchmarks/bench_serve.py``'s
    drag storm through ``TreantServer`` — 64 sessions over ``serve_spec()``
    (7 COUNT-valued vizzes, brush on airport_state, 8 hot windows, 3 drag
    positions, 2 warm and 4 timed rounds, ``step()`` until the queue drains,
    ``idle()`` between rounds), then 64 sessions over the four spec
    variants, then the shared storm under a store budget of the pinned floor
    plus half the evictable bytes.  Prints events/s, p99 applied-event
    latency (the synced time of the ``step()`` that applied the event), the
    cross-session batch width, coalesced events, kernel-2 launches per
    ``step()`` and the store against budget and floor.  Every read must
    equal a serial ``Session.apply`` of every submitted event on a twin
    Treant (bit for bit), the budget must hold, the shared storm once more
    with every segment-kernel launch held bit for bit against its plain
    version must give the same reads, and the storm at
    300,000 flights and 16 sessions must equal the CPU.  Launch counts join
    the kernel records (``launches_explore``, ``launches_serve``);
14. ML phase (Fig 18): ``schema.favorita`` at Kaggle's Favorita widths (54
    stores, 4,100 items, 1,684 dates) with 8M sales;
    ``examples/ml_augmentation.py``'s model (k = 11): ``fit``,
    ``calibrate``, all 30 ``favorita_augmentations(n_per_key=10)`` through
    ``fit_augmented`` and ``fit_unfactorized_baseline`` for the first of
    each key.  Prints the fit and calibrate times, per-key candidate times
    and messages, the peak device memory.  At most one computed message per
    candidate, none for a repeated key; no kernel launch (the covariance
    ring reduces in plain torch).  The base element (c, s, Q) must be within
    its float32 sum bound of float64 numpy sums of the same join; R² and
    weights against a float64 numpy fit, and augmented R² against the cold
    baseline and numpy, within the reference test's tolerances or the
    bound carried through the solve, whichever is wider; the drive at
    60,000 sales must equal the CPU;
15. cube phase (Fig 24/25): ``build_cube`` over phase 12's catalog, dims
    (carrier_group, airport_state, month, dow), COUNT, h = 3, pivot k = 0,
    1, 2 on fresh engines, and ``naive_cube_cost`` once.  Prints calibrate
    against total and worst per-cuboid query time, store bytes and messages
    per k.  Every cuboid must equal a numpy ``bincount`` and roll up to the
    apex; the cubes again with every segment-kernel launch held bit for bit
    against its plain version; the cubes at 60,000 flights must equal the
    CPU (``launches_ml``, ``launches_cube`` join the kernel records);
16. unfused phase: ``open_session`` of five COUNT and SUM vizzes on the
    slice's catalog (Opp amounts rounded to integers, so float sums are
    exact), fused and with ``fuse_level_kernel=False``: bit-equal answers,
    no fused level launch and at least as many calibration dispatches when
    unfused, and ``level_segment_aggregate`` launched by
    ``run_message_batch`` (``launches_unfused``);
17. sharded phase, on phase 16's catalog: the same five vizzes opened and
    one interaction under ``Treant(mesh=ShardMesh.virtual(k, "cuda"))`` for
    k = 2 and 4 beside ``mesh=0``, then one 50,000-row Opp flush tick at
    k = 4 and ``mesh=0``.  Answers bit-equal to ``mesh=0``, plan counters
    equal but ``shard_execs`` (> 0), ``allreduce_bytes`` (equal to the bytes
    the ⊕-folds carried) and ``shard_imbalance`` (its formula's worst
    relation); synced times and peak device memory for k = 1, 2, 4, each
    after an untimed warm open and interaction on a catalog of its own
    (``launches_sharded``: the first 4-shard run's launches, counted from
    0 after its warm-up); the k = 4 run again with every segment-kernel
    launch held bit for bit against its plain version; ``open_session`` at
    k = 1 and 4 under ``torch.profiler``; the domain-sharded
    chain demo (r = 6, d = 4,096, 4 shards) against
    ``calibrate_chain_reference`` at rtol 1e-4;
18. LM serving phase (``repro_torch.models`` / ``runtime.step`` /
    ``launch.serve``, plain PyTorch, no kernel of its own): each of the ten
    archs' ``smoke_config`` with every parameter leaf random, then
    stablelm-12b at full width with its depth cut from 40 to 2 layers,
    each on the card in float32 (TF32 off) against the port on the CPU:
    prefill logits and caches and every decode step's logits within rtol
    = atol 5e-4, greedy tokens equal; stablelm-12b at full width and
    depth in bfloat16 (batch 4, prompt 64, 32 greedy decode steps): finite
    logits, the teacher-forced decode at position 64 against a prefill of
    65 tokens within its bf16 bound (rms difference at most
    4·2^-8·√(2L+1) of the logits' rms, the largest at most four times
    that), prefill and decode times beside their bounds (bytes over 3.35
    TB/s, operations over 989 TFLOP/s), tokens/s, peak device memory and
    one profiled decode step; zamba2-1.2b at full size through
    ``repro_torch.launch.serve.main`` on the default device, float32:
    (4, 33) tokens, all in the vocabulary.

Two times go with every kernel: ``ms``, wrapper calls back to back between
CUDA events (what the main path pays, host cost included), and
``device_ms``, the same calls captured in a CUDA graph and replayed between
CUDA events (no host cost), rotating among enough input copies to exceed
the 50 MB L2 cache.

The line before the last is the ``nvidia-smi`` line, the one before it the
``{"kernels": [...]}`` record; the last line is
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before the
last line.  Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import statistics
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate (data sheet)
FP32_FLOPS = 67e12                 # H100 SXM float32 rate outside the tensor cores
SCALE = 50                         # x the generator's default table sizes
DENSE_ROWS = 100_000               # every x50 dimension table is at most this
KERNEL_SOURCES = {
    "segment_aggregate": (
        "src/repro_torch/kernels/segment_aggregate/csrc/segment_aggregate.cu",
        "src/repro/kernels/segment_aggregate/kernel.py:62",
    ),
    "level_segment_aggregate": (
        "src/repro_torch/kernels/segment_aggregate/csrc/level_segment_aggregate.cu",
        "src/repro/kernels/segment_aggregate/kernel.py:125",
    ),
    "semiring_contract": (
        "src/repro_torch/kernels/semiring_contract/csrc/semiring_contract.cu",
        "src/repro/kernels/semiring_contract/kernel.py:36",
    ),
    "tropical_contract": (
        "src/repro_torch/kernels/tropical_contract/csrc/tropical_contract.cu",
        "src/repro/kernels/tropical_contract/kernel.py:37",
    ),
}
SEGMENT = ("segment_aggregate", "level_segment_aggregate")
CONTRACT = ("semiring_contract", "tropical_contract")


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


L2_BYTES = 50 * 2**20              # H100 L2 cache


def device_ms(fn, args: tuple, reps: int = 20, rounds: int = 5) -> float:
    """Device time of one ``fn(*args)`` call: ``reps`` calls captured in a
    CUDA graph, replayed between CUDA events (replay has no host cost), the
    median over ``rounds`` replays of the mean per call.  The calls rotate
    among copies of the tensor arguments, enough to exceed the L2 cache
    (at most 256), so the inputs come from device memory as on the main
    path."""
    import torch

    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    copies = max(1, min(256, -(-2 * L2_BYTES // max(nbytes, 1))))
    sets = [args] + [tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
                     for _ in range(copies - 1)]
    reps = max(reps, copies)
    # warm up and capture on one stream: the contract kernels keep their
    # scratch per stream, so it exists before the capture
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for a in sets:
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for i in range(reps):
            fn(*sets[i % copies])
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(out)


def bound_ms(n: int, v: int, g: int) -> float:
    """Least time on the card: read codes (4N) and values (4NV) once, write
    the output (4GV) once, at the device memory rate."""
    return (n * 4 + n * v * 4 + g * v * 4) / HBM_BYTES_PER_S * 1e3


def contract_bound(g: int, b: int, a: int, in_bytes: int = 4, masked: bool = False,
                   tropical: bool = False) -> tuple[float, str]:
    """Least time on the card for one (G, B) x (B, A) contraction: the larger
    of the bytes (inputs read once, the float32 output written once) at the
    device memory rate and the operations at the float32 rate: 2·G·B·A flops
    at 67 TFLOP/s for the sum (G·B·A FMAs), 2·G·B·A adds and min/max at half
    that rate for the tropical product."""
    nbytes = (g * b + b * a) * in_bytes + g * a * 4 + (b * 4 if masked else 0)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * g * b * a / (FP32_FLOPS / 2 if tropical else FP32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def reset_launches(K) -> None:
    for ops in (K.seg_ops, K.sc_ops, K.tc_ops):
        ops.reset_launches()


def read_launches(K) -> dict:
    return {**K.seg_ops.LAUNCHES, **K.sc_ops.LAUNCHES, **K.tc_ops.LAUNCHES}


@contextlib.contextmanager
def recording_contracts(K, captured: dict, shapes: list):
    """Record every contract-kernel launch's shape, and keep one copy of the
    inputs of each distinct (kernel, shape, op), while the block runs."""
    real_sc, real_tc = K.sc_kernel.launch, K.tc_kernel.launch

    def keep(name, m, r, op, mask=None):
        key = (name, *m.shape, r.shape[1], str(m.dtype), op)
        shapes.append((*key, tuple(m.stride()), tuple(r.stride())))
        if key not in captured:  # clone() keeps a transposed view's strides
            captured[key] = (m.clone(), r.clone(), op, None if mask is None else mask.clone())

    def sc_launch(m, r, mask, out, scratch, geom):
        keep("semiring_contract", m, r, "sum", mask)
        real_sc(m, r, mask, out, scratch, geom)

    def tc_launch(m, r, out, scratch, geom, is_min):
        keep("tropical_contract", m, r, "min" if is_min else "max")
        real_tc(m, r, out, scratch, geom, is_min)

    K.sc_kernel.launch, K.tc_kernel.launch = sc_launch, tc_launch
    try:
        yield
    finally:
        K.sc_kernel.launch, K.tc_kernel.launch = real_sc, real_tc


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


# the regimes' record shapes (csrc/contract.cuh): wide (16, 1e5) x (1e5, 8),
# (16, 1e5) x (1e5, 1) and (1, 5e4) x (5e4, 8); tall (1e5, 16) x (16, 1) and
# (1e5, 16) x (16, 8)
REGIME_SHAPES = [(16, 100_000, 8), (16, 100_000, 1), (1, 50_000, 8), (100_000, 16, 1),
                 (100_000, 16, 8)]


def contract_kernel_phase(torch, K, report: dict) -> None:
    """Kernels 3 and 4 against their plain versions at ``tests/test_kernels.py``'s
    shapes and at the regimes' record shapes, M also as a transposed view
    (strides (1, G), as the dense plan hands it over), each call timed.
    Integer-valued data in [-20, 20] is exact in float16 too, and every
    product and sum stays an integer below 2^24, so the sum must match
    exactly; min/max are exact in any order.  Then the repeat check: two
    calls on gamma-valued float32 data give the same bits."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    shapes = [(8, 8, 8), (64, 64, 64), (100, 70, 130), (256, 128, 200), (1, 300, 5)]
    rows = []
    for g, b, a in shapes + REGIME_SHAPES:
        m = torch.randint(-20, 21, (g, b), generator=gen, device=dev).float()
        r = torch.randint(-20, 21, (b, a), generator=gen, device=dev).float()
        mask = (torch.rand(b, generator=gen, device=dev) > 0.5).float()
        for view in (False,) if (g, b, a) in shapes else (False, True):
            def lay(x):  # M as it lies, or as a transposed view of the same values
                return x.t().contiguous().t() if view else x

            for dtype in (torch.float32, torch.float16):
                for mk in (None, mask):
                    rows.append(contract_row(torch, K, "semiring_contract", lay(m.to(dtype)),
                                             r.to(dtype), "sum", mk))
            for op in ("min", "max"):
                ident = float("inf") if op == "min" else float("-inf")
                mi = m.masked_fill(torch.rand(m.shape, generator=gen, device=dev) < 0.3, ident)
                rows.append(contract_row(torch, K, "tropical_contract", lay(mi), r, op))
    print_contract_rows(rows)
    report["contract_kernel_phase"] = rows
    gamma = torch.distributions.Gamma(torch.tensor(2.0, device=dev),
                                      torch.tensor(1 / 5000.0, device=dev))
    for g, b, a in REGIME_SHAPES:
        m, r = gamma.sample((g, b)), gamma.sample((b, a)) / 1e4
        for mm in (m, m.t().contiguous().t()):
            first, second = K.sc_ops.contract_op(mm, r), K.sc_ops.contract_op(mm, r)
            torch.cuda.synchronize()
            check(torch.equal(first, second),
                  f"semiring_contract ({g}, {b}) x ({b}, {a}) differs between two calls")
            torch.testing.assert_close(first, K.sc_ref.semiring_contract_ref(mm, r),
                                       rtol=1e-5, atol=0)
    print("  semiring_contract: two calls on gamma-valued data give the same bits", flush=True)
    # split launches on two streams at once: each stream has its own
    # workspace and tickets, so neither reads the other's partials
    streams = torch.cuda.Stream(), torch.cuda.Stream()
    for g, b, a in ((16, 100_000, 8), (192, 100_000, 8)):
        pairs = [(torch.randint(-20, 21, (g, b), generator=gen, device=dev).float(),
                  torch.randint(-20, 21, (b, a), generator=gen, device=dev).float())
                 for _ in streams]
        regime = K.launch.contract_args(*pairs[0], (torch.float32,)).regime
        for name, (run, plain) in (
                ("semiring_contract", (K.sc_ops.contract_op, K.sc_ref.semiring_contract_ref)),
                ("tropical_contract", (K.tc_ops.contract_op, K.tc_ref.tropical_contract_ref))):
            torch.cuda.synchronize()
            outs = [[] for _ in streams]
            for _ in range(8):
                for st, pair, got in zip(streams, pairs, outs):
                    with torch.cuda.stream(st):
                        got.append(run(*pair))
            torch.cuda.synchronize()
            for pair, got in zip(pairs, outs):
                want = plain(*pair)
                check(all(torch.equal(x, want) for x in got),
                      f"{name} ({g}, {b}) x ({b}, {a}) {regime}: wrong on two streams at once")
    print("  both contract kernels: split launches on two streams at once are exact", flush=True)


def contract_run(K, name, m, r, op, mask=None):
    if name == "semiring_contract":
        return (lambda: K.sc_ops.contract_op(m, r, mask),
                lambda: K.sc_ref.semiring_contract_ref(m, r, mask))
    is_min = op == "min"
    return (lambda: K.tc_ops.contract_op(m, r, is_min=is_min),
            lambda: K.tc_ref.tropical_contract_ref(m, r, is_min))


def contract_row(torch, K, name, m, r, op, mask=None, exact=True) -> dict:
    """Check one contract-kernel call against its plain version (exactly, or
    to rtol 1e-5 for float sums in another order), then time the kernel, the
    plain version and, for a float32 product without σ mask, one
    ``torch.matmul`` (the port never calls it; kernel 4 has no single
    PyTorch call).  The bound comes from the shapes."""
    run, plain = contract_run(K, name, m, r, op, mask)
    got, want = run(), plain()
    torch.cuda.synchronize()
    (g, b), a = m.shape, r.shape[1]
    what = f"{name} {op} {m.dtype} mask={mask is not None} ({g}, {b}) x ({b}, {a})"
    check(not bool(torch.isnan(got).any()), f"{what} gave NaN")
    if exact:
        check(torch.equal(got, want), f"{what} disagrees with its plain version")
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    library = library_device = None
    if name == "semiring_contract" and mask is None and m.dtype == torch.float32:
        library = time_ms(lambda: torch.matmul(m, r))
        library_device = device_ms(torch.matmul, (m, r))
    bound, by = contract_bound(g, b, a, m.element_size(), mask is not None,
                               name == "tropical_contract")
    if name == "semiring_contract":
        dev_ms = device_ms(K.sc_ops.contract_op, (m, r, mask))
    else:
        dev_ms = device_ms(lambda mm, rr: K.tc_ops.contract_op(mm, rr, is_min=op == "min"), (m, r))
    return dict(kernel=name, g=g, b=b, a=a, op=op, dtype=str(m.dtype).replace("torch.", ""),
                masked=mask is not None, m_strides=list(m.stride()),
                regime=K.launch.contract_args(m, r, (m.dtype,)).regime,
                ms=time_ms(run), device_ms=dev_ms, plain_ms=time_ms(plain, 3, 3),
                library_ms=library, library_device_ms=library_device, bound_ms=bound,
                bound_by=by, max_abs_err=max_abs_err(got, want))


def print_contract_rows(rows: list[dict]) -> None:
    for r in rows:
        lib = ("null" if r["library_ms"] is None else
               f"{r['library_ms']:.4f} ms (device {r['library_device_ms']:.4f})")
        mask = "mask" if r["masked"] else "    "
        print(f"  {r['kernel']:18s} {r['op']:3s} {r['dtype']:7s} {mask} {r['regime']:5s} "
              f"({r['g']}, {r['b']}) x ({r['b']}, {r['a']}) M strides {tuple(r['m_strides'])}  "
              f"kernel {r['ms']:.4f} ms (device {r['device_ms']:.4f})  "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})  plain {r['plain_ms']:.4f} ms  "
              f"library {lib}", flush=True)
        for lay in r.get("path_m_layouts", ()):
            print(f"    the main paths handed M over with strides {tuple(lay['strides'])} "
                  f"(read along {lay['read_along']}) in {lay['launches']} launches", flush=True)


def host_us(fn, n: int = 200, rounds: int = 7) -> float:
    """Host time of one ``fn()`` call in microseconds: the median over
    ``rounds`` of the mean of ``n`` calls on the host clock, with the device
    drained between rounds (outside the clock)."""
    import torch

    fn()
    out = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out.append((time.perf_counter() - t0) / n * 1e6)
    torch.cuda.synchronize()
    return statistics.median(out)


def host_cost_phase(torch, K, report: dict) -> None:
    """Split the host cost of a contract wrapper call into its steps, at the
    record input (16, 100 000) x (100 000, 8) with M a transposed view.  The
    steps an earlier wrapper took (``torch.zeros``/``torch.full`` output,
    ``build.load`` + ``getattr``, a device context, a ``Stream`` object) are
    timed beside the ones that replaced them, and the whole calls beside
    ``torch.matmul``."""
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(5)
    m = torch.randint(-20, 21, (100_000, 16), generator=gen, device=dev).float().t()
    r = torch.randint(-20, 21, (100_000, 8), generator=gen, device=dev).float()
    mc = m.contiguous()
    dtypes = (torch.float32,)
    geom = K.launch.contract_args(m, r, dtypes)
    out = torch.empty((16, 8), device=dev)
    kern = K.sc_kernel.KERNEL
    K.sc_ops.contract_op(m, r)
    scratch = kern.scratch(dev, geom)
    fn, raw, sym = kern._fn, kern._stream, kern.symbol
    ptrs = (m.data_ptr(), r.data_ptr(), None, out.data_ptr(), *scratch, geom.address)

    def device_context():
        with torch.cuda.device(dev):
            pass

    steps = [
        ("checks and cached geometry (launch.contract_args)",
         lambda: K.launch.contract_args(m, r, dtypes)),
        ("torch.zeros output (earlier wrapper: allocation + fill launch)",
         lambda: torch.zeros((16, 8), device=dev)),
        ("torch.full output (earlier tropical wrapper: allocation + fill launch)",
         lambda: torch.full((16, 8), float("inf"), device=dev)),
        ("torch.empty output", lambda: torch.empty((16, 8), device=dev)),
        ("m.new_empty output", lambda: m.new_empty((16, 8))),
        ("torch.empty workspace (a fresh one per call)", lambda: torch.empty(geom.ws, device=dev)),
        ("Kernel.scratch (workspace and tickets kept per stream)",
         lambda: kern.scratch(dev, geom)),
        ("build.load + getattr (earlier wrapper, every call)",
         lambda: getattr(K.build.load(sym), sym)),
        ("with torch.cuda.device(...) (earlier wrapper, every call)", device_context),
        ("torch.cuda.current_stream(dev).cuda_stream (earlier wrapper)",
         lambda: torch.cuda.current_stream(dev).cuda_stream),
        ("raw current stream", lambda: raw(dev.index)),
        ("torch.cuda.current_device()", torch.cuda.current_device),
        ("data_ptr() of m, r, out", lambda: (m.data_ptr(), r.data_ptr(), out.data_ptr())),
        ("ctypes call: launch + cudaGetLastError", lambda: fn(*ptrs, raw(dev.index))),
        ("kernel.launch (bound kernel, device check, stream, ctypes)",
         lambda: K.sc_kernel.launch(m, r, None, out, scratch, geom)),
        ("contract_op, M a transposed view (the whole wrapper)",
         lambda: K.sc_ops.contract_op(m, r)),
        ("contract_op, M contiguous", lambda: K.sc_ops.contract_op(mc, r)),
        ("torch.matmul(m, r), M contiguous", lambda: torch.matmul(mc, r)),
        ("torch.matmul(m, r), M a transposed view", lambda: torch.matmul(m, r)),
    ]
    rows = [{"step": name, "host_us": host_us(f)} for name, f in steps]
    for row in rows:
        print(f"  host {row['host_us']:8.2f} us  {row['step']}", flush=True)
    report["host_cost"] = rows


# ---------------------------------------------------------------------------
# phase 4: the quickstart slice at a deployment's size
# ---------------------------------------------------------------------------

SQL = ("SELECT camp_type, SUM(amount) FROM Opp WHERE state IN (1,2,3) "
       "GROUP BY camp_type")


def quickstart(torch, rt, cat, device: str, **treant_kw) -> dict:
    """The quickstart's calls on one device; returns answers, counts, times
    (and the Treant, for the phases that go on with it)."""
    Treant, Query, sr, mask_in, parse = rt

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    t = Treant(cat, ring=sr.SUM, device=device, **treant_kw)
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
        plans=t.cache_stats()["plans"], treant=t,
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


def slice_phase(torch, np, K, rt, schema, report: dict) -> dict:
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
    kernel = K.seg_kernel
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
    reset_launches(K)
    gpu = quickstart(torch, rt, cat, "cuda")
    launches = read_launches(K)
    print(f"slice: launches on the main path {launches}", flush=True)
    for name in SEGMENT:
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
    check_plan_counters(gpu, cpu)
    print_latencies("slice", gpu, cpu)
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
    profile_phase(torch, "slice", lambda: quickstart(torch, rt, cat, "cuda"), report)
    return dict(cat=cat, captured=captured, launches=launches, answers=gpu["answers"])


def check_plan_counters(gpu: dict, cpu: dict) -> None:
    for key in ("calibration_dispatches", "fused_level_launches", "kernel_execs",
                "plans_built", "plan_hits"):
        check(gpu["plans"][key] == cpu["plans"][key],
              f"plan counter {key} differs: cuda {gpu['plans'][key]} cpu {cpu['plans'][key]}")


def print_latencies(label: str, gpu: dict, cpu: dict) -> None:
    print(f"{label}: offline calibration {gpu['offline_s'] * 1e3:.1f} ms on cuda "
          f"({cpu['offline_s'] * 1e3:.1f} ms on the CPU); think-time "
          f"{gpu['think_s'] * 1e3:.1f} ms", flush=True)
    for name, s in gpu["latency_s"].items():
        print(f"{label}: {name:20s} {s * 1e3:8.3f} ms on cuda  "
              f"({cpu['latency_s'][name] * 1e3:.3f} ms on the CPU)", flush=True)


def profile_phase(torch, label: str, run, report: dict) -> None:
    """One more run on the card under ``torch.profiler``: device time by
    kernel (and copy) and the device's busy share of the run's wall time
    (the profiler slows the host, so the share is a lower bound)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
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
    # the 20 longest, and every launch of the port's own kernels
    kept = rows[:20] + [r for r in rows[20:] if any(k in r["name"] for k in KERNEL_SOURCES)]
    report.setdefault("profile", {})[label] = dict(wall_ms=wall_ms, device_busy_ms=busy_us / 1e3,
                                                   top=kept)
    if not rows:
        print(f"profile {label}: the trace holds no device time (busy share not measured)",
              flush=True)
        return
    print(f"profile {label}: {wall_ms:.1f} ms wall under the profiler, device busy "
          f"{busy_us / 1e3:.1f} ms ({100 * busy_us / 1e3 / wall_ms:.1f}%)", flush=True)
    for r in rows[:10]:
        print(f"profile {label}:   {r['device_ms']:8.3f} ms  {r['calls']:5d} calls  "
              f"{r['name'][:90]}", flush=True)


# ---------------------------------------------------------------------------
# phase 5: the same sequence with every dimension bag dense
# ---------------------------------------------------------------------------

def dense_phase(torch, np, K, rt, sliced: dict, report: dict) -> dict:
    cat = sliced["cat"]
    dims = {n: cat.get(n).num_rows for n in cat.names() if n != "Opp"}
    check(max(dims.values()) <= DENSE_ROWS < cat.get("Opp").num_rows,
          f"dense phase needs every dimension table dense and Opp sparse: {dims}")
    captured: dict = {}
    shapes: list = []
    with recording_contracts(K, captured, shapes):
        quickstart(torch, rt, cat, "cuda", dense_rows_threshold=DENSE_ROWS)
    reset_launches(K)
    gpu = quickstart(torch, rt, cat, "cuda", dense_rows_threshold=DENSE_ROWS)
    launches = read_launches(K)
    print(f"dense: launches on the dense path {launches}", flush=True)
    for name in CONTRACT:
        check(launches[name] > 0, f"{name} never launched on the dense path")
    t0 = time.perf_counter()
    cpu = quickstart(torch, rt, cat, "cpu", dense_rows_threshold=DENSE_ROWS)
    cpu_s = time.perf_counter() - t0
    check(gpu["counts"] == cpu["counts"],
          f"dense message counts differ: cuda {gpu['counts']} cpu {cpu['counts']}")
    check_plan_counters(gpu, cpu)
    for name, sparse in sliced["answers"].items():
        g, c = gpu["answers"][name], cpu["answers"][name]
        check(bool(torch.isfinite(g).all()), f"dense {name}: non-finite answer on cuda")
        if name == "max_by_stage":
            check(torch.equal(g, sparse) and torch.equal(g, c), f"dense {name}: MAX differs")
        else:
            torch.testing.assert_close(g, sparse, rtol=1e-5, atol=0)
            torch.testing.assert_close(g, c, rtol=1e-5, atol=0)
    print_latencies("dense", gpu, cpu)
    print(f"dense: answers equal the sparse slice and the CPU run; counts equal "
          f"{gpu['counts']}; CPU run took {cpu_s:.1f} s", flush=True)
    t = gpu["treant"]
    project = project_times(np, t)
    for shape, ms in project.items():
        print(f"dense: User factor project_to to {shape}: {ms['view']:.4f} ms as the plan "
              f"hands it over (a strided view: {ms['is_view']}), {ms['contiguous']:.4f} ms with "
              f".contiguous()", flush=True)
    report["dense"] = dict(
        dense_rows_threshold=DENSE_ROWS, dims=dims, launches=launches, counts=gpu["counts"],
        offline_ms=gpu["offline_s"] * 1e3, think_ms=gpu["think_s"] * 1e3,
        latency_ms={k: v * 1e3 for k, v in gpu["latency_s"].items()},
        cpu_offline_ms=cpu["offline_s"] * 1e3,
        cpu_latency_ms={k: v * 1e3 for k, v in cpu["latency_s"].items()},
        plans=gpu["plans"], launch_shapes=shapes, project_to_ms=project,
    )
    profile_phase(torch, "dense", lambda: quickstart(
        torch, rt, cat, "cuda", dense_rows_threshold=DENSE_ROWS), report)
    return dict(captured=captured, launches=launches, treant=t)


def project_times(np, t) -> dict:
    """Time the plain-torch ``project_to`` that reshapes the dense User
    factor into the contract kernel's M before each launch: as the plan
    does it now (a view where reshape allows) and with the ``.contiguous()``
    copy the plan made before the kernels took strided M."""
    user = t.catalog.get("User")
    f = t.engine.plans._factors.get(("base", user.key, "sum", None))
    check(f is not None, "the dense User factor is not in the plan cache")
    d = f.domains
    out = {}
    for keep in (("role_id", "user_id"), ("role_id", "title", "user_id"),
                 ("user_id", "role_id"), ("user_id", "title", "role_id")):
        rows = int(np.prod([d[a] for a in keep[:-1]]))
        view = lambda: f.project_to(keep).field.reshape(rows, d[keep[-1]])  # noqa: E731
        out["x".join(keep)] = {"view": time_ms(view, 5, 3),
                               "contiguous": time_ms(lambda: view().contiguous(), 5, 3),
                               "is_view": not view().is_contiguous()}
    return out


# ---------------------------------------------------------------------------
# phase 6: Fig 21, the empty-bag shortcut view on tpcds_star
# ---------------------------------------------------------------------------

def fig21_phase(torch, np, K, rt2, schema, report: dict) -> dict:
    """Returns the contract-kernel inputs captured in the warm-up runs."""
    CJTEngine, Query, sr, insert_empty_bag, jt_from_catalog = rt2
    t0 = time.perf_counter()
    cat = schema.tpcds_star(n_sales=10_000_000)
    fact = cat.get("Store_Sales")
    print(f"fig21: tpcds_star with {fact.num_rows} sales (row bucket {fact.row_bucket}) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    jt = jt_from_catalog(cat)
    jt2 = insert_empty_bag(jt, "TimeStores", ("store_key", "time_key"), host="bag:Store_Sales",
                           reroute=["bag:Stores", "bag:Time"])
    sk, tk = fact.codes["store_key"], fact.codes["time_key"]
    n_s, n_t = cat.domains()["store_key"], cat.domains()["time_key"]
    flat = sk.astype(np.int64) * n_t + tk
    mx = np.full(n_s * n_t, -np.inf, np.float32)
    np.maximum.at(mx, flat, fact.measures["sales_price"])
    want = {"count": np.bincount(flat, minlength=n_s * n_t).reshape(n_s, n_t).astype(np.float32),
            "tropical_max": mx.reshape(n_s, n_t)}
    measure = {"count": None, "tropical_max": ("Store_Sales", "sales_price")}
    captured: dict = {}
    shapes: list = []
    out = {}
    for ring in ("count", "tropical_max"):
        q = Query.make(cat, ring=ring, measure=measure[ring])
        qg = q.with_group_by("store_key", "time_key")
        res = {}
        for label, tree in (("without", jt), ("with", jt2)):
            with recording_contracts(K, captured, shapes):  # warm-up
                e = CJTEngine(tree, cat, sr.get(ring), device="cuda")
                e.calibrate(q)
                e.execute(qg)
            reset_launches(K)
            e = CJTEngine(tree, cat, sr.get(ring), device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e.calibrate(q)
            torch.cuda.synchronize()
            build_ms = (time.perf_counter() - t0) * 1e3
            e.execute(qg)  # first run after calibration, then the timed one
            t0 = time.perf_counter()
            f, st = e.execute(qg)
            query_ms = (time.perf_counter() - t0) * 1e3
            res[label] = (f.field.cpu(), build_ms, query_ms, read_launches(K),
                          st.messages_computed)
        (f0, b0, q0, l0, _), (f1, b1, q1, l1, c1) = res["without"], res["with"]
        check(torch.equal(f0, f1), f"fig21 {ring}: answers with and without the empty bag differ")
        check(np.array_equal(f1.numpy(), want[ring]), f"fig21 {ring}: differs from numpy")
        kernel = "semiring_contract" if ring == "count" else "tropical_contract"
        check(l1[kernel] > 0, f"fig21 {ring}: {kernel} never launched with the empty bag")
        out[ring] = dict(build_ms_without=b0, build_ms_with=b1, query_ms_without=q0,
                         query_ms_with=q1, launches_without=l0, launches_with=l1,
                         computed_with=c1)
        print(f"fig21 {ring}: calibrate {b0:.1f} ms without the empty bag, {b1:.1f} ms with; "
              f"(store_key, time_key) query {q0:.3f} ms without, {q1:.3f} ms with; "
              f"launches with the bag {l1}", flush=True)
    print("fig21: answers equal with and without the bag and the numpy brute force", flush=True)
    report["fig21"] = dict(n_sales=fact.num_rows, rings=out, launch_shapes=shapes)
    return captured


# ---------------------------------------------------------------------------
# phase 7: R̄ on the dense Treant
# ---------------------------------------------------------------------------

def rbar_phase(torch, np, Query, t, report: dict) -> None:
    cat = t.catalog
    q = Query.make(cat, ring="sum", measure=("Opp", "amount"), group_by=("camp_type",),
                   removed=("Acc",))
    r = t.interact("anna", "pipeline_by_campaign", q)
    opp, camp = cat.get("Opp"), cat.get("Camp")
    ctype = camp.codes["camp_type"][opp.codes["camp_id"]]
    want = np.bincount(ctype, opp.measures["amount"].astype(np.float64), 8)
    got = r.factor.field.cpu()
    check(bool(torch.isfinite(got).all()), "R̄: non-finite answer")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    print(f"rbar: removed=('Acc',) on the dense Treant equals the numpy brute force; "
          f"{r.latency_s * 1e3:.3f} ms, {r.stats.messages_computed} messages computed",
          flush=True)
    report["rbar"] = dict(latency_ms=r.latency_s * 1e3, computed=r.stats.messages_computed)


# ---------------------------------------------------------------------------
# phase 8: the contract kernels at every shape the dense paths launched
# ---------------------------------------------------------------------------

def path_m_layouts(K, launches: list, key: tuple) -> list[dict]:
    """How the main paths handed M over at one (kernel, shape, dtype, op):
    each distinct stride pair, the axis it is read along (B: contiguous
    along B, as a row-major M; G: contiguous along G, as a transposed view)
    and how many launches took it."""
    seen: dict = {}
    for *k, m_strides, _ in launches:
        if tuple(k) == key:
            seen[m_strides] = seen.get(m_strides, 0) + 1
    along_b = {st: K.launch.unit_strides(key[1:3], st)[1] == 1 for st in seen}
    return [{"strides": list(st), "read_along": "B" if along_b[st] else "G", "launches": n}
            for st, n in sorted(seen.items())]


def contract_shapes_phase(torch, K, captured: dict, report: dict) -> list[dict]:
    launches = report["dense"]["launch_shapes"] + report["fig21"]["launch_shapes"]
    rows = []
    for key, (m, r, op, mask) in sorted(captured.items(), key=lambda kv: str(kv[0])):
        row = contract_row(torch, K, key[0], m, r, op, mask, exact=key[0] == "tropical_contract")
        row["path_m_layouts"] = path_m_layouts(K, launches, key)
        rows.append(row)
    print_contract_rows(rows)
    report["contract_shapes"] = rows
    return rows


# ---------------------------------------------------------------------------
# phase 9: one record per kernel
# ---------------------------------------------------------------------------

def kernel_records(torch, K, sliced: dict, contract_rows: list[dict],
                   dense: dict) -> list[dict]:
    """Time each kernel on the inputs of its largest main-path launch."""
    ops, ref = K.seg_ops, K.seg_ref
    wrappers = {"segment_aggregate": (ops.aggregate_op, ref.segment_aggregate_ref),
                "level_segment_aggregate": (ops.level_segment_aggregate,
                                            ref.level_segment_aggregate_ref)}
    records = []
    for name in SEGMENT:
        source, replaces = KERNEL_SOURCES[name]
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
            "device_ms": device_ms(run, (codes, values, g, op)),
            "plain_ms": time_ms(lambda: plain(codes, values, g, op), 3, 3),
            "bound_ms": bound_ms(n, v, g), "bound_by": "bytes",
            "library_ms": time_ms(library_call(codes, values, g, op)),
            "shape": {"n": n, "v": v, "g": g, "op": op},
        })
    for name in CONTRACT:
        source, replaces = KERNEL_SOURCES[name]
        mine = [r for r in contract_rows if r["kernel"] == name and
                any(k[0] == name and k[1:4] == (r["g"], r["b"], r["a"])
                    for k in dense["captured"])]
        check(bool(mine), f"{name}: no dense-path launch to time")
        top = max(mine, key=lambda r: (r["g"] * r["b"] + r["b"] * r["a"], r["op"]))
        records.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": dense["launches"][name], "max_abs_err": top["max_abs_err"],
            "ms": top["ms"], "device_ms": top["device_ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": top["library_ms"],
            "shape": {"g": top["g"], "b": top["b"], "a": top["a"], "op": top["op"],
                      "m_strides": top["m_strides"], "regime": top["regime"],
                      "path_m_layouts": top["path_m_layouts"]},
        })
    return records


# ---------------------------------------------------------------------------
# phase 10: live dashboards — a declarative session, streamed ticks, updates
# ---------------------------------------------------------------------------

LIVE_CPU_SCALE = 5                 # the CPU comparison's catalog: x5 (1M opportunities)
# tombstone-fraction base that the third tick crosses: each tick appends 2 %
# of the fact and tombstones 0.1 % of the live rows, so the fraction reads
# about 0.0010, 0.0019, 0.0028 after ticks 1-3, and the learned per-relation
# threshold is base x (1.5 - the delete mix, about 0.048) = 0.0023
LIVE_COMPACTION = 0.0016
LIVE_TICKS = 4


def live_catalog(schema, scale: int):
    return schema.salesforce(n_opp=200_000 * scale, n_user=2_000 * scale,
                             n_camp=500 * scale, n_acc=1_000 * scale)


def live_spec(L):
    amount = ("Opp", "amount")
    return L.DashboardSpec(vizzes=tuple(
        L.VizSpec(f"by_{g}", measure=amount, ring="sum", group_by=(g,))
        for g in ("stage", "state", "camp_type", "title")
    ) + (L.VizSpec("max_by_stage", measure=amount, ring="tropical_max", group_by=("stage",)),))


def live_events(L) -> list:
    return [
        ("filter_state", L.SetFilter("state", values=(0, 1, 2, 3, 4), source="by_state")),
        ("filter_camp_type", L.SetFilter("camp_type", lo=0, hi=4, source="by_camp_type")),
        ("drill_role_name", L.Drill("by_stage", "role_name")),
        ("swap_title_to_min", L.SwapMeasure("by_title", "Opp", "amount", ring="tropical_min")),
        ("toggle_camp", L.ToggleRelation("Camp")),
        ("undo", L.Undo()),
        ("clear_state", L.ClearFilter("state")),
    ]


def _random_rows(np, rng, rel, n: int) -> tuple[dict, dict]:
    codes = {a: rng.integers(0, rel.domains[a], n).astype(np.int32) for a in rel.attrs}
    meas = {m: rng.gamma(2.0, 5_000.0, n).astype(np.float32) for m in rel.measures}
    return codes, meas


def _opp_tick(np, rng, buf, n_append: int) -> None:
    """One tick shaped like ``benchmarks/bench_ingest.py``'s queue tick: four
    append micro-batches, then one delete micro-batch that tombstones 0.1 % of
    the live rows and cancels two of the tick's fresh appends."""
    for _ in range(4):
        codes, meas = _random_rows(np, rng, buf.base, n_append)
        buf.append(codes, measures=meas)
    base = buf.base
    live = np.flatnonzero(base._materialized_weights() != 0.0)
    mask = np.zeros(base.num_rows + buf.pending_appends, bool)
    mask[rng.choice(live, len(live) // 1000, replace=False)] = True
    mask[base.num_rows + rng.choice(buf.pending_appends, 2, replace=False)] = True
    buf.delete(mask)


def _reads(sess, vizzes=None) -> tuple[dict, dict, dict]:
    """Read every viz: answers (on the host), (computed, reused) counts and
    the queries read."""
    answers, counts, queries = {}, {}, {}
    for viz in vizzes or sess.vizzes:
        r = sess.read(viz)
        answers[viz] = r.factor.field.cpu()
        counts[viz] = (r.stats.messages_computed, r.stats.messages_reused)
        queries[viz] = sess.query_of(viz)
    return answers, counts, queries


def _update_summary(*ups) -> dict:
    """Messages maintained, delta messages and fallbacks of ``UpdateResult``s,
    with every ``DeltaStats`` (comparable across devices)."""
    return dict(
        maintained=sum(st.edges_maintained for u in ups for st in u.stats),
        delta_messages=sum(st.delta_messages for u in ups for st in u.stats),
        fallbacks=sum(u.queries_fallback for u in ups),
        updates=[(u.relation, u.queries_maintained, u.queries_fallback,
                  [dataclasses.asdict(st) for st in u.stats]) for u in ups],
    )


def _flush_summary(res) -> dict:
    return dict(_update_summary(*res.updates, *res.compactions), watermark=res.watermark,
                compactions=len(res.compactions))


def live_drive(torch, np, K, L, cat, device: str) -> dict:
    """The live-dashboard main path on one device: a declarative session
    (five linked vizzes, seven events, think-time between them), four
    streamed ticks on Opp with two User updates between ticks 2 and 3 (one
    compaction at tick 3), then a dense Treant taking a Role update and one
    Opp tick.  Returns every step's answers, counts and times, and the
    launch counts of the session and ingest parts (counted from 0)."""
    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def mem() -> dict:
        if not cuda:
            return {}
        return {"allocated_mb": torch.cuda.memory_allocated() / 2**20,
                "max_allocated_mb": torch.cuda.max_memory_allocated() / 2**20}

    def batched(t) -> int:
        return t.cache_stats()["plans"]["batched_execs"]

    rng = np.random.default_rng(14)
    n_append = cat.get("Opp").num_rows // 200
    steps = []
    reset_launches(K)
    t = L.Treant(cat, ring=L.sr.SUM, device=device, compaction_threshold=LIVE_COMPACTION)
    t0 = time.perf_counter()
    sess = t.open_session(live_spec(L), name="live")
    sync()
    open_ms = (time.perf_counter() - t0) * 1e3
    for label, event in live_events(L):
        before, b0 = read_launches(K), batched(t)
        res = sess.apply(event)
        after = read_launches(K)
        # group widths from the members' ExecStats: w members report width w
        members: dict[int, int] = {}
        for r in res.results.values():
            if r.stats.batched_absorptions:
                members[r.stats.batch_width] = members.get(r.stats.batch_width, 0) + 1
        widths = sorted(w for w, n in members.items() for _ in range(n // w))
        t0 = time.perf_counter()
        edges = sess.idle()
        sync()
        steps.append(dict(
            phase="session", label=label, fanout_ms=res.latency_s * 1e3,
            vizzes=len(res.affected), group_widths=widths, batched_execs=batched(t) - b0,
            level_launches=after["level_segment_aggregate"] - before["level_segment_aggregate"],
            launches={k: after[k] - before[k] for k in after},
            idle_ms=(time.perf_counter() - t0) * 1e3, idle_edges=edges,
            answers={v: r.factor.field.cpu() for v, r in res.results.items()},
            counts={v: (r.stats.messages_computed, r.stats.messages_reused)
                    for v, r in res.results.items()},
            queries={v: res.queries[v] for v in res.affected}, dense_rows_threshold=0,
        ))
    session_launches = read_launches(K)
    wm0 = t.catalog.watermark
    user_updates = 0
    for tick in range(1, LIVE_TICKS + 1):
        if tick == 3:  # between ticks 2 and 3: a User append, then a User delete
            user = cat.get("User")
            codes, _ = _random_rows(np, rng, user, 1_000)
            appended, d_app = user.append_rows(codes)
            gone = np.zeros(appended.num_rows, bool)
            gone[rng.choice(user.num_rows, 500, replace=False)] = True
            deleted, d_del = appended.delete_rows(gone)
            for label, rel, delta in (("user_append", appended, d_app),
                                      ("user_delete", deleted, d_del)):
                before = read_launches(K)
                t0 = time.perf_counter()
                res = t.update(rel, delta)
                sync()
                ms = (time.perf_counter() - t0) * 1e3
                after = read_launches(K)
                answers, counts, queries = _reads(sess)
                user_updates += 1
                steps.append(dict(
                    phase="ingest", label=label, update_ms=ms, memory=mem(),
                    launches={k: after[k] - before[k] for k in after},
                    summary=_update_summary(res), answers=answers, counts=counts,
                    queries=queries, dense_rows_threshold=0,
                ))
        buf = t.stream("Opp")
        _opp_tick(np, rng, buf, n_append)
        before = read_launches(K)
        t0 = time.perf_counter()
        res = t.flush()
        sync()
        flush_ms = (time.perf_counter() - t0) * 1e3
        after = read_launches(K)
        answers, counts, queries = _reads(sess)
        t1 = time.perf_counter()
        edges = sess.idle()
        sync()
        steps.append(dict(
            phase="ingest", label=f"tick_{tick}", flush_ms=flush_ms, memory=mem(),
            opp_rows=t.catalog.get("Opp").num_rows,
            tombstones=t.catalog.get("Opp").tombstone_count,
            launches={k: after[k] - before[k] for k in after}, summary=_flush_summary(res),
            idle_ms=(time.perf_counter() - t1) * 1e3, idle_edges=edges,
            answers=answers, counts=counts, queries=queries, dense_rows_threshold=0,
        ))
    ingest = dataclasses.asdict(t.ingest)
    ingest["watermarks"] = t.catalog.watermark - wm0
    ingest["user_updates"] = user_updates
    sess.close()
    del t, sess
    # the dense Treant on the committed catalog: every dimension bag dense
    td = L.Treant(cat, ring=L.sr.SUM, device=device, dense_rows_threshold=DENSE_ROWS,
                  compaction_threshold=0.0)
    t0 = time.perf_counter()
    dsess = td.open_session(live_spec(L), name="dense")
    sync()
    dense_open_ms = (time.perf_counter() - t0) * 1e3
    role = cat.get("Role")
    codes, _ = _random_rows(np, rng, role, 4)
    new_rel, delta = role.append_rows(codes)
    before = read_launches(K)
    t0 = time.perf_counter()
    res = td.update(new_rel, delta)
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    after = read_launches(K)
    answers, counts, queries = _reads(dsess)
    steps.append(dict(
        phase="dense", label="role_append", update_ms=ms, memory=mem(),
        launches={k: after[k] - before[k] for k in after}, summary=_update_summary(res),
        answers=answers, counts=counts, queries=queries, dense_rows_threshold=DENSE_ROWS,
    ))
    buf = td.stream("Opp")
    codes, meas = _random_rows(np, rng, buf.base, n_append)
    buf.append(codes, measures=meas)
    before = read_launches(K)
    t0 = time.perf_counter()
    res = td.flush()
    sync()
    flush_ms = (time.perf_counter() - t0) * 1e3
    after = read_launches(K)
    answers, counts, queries = _reads(dsess)
    steps.append(dict(
        phase="dense", label="opp_tick", flush_ms=flush_ms, memory=mem(),
        launches={k: after[k] - before[k] for k in after}, summary=_flush_summary(res),
        answers=answers, counts=counts, queries=queries, dense_rows_threshold=DENSE_ROWS,
    ))
    dsess.close()
    total = read_launches(K)
    return dict(
        steps=steps, open_ms=open_ms, dense_open_ms=dense_open_ms, ingest=ingest,
        launches_session=session_launches,
        launches_ingest={k: total[k] - session_launches[k] for k in total},
    )


@contextlib.contextmanager
def timing_methods(torch, targets: list, totals: dict):
    """Add each wrapped method's synced wall time to ``totals[label]`` while
    the block runs (``targets``: (label, class, method name))."""
    saved = []
    for label, cls, name in targets:
        real = getattr(cls, name)

        def timed(*a, _real=real, _label=label, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _real(*a, **kw)
            torch.cuda.synchronize()
            totals[_label] = totals.get(_label, 0.0) + (time.perf_counter() - t0) * 1e3
            return out

        saved.append((cls, name, real))
        setattr(cls, name, timed)
    try:
        yield
    finally:
        for cls, name, real in saved:
            setattr(cls, name, real)


def live_profile(torch, np, L, cat, report: dict) -> None:
    """Where the live phases' time goes: the session (open, seven events with
    think-time) and one flush tick under ``torch.profiler``, then one more
    tick with its host time split into coalescing, delta maintenance
    (``apply_delta``), the prewarm (``execute``) and the rest (commit,
    re-snapshot, scheduling)."""
    rng = np.random.default_rng(41)
    t = L.Treant(cat, ring=L.sr.SUM, device="cuda", compaction_threshold=0.0)
    sess = t.open_session(live_spec(L), name="warm")  # uploads and plan builds
    sess.close()

    def run():
        s = t.open_session(live_spec(L), name="profiled")
        for _, event in live_events(L):
            s.apply(event)
            s.idle()
        _opp_tick(np, rng, t.stream("Opp"), cat.get("Opp").num_rows // 200)
        t.flush()
        return s

    profile_phase(torch, "live", run, report)
    _opp_tick(np, rng, t.stream("Opp"), cat.get("Opp").num_rows // 200)
    split: dict = {}
    targets = [("coalesce", L.StreamBuffer, "coalesce"), ("apply_delta", L.CJTEngine,
                                                           "apply_delta"),
               ("prewarm_execute", L.CJTEngine, "execute")]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with timing_methods(torch, targets, split):
        t.flush()
    torch.cuda.synchronize()
    split["flush"] = (time.perf_counter() - t0) * 1e3
    split["rest"] = split["flush"] - sum(v for k, v in split.items() if k != "flush")
    report["live"]["tick_split_ms"] = split
    print("live: one more tick, host time split (synced): " + ", ".join(
        f"{k} {v:.1f} ms" for k, v in split.items()), flush=True)


def live_cold_checks(torch, L, cat, record: dict, device: str) -> int:
    """Hold every rendered or read viz against a cold engine (fresh message
    store) over the versions its query snapshots: rtol 1e-5 for sums, exact
    for MIN/MAX.  Returns the number of answers checked."""
    jt = L.jt_from_catalog(cat)
    caches: dict = {}
    n = 0
    for step in record["steps"]:
        thr = step["dense_rows_threshold"]
        for viz, q in step["queries"].items():
            key = (q.ring_name, thr)
            if key not in caches:
                caches[key] = L.PlanCache(L.sr.get(q.ring_name), device)
            eng = L.CJTEngine(jt, cat, L.sr.get(q.ring_name), store=L.MessageStore(),
                              dense_rows_threshold=thr, plan_cache=caches[key], device=device)
            want = eng.execute(q)[0].field.cpu()
            got = step["answers"][viz]
            what = f"{step['phase']} {step['label']} {viz}"
            check(bool(torch.isfinite(got).all()) or q.ring_name != "sum",
                  f"{what}: non-finite answer")
            if q.ring_name.startswith("tropical"):
                check(torch.equal(got, want), f"{what}: differs from a cold rebuild")
            else:
                torch.testing.assert_close(got, want, rtol=1e-5, atol=0,
                                           msg=f"{what}: differs from a cold rebuild")
            n += 1
    return n


def live_compare(torch, a: dict, b: dict, what: str) -> None:
    """Two drives of one sequence (cuda and the CPU): equal counts, flush and
    update summaries, and answers (rtol 1e-5 for sums, exact for MIN/MAX)."""
    check(len(a["steps"]) == len(b["steps"]), f"{what}: step lists differ")
    check(a["ingest"] == b["ingest"], f"{what}: ingest counters {a['ingest']} != {b['ingest']}")
    for x, y in zip(a["steps"], b["steps"]):
        label = f"{what} {x['phase']} {x['label']}"
        check(x["counts"] == y["counts"], f"{label}: counts {x['counts']} != {y['counts']}")
        check(x.get("summary") == y.get("summary"), f"{label}: summaries differ")
        for viz, g in x["answers"].items():
            c = y["answers"][viz]
            if x["queries"][viz].ring_name.startswith("tropical"):
                check(torch.equal(g, c), f"{label} {viz}: MIN/MAX differs")
            else:
                torch.testing.assert_close(g, c, rtol=1e-5, atol=0, msg=f"{label} {viz}")


def live_phase(torch, np, K, L, schema, report: dict) -> dict:
    """Phases 10-11 (session, ingest) at full size on the card, held against
    cold rebuilds on the card and the same sequence on the CPU."""
    t0 = time.perf_counter()
    cat = live_catalog(schema, SCALE)
    print(f"live: catalog of {cat.get('Opp').num_rows} opportunities in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_mb = torch.cuda.memory_allocated() / 2**20
    rec = live_drive(torch, np, K, L, cat, "cuda")
    print(f"live: open_session {rec['open_ms']:.1f} ms (5 vizzes, union-carry calibration); "
          f"device memory before the phase {base_mb:.1f} MiB", flush=True)
    for st in rec["steps"]:
        if st["phase"] == "session":
            print(f"session: {st['label']:18s} fan-out {st['fanout_ms']:8.3f} ms, "
                  f"{st['vizzes']} vizzes, batch groups {st['group_widths']}, "
                  f"level_segment_aggregate launches {st['level_launches']}, "
                  f"batched_execs {st['batched_execs']}; idle {st['idle_ms']:.1f} ms "
                  f"({st['idle_edges']} edges)", flush=True)
            check(st["level_launches"] == len(st["group_widths"]) == st["batched_execs"],
                  f"session {st['label']}: {st['level_launches']} level launches for "
                  f"{len(st['group_widths'])} batch groups")
    check(any(w >= 2 for st in rec["steps"] if st["phase"] == "session"
              for w in st["group_widths"]), "no batch group of width >= 2 ran on the card")
    for st in rec["steps"]:
        if st["phase"] == "session":
            continue
        s, m = st["summary"], st["memory"]
        ms = st.get("flush_ms", st.get("update_ms"))
        print(f"{st['phase']}: {st['label']:12s} {ms:9.3f} ms, messages maintained "
              f"{s['maintained']}, delta messages {s['delta_messages']}, fallbacks "
              f"{s['fallbacks']}, launches {st['launches']}, memory_allocated "
              f"{m['allocated_mb']:.1f} MiB, max_memory_allocated {m['max_allocated_mb']:.1f} MiB",
              flush=True)
        if st["label"].startswith("tick") or st["label"] == "opp_tick":
            check(st["launches"]["segment_aggregate"] > 0,
                  f"{st['label']}: segment_aggregate never launched")
    ticks = [st for st in rec["steps"] if st["label"].startswith("tick")]
    compacted = [st["label"] for st in ticks if st["summary"]["compactions"]]
    check(compacted == ["tick_3"], f"compaction at {compacted}, expected tick_3 only")
    ing = rec["ingest"]
    apart = ing["compactions"] + ing["user_updates"]
    check(ing["version_bumps"] - apart == ing["delta_sweeps"] - apart == ing["ticks"]
          == LIVE_TICKS, f"ingest counters {ing}")
    (role,) = [st for st in rec["steps"] if st["label"] == "role_append"]
    check(role["launches"]["semiring_contract"] > 0,
          f"the dense Role update launched no semiring_contract: {role['launches']}")
    t0 = time.perf_counter()
    n = live_cold_checks(torch, L, cat, rec, "cuda")
    print(f"live: {n} answers equal cold rebuilds on the card "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    small = live_catalog(schema, LIVE_CPU_SCALE)
    n_small = small.get("Opp").num_rows
    cpu = live_drive(torch, np, K, L, small, "cpu")
    cpu_s = time.perf_counter() - t0
    gpu_small = live_drive(torch, np, K, L, live_catalog(schema, LIVE_CPU_SCALE), "cuda")
    live_compare(torch, gpu_small, cpu, f"x{LIVE_CPU_SCALE}")
    print(f"live: the sequence at x{LIVE_CPU_SCALE} ({n_small} opportunities at the start) "
          f"gives the same counts and answers on cuda and on the CPU (CPU run {cpu_s:.1f} s)",
          flush=True)
    print(f"live: launches, session phase {rec['launches_session']}; ingest phase "
          f"{rec['launches_ingest']}", flush=True)

    def strip(step):
        return {k: v for k, v in step.items() if k not in ("answers", "queries")}

    report["live"] = dict(
        n_opp=200_000 * SCALE, open_ms=rec["open_ms"], dense_open_ms=rec["dense_open_ms"],
        ingest=ing, launches_session=rec["launches_session"],
        launches_ingest=rec["launches_ingest"], base_memory_mb=base_mb,
        steps=[strip(st) for st in rec["steps"]], cold_checked=n,
        cpu_scale=LIVE_CPU_SCALE, cpu_s=cpu_s,
    )
    live_profile(torch, np, L, cat, report)
    return rec


# ---------------------------------------------------------------------------
# phase 12: exploration with think-time (bin cubes against σ prefetch)
# ---------------------------------------------------------------------------

# one year of US domestic flights at the size of BTS's On-Time Performance
# table (about 7.4M flights in 2019), with the generator's own 400 airports,
# 30 carriers and 365 dates: the Flights row bucket is 2^23
EXPLORE_FLIGHTS = 7_400_000
EXPLORE_CPU_FLIGHTS = 300_000
# (brush dimension, source viz), as benchmarks/bench_explore.py drives them
BRUSH_DIMS = (("carrier_group", "by_carrier"), ("delay_bucket", "by_delay"),
              ("month", "by_month"))
EXPLORE_ROUNDS = 2                 # timed passes per leg, after one warm pass


def explore_spec(L):
    """``benchmarks/bench_explore.py``'s spec: 8 vizzes, SUM of dep_delay."""
    m = ("Flights", "dep_delay")
    V = L.VizSpec
    return L.DashboardSpec(vizzes=(
        V("by_state", measure=m, ring="sum", group_by=("airport_state",)),
        V("by_size", measure=m, ring="sum", group_by=("airport_size",)),
        V("by_carrier", measure=m, ring="sum", group_by=("carrier_group",)),
        V("by_delay", measure=m, ring="sum", group_by=("delay_bucket",)),
        V("by_month", measure=m, ring="sum", group_by=("month",)),
        V("by_dow", measure=m, ring="sum", group_by=("dow",)),
        V("state_by_size", measure=m, ring="sum", group_by=("airport_state", "airport_size")),
        V("carrier_by_month", measure=m, ring="sum", group_by=("carrier_group", "month")),
    ))


def explore_context(L) -> list:
    """The held analysis context: two standing filters on other dimensions."""
    return [L.SetFilter("airport_size", values=(1, 2), source="by_size"),
            L.SetFilter("dow", lo=0, hi=4, source="by_dow")]


def explore_events(L, doms) -> list:
    """Per brush dimension: the anchor IN (0, 1), then the timed events — a
    3-value jump to the top of the domain and the backtrack to unfiltered."""
    out = []
    for dim, src in BRUSH_DIMS:
        d = doms[dim]
        out.append((L.SetFilter(dim, values=(0, 1), source=src),
                    [L.SetFilter(dim, values=(d - 3, d - 2, d - 1), source=src),
                     L.ClearFilter(dim)]))
    return out


def _store_probes(t) -> int:
    return t.store.hits + t.store.misses + t.store.widen_hits


def _plan_execs(t) -> int:
    p = t.cache_stats()["plans"]
    return p["plans_built"] + p["plan_hits"]


@contextlib.contextmanager
def cube_build_probe(torch, L, builds: list, cuda: bool):
    """While the block runs, record every bin-cube build: viz, dim, time
    (synced), peak device memory during the build and the widest rowwise
    field its sparse contractions took (rows × carried lanes, from the
    calls themselves)."""
    real_build, real_run = L.Session._build_bin_cube, L.PlanCache.run_sparse
    widest = [0]

    def run_sparse(self, catalog, rel, vals, incoming, preds, out_attrs, stats=None):
        rel_set = set(rel.attrs)
        doms = {a: d for m in incoming for a, d in m.domains.items() if a not in rel_set}
        lanes = 1
        for d in doms.values():
            lanes *= d
        widest[0] = max(widest[0], rel.row_bucket * lanes)
        return real_run(self, catalog, rel, vals, incoming, preds, out_attrs, stats)

    def build(self, viz, dim):
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() if cuda else 0
        before = self.bin_cube_bytes
        widest[0] = 0
        t0 = time.perf_counter()
        ok = real_build(self, viz, dim)
        if cuda:
            torch.cuda.synchronize()
        if ok:
            builds.append(dict(
                viz=viz, dim=dim, ms=(time.perf_counter() - t0) * 1e3,
                cube_bytes=self.bin_cube_bytes - before, widest_rowwise_elems=widest[0],
                peak_mb=torch.cuda.max_memory_allocated() / 2**20 if cuda else None,
                base_mb=base / 2**20 if cuda else None,
            ))
        return ok

    L.Session._build_bin_cube, L.PlanCache.run_sparse = build, run_sparse
    try:
        yield
    finally:
        L.Session._build_bin_cube, L.PlanCache.run_sparse = real_build, real_run


AUDIT_BLOCK_ELEMS = 1 << 27        # plain-version columns per call: 1 GiB of float64 sums
AUDIT_RTOL = 1e-5                  # the least relative tolerance of a float sum
AUDIT_LAMBDA = 4.0                 # ... and of a segment of n rows: λ·√n·2^-24


def hold_plain(torch, ref, codes, values, g: int, op: str, got, exact: bool,
               what: str) -> tuple[float, float, int]:
    """One segment reduction's output against ``ref.segment_aggregate_ref`` on
    the same tensors, a block of columns at a time.  Bit for bit when
    ``exact``; else each cell of a segment of n rows to a relative
    max(``AUDIT_RTOL``, λ·√n·u), u = 2^-24: float32 atomics add n
    non-negative terms in any order, and the float64 plain sum stands for
    the exact one; λ·√n·u is the probabilistic bound of such a sum's
    rounding error (Higham and Mary, 2019), λ = ``AUDIT_LAMBDA``.  Returns
    the largest absolute and relative differences and the rows of the
    segment with the largest relative one."""
    if values.dim() == 1:
        values, got = values[:, None], got[:, None]
    step = max(1, AUDIT_BLOCK_ELEMS // max(values.shape[0], 1))
    rows = torch.bincount(codes[(codes >= 0) & (codes < g)].long(), minlength=g)
    tol = (AUDIT_LAMBDA * rows.double().sqrt() * 2.0 ** -24).clamp_min(AUDIT_RTOL)[:, None]
    err, rel, at = 0.0, 0.0, 0
    for j in range(0, values.shape[1], step):
        part, want = got[:, j:j + step], ref.segment_aggregate_ref(
            codes, values[:, j:j + step], g, op)
        if exact:
            check(torch.equal(part, want), f"{what} disagrees with its plain version")
        r = torch.where(part == want, 0.0, (part - want).abs().double() / want.abs())
        bad = r > tol
        if bool(bad.any()):
            k = int(bad.flatten().nonzero()[0])
            check(False, f"{what} disagrees with its plain version: relative error "
                  f"{float(r.flatten()[k])} over a segment of {int(rows[k // r.shape[1]])} "
                  f"rows, tolerance {float(tol[k // r.shape[1], 0])}")
        k = int(r.argmax())
        if float(r.flatten()[k]) > rel:
            rel, at = float(r.flatten()[k]), int(rows[k // r.shape[1]])
        err = max(err, max_abs_err(part, want))
    return err, rel, at


@contextlib.contextmanager
def kernel_audit(torch, K, L, audit: dict, exact: bool):
    """While the block runs, hold every output of the two segment-kernel
    wrappers (``aggregate_op``, and each message of a ``level_aggregate``
    launch) against the plain version on the same tensors, and count the
    level launches of every level-plan call (``run_level``,
    ``run_sparse_batch``): more than one means the plan split its members
    over several launches (``plans.ROWWISE_MAX_ELEMS``).  ``audit`` gets, per
    kernel, the outputs checked, the widest launch (rows, padded lanes) and
    the largest absolute error, and the launches per level-plan call."""
    ops, ref = K.seg_ops, K.seg_ref
    real_agg, real_level = ops.aggregate_op, ops.level_aggregate
    real_runs = {name: getattr(L.PlanCache, name) for name in ("run_level", "run_sparse_batch")}
    for name in SEGMENT:
        audit[name] = dict(checked=0, widest=(0, 0), max_abs_err=0.0, max_rel_err=0.0,
                           rows_at_max_rel=0)
    audit["level_runs"] = []
    running: list = []             # launches of the level-plan calls in progress

    def note(name, rows, lanes, errs):
        a = audit[name]
        a["checked"] += 1
        a["widest"] = max(a["widest"], (rows, lanes), key=lambda w: w[0] * w[1])
        for err, rel, at in errs:
            a["max_abs_err"] = max(a["max_abs_err"], err)
            if rel > a["max_rel_err"]:
                a["max_rel_err"], a["rows_at_max_rel"] = rel, at

    def aggregate_op(codes, values, num_segments, op="sum"):
        out = real_agg(codes, values, num_segments, op)
        errs = [hold_plain(torch, ref, codes, values, num_segments, op, out, exact,
                           f"segment_aggregate {op} N={codes.shape[0]} G={num_segments}")]
        note("segment_aggregate", codes.shape[0], values.shape[-1] if values.dim() > 1 else 1,
             errs)
        return out

    def level_aggregate(items, op="sum"):
        outs = real_level(items, op=op)
        if running:
            running[-1] += 1
        errs = [hold_plain(torch, ref, codes, values, g, op, o, exact,
                           f"level_segment_aggregate {op} member N={codes.shape[0]} G={g} "
                           f"V={values.shape[1]} of {len(items)}")
                for (codes, values, g), o in zip(items, outs)]
        note("level_segment_aggregate", sum(c.shape[0] for c, _, _ in items),
             max(v.shape[1] for _, v, _ in items), errs)
        return outs

    def counted(real):
        def run(self, *args, **kwargs):
            running.append(0)
            try:
                return real(self, *args, **kwargs)
            finally:
                audit["level_runs"].append(running.pop())
        return run

    ops.aggregate_op, ops.level_aggregate = aggregate_op, level_aggregate
    for name, real in real_runs.items():
        setattr(L.PlanCache, name, counted(real))
    try:
        yield
    finally:
        ops.aggregate_op, ops.level_aggregate = real_agg, real_level
        for name, real in real_runs.items():
            setattr(L.PlanCache, name, real)
    audit["split_runs"] = [n for n in audit["level_runs"] if n > 1]


def print_audit(label: str, audit: dict, seconds: float) -> None:
    for name in SEGMENT:
        a = audit[name]
        print(f"{label}: {name}: {a['checked']} launches held against the plain version, "
              f"the widest {a['widest'][0]} rows x {a['widest'][1]} lanes, max abs err "
              f"{a['max_abs_err']}, max relative err {a['max_rel_err']} (a segment of "
              f"{a['rows_at_max_rel']} rows)", flush=True)
    splits = audit["split_runs"]
    print(f"{label}: {len(audit['level_runs'])} level-plan calls, {len(splits)} of them split "
          f"(up to {max(splits, default=1)} launches in one call); audit {seconds:.1f} s",
          flush=True)


def explore_drive(torch, K, L, cat, device: str, rounds: int = EXPLORE_ROUNDS) -> dict:
    """Both legs of the exploration on one device: leg A with
    ``FixedKPrefetch(2)``, leg B with ``PredictiveThinkTime(16, 2)``.  One
    warm pass (the context, then every dimension's anchor, jump and clear,
    ``idle()`` after each event), then ``rounds`` timed passes interleaved
    A, B.  Returns per-event and per-idle records, the cube builds and the
    launch counts of the whole drive (counted from 0)."""
    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def peak_since_reset(*more) -> float | None:
        """Peak device memory (MiB) since the last reset, or since a build
        inside the step reset it (the builds' own peaks in ``more``)."""
        if not cuda:
            return None
        return max([torch.cuda.max_memory_allocated() / 2**20, *more])

    def reset_peak():
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

    events = explore_events(L, cat.domains())
    jt = L.jt_from_catalog(cat)
    policies = {"A": L.FixedKPrefetch(2),
                "B": L.PredictiveThinkTime(cube_builds_per_idle=16, prefetch_k=2)}
    steps, builds, idles, open_ms, open_peak = [], [], [], {}, {}
    reset_launches(K)
    with cube_build_probe(torch, L, builds, cuda):
        legs = {}
        for leg, policy in policies.items():
            t = L.Treant(cat, ring=L.sr.SUM, jt=jt, policy=policy, device=device)
            reset_peak()
            t0 = time.perf_counter()
            legs[leg] = (t, t.open_session(explore_spec(L), name=f"explore_{leg}"))
            sync()
            open_ms[leg] = (time.perf_counter() - t0) * 1e3
            open_peak[leg] = peak_since_reset()

        def apply(leg, rnd, event, timed):
            t, sess = legs[leg]
            reset_peak()
            probes0, execs0 = _store_probes(t), _plan_execs(t)
            res = sess.apply(event)
            rec = dict(
                leg=leg, round=rnd, timed=timed, event=repr(event),
                fanout_ms=res.latency_s * 1e3, vizzes=len(res.affected),
                prefetch_hits=sum(r.stats.prefetch_hits for r in res.results.values()),
                bin_cube_hits=sum(r.stats.bin_cube_hits for r in res.results.values()),
                plan_execs=_plan_execs(t) - execs0, store_probes=_store_probes(t) - probes0,
                answers={v: r.factor.field.cpu() for v, r in res.results.items()},
                queries={v: res.queries[v] for v in res.affected},
            )
            sync()
            rec["peak_mb"] = peak_since_reset()
            steps.append(rec)
            n0, b0 = len(builds), t.scheduler.cube_builds
            reset_peak()
            t0 = time.perf_counter()
            edges = sess.idle()
            sync()
            per_build = [b["peak_mb"] for b in builds[n0:]]
            idles.append(dict(
                leg=leg, round=rnd, after=repr(event), think_ms=(time.perf_counter() - t0) * 1e3,
                edges=edges, cube_builds=t.scheduler.cube_builds - b0,
                bin_cube_bytes=sess.bin_cube_bytes, peak_mb_per_build=per_build,
                peak_mb=peak_since_reset(*per_build),
            ))

        for rnd in range(rounds + 1):  # round 0 is the warm pass
            for leg in ("A", "B"):
                if rnd == 0:
                    for ctx in explore_context(L):
                        apply(leg, rnd, ctx, False)
                for anchor, follows in events:
                    apply(leg, rnd, anchor, False)
                    for ev in follows:
                        apply(leg, rnd, ev, rnd > 0)
    stats = {leg: dict(t.cache_stats()["scheduler"], **{
        k: v for k, v in sess.stats().items() if k in ("prefetch_hits", "bin_cube_hits",
                                                        "bin_cubes", "bin_cube_bytes")})
             for leg, (t, sess) in legs.items()}
    for t, sess in legs.values():
        sess.close()
    peaks = [*open_peak.values(), *(x["peak_mb"] for x in steps + idles)]
    return dict(steps=steps, idles=idles, builds=builds, open_ms=open_ms, open_peak_mb=open_peak,
                stats=stats, launches=read_launches(K),
                peak_mb=max(peaks) if cuda else None)


def explore_cold_checks(torch, L, cat, rec: dict, device: str) -> int:
    """Every timed event's rendered vizzes against a cold engine (fresh
    message store) on ``device``: rtol 1e-5 (float sums in another order)."""
    jt = L.jt_from_catalog(cat)
    cache = L.PlanCache(L.sr.SUM, device)
    n = 0
    for st in rec["steps"]:
        if not st["timed"]:
            continue
        for viz, q in st["queries"].items():
            eng = L.CJTEngine(jt, cat, L.sr.SUM, store=L.MessageStore(), plan_cache=cache,
                              device=device)
            want = eng.execute(q)[0].field.cpu()
            torch.testing.assert_close(st["answers"][viz], want, rtol=1e-5, atol=0,
                                       msg=f"explore {st['leg']} {st['event']} {viz}")
            n += 1
    return n


EXPLORE_COUNTERS = ("leg", "round", "timed", "event", "vizzes", "prefetch_hits",
                    "bin_cube_hits", "plan_execs", "store_probes")


def explore_compare(torch, a: dict, b: dict, what: str) -> None:
    """Two drives of the exploration (cuda and the CPU): equal counters per
    event and per leg, equal cube builds, answers to rtol 1e-5."""
    check(len(a["steps"]) == len(b["steps"]), f"{what}: step lists differ")
    check(a["stats"] == b["stats"], f"{what}: leg counters {a['stats']} != {b['stats']}")
    check([(x["viz"], x["dim"]) for x in a["builds"]] == [(x["viz"], x["dim"])
                                                           for x in b["builds"]],
          f"{what}: cube builds differ")
    for x, y in zip(a["steps"], b["steps"]):
        cx = {k: x[k] for k in EXPLORE_COUNTERS}
        cy = {k: y[k] for k in EXPLORE_COUNTERS}
        check(cx == cy, f"{what}: {cx} != {cy}")
        for viz, g in x["answers"].items():
            torch.testing.assert_close(g, y["answers"][viz], rtol=1e-5, atol=0,
                                       msg=f"{what} {x['leg']} {x['event']} {viz}")


def explore_phase(torch, np, K, L, schema, report: dict) -> dict:
    t0 = time.perf_counter()
    cat = schema.flight(n_flights=EXPLORE_FLIGHTS)
    fl = cat.get("Flights")
    print(f"explore: catalog of {fl.num_rows} flights (row bucket {fl.row_bucket}) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rec = explore_drive(torch, K, L, cat, "cuda")
    launches = rec["launches"]
    print(f"explore: open_session {rec['open_ms']['A']:.1f} ms (leg A), "
          f"{rec['open_ms']['B']:.1f} ms (leg B), peak device memory "
          f"{rec['open_peak_mb']['A']:.1f} / {rec['open_peak_mb']['B']:.1f} MiB; "
          f"launches {launches}; peak device memory of the phase {rec['peak_mb']:.1f} MiB",
          flush=True)
    for name in SEGMENT:
        check(launches[name] > 0, f"explore: {name} never launched")
    for st, idle in zip(rec["steps"], rec["idles"]):
        tag = "timed" if st["timed"] else "warm "
        print(f"explore {st['leg']} r{st['round']} {tag} {st['event'][:58]:58s} fan-out "
              f"{st['fanout_ms']:8.3f} ms, {st['vizzes']} vizzes, prefetch hits "
              f"{st['prefetch_hits']}, cube hits {st['bin_cube_hits']}, plan execs "
              f"{st['plan_execs']}, store probes {st['store_probes']}; idle "
              f"{idle['think_ms']:.1f} ms, {idle['cube_builds']} cube builds, bin_cube_bytes "
              f"{idle['bin_cube_bytes']}, peak MiB per build "
              f"{[round(m, 1) for m in idle['peak_mb_per_build']]}", flush=True)
    timed_b = [st for st in rec["steps"] if st["timed"] and st["leg"] == "B"]
    check(bool(timed_b), "explore: leg B has no timed event")
    for st in timed_b:
        check(st["vizzes"] > 0 and st["bin_cube_hits"] == st["vizzes"]
              and st["plan_execs"] == 0 and st["store_probes"] == 0,
              f"explore: leg B timed event not cube-served: {st['event']} "
              f"{ {k: st[k] for k in EXPLORE_COUNTERS} }")
    widest = max(rec["builds"], key=lambda b: b["widest_rowwise_elems"])
    peak = max(rec["builds"], key=lambda b: b["peak_mb"])
    print(f"explore: {len(rec['builds'])} cube builds; widest rowwise field "
          f"{widest['widest_rowwise_elems']} elements ({widest['viz']} on {widest['dim']}); "
          f"peak device memory of a build {peak['peak_mb']:.1f} MiB ({peak['viz']} on "
          f"{peak['dim']}, {peak['ms']:.1f} ms)", flush=True)
    t0 = time.perf_counter()
    n = explore_cold_checks(torch, L, cat, rec, "cuda")
    print(f"explore: {n} timed answers equal cold engines on the card "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    # the warm pass again at full size, every kernel launch held against the
    # plain version (apart from the timed drive, whose latencies it would skew)
    gc.collect()
    torch.cuda.empty_cache()
    audit: dict = {}
    t0 = time.perf_counter()
    with kernel_audit(torch, K, L, audit, exact=False):
        explore_drive(torch, K, L, cat, "cuda", rounds=0)
    print_audit("explore", audit, time.perf_counter() - t0)
    for name in SEGMENT:
        check(audit[name]["checked"] > 0, f"explore: no {name} launch was held")
    check(bool(audit["split_runs"]), "explore: no level-plan call split its launch")
    t0 = time.perf_counter()
    small = schema.flight(n_flights=EXPLORE_CPU_FLIGHTS)
    cpu = explore_drive(torch, K, L, small, "cpu", rounds=0)
    cpu_s = time.perf_counter() - t0
    gpu_small = explore_drive(torch, K, L, schema.flight(n_flights=EXPLORE_CPU_FLIGHTS),
                              "cuda", rounds=0)
    explore_compare(torch, gpu_small, cpu, f"explore at {EXPLORE_CPU_FLIGHTS} flights")
    print(f"explore: the sequence at {EXPLORE_CPU_FLIGHTS} flights gives the same counters "
          f"and answers on cuda and on the CPU (CPU run {cpu_s:.1f} s)", flush=True)

    def fanout(leg, timed=True):
        return [st["fanout_ms"] for st in rec["steps"] if st["leg"] == leg and st["timed"]]

    report["explore"] = dict(
        n_flights=fl.num_rows, row_bucket=fl.row_bucket, open_ms=rec["open_ms"],
        open_peak_mb=rec["open_peak_mb"], peak_mb=rec["peak_mb"],
        launches=launches, stats=rec["stats"], builds=rec["builds"], idles=rec["idles"],
        steps=[{k: v for k, v in st.items() if k not in ("answers", "queries")}
               for st in rec["steps"]],
        timed_fanout_ms={"A": fanout("A"), "B": fanout("B")},
        median_timed_fanout_ms={leg: statistics.median(fanout(leg)) for leg in ("A", "B")},
        cold_checked=n, cpu_flights=EXPLORE_CPU_FLIGHTS, cpu_s=cpu_s, audit=audit,
    )
    print(f"explore: median timed fan-out {report['explore']['median_timed_fanout_ms']['A']:.3f}"
          f" ms (leg A, σ prefetch), {report['explore']['median_timed_fanout_ms']['B']:.3f} ms "
          f"(leg B, bin cubes)", flush=True)

    def leg_b():  # open, context, one anchor with think-time, its jump and clear
        t = L.Treant(cat, ring=L.sr.SUM, device="cuda",
                     policy=L.PredictiveThinkTime(cube_builds_per_idle=16, prefetch_k=2))
        sess = t.open_session(explore_spec(L), name="profiled")
        for ev in explore_context(L):
            sess.apply(ev)
        anchor, follows = explore_events(L, cat.domains())[0]
        sess.apply(anchor)
        sess.idle()
        for ev in follows:
            sess.apply(ev)
        sess.close()

    profile_phase(torch, "explore", leg_b, report)
    return dict(cat=cat, launches=launches)


# ---------------------------------------------------------------------------
# phase 13: the multi-tenant serving tier (benchmarks/bench_serve.py's storm)
# ---------------------------------------------------------------------------

SERVE_SESSIONS = 64
SERVE_CPU_SESSIONS = 16
SERVE_ROUNDS = 4                   # timed rounds; two warm rounds precede them
DRAG = 3                           # brush positions per drag: 2 superseded + 1 final
HOT_WINDOWS = 8                    # distinct σ windows per round
WARM, WARM2 = -1, -2               # the warm rounds' markers
FAN_DIMS = ("month", "carrier_group", "airport_size", "dow", "delay_bucket", "distance_bucket")


def serve_spec(L, dims=FAN_DIMS):
    """``bench_serve.serve_spec``: the brush source by airport_state plus one
    COUNT-valued SUM viz per fan-out dimension."""
    vizzes = [L.VizSpec("by_state", measure=None, ring="sum", group_by=("airport_state",))]
    vizzes += [L.VizSpec(f"by_{d}", measure=None, ring="sum", group_by=(d,)) for d in dims]
    return L.DashboardSpec(vizzes=tuple(vizzes))


def spec_variants(L) -> list:
    return [serve_spec(L, FAN_DIMS[i:i + 3]) for i in range(4)]


def brush(L, i: int, rnd: int, step: int = DRAG - 1):
    """``bench_serve.brush``: session ``i``'s ``step``-th drag position of
    round ``rnd`` on airport_state (sessions cluster on the hot windows)."""
    if rnd == WARM:
        return L.SetFilter("airport_state", lo=20, hi=26, source="by_state")
    if rnd == WARM2:
        lo = (5 * (i % HOT_WINDOWS) + 3) % 49
        return L.SetFilter("airport_state", lo=lo, hi=lo + 6, source="by_state")
    lo = max((5 * (i % HOT_WINDOWS) + 11 * rnd) % 49 - (DRAG - 1 - step), 0)
    return L.SetFilter("airport_state", lo=lo, hi=lo + 2 + rnd, source="by_state")


def _drag_of(rnd: int) -> int:
    return 1 if rnd in (WARM, WARM2) else DRAG


def serial_pass(sessions, L, rounds, sync) -> list:
    """Every submitted event applied one ``Session.apply`` at a time."""
    lat = []
    for rnd in rounds:
        for step in range(_drag_of(rnd)):
            for i, sess in enumerate(sessions):
                t0 = time.perf_counter()
                sess.apply(brush(L, i, rnd, step))
                sync()
                lat.append(time.perf_counter() - t0)
    return lat


def server_pass(server, handles, L, K, rounds, sync) -> dict:
    """Submit each round's drag stream, ``step()`` until the queue drains,
    ``idle()`` between rounds.  An applied event's latency is the synced
    time of the ``step()`` that applied it; the wall time counts submitting and
    stepping, not the think-time between rounds (``idle_ms``, apart), as
    ``bench_serve``'s does; kernel-2 launches are counted per step."""
    lat, per_step, idle_ms = [], [], []
    wall = 0.0
    for rnd in rounds:
        t_round = time.perf_counter()
        for step in range(_drag_of(rnd)):
            for i, h in enumerate(handles):
                h.submit(brush(L, i, rnd, step))
        while server.queue_depth:
            before = K.seg_ops.LAUNCHES["level_segment_aggregate"]
            t0 = time.perf_counter()
            n = server.step()
            sync()
            dt = time.perf_counter() - t0
            per_step.append(K.seg_ops.LAUNCHES["level_segment_aggregate"] - before)
            lat.extend([dt] * n)
        wall += time.perf_counter() - t_round
        t0 = time.perf_counter()
        server.idle()
        sync()
        idle_ms.append((time.perf_counter() - t0) * 1e3)
    return dict(lat=lat, wall_s=wall, level_launches_per_step=per_step, idle_ms=idle_ms)


def reads_of(handles) -> dict:
    return {(h.id, v): h.read(v).factor.field.cpu() for h in handles for v in h.session.vizzes}


def storm(torch, K, L, cat, device: str, n_sessions: int, variants: bool = False,
          max_store_bytes=None, serial: bool = True) -> dict:
    """One storm through a ``TreantServer`` (and, with ``serial``, the same
    events applied one by one on a twin Treant).  Returns reads, counters,
    latencies, store accounting and the launch counts of the server side."""
    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    jt = L.jt_from_catalog(cat)
    specs = spec_variants(L) if variants else [serve_spec(L)]
    tag = "d" if variants else "s"
    out = {}
    if serial:
        t_ser = L.Treant(cat, ring=L.sr.SUM, jt=jt, device=device)
        sessions = [t_ser.open_session(specs[i % len(specs)], name=f"{tag}{i}")
                    for i in range(n_sessions)]
        serial_pass(sessions, L, [WARM, WARM2], sync)
        lat = serial_pass(sessions, L, range(SERVE_ROUNDS), sync)
        out["serial_lat"] = lat
        out["serial_reads"] = {(s.id, v): s.read(v).factor.field.cpu()
                               for s in sessions for v in s.vizzes}
        for sess in sessions:
            sess.close()
        del t_ser, sessions
    reset_launches(K)
    t = L.Treant(cat, ring=L.sr.SUM, jt=jt, device=device)
    server = L.TreantServer(t, max_queue=4 * n_sessions, max_store_bytes=max_store_bytes)
    t0 = time.perf_counter()
    handles = [server.open_session(specs[i % len(specs)], name=f"{tag}{i}")
               for i in range(n_sessions)]
    sync()
    out["open_ms"] = (time.perf_counter() - t0) * 1e3
    server_pass(server, handles, L, K, [WARM, WARM2], sync)
    server.stats_ = L.ServeStats()
    out.update(server_pass(server, handles, L, K, range(SERVE_ROUNDS), sync))
    out["stats"] = server.stats()
    out["reads"] = reads_of(handles)
    store = t.store
    out["store"] = dict(nbytes=store.nbytes, pinned=store.pinned_nbytes,
                        budget=store.max_bytes, evictions=store.evictions,
                        inflight=store._inflight_depth)
    out["launches"] = read_launches(K)
    out["events"] = n_sessions * SERVE_ROUNDS * DRAG
    for h in handles:
        h.close()
    return out


def serve_check(torch, rec: dict, what: str) -> None:
    st = rec["stats"]
    check(st["cross_session_batch_width"] > 1, f"{what}: no dispatch served two sessions")
    n = len({sid for sid, _ in rec["reads"]})
    check(st["coalesced_events"] == n * SERVE_ROUNDS * (DRAG - 1), f"{what}: coalescing {st}")
    check(st["events_processed"] == n * SERVE_ROUNDS, f"{what}: processed {st}")
    if "serial_reads" in rec:
        check(rec["reads"].keys() == rec["serial_reads"].keys(), f"{what}: read sets differ")
        for key, got in rec["reads"].items():
            check(torch.equal(got, rec["serial_reads"][key]),
                  f"{what}: {key} differs from serial apply")


def serve_phase(torch, np, K, L, schema, cat, report: dict) -> dict:
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = {}
    launches = {name: 0 for name in read_launches(K)}

    def summary(label, rec):
        st, lat = rec["stats"], rec["lat"]
        eps = rec["events"] / rec["wall_s"]
        row = dict(
            events_per_s=eps, p99_event_ms=float(np.percentile(lat, 99)) * 1e3,
            serial_events_per_s=(rec["events"] / sum(rec["serial_lat"])
                                 if "serial_lat" in rec else None),
            serial_p99_event_ms=(float(np.percentile(rec["serial_lat"], 99)) * 1e3
                                 if "serial_lat" in rec else None),
            cross_session_batch_width=st["cross_session_batch_width"],
            coalesced_events=st["coalesced_events"], dedup_hits=st["dedup_hits"],
            batches=st["batches"], level_launches_per_step=rec["level_launches_per_step"],
            idle_ms=rec["idle_ms"], open_ms=rec["open_ms"], store=rec["store"],
            launches=rec["launches"],
        )
        for k in launches:
            launches[k] += rec["launches"][k]
        ser = ("" if row["serial_events_per_s"] is None else
               f" (serial apply {row['serial_events_per_s']:.1f} events/s, p99 "
               f"{row['serial_p99_event_ms']:.3f} ms)")
        print(f"serve {label}: {eps:.1f} events/s, p99 applied-event latency "
              f"{row['p99_event_ms']:.3f} ms{ser}; cross_session_batch_width "
              f"{row['cross_session_batch_width']}, coalesced {row['coalesced_events']}, "
              f"dedup hits {row['dedup_hits']}, {row['batches']} batches, level launches per "
              f"step {row['level_launches_per_step']}; store {rec['store']['nbytes']} B "
              f"(pinned floor {rec['store']['pinned']} B, budget {rec['store']['budget']}, "
              f"evictions {rec['store']['evictions']}); open {rec['open_ms']:.1f} ms", flush=True)
        out[label] = row

    shared = storm(torch, K, L, cat, "cuda", SERVE_SESSIONS)
    serve_check(torch, shared, "serve shared")
    summary(f"shared{SERVE_SESSIONS}", shared)
    distinct = storm(torch, K, L, cat, "cuda", SERVE_SESSIONS, variants=True)
    serve_check(torch, distinct, "serve distinct")
    summary(f"distinct{SERVE_SESSIONS}", distinct)
    footprint, pinned = shared["store"]["nbytes"], shared["store"]["pinned"]
    budget = pinned + (footprint - pinned) // 2
    budgeted = storm(torch, K, L, cat, "cuda", SERVE_SESSIONS, max_store_bytes=budget,
                     serial=False)
    serve_check(torch, budgeted, "serve budget")
    bs = budgeted["store"]
    check(bs["nbytes"] <= budget and bs["pinned"] <= bs["nbytes"] and bs["inflight"] == 0,
          f"serve budget: store at rest {bs} over the budget {budget}")
    check(footprint == pinned or bs["evictions"] > 0, f"serve budget: nothing evicted {bs}")
    for key, got in budgeted["reads"].items():
        check(torch.equal(got, shared["reads"][key]),
              f"serve budget: {key} differs from the unbudgeted storm")
    summary(f"budget{SERVE_SESSIONS}", budgeted)
    print(f"serve: budget {budget} B = pinned floor {pinned} B + half of the "
          f"{footprint - pinned} evictable bytes; at rest {bs['nbytes']} B after "
          f"{bs['evictions']} evictions; every read equals serial apply and the unbudgeted "
          f"storm", flush=True)
    for name in SEGMENT:
        check(launches[name] > 0, f"serve: {name} never launched")
    # the shared storm once more, every kernel launch held against the plain
    # version (apart from the timed storms, whose latencies it would skew)
    audit: dict = {}
    t0 = time.perf_counter()
    with kernel_audit(torch, K, L, audit, exact=True):
        audited = storm(torch, K, L, cat, "cuda", SERVE_SESSIONS, serial=False)
    print_audit("serve", audit, time.perf_counter() - t0)
    for name in SEGMENT:
        check(audit[name]["checked"] > 0, f"serve: no {name} launch was held")
    for key, got in audited["reads"].items():
        check(torch.equal(got, shared["reads"][key]),
              f"serve audited: {key} differs from the shared storm")
    t = L.Treant(cat, ring=L.sr.SUM, device="cuda")
    server = L.TreantServer(t, max_queue=4 * SERVE_SESSIONS)
    handles = [server.open_session(serve_spec(L), name=f"p{i}") for i in range(SERVE_SESSIONS)]
    server_pass(server, handles, L, K, [WARM, WARM2], torch.cuda.synchronize)
    profile_phase(torch, "serve", lambda: server_pass(server, handles, L, K, [0],
                                                      torch.cuda.synchronize), report)
    for h in handles:
        h.close()
    del t, server, handles
    t0 = time.perf_counter()
    small = schema.flight(n_flights=EXPLORE_CPU_FLIGHTS)
    cpu = storm(torch, K, L, small, "cpu", SERVE_CPU_SESSIONS, serial=False)
    cpu_s = time.perf_counter() - t0
    gpu = storm(torch, K, L, schema.flight(n_flights=EXPLORE_CPU_FLIGHTS), "cuda",
                SERVE_CPU_SESSIONS, serial=False)
    keys = ("events_processed", "coalesced_events", "batches", "cross_session_batch_width",
            "dedup_hits", "shared_prefetch_hits", "pool_cube_hits", "think_time_messages")
    check({k: gpu["stats"][k] for k in keys} == {k: cpu["stats"][k] for k in keys},
          f"serve at {EXPLORE_CPU_FLIGHTS} flights: counters differ")
    for key, got in gpu["reads"].items():
        check(torch.equal(got, cpu["reads"][key]),
              f"serve at {EXPLORE_CPU_FLIGHTS} flights: {key} differs from the CPU")
    print(f"serve: the storm at {EXPLORE_CPU_FLIGHTS} flights and {SERVE_CPU_SESSIONS} sessions "
          f"gives the same reads and counters on cuda and on the CPU (CPU run {cpu_s:.1f} s); "
          f"launches {launches}; peak device memory of the phase "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB", flush=True)
    report["serve"] = dict(out, budget=budget, footprint=footprint, pinned=pinned, audit=audit,
                           launches=launches, cpu_flights=EXPLORE_CPU_FLIGHTS,
                           cpu_sessions=SERVE_CPU_SESSIONS, cpu_s=cpu_s,
                           max_allocated_mb=torch.cuda.max_memory_allocated() / 2**20)
    return dict(launches=launches)


# ---------------------------------------------------------------------------
# phase 14: factorized ML over the Favorita join (Fig 18)
# ---------------------------------------------------------------------------

# Kaggle's Corporación Favorita sales table at its published widths (54
# stores, 4,100 items, 1,684 dates); its 125,497,040 sales are cut to 8M:
# examples/ml_augmentation.py's features give k = 11, 133 float32 per row of
# the covariance lift (66.8 GB at the full table)
ML_SALES = 8_000_000
ML_CPU_SALES = 60_000
ML_WIDTHS = dict(n_stores=54, n_items=4_100, n_dates=1_684)
ML_AUG_PER_KEY = 10
ML_R2_TOL = 1e-3                   # the reference test's R² tolerance against numpy
ML_COLD_TOL = 1e-4                 # ... and against the cold baseline


def ml_features(M, well_posed: bool = False) -> list:
    """``examples/ml_augmentation.py``'s features (unit_sales, one-hot store
    type and perishable: with the intercept, the two one-hot blocks are
    collinear), or numeric ones only (unit_sales, item_weight): a model whose
    normal equations do not rest on the ridge alone."""
    if well_posed:
        return [M.FeatureSpec("Sales", "unit_sales"), M.FeatureSpec("Items", "item_weight")]
    return [M.FeatureSpec("Sales", "unit_sales"),
            M.FeatureSpec("Stores", "store_type", categorical=True),
            M.FeatureSpec("Items", "perishable", categorical=True)]


def ml_model(M, cat, device: str, well_posed: bool = False):
    return M.FactorizedLinearRegression(cat, ml_features(M, well_posed),
                                        M.FeatureSpec("Trans", "transactions"), device=device)


def per_sale(np, cat, rel_name: str, column: str, measure: bool):
    """A column of ``rel_name`` carried to every sale through the join."""
    sales, rel = cat.get("Sales"), cat.get(rel_name)
    vals = rel.measures[column] if measure else rel.codes[column]
    if rel_name == "Sales":
        return vals
    keys = [a for a in rel.attrs if a in sales.attrs]
    doms = [cat.domains()[a] for a in keys]
    lut = np.zeros(int(np.prod(doms)), dtype=np.float64 if measure else np.int64)
    lut[np.ravel_multi_index([rel.codes[a] for a in keys], doms)] = vals
    return lut[np.ravel_multi_index([sales.codes[a] for a in keys], doms)]


def ml_design(np, model, cat, aug=None):
    """The join's design matrix in float64 on the host (one row per sale,
    ``tests/test_ml_cube.py::_numpy_fit``'s construction), in the model's slot
    layout: intercept, features, augmentation slot, target."""
    n = cat.get("Sales").num_rows
    X = np.zeros((n, model.k))
    X[:, model.slot_of["__intercept__"][0]] = 1.0
    for f in model.features:
        lo = model.slot_of[f.tag][0]
        if f.categorical:
            X[np.arange(n), lo + per_sale(np, cat, f.relation, f.column, False)] = 1.0
        else:
            X[:, lo] = per_sale(np, cat, f.relation, f.column, True)
    if aug is not None:
        X[:, model.slot_of["__aug__"][0]] = aug.measures["v"][cat.get("Sales").codes[aug.attrs[0]]]
    X[:, model.slot_of["__target__"][0]] = per_sale(np, cat, model.target.relation,
                                                    model.target.column, True)
    return X


def r2_of(np, model, X, w, with_aug: bool) -> float:
    """R² of weights ``w`` on the float64 design ``X``."""
    y = X[:, model.slot_of["__target__"][0]]
    sse = float(((X[:, model._feature_slots(with_aug)] @ w - y) ** 2).sum())
    return 1.0 - sse / float(((y - y.mean()) ** 2).sum())


def numpy_fit(np, model, X, with_aug: bool) -> tuple:
    """Ridge normal equations in float64 (``_numpy_fit``): weights, R²."""
    A = X[:, model._feature_slots(with_aug)]
    y = X[:, model.slot_of["__target__"][0]]
    w = np.linalg.solve(A.T @ A + model.ridge * np.eye(A.shape[1]), A.T @ y)
    return w, r2_of(np, model, X, w, with_aug)


def element64(np, X) -> tuple:
    """The join's covariance element (c, s, Q) in float64."""
    return (np.float64(X.shape[0]), X.sum(0), X.T @ X)


def sum_bound(np, X) -> tuple:
    """Per-entry rounding bound of the card's float32 element over the
    design ``X``: a sum of n terms in any order is within λ·√n·u of the sum
    of their absolute values (u = 2^-24, λ = ``AUDIT_LAMBDA``; the
    probabilistic bound phase 12's audit uses).  Entries whose terms are all
    0 or 1 (count, intercept, one-hots) are integers below 2^24, exact in
    float32 in any order: their bound is 0."""
    n = X.shape[0]
    d = AUDIT_LAMBDA * float(np.sqrt(n)) * 2.0 ** -24
    c, s, q = element64(np, np.abs(X))
    exact = np.all((X == 0.0) | (X == 1.0), axis=0) & (n < 2 ** 24)
    return (0.0 if n < 2 ** 24 else d * c, np.where(exact, 0.0, d * s),
            np.where(exact[:, None] & exact[None, :], 0.0, d * q))


def check_element(np, got, X, what: str) -> list[float]:
    """The card's element against float64 sums of the same join, each entry
    within its ``sum_bound``; returns the largest relative errors of c, s, Q."""
    errs = []
    for g, want, b, name in zip(got, element64(np, X), sum_bound(np, X), ("c", "s", "Q")):
        d = np.abs(g.double().numpy() - want)
        check(bool((d <= b).all()), f"{what}: element {name} off its float32 bound: "
              f"max |err| - bound {float((d - b).max())}")
        errs.append(float((d / np.maximum(np.abs(want), 1e-300)).max()))
    return errs


def solve_from(torch, model, el, with_aug: bool):
    """``model._solve`` on a float64 element: (R², weights)."""
    r = model._solve(tuple(torch.as_tensor(x, dtype=torch.float64) for x in el), with_aug, None)
    return r.r2, r.weights


def propagated_tol(np, torch, model, X, with_aug: bool) -> tuple:
    """First-order bound of the fit's error from the element's rounding:
    Σ over entries of |f(el + bound_e) − f(el)| for f = R² and each weight
    (Q's symmetric pairs move together, as the card computes both alike)."""
    el, (bc, bs, bq) = element64(np, X), sum_bound(np, X)
    r0, w0 = solve_from(torch, model, el, with_aug)
    tol_r2, tol_w = 0.0, np.zeros_like(w0)
    c, s, q = el
    moves = [(c + bc, s, q)]
    for i in np.flatnonzero(bs):
        s2 = s.copy()
        s2[i] += bs[i]
        moves.append((c, s2, q))
    for i, j in zip(*np.nonzero(np.triu(bq))):
        q2 = q.copy()
        q2[i, j] += bq[i, j]
        q2[j, i] = q2[i, j]
        moves.append((c, s, q2))
    for el2 in moves:
        r, w = solve_from(torch, model, el2, with_aug)
        tol_r2 += abs(r - r0)
        tol_w = tol_w + np.abs(w - w0)
    return tol_r2, tol_w


def ml_drive(torch, M, cat, augs, device: str, well_posed: bool = False,
             all_candidates: bool = True) -> dict:
    """Fig 18 on one device: the base fit, calibration, every candidate of
    ``augs`` (or the first of each key) through ``fit_augmented``, and the
    cold baseline of the first candidate of each key.  Times end in a device
    sync (the solve reads the element back)."""
    cuda = device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    model = ml_model(M, cat, device, well_posed)
    t0 = time.perf_counter()
    base = model.fit()
    fit_ms = (time.perf_counter() - t0) * 1e3
    element = tuple(leaf.cpu() for leaf in model.engine.execute(model._base_query())[0].field)
    t0 = time.perf_counter()
    cal = model.calibrate()
    if cuda:
        torch.cuda.synchronize()
    cal_ms = (time.perf_counter() - t0) * 1e3
    cands, cold, seen, solved = [], {}, set(), []
    real_solve = model._solve

    def solve(element, with_aug, stats):  # keeps each candidate's element for the host checks
        solved.append(tuple(x.detach().cpu() for x in element))
        return real_solve(element, with_aug, stats)

    model._solve = solve
    try:
        for a in augs:
            key = a.attrs[0]
            if key in seen and not all_candidates:
                continue
            t0 = time.perf_counter()
            r = model.fit_augmented(a)
            cands.append(dict(name=a.name, key=key, ms=(time.perf_counter() - t0) * 1e3,
                              r2=r.r2, weights=r.weights, element=solved[-1],
                              computed=r.stats.messages_computed,
                              reused=r.stats.messages_reused, repeat=key in seen))
            seen.add(key)
    finally:
        del model._solve
    for a in augs:
        if a.attrs[0] in cold:
            continue
        t0 = time.perf_counter()
        r = model.fit_unfactorized_baseline(a)
        cold[a.attrs[0]] = dict(name=a.name, ms=(time.perf_counter() - t0) * 1e3, r2=r.r2,
                                computed=r.stats.messages_computed)
    return dict(model=model, base=base, element=element, fit_ms=fit_ms, cal_ms=cal_ms,
                cal_computed=cal.messages_computed, cands=cands, cold=cold,
                peak_mb=torch.cuda.max_memory_allocated() / 2**20 if cuda else None)


def ml_fit_checks(np, torch, rec: dict, cat, augs) -> dict:
    """The fit of ``rec``'s model against float64 numpy on the host.  Held
    (``ok``): the base R² and each first-of-key candidate's within the
    reference test's 1e-3 of numpy's, each candidate's within 1e-4 of its
    cold baseline, and the weights through the float64 objective (the
    card's weights on the float64 design reach numpy's R² within 1e-3).
    Each candidate's element is held to its float32 bound (``check_element``,
    which fails the phase).  Reported only: the element's bound carried
    through the solve (``propagated_tol``) and the weights side by side."""
    model, base = rec["model"], rec["base"]
    X = ml_design(np, model, cat)
    w64, r2_64 = numpy_fit(np, model, X, with_aug=False)
    tol_r2, tol_w = propagated_tol(np, torch, model, X, with_aug=False)
    out = dict(r2=base.r2, numpy_r2=r2_64, weights_r2=r2_of(np, model, X, base.weights, False),
               weights=base.weights.tolist(), numpy_weights=w64.tolist(),
               propagated_r2=tol_r2, propagated_weights=tol_w.tolist(), augmented=[])
    out["ok"] = (abs(base.r2 - r2_64) <= ML_R2_TOL
                 and abs(out["weights_r2"] - r2_64) <= ML_R2_TOL)
    for c in (c for c in rec["cands"] if not c["repeat"]):
        a = next(x for x in augs if x.name == c["name"])
        Xa = ml_design(np, model, cat, aug=a)
        errs = check_element(np, c["element"], Xa, f"ml {c['name']}")
        tol_a, _ = propagated_tol(np, torch, model, Xa, with_aug=True)
        _, r2_a64 = numpy_fit(np, model, Xa, with_aug=True)
        row = dict(name=c["name"], r2=c["r2"], cold_r2=rec["cold"][c["key"]]["r2"],
                   numpy_r2=r2_a64, weights_r2=r2_of(np, model, Xa, c["weights"], True),
                   propagated_r2=tol_a, element_max_rel_err=errs)
        row["ok"] = (abs(c["r2"] - row["cold_r2"]) <= ML_COLD_TOL
                     and abs(c["r2"] - r2_a64) <= ML_R2_TOL
                     and abs(row["weights_r2"] - r2_a64) <= ML_R2_TOL)
        out["augmented"].append(row)
    return out


def print_fit(label: str, fit: dict) -> None:
    print(f"{label}: base R² {fit['r2']:.6f} against numpy's {fit['numpy_r2']:.6f} (|err| "
          f"{abs(fit['r2'] - fit['numpy_r2']):.3g}, held at {ML_R2_TOL:g}; the element's bound "
          f"through the solve {fit['propagated_r2']:.3g}); the weights reach R² "
          f"{fit['weights_r2']:.6f} on the float64 design; weights "
          f"{[round(w, 4) for w in fit['weights']]} against "
          f"{[round(w, 4) for w in fit['numpy_weights']]}", flush=True)
    for r in fit["augmented"]:
        print(f"{label}: {r['name']}: R² {r['r2']:.6f}, cold baseline {r['cold_r2']:.6f} (|err| "
              f"{abs(r['r2'] - r['cold_r2']):.3g}, held at {ML_COLD_TOL:g}), numpy "
              f"{r['numpy_r2']:.6f} (|err| {abs(r['r2'] - r['numpy_r2']):.3g}, held at "
              f"{ML_R2_TOL:g}; the element's bound through the solve {r['propagated_r2']:.3g}); "
              f"its weights reach R² {r['weights_r2']:.6f} on the float64 design; element "
              f"within its float32 bound (max relative err s {r['element_max_rel_err'][1]:.3g}, "
              f"Q {r['element_max_rel_err'][2]:.3g})", flush=True)


def ml_phase(torch, np, K, M, schema, report: dict) -> dict:
    gc.collect()
    torch.cuda.empty_cache()
    cat = schema.favorita(n_sales=ML_SALES, **ML_WIDTHS)
    augs = schema.favorita_augmentations(cat, n_per_key=ML_AUG_PER_KEY)
    reset_launches(K)
    t0 = time.perf_counter()
    rec = ml_drive(torch, M, cat, augs, "cuda")
    drive_s = time.perf_counter() - t0
    launches = read_launches(K)
    model, n = rec["model"], cat.get("Sales").num_rows
    print(f"ml: {n} sales (row bucket {cat.get('Sales').row_bucket}), k = {model.k}; base fit "
          f"{rec['fit_ms']:.1f} ms, calibrate {rec['cal_ms']:.1f} ms "
          f"({rec['cal_ms'] / rec['fit_ms']:.2f} x the fit, {rec['cal_computed']} messages); "
          f"peak device memory {rec['peak_mb']:.1f} MiB; launches {launches} "
          f"(drive {drive_s:.1f} s)", flush=True)
    check(not any(launches.values()),
          f"ml: the covariance ring launched a kernel {launches} (its plain path has none)")
    by_key: dict = {}
    for c in rec["cands"]:
        by_key.setdefault(c["key"], []).append(c)
        check(c["computed"] == 0 if c["repeat"] else c["computed"] <= 1,
              f"ml: candidate {c['name']} computed {c['computed']} messages")
    for key, cs in by_key.items():
        ms = [c["ms"] for c in cs]
        print(f"ml: {len(cs)} {key}-keyed candidates: first {ms[0]:.2f} ms "
              f"({cs[0]['computed']} message), the rest median {statistics.median(ms[1:]):.2f} "
              f"ms, max {max(ms[1:]):.2f} ms ({sum(c['computed'] for c in cs[1:])} messages); "
              f"cold baseline {rec['cold'][key]['ms']:.1f} ms "
              f"({rec['cold'][key]['computed']} messages)", flush=True)
    t0 = time.perf_counter()
    errs = check_element(np, rec["element"], ml_design(np, model, cat), "ml")
    print(f"ml: the element is within its float32 bound of float64 sums (max relative err c "
          f"{errs[0]:.3g}, s {errs[1]:.3g}, Q {errs[2]:.3g}; λ·√n·u = "
          f"{AUDIT_LAMBDA * n ** 0.5 * 2 ** -24:.3g})", flush=True)
    # the example's features are collinear: the fit rests on the ridge alone,
    # and the float32 rounding of the target's sums decides it at this size
    # (in both packages), so it is reported, not held; a well-posed model on
    # the same join is held to numpy
    example = ml_fit_checks(np, torch, rec, cat, augs)
    print_fit("ml (example's collinear features, reported)", example)
    wp = ml_drive(torch, M, cat, augs, "cuda", well_posed=True, all_candidates=False)
    check_element(np, wp["element"], ml_design(np, wp["model"], cat), "ml well-posed")
    held = ml_fit_checks(np, torch, wp, cat, augs)
    print_fit("ml (numeric features, held)", held)
    check(held["ok"] and all(r["ok"] for r in held["augmented"]),
          "ml: the well-posed fit disagrees with numpy or its cold baseline past its tolerance")
    host_s = time.perf_counter() - t0
    # the same drive at 60,000 sales on the card and on the CPU
    t0 = time.perf_counter()
    small = schema.favorita(n_sales=ML_CPU_SALES, **ML_WIDTHS)
    small_augs = schema.favorita_augmentations(small, n_per_key=ML_AUG_PER_KEY)
    sg = ml_drive(torch, M, small, small_augs, "cuda")
    sc = ml_drive(torch, M, small, small_augs, "cpu")
    cpu_s = time.perf_counter() - t0
    X_s = ml_design(np, sc["model"], small)
    b2 = tuple(2 * b for b in sum_bound(np, X_s))
    for g, c, b in zip(sg["element"], sc["element"], b2):
        check(bool((np.abs(g.double().numpy() - c.double().numpy()) <= b).all()),
              f"ml at {ML_CPU_SALES} sales: cuda and CPU elements differ past the bound")
    check(abs(sg["base"].r2 - sc["base"].r2) <= ML_COLD_TOL,
          f"ml at {ML_CPU_SALES} sales: R² {sg['base'].r2} on cuda, {sc['base'].r2} on the CPU")
    counts = [[(c["computed"], c["reused"]) for c in r["cands"]] for r in (sg, sc)]
    check(counts[0] == counts[1], f"ml at {ML_CPU_SALES} sales: message counts differ")
    print(f"ml: the drive at {ML_CPU_SALES} sales gives the same message counts, elements "
          f"within their bound and R² {sg['base'].r2:.6f} / {sc['base'].r2:.6f} on cuda and on "
          f"the CPU ({cpu_s:.1f} s; host checks {host_s:.1f} s)", flush=True)
    report["ml"] = dict(
        n_sales=n, k=model.k, fit_ms=rec["fit_ms"], calibrate_ms=rec["cal_ms"],
        calibrate_messages=rec["cal_computed"], peak_mb=rec["peak_mb"], launches=launches,
        candidates=[{k: v for k, v in c.items() if k not in ("weights", "element")}
                    for c in rec["cands"]], cold=rec["cold"], element_max_rel_err=errs,
        example_fit=example, held_fit=held, cpu_sales=ML_CPU_SALES, cpu_s=cpu_s,
    )
    # where the phase's device time goes: one cold fit under the profiler
    profile_phase(torch, "ml", lambda: model.fit_unfactorized_baseline(), report)
    return dict(launches=launches)


# ---------------------------------------------------------------------------
# phase 15: the data cube over the exploration catalog (Fig 24/25)
# ---------------------------------------------------------------------------

CUBE_DIMS = ("carrier_group", "airport_state", "month", "dow")  # bench_cube's dims
CUBE_H = 3
CUBE_PIVOTS = (0, 1, 2)
CUBE_CPU_FLIGHTS = 300_000        # the CPU comparison: benchmarks/bench_cube.py's size


def host_rss_mib() -> float:
    """This process's resident set in MiB (``/proc/self/statm``)."""
    try:
        pages = int(Path("/proc/self/statm").read_text().split()[1])
    except (OSError, IndexError, ValueError):
        return float("nan")
    return pages * os.sysconf("SC_PAGE_SIZE") / 2**20


@contextlib.contextmanager
def host_peak(out: dict, every_s: float = 0.005):
    """Sample the resident set every ``every_s`` while the block runs and
    put the largest sample (MiB) in ``out["peak_mib"]``; a spike shorter
    than the interval can be missed."""
    samples = [host_rss_mib()]
    done = threading.Event()

    def sample():
        while not done.wait(every_s):
            samples.append(host_rss_mib())

    th = threading.Thread(target=sample, daemon=True)
    th.start()
    try:
        yield
    finally:
        done.set()
        th.join()
        samples.append(host_rss_mib())
        out["peak_mib"] = max(samples)


def cube_brute_force(np, cat) -> dict:
    """Every dim's code per flight, for numpy ``bincount`` cuboids."""
    fl, car, ap, dt = (cat.get(n) for n in ("Flights", "Carrier", "Airport", "Dates"))
    return {
        "carrier_group": car.codes["carrier_group"][fl.codes["carrier_id"]].astype(np.int64),
        "airport_state": ap.codes["airport_state"][fl.codes["airport_id"]].astype(np.int64),
        "month": dt.codes["month"][fl.codes["date_id"]].astype(np.int64),
        "dow": dt.codes["dow"][fl.codes["date_id"]].astype(np.int64),
    }


def cube_drive(torch, L, cat, device: str) -> dict:
    """``build_cube`` at every pivot k on fresh engines and stores."""
    jt = L.jt_from_catalog(cat)
    base = L.Query.make(cat, ring="count")
    out = {}
    for k in CUBE_PIVOTS:
        eng = L.CJTEngine(jt, cat, L.sr.COUNT, store=L.MessageStore(), device=device)
        out[k] = L.build_cube(eng, base, CUBE_DIMS, h=CUBE_H, pivot_k=k)
    return out


def cube_phase(torch, np, K, L, cat, report: dict) -> dict:
    gc.collect()
    torch.cuda.empty_cache()
    jt = L.jt_from_catalog(cat)
    base = L.Query.make(cat, ring="count")
    warm = L.CJTEngine(jt, cat, L.sr.COUNT, store=L.MessageStore(), device="cuda")
    L.build_cube(warm, base, CUBE_DIMS[:2], h=1, pivot_k=0)  # first launches and uploads
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(K)
    reps = cube_drive(torch, L, cat, "cuda")
    launches = read_launches(K)
    peak = torch.cuda.max_memory_allocated() / 2**20
    for name in SEGMENT:
        check(launches[name] > 0, f"cube: {name} never launched")
    codes = cube_brute_force(np, cat)
    n = cat.get("Flights").num_rows
    doms = cat.domains()
    for k, rep in reps.items():
        worst = max(rep.query_s.items(), key=lambda kv: kv[1])
        print(f"cube k={k}: calibrate {rep.calibrate_s * 1e3:.1f} ms, {len(rep.cuboids)} "
              f"cuboids {rep.total_query_s * 1e3:.1f} ms in all, worst "
              f"{worst[1] * 1e3:.2f} ms ({'+'.join(worst[0]) or 'apex'}); store "
              f"{rep.store_bytes} B, {rep.messages_computed} messages", flush=True)
        for combo, f in rep.cuboids.items():
            got = f.field.cpu().double().numpy()
            check(float(got.sum()) == n, f"cube k={k} {combo} does not roll up to the apex")
            if combo:
                flat = np.ravel_multi_index([codes[a] for a in combo],
                                            [doms[a] for a in combo])
                want = np.bincount(flat, minlength=int(np.prod([doms[a] for a in combo])))
                check(np.array_equal(got.reshape(-1), want),
                      f"cube k={k} {combo} differs from the numpy brute force")
    t0 = time.perf_counter()
    _, naive = L.naive_cube_cost(
        lambda: L.CJTEngine(jt, cat, L.sr.COUNT, store=L.MessageStore(), device="cuda"),
        base, CUBE_DIMS, CUBE_H)
    naive_s = time.perf_counter() - t0
    print(f"cube: naive (a cold store per cuboid) {sum(naive.values()) * 1e3:.1f} ms over "
          f"{len(naive)} cuboids ({naive_s:.1f} s wall); launches {launches}; peak device "
          f"memory {peak:.1f} MiB; every cuboid equals a numpy bincount", flush=True)
    audit: dict = {}
    t0 = time.perf_counter()
    with kernel_audit(torch, K, L, audit, exact=True):
        cube_drive(torch, L, cat, "cuda")
    print_audit("cube", audit, time.perf_counter() - t0)
    for name in SEGMENT:
        check(audit[name]["checked"] > 0, f"cube: no {name} launch was held")
    t0 = time.perf_counter()
    small = L.flight(n_flights=CUBE_CPU_FLIGHTS)
    gpu_s = cube_drive(torch, L, small, "cuda")
    gc.collect()
    host = dict(before_mib=host_rss_mib())
    with host_peak(host):
        cpu_s = cube_drive(torch, L, small, "cpu")
    for k in CUBE_PIVOTS:
        g, c = gpu_s[k], cpu_s[k]
        check((g.messages_computed, g.store_bytes) == (c.messages_computed, c.store_bytes),
              f"cube k={k} at {CUBE_CPU_FLIGHTS} flights: counters differ")
        for combo, f in g.cuboids.items():
            check(torch.equal(f.field.cpu(), c.cuboids[combo].field),
                  f"cube k={k} {combo} at {CUBE_CPU_FLIGHTS} flights: cuda and CPU differ")
    print(f"cube: the cubes at {CUBE_CPU_FLIGHTS} flights equal the CPU bit for bit with "
          f"equal counters ({time.perf_counter() - t0:.1f} s; resident set {host['before_mib']:.1f} "
          f"MiB before the CPU drive, {host['peak_mib']:.1f} MiB at its sampled peak)",
          flush=True)
    report["cube"] = dict(
        dims=CUBE_DIMS, h=CUBE_H, launches=launches, peak_mb=peak, cpu_flights=CUBE_CPU_FLIGHTS,
        cpu_host_rss_mib=host, naive_ms=
        {"+".join(c) or "apex": s * 1e3 for c, s in naive.items()}, audit=audit,
        pivots={k: dict(calibrate_ms=r.calibrate_s * 1e3, total_query_ms=r.total_query_s * 1e3,
                        query_ms={"+".join(c) or "apex": s * 1e3 for c, s in r.query_s.items()},
                        store_bytes=r.store_bytes, messages_computed=r.messages_computed)
                for k, r in reps.items()},
    )
    return dict(launches=launches)


# ---------------------------------------------------------------------------
# phase 16: offline calibration with unfused levels
# ---------------------------------------------------------------------------

def unfused_spec(L):
    """COUNT and SUM vizzes over the slice's join: their union-carry passes
    share level edges, so a level has groups of several messages."""
    m = ("Opp", "amount")
    V = L.VizSpec
    return L.DashboardSpec(vizzes=(
        V("sum_by_stage", measure=m, ring="sum", group_by=("stage",)),
        V("sum_by_state", measure=m, ring="sum", group_by=("state",)),
        V("sum_by_camp", measure=m, ring="sum", group_by=("camp_type",)),
        V("count_by_title", ring="count", group_by=("title",)),
        V("count_by_role", ring="count", group_by=("role_name",)),
    ))


def int_amount_catalog(np, L, cat):
    """The slice's catalog with Opp's amounts rounded to integers (``amount /
    10000``, total under 2^24): every float sum over it is exact in any
    order, so answers computed two ways must agree bit for bit."""
    opp = cat.get("Opp")
    rounded = np.round(opp.measures["amount"] / 10_000.0).astype(np.float32)
    check(float(rounded.astype(np.float64).sum()) < 2 ** 24,
          "the rounded amounts' total is not exact in float32")
    return L.Catalog([opp.with_version("int_amount", measures={"amount": rounded})]
                     + [cat.get(n) for n in cat.names() if n != "Opp"])


def unfused_phase(torch, np, K, L, icat, report: dict) -> dict:
    """``open_session`` (offline calibration) on the slice's catalog with
    integer amounts (``int_amount_catalog``), fused and with
    ``fuse_level_kernel=False``: both answers must agree bit for bit."""
    # an untimed open first: the rounded Opp is a new version, and its codes
    # upload once for both timed runs
    L.Treant(icat, ring=L.sr.SUM, device="cuda").open_session(unfused_spec(L)).close()
    out, launches = {}, {}
    for fuse in (True, False):
        gc.collect()
        torch.cuda.empty_cache()
        reset_launches(K)
        t = L.Treant(icat, ring=L.sr.SUM, fuse_level_kernel=fuse, device="cuda")
        t0 = time.perf_counter()
        sess = t.open_session(unfused_spec(L), name=f"fuse_{fuse}")
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches[fuse] = read_launches(K)
        answers = {v: sess.read(v).factor.field.cpu() for v in sess.spec.names}
        out[fuse] = dict(ms=ms, plans=t.cache_stats()["plans"], answers=answers)
        sess.close()
    f, u = out[True], out[False]
    for viz, a in f["answers"].items():
        check(torch.equal(a, u["answers"][viz]), f"unfused: {viz} differs from the fused run")
    check(u["plans"]["fused_level_launches"] == 0, "unfused: a fused level launch ran")
    check(u["plans"]["calibration_dispatches"] >= f["plans"]["calibration_dispatches"],
          "unfused: fewer dispatches than the fused run")
    check(launches[False]["level_segment_aggregate"] > 0,
          "unfused: run_message_batch never launched level_segment_aggregate")
    print(f"unfused: open_session {f['ms']:.1f} ms fused, {u['ms']:.1f} ms unfused; "
          f"calibration dispatches {f['plans']['calibration_dispatches']} / "
          f"{u['plans']['calibration_dispatches']}, fused level launches "
          f"{f['plans']['fused_level_launches']} / {u['plans']['fused_level_launches']}, "
          f"level-batched groups {u['plans']['level_batched_execs']} (widest "
          f"{u['plans']['level_batch_width']}); launches {launches[True]} / {launches[False]}; "
          f"{len(f['answers'])} answers equal bit for bit", flush=True)
    report["unfused"] = dict(open_ms={"fused": f["ms"], "unfused": u["ms"]},
                             plans={"fused": f["plans"], "unfused": u["plans"]},
                             launches={"fused": launches[True], "unfused": launches[False]})
    return dict(launches=launches[False])


# ---------------------------------------------------------------------------
# phase 17: sharded execution on virtual meshes of the one card
# ---------------------------------------------------------------------------

SHARD_WIDTHS = (1, 2, 4)           # 1: Treant(mesh=0), the unsharded run
SHARD_ORDER = (1, 2, 4, 4, 2, 1)   # each width twice, in turns
SHARD_TICK_ROWS = 50_000           # rows of the Opp flush tick
SHARD_TICK_WIDTHS = (1, 4)
CHAIN_R, CHAIN_D, CHAIN_SHARDS = 6, 4_096, 4
SHARD_COUNTERS = ("shard_execs", "allreduce_bytes", "shard_imbalance")


def shard_tick_rows(np, rel) -> tuple[dict, dict]:
    """The tick's rows: uniform codes and integer amounts 0-3, so the sums
    stay exact (checked against 2^24 after the tick)."""
    rng = np.random.default_rng(17)
    codes = {a: rng.integers(0, rel.domains[a], SHARD_TICK_ROWS).astype(np.int32)
             for a in rel.attrs}
    return codes, {"amount": rng.integers(0, 4, SHARD_TICK_ROWS).astype(np.float32)}


@contextlib.contextmanager
def folded_bytes(L, out: list):
    """While the block runs, add to ``out`` the bytes of every ⊕-fold's
    result (one partial's payload: what a collective of the fold carries)."""
    real = L.dist.allreduce_field

    def counting(partials, collective):
        res = real(partials, collective)
        stack, nbytes = [res], 0
        while stack:
            x = stack.pop()
            if isinstance(x, (tuple, list)):
                stack.extend(x)
            elif x is not None:
                nbytes += sum(t.numel() * t.element_size() for t in L.sr.leaves(x.field))
        out.append(nbytes)
        return res

    L.dist.allreduce_field = counting
    try:
        yield
    finally:
        L.dist.allreduce_field = real


def shard_event(L):
    return L.SetFilter("state", values=(0, 1, 2, 3, 4), source="sum_by_state")


def sharded_catalog(L, icat, k: int, device: str):
    """A catalog of its own over ``icat``'s relations (a flush commits a new
    Opp version) and the mesh of width k (``0`` for k = 1), after an untimed
    open and interaction that upload the codes and lifts.  Its launches are
    warm-up: the caller sets the counts to 0 after it."""
    cat = L.Catalog([icat.get(n) for n in icat.names()])
    mesh = L.ShardMesh.virtual(k, device) if k > 1 else 0
    warm = L.Treant(cat, ring=L.sr.SUM, mesh=mesh, device=device).open_session(unfused_spec(L))
    warm.apply(shard_event(L))
    warm.close()
    return cat, mesh


def sharded_drive(torch, np, L, cat, mesh, k: int, device: str, tick: bool) -> dict:
    """Phase 16's five vizzes opened, one interaction and (``tick``) one
    50,000-row Opp flush under ``Treant(mesh=mesh)`` on ``cat`` (both from
    ``sharded_catalog``; ``mesh`` is ``ShardMesh.virtual(k, device)``, or
    ``0`` for k = 1).  Returns synced times, the peak device memory from the
    timed open on, answers after the interaction and after the tick, plan
    counters and the bytes of every ⊕-fold."""
    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    folds: list = []
    with folded_bytes(L, folds):
        t = L.Treant(cat, ring=L.sr.SUM, mesh=mesh, device=device)
        t0 = time.perf_counter()
        sess = t.open_session(unfused_spec(L), name=f"shards_{k}")
        sync()
        open_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        sess.apply(shard_event(L))
        sync()
        apply_ms = (time.perf_counter() - t0) * 1e3
        answers = {v: sess.read(v).factor.field.cpu() for v in sess.spec.names}
        rec = dict(k=k, open_ms=open_ms, apply_ms=apply_ms, answers=answers,
                   plans=t.cache_stats()["plans"], folds=list(folds),
                   rels={n: (cat.get(n).num_rows, cat.get(n).row_bucket) for n in cat.names()})
        if tick:
            codes, meas = shard_tick_rows(np, cat.get("Opp"))
            t.stream("Opp").append(codes, measures=meas)
            t0 = time.perf_counter()
            res = t.flush()
            sync()
            rec["flush_ms"] = (time.perf_counter() - t0) * 1e3
            rec["flush"] = _flush_summary(res)
            rec["tick_answers"] = {v: sess.read(v).factor.field.cpu() for v in sess.spec.names}
            rec["tick_plans"], rec["tick_folds"] = t.cache_stats()["plans"], folds
            opp = cat.get("Opp")
            check(float(opp.measures["amount"].astype(np.float64).sum()) < 2 ** 24,
                  "sharded: the amounts' total after the tick is not exact in float32")
    if cuda:
        rec["peak_mb"] = torch.cuda.max_memory_allocated() / 2**20
    sess.close()
    return rec


def sharded_checks(torch, L, runs: dict) -> None:
    """Answers bit-equal to the unsharded run, plan counters equal but the
    shard counters, ``allreduce_bytes`` equal to the folds' bytes and
    ``shard_imbalance`` equal to its formula's worst relation: after the
    interaction and, where both ran it, after the tick."""
    base = runs[1]
    check(base["plans"]["shard_execs"] == 0 and not base["folds"],
          "sharded: the mesh=0 run sharded a dispatch")
    for k, rec in runs.items():
        if k == 1:
            continue
        for key in ("answers", "tick_answers"):
            for viz, a in rec.get(key, {}).items():
                check(torch.equal(a, base[key][viz]),
                      f"sharded k={k}: {viz} differs from mesh=0 ({key})")
        if "flush" in rec:
            check(rec["flush"] == base["flush"], f"sharded k={k}: the tick's counters differ")
        worst = max(L.dist.shard_imbalance(n, b, k) for n, b in rec["rels"].values())
        for stage in ("", "tick_"):
            if stage + "plans" not in rec:
                continue
            plans, folds = rec[stage + "plans"], rec[stage + "folds"]
            what = f"sharded k={k}{' after the tick' if stage else ''}"
            check({c: v for c, v in plans.items() if c not in SHARD_COUNTERS}
                  == {c: v for c, v in base[stage + "plans"].items() if c not in SHARD_COUNTERS},
                  f"{what}: plan counters differ from mesh=0")
            check(plans["shard_execs"] > 0 and plans["shard_execs"] == len(folds),
                  f"{what}: {plans['shard_execs']} sharded dispatches, {len(folds)} folds")
            check(plans["allreduce_bytes"] == sum(folds),
                  f"{what}: allreduce_bytes {plans['allreduce_bytes']} != folded {sum(folds)}")
            if stage:  # the tick's delta relation
                worst = max(worst, L.dist.shard_imbalance(
                    SHARD_TICK_ROWS, L.row_bucket(SHARD_TICK_ROWS), k))
            check(abs(plans["shard_imbalance"] - worst) < 1e-12,
                  f"{what}: shard_imbalance {plans['shard_imbalance']} != {worst}")


def chain_demo(torch, np, L, device: str) -> dict:
    """The domain-sharded chain calibration at r = 6, d = 4,096 on a 4-shard
    virtual mesh against the unsharded ``calibrate_chain_reference``."""
    dist = L.dist
    mesh = dist.ShardMesh.virtual(CHAIN_SHARDS, device, axis="data")
    rng = np.random.default_rng(0)
    factors_np = [rng.random((CHAIN_D, CHAIN_D)).astype(np.float32) for _ in range(CHAIN_R)]
    fwd_ref, bwd_ref = dist.calibrate_chain_reference(
        [torch.from_numpy(f).to(device) for f in factors_np])
    fn = dist.make_chain_calibrate(mesh, "data", CHAIN_R, CHAIN_D)
    placed = dist.place_chain_factors(mesh, "data", factors_np)
    fn(placed)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    fwd, bwd, total = fn(placed)
    if device == "cuda":
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    err = 0.0
    for got, want in zip(fwd + bwd, fwd_ref + bwd_ref):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=0)
        err = max(err, float(((got - want).abs() / want.abs()).max()))
    return dict(r=CHAIN_R, d=CHAIN_D, shards=CHAIN_SHARDS, ms=ms, max_rel_err=err,
                total=float(total))


def sharded_phase(torch, np, K, L, icat, report: dict) -> dict:
    """Phase 17: the sharded plans on virtual meshes of the one card."""
    card = report["card"]
    runs: dict = {k: [] for k in SHARD_WIDTHS}
    launches: dict = {k: [] for k in SHARD_WIDTHS}
    for k in SHARD_ORDER:
        cat, mesh = sharded_catalog(L, icat, k, "cuda")
        reset_launches(K)
        rec = sharded_drive(torch, np, L, cat, mesh, k, "cuda", tick=k in SHARD_TICK_WIDTHS)
        launches[k].append(read_launches(K))
        runs[k].append(rec)
        del cat
        gc.collect()
        torch.cuda.empty_cache()
        plans = rec.get("tick_plans", rec["plans"])
        tick = (f", flush {rec['flush_ms']:.1f} ms" if "flush_ms" in rec else "")
        print(f"sharded ({card}) k={k}: open_session {rec['open_ms']:.1f} ms, interaction "
              f"{rec['apply_ms']:.1f} ms{tick}; peak device memory {rec['peak_mb']:.1f} MiB; "
              f"shard_execs {plans['shard_execs']}, allreduce_bytes {plans['allreduce_bytes']}, "
              f"shard_imbalance {plans['shard_imbalance']:.4f}; launches {launches[k][-1]}",
              flush=True)
    for rep in range(SHARD_ORDER.count(1)):
        sharded_checks(torch, L, {k: runs[k][rep] for k in SHARD_WIDTHS})
    k = max(SHARD_WIDTHS)
    for name in SEGMENT:
        check(launches[k][0][name] > 0, f"sharded k={k}: {name} never launched")
    check(launches[k][0]["level_segment_aggregate"] > launches[1][0]["level_segment_aggregate"],
          f"sharded k={k}: no more level launches than mesh=0")
    opp_n, opp_b = runs[k][0]["rels"]["Opp"]
    print(f"sharded: answers bit-equal to mesh=0 at k = {SHARD_WIDTHS[1:]} and after the "
          f"{SHARD_TICK_ROWS}-row tick; Opp's own imbalance "
          + ", ".join(f"{L.dist.shard_imbalance(opp_n, opp_b, k):.4f} at k={k}"
                      for k in SHARD_WIDTHS[1:]), flush=True)
    audit: dict = {}
    k = max(SHARD_WIDTHS)
    cat, mesh = sharded_catalog(L, icat, k, "cuda")
    t0 = time.perf_counter()
    with kernel_audit(torch, K, L, audit, exact=True):
        again = sharded_drive(torch, np, L, cat, mesh, k, "cuda", tick=True)
    del cat
    print_audit(f"sharded k={k}", audit, time.perf_counter() - t0)
    for name in SEGMENT:
        check(audit[name]["checked"] > 0, f"sharded: no {name} launch was held")
    # a sharded level-plan call launches once per shard (the audit's
    # "split" counts those launches)
    check(min(audit["level_runs"]) >= k, f"sharded: a level-plan call launched fewer than "
          f"{k} times: {audit['level_runs']}")
    for key in ("answers", "tick_answers"):
        for viz, a in again[key].items():
            check(torch.equal(a, runs[k][0][key][viz]), f"sharded: audited {viz} differs ({key})")
    for k in (1, max(SHARD_WIDTHS)):
        cat, mesh = sharded_catalog(L, icat, k, "cuda")
        t = L.Treant(cat, ring=L.sr.SUM, mesh=mesh, device="cuda")
        profile_phase(torch, f"sharded k={k}",
                      lambda: t.open_session(unfused_spec(L), name="profiled"), report)
        del cat, t
        gc.collect()
        torch.cuda.empty_cache()
    chain = chain_demo(torch, np, L, "cuda")
    print(f"sharded ({card}): chain r={chain['r']} d={chain['d']} on {chain['shards']} "
          f"shards {chain['ms']:.1f} ms, max relative error {chain['max_rel_err']:.3g} "
          f"against calibrate_chain_reference (rtol 1e-4)", flush=True)
    report["sharded"] = dict(
        card=card, order=SHARD_ORDER, chain=chain, audit=audit,
        runs={k: [{key: v for key, v in r.items() if key not in ("answers", "tick_answers")}
                  for r in rs] for k, rs in runs.items()},
        launches=launches,
    )
    # the main path's count: the first 4-shard run, counted from 0
    return dict(launches=launches[k][0])


# ---------------------------------------------------------------------------
# phase 18: LM serving (the port of the reference's LM stack)
# ---------------------------------------------------------------------------

LM_TOL = 5e-4                      # card (float32, TF32 off) against the CPU: rtol = atol
LM_SMOKE = (2, 20, 4)              # batch, prompt, decode steps of the ten smoke configs
LM_WIDE = (1, 16, 2)               # ... of stablelm-12b at full width, depth cut to 2
LM_WIDE_LAYERS = 2
LM_SERVE = (4, 64, 32)             # the reference serve entry point's batch, prompt, tokens
BF16_U = 2.0 ** -8                 # bfloat16's unit roundoff
LM_BF16_K = 4.0                    # roundings per sublayer and path the bf16 bound allows
H100_BF16_FLOPS = 989e12           # dense bf16 tensor-core peak (data sheet)


def lm_random_tree(np, LM, cfg, seed: int) -> dict:
    """A numpy value for every parameter leaf (``tests/_torch_lm.py``'s
    recipe): the default init's constants would hide a flipped conv or a
    dead cross-attention gate."""
    rng = np.random.default_rng(seed)

    def build(path: str, spec):
        name = path.rsplit("/", 1)[-1]
        if name.startswith("mu_"):
            return rng.uniform(0.0, 1.0, spec.shape).astype(np.float32)
        if name == "gate":
            return rng.standard_normal(spec.shape).astype(np.float32)
        if spec.init == "normal":
            fan_in = spec.shape[-2] if len(spec.shape) >= 2 else max(spec.shape[-1], 1)
            return (rng.standard_normal(spec.shape) / np.sqrt(fan_in)).astype(np.float32)
        base = {"zeros": 0.0, "ones": 1.0}.get(spec.init)
        base = float(spec.init[6:]) if base is None else base
        return (base + 0.3 * rng.standard_normal(spec.shape)).astype(np.float32)

    return LM.lm.map_specs(LM.lm.param_specs(cfg), build)


def lm_batch(torch, np, cfg, b: int, s: int, seed: int, device) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.input_mode == "embeddings":
        out["embeds"] = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    if cfg.input_mode == "tokens+vision":
        out["vision"] = rng.standard_normal((b, cfg.n_vision_tokens, cfg.d_model)).astype(
            np.float32)
    return {k: torch.as_tensor(v, device=device) for k, v in out.items()}


def lm_run(torch, LM, cfg, params, batch: dict, gen: int, feed=None) -> dict:
    """Prefill, caches padded to S + gen, then ``gen`` decode steps on the
    greedy tokens of ``feed`` (another run's) or, without it, on this run's.
    Returns the logits of every step (prefill first), copies of the prefill
    caches and the greedy tokens, all on the CPU."""
    b, s = next(iter(batch.values())).shape[:2]
    dev = params["head"].device
    prefill, decode = LM.step.make_prefill_step(cfg), LM.step.make_decode_step(cfg)
    logits, caches = prefill(params, batch)
    out = {"logits": [logits.cpu()], "caches": {k: v.cpu().clone() for k, v in caches.items()}}
    caches = LM.serve.pad_caches(caches, s + gen)
    tokens = [logits.argmax(-1).cpu()]
    for i in range(gen):
        if cfg.input_mode == "embeddings":
            db = {"embeds": torch.zeros((b, 1, cfg.d_model), device=dev)}
        else:
            db = {"tokens": (feed or tokens)[i][:, None].to(device=dev, dtype=torch.int32)}
        logits, caches = decode(params, db, caches, s + i)
        out["logits"].append(logits.cpu())
        tokens.append(logits.argmax(-1).cpu())
    out["tokens"] = tokens
    return out


def lm_card_vs_cpu(torch, np, LM, cfg, params_cpu, params_gpu, shape, label: str) -> dict:
    """The same prefill and decode steps on the card and on the CPU (the
    CPU's greedy tokens fed to both): logits and prefill caches within
    LM_TOL, greedy tokens equal."""
    b, s, gen = shape
    cpu = lm_run(torch, LM, cfg, params_cpu, lm_batch(torch, np, cfg, b, s, 2, "cpu"), gen)
    card = lm_run(torch, LM, cfg, params_gpu, lm_batch(torch, np, cfg, b, s, 2, "cuda"), gen,
                  feed=cpu["tokens"])
    errs = {}
    for name, ref in cpu["caches"].items():
        got = card["caches"][name]
        check(torch.allclose(got, ref, rtol=LM_TOL, atol=LM_TOL),
              f"{label}: prefill cache {name} differs from the CPU by {max_abs_err(got, ref):.3g}")
        errs[f"cache_{name}"] = max_abs_err(got, ref)
    for i, (got, ref) in enumerate(zip(card["logits"], cpu["logits"])):
        check(bool(torch.isfinite(got).all()), f"{label}: step {i} logits are not finite")
        check(torch.allclose(got, ref, rtol=LM_TOL, atol=LM_TOL),
              f"{label}: step {i} logits differ from the CPU by {max_abs_err(got, ref):.3g}")
        errs[f"logits_{i}"] = max_abs_err(got, ref)
    same = all(torch.equal(a, b_) for a, b_ in zip(card["tokens"], cpu["tokens"]))
    check(same, f"{label}: greedy tokens differ between the card and the CPU")
    return {"max_abs_err": max(errs.values()), "errs": errs,
            "tokens": torch.stack(cpu["tokens"], 1).tolist()}


def lm_work(cfg, params, b: int, s: int, t_ctx: int) -> dict:
    """Least work of one uniform-pattern step over ``s`` new tokens per row
    (prefill: s = S; decode: s = 1 at context length ``t_ctx``), in the
    params' dtype.  Bytes: every parameter read once except the embedding
    table (its B·s gathered rows), the new K/V written, the cache read up to
    ``t_ctx`` and the float32 logits written.  Operations: 2 per multiply-add
    of the block matmuls for B·s tokens, the head for the B last rows, and
    causal attention (QKᵀ and PV) over the pairs this step needs."""
    lay = params["layers"]
    esz = params["head"].element_size()
    n_all = sum(t.numel() for t in _lm_leaves(params))
    n_mat = sum(t.numel() for t in _lm_leaves(lay) if t.dim() >= 3)
    kv_row = 2 * cfg.n_kv_heads * cfg.d_head * esz * cfg.n_layers     # K and V, every layer
    pairs = b * s * (s + 1) // 2 if s > 1 else b * t_ctx
    flops = (2 * b * s * n_mat + 2 * b * cfg.d_model * cfg.vocab
             + 4 * pairs * cfg.n_heads * cfg.d_head * cfg.n_layers)
    nbytes = ((n_all - cfg.vocab * cfg.d_model) * esz + b * s * cfg.d_model * esz
              + b * s * kv_row + (b * t_ctx * kv_row if s == 1 else 0) + b * cfg.vocab * 4)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / H100_BF16_FLOPS * 1e3
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _lm_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _lm_leaves(v)
    else:
        yield tree


def lm_full_depth(torch, np, LM, report: dict) -> dict:
    """stablelm-12b at full width and depth in bfloat16 through
    ``repro_torch.runtime.step``: timed prefill and greedy decode beside
    their bounds, the teacher-forced check, one profiled decode step."""
    cfg = LM.get_config("stablelm-12b")
    b, s, gen = LM_SERVE
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = LM.lm.init_params(cfg, 0, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 2**20
    n_params = sum(t.numel() for t in _lm_leaves(params))
    check(n_params == cfg.n_params(), f"stablelm-12b has {n_params} parameters, "
          f"n_params() says {cfg.n_params()}")
    weights_mib = sum(t.numel() * t.element_size() for t in _lm_leaves(params)) / 2**20
    toks = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab, (b, s + 1)),
                           dtype=torch.int32, device="cuda")
    prefill, decode = LM.step.make_prefill_step(cfg), LM.step.make_decode_step(cfg)
    torch.cuda.reset_peak_memory_stats()
    batch = {"tokens": toks[:, :s]}
    prefill(params, batch)                                        # warm-up
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = prefill(params, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    prefill_ms = statistics.median(times)
    check(bool(torch.isfinite(logits).all()), "stablelm-12b bf16: prefill logits are not finite")

    # teacher forcing: decode of token S after a prefill of S against the
    # last logits of a prefill of S + 1
    full, _ = prefill(params, {"tokens": toks})
    tf, _ = decode(params, {"tokens": toks[:, s:]}, LM.serve.pad_caches(caches, s + 1), s)
    check(bool(torch.isfinite(tf).all()), "stablelm-12b bf16: decode logits are not finite")
    delta = (tf - full).float()
    rms = lambda x: float(x.pow(2).mean().sqrt())                   # noqa: E731
    scale = BF16_U * math.sqrt(2 * cfg.n_layers + 1) * rms(full)
    tf_rec = {"rms_delta": rms(delta), "max_delta": float(delta.abs().max()),
              "rms_logits": rms(full), "rms_bound": LM_BF16_K * scale,
              "max_bound": 4 * LM_BF16_K * scale,
              "argmax_equal": int((tf.argmax(-1) == full.argmax(-1)).sum())}
    check(tf_rec["rms_delta"] <= tf_rec["rms_bound"] and tf_rec["max_delta"] <= tf_rec["max_bound"],
          f"stablelm-12b bf16: teacher-forced decode differs from prefill by rms "
          f"{tf_rec['rms_delta']:.4g} / max {tf_rec['max_delta']:.4g}, bounds "
          f"{tf_rec['rms_bound']:.4g} / {tf_rec['max_bound']:.4g}")

    warm = LM.serve.pad_caches(caches, s + gen)
    tok = logits.argmax(-1).to(torch.int32)[:, None]
    for i in range(2):                                            # warm-up
        decode(params, {"tokens": tok}, warm, s + i)
    caches = LM.serve.pad_caches(caches, s + gen)
    out = [tok]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(gen):
        step_logits, caches = decode(params, {"tokens": out[-1]}, caches, s + i)
        out.append(step_logits.argmax(-1).to(torch.int32)[:, None])
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    check(bool(torch.isfinite(step_logits).all()), "stablelm-12b bf16: the last logits are not finite")
    serve_peak = torch.cuda.max_memory_allocated() / 2**20
    tokens = torch.cat(out, 1).cpu()
    check(bool(((tokens >= 0) & (tokens < cfg.vocab)).all()), "stablelm-12b: a token is out of vocab")
    pre_w = lm_work(cfg, params, b, s, s)
    dec_w = lm_work(cfg, params, b, 1, s + gen // 2)             # the mean context of the run
    rec = {"layers": cfg.n_layers, "d_model": cfg.d_model, "params": n_params,
           "weights_mib": weights_mib, "init_s": init_s, "init_peak_mib": init_peak,
           "prefill_ms": prefill_ms, "prefill_ms_runs": times, "prefill": pre_w,
           "decode_ms_per_step": decode_s * 1e3 / gen, "decode": dec_w,
           "tokens_per_s": b * gen / decode_s, "bound_tokens_per_s": b * 1e3 / dec_w["bound_ms"],
           "serve_peak_mib": serve_peak, "teacher_forced": tf_rec, "tokens": tokens.tolist()}
    print(f"  stablelm-12b bf16, {cfg.n_layers} layers, {n_params:,} parameters "
          f"({weights_mib:,.1f} MiB), init {init_s:.1f} s (peak {init_peak:,.1f} MiB)", flush=True)
    print(f"  prefill {b}x{s}: {prefill_ms:.3f} ms (runs {', '.join(f'{t:.3f}' for t in times)}); "
          f"bound {pre_w['bound_ms']:.3f} ms ({pre_w['bound_by']}: {pre_w['bytes'] / 1e9:.2f} GB, "
          f"{pre_w['flops'] / 1e12:.3f} TFLOP)", flush=True)
    print(f"  decode: {rec['decode_ms_per_step']:.3f} ms per step over {gen} steps, "
          f"{rec['tokens_per_s']:.1f} tokens/s; bound {dec_w['bound_ms']:.3f} ms per step "
          f"({dec_w['bound_by']}: {dec_w['bytes'] / 1e9:.2f} GB), {rec['bound_tokens_per_s']:.1f} "
          f"tokens/s", flush=True)
    print(f"  peak while serving {serve_peak:,.1f} MiB (weights {weights_mib:,.1f})", flush=True)
    print(f"  teacher-forced decode at {s} against prefill of {s + 1}: rms {tf_rec['rms_delta']:.5f} "
          f"(bound {tf_rec['rms_bound']:.5f}), max {tf_rec['max_delta']:.5f} (bound "
          f"{tf_rec['max_bound']:.5f}), rms logits {tf_rec['rms_logits']:.4f}, argmax equal "
          f"{tf_rec['argmax_equal']}/{b}", flush=True)
    print(f"  greedy tokens: {tokens.tolist()}", flush=True)
    # one decode step at the last position (the whole cache read) under the profiler
    profile_phase(torch, "lm_decode",
                  lambda: decode(params, {"tokens": out[-1]}, caches, s + gen - 1), report)
    return rec


def lm_phase(torch, np, LM, report: dict) -> dict:
    """Phase 18: the ten smoke configs and stablelm-12b at full width (2
    layers), each on the card against the CPU in float32; stablelm-12b at
    full depth in bf16; zamba2-1.2b at full size through the serve entry
    point (float32, the default device)."""
    started = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    rec: dict = {"tolerance": LM_TOL, "smoke": {}}
    try:
        for arch in LM.ALL_ARCHS:
            cfg = LM.smoke_config(LM.get_config(arch))
            tree = lm_random_tree(np, LM, cfg, 1)
            r = lm_card_vs_cpu(torch, np, LM, cfg, LM.convert.params_from_reference(cfg, tree, "cpu"),
                               LM.convert.params_from_reference(cfg, tree, "cuda"), LM_SMOKE, arch)
            rec["smoke"][arch] = r
            print(f"  {arch} smoke: card = CPU, max |err| {r['max_abs_err']:.3g}, tokens "
                  f"{r['tokens'][0]}", flush=True)

        wide = dataclasses.replace(LM.get_config("stablelm-12b"), n_layers=LM_WIDE_LAYERS)
        gpu = LM.lm.init_params(wide, 0, device="cuda")
        cpu = _lm_map(gpu, lambda t: t.cpu())
        r = lm_card_vs_cpu(torch, np, LM, wide, cpu, gpu, LM_WIDE, "stablelm-12b wide")
        del gpu, cpu
        rec["wide"] = dict(r, cut=f"n_layers 40 -> {LM_WIDE_LAYERS}", shape=LM_WIDE)
        print(f"  stablelm-12b at full width (d {wide.d_model}, d_head {wide.d_head}, GQA "
              f"{wide.n_heads}/{wide.n_kv_heads}, vocab {wide.vocab:,}), depth cut 40 -> "
              f"{LM_WIDE_LAYERS} layers, float32: card = CPU, max |err| {r['max_abs_err']:.3g}, "
              f"tokens {r['tokens'][0]}", flush=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    gc.collect()
    torch.cuda.empty_cache()

    rec["full"] = lm_full_depth(torch, np, LM, report)
    gc.collect()
    torch.cuda.empty_cache()

    argv = ["--arch", "zamba2-1.2b", "--no-smoke", "--batch", str(LM_SERVE[0]),
            "--prompt-len", str(LM_SERVE[1]), "--gen", str(LM_SERVE[2])]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    seq = LM.serve.main(argv)
    wall = time.perf_counter() - t0
    zcfg = LM.get_config("zamba2-1.2b")
    check(seq.shape == (LM_SERVE[0], LM_SERVE[2] + 1), f"zamba2-1.2b serve returned {seq.shape}")
    check(bool(((seq >= 0) & (seq < zcfg.vocab)).all()), "zamba2-1.2b serve: a token is out of vocab")
    rec["zamba"] = {"argv": argv, "wall_s": wall, "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
                    "tokens": seq.tolist()}
    print(f"  zamba2-1.2b full size through repro_torch.launch.serve.main (float32, cuda): "
          f"{seq.shape}, {wall:.2f} s wall with init, peak {rec['zamba']['peak_mib']:,.1f} MiB",
          flush=True)
    rec["wall_s"] = time.perf_counter() - started
    print(f"  phase 18: {rec['wall_s']:.1f} s", flush=True)
    report["lm"] = rec
    return rec


def _lm_map(tree, fn):
    if isinstance(tree, dict):
        return {k: _lm_map(v, fn) for k, v in tree.items()}
    return fn(tree)


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
    import types

    import numpy as np

    from repro_torch.core import (
        CJTEngine, ClearFilter, DashboardSpec, Drill, FactorizedLinearRegression, FeatureSpec,
        FixedKPrefetch, MessageStore, PlanCache, PredictiveThinkTime, Query, Session, SetFilter,
        SwapMeasure, ToggleRelation, Treant, Undo, VizSpec, build_cube, insert_empty_bag,
        jt_from_catalog, naive_cube_cost,
    )
    from repro_torch.core import distributed as dist
    from repro_torch.core import semiring as sr
    from repro_torch.kernels import build, launch
    from repro_torch.kernels.segment_aggregate import kernel as seg_kernel
    from repro_torch.kernels.segment_aggregate import ops as seg_ops
    from repro_torch.kernels.segment_aggregate import ref as seg_ref
    from repro_torch.kernels.semiring_contract import kernel as sc_kernel
    from repro_torch.kernels.semiring_contract import ops as sc_ops
    from repro_torch.kernels.semiring_contract import ref as sc_ref
    from repro_torch.kernels.tropical_contract import kernel as tc_kernel
    from repro_torch.kernels.tropical_contract import ops as tc_ops
    from repro_torch.kernels.tropical_contract import ref as tc_ref
    from repro_torch.relational import Catalog, StreamBuffer, schema
    from repro_torch.relational.relation import mask_in, row_bucket
    from repro_torch.relational.sql import parse
    from repro_torch.serve import ServeStats, TreantServer
    from repro_torch import configs as lm_configs
    from repro_torch.configs.base import smoke_config
    from repro_torch.launch import serve as lm_serve
    from repro_torch.models import convert as lm_convert
    from repro_torch.models import lm
    from repro_torch.runtime import step as lm_step

    K = types.SimpleNamespace(
        seg_kernel=seg_kernel, seg_ops=seg_ops, seg_ref=seg_ref, sc_kernel=sc_kernel,
        sc_ops=sc_ops, sc_ref=sc_ref, tc_kernel=tc_kernel, tc_ops=tc_ops, tc_ref=tc_ref,
        launch=launch, build=build,
    )
    L = types.SimpleNamespace(
        Treant=Treant, CJTEngine=CJTEngine, MessageStore=MessageStore, PlanCache=PlanCache,
        DashboardSpec=DashboardSpec, VizSpec=VizSpec, SetFilter=SetFilter,
        ClearFilter=ClearFilter, Drill=Drill, SwapMeasure=SwapMeasure,
        ToggleRelation=ToggleRelation, Undo=Undo, sr=sr, jt_from_catalog=jt_from_catalog,
        StreamBuffer=StreamBuffer, Session=Session, FixedKPrefetch=FixedKPrefetch,
        PredictiveThinkTime=PredictiveThinkTime, TreantServer=TreantServer, ServeStats=ServeStats,
        Query=Query, Catalog=Catalog, build_cube=build_cube, naive_cube_cost=naive_cube_cost,
        flight=schema.flight, dist=dist, ShardMesh=dist.ShardMesh, row_bucket=row_bucket,
    )
    M = types.SimpleNamespace(FactorizedLinearRegression=FactorizedLinearRegression,
                              FeatureSpec=FeatureSpec)
    LM = types.SimpleNamespace(ALL_ARCHS=lm_configs.ALL_ARCHS, get_config=lm_configs.get_config,
                               smoke_config=smoke_config, lm=lm, convert=lm_convert,
                               step=lm_step, serve=lm_serve)
    report: dict = {}
    started = time.perf_counter()
    try:
        card = card_line()
        print(f"card: {card}", flush=True)
        report["card"] = card
        t0 = time.perf_counter()
        build.build()
        report["build_s"] = time.perf_counter() - t0
        print(f"build: {report['build_s']:.1f} s", flush=True)
        print("kernel phase:", flush=True)
        kernel_phase(torch, seg_ops, seg_ref, report)
        contract_kernel_phase(torch, K, report)
        print("host cost of a contract wrapper call:", flush=True)
        host_cost_phase(torch, K, report)
        rt = (Treant, Query, sr, mask_in, parse)
        sliced = slice_phase(torch, np, K, rt, schema, report)
        dense = dense_phase(torch, np, K, rt, sliced, report)
        fig21 = fig21_phase(torch, np, K, (CJTEngine, Query, sr, insert_empty_bag,
                                           jt_from_catalog), schema, report)
        rbar_phase(torch, np, Query, dense["treant"], report)
        print("contract kernels at the dense paths' shapes:", flush=True)
        contract_rows = contract_shapes_phase(
            torch, K, {**dense["captured"], **fig21}, report)
        records = kernel_records(torch, K, sliced, contract_rows, dense)
        print("live dashboards (session and ingest phases):", flush=True)
        live = live_phase(torch, np, K, L, schema, report)
        del live["steps"]
        print("exploration with think-time (phase 12):", flush=True)
        explore = explore_phase(torch, np, K, L, schema, report)
        print("serving tier (phase 13):", flush=True)
        flights = explore.pop("cat")
        served = serve_phase(torch, np, K, L, schema, flights, report)
        print("factorized ML on Favorita (phase 14):", flush=True)
        ml = ml_phase(torch, np, K, M, schema, report)
        print("data cube over the flights (phase 15):", flush=True)
        cube = cube_phase(torch, np, K, L, flights, report)
        del flights
        print("offline calibration with unfused levels (phase 16):", flush=True)
        icat = int_amount_catalog(np, L, sliced["cat"])
        unfused = unfused_phase(torch, np, K, L, icat, report)
        print("sharded execution on virtual meshes (phase 17):", flush=True)
        sharded = sharded_phase(torch, np, K, L, icat, report)
        for r in records:
            r["launches_session"] = live["launches_session"][r["name"]]
            r["launches_ingest"] = live["launches_ingest"][r["name"]]
            r["launches_explore"] = explore["launches"][r["name"]]
            r["launches_serve"] = served["launches"][r["name"]]
            r["launches_ml"] = ml["launches"][r["name"]]
            r["launches_cube"] = cube["launches"][r["name"]]
            r["launches_unfused"] = unfused["launches"][r["name"]]
            r["launches_sharded"] = sharded["launches"][r["name"]]
        # the earlier phases' tensors go before the LM stack's 24 GB of weights
        del sliced, dense, fig21, icat, live, explore, served, ml, cube, unfused, sharded
        gc.collect()
        torch.cuda.empty_cache()
        print("LM serving (phase 18):", flush=True)
        lm_phase(torch, np, LM, report)
    except (SmokeFailure, AssertionError) as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    report["kernels"] = records
    report["total_s"] = time.perf_counter() - started
    print(f"total: {report['total_s']:.1f} s", flush=True)
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
