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
9. time each kernel on the inputs of its largest main-path launch.

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
import json
import statistics
import subprocess
import sys
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

    from repro_torch.core import CJTEngine, Query, Treant, insert_empty_bag, jt_from_catalog
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
    from repro_torch.relational import schema
    from repro_torch.relational.relation import mask_in
    from repro_torch.relational.sql import parse

    K = types.SimpleNamespace(
        seg_kernel=seg_kernel, seg_ops=seg_ops, seg_ref=seg_ref, sc_kernel=sc_kernel,
        sc_ops=sc_ops, sc_ref=sc_ref, tc_kernel=tc_kernel, tc_ops=tc_ops, tc_ref=tc_ref,
        launch=launch, build=build,
    )
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
