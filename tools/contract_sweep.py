#!/usr/bin/env python3
"""Sweep the wide regime's launch geometry of the contract kernels.

    python3 tools/contract_sweep.py

The launch geometry is Python (``repro_torch/kernels/launch.py``), so a
setting changes without a rebuild.  For every record shape of the dense path
with M contiguous and as a transposed view, the script tries each setting of
``launch.WIDE_BLOCKS``, ``launch.WIDE_MIN_CHUNK`` and ``launch.WIDE_CLUSTER``
in ``SETTINGS``, and keeps only those that give the shape a launch not seen
before (the cluster cap, for one, changes only grids of at most 8 blocks).
Each launch is checked exactly against the plain version on integer-valued
data, then timed two ways: the kernel time per call from ``torch.profiler``
(over 50 calls, launch gaps excluded) and ``device_ms`` (CUDA-graph replay,
inputs rotated past L2, launch gaps included; ``chip_smoke.device_ms``).
The tall shapes run once, as a yardstick.  Output: a table on standard
output and ``chiprun_out/contract_sweep.json``.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WIDE = [(16, 100_000, 8), (16, 100_000, 1), (1, 50_000, 8), (60, 512, 1)]
TALL = [(100_000, 16, 1), (100_000, 16, 8)]
# (WIDE_BLOCKS, WIDE_MIN_CHUNK, WIDE_CLUSTER): the committed setting first
SETTINGS = [(264, 64, 8), (132, 64, 8), (528, 64, 8), (264, 64, 1),
            (264, 256, 8), (264, 512, 8), (264, 1024, 8), (264, 4096, 8)]
KNOBS = ("WIDE_BLOCKS", "WIDE_MIN_CHUNK", "WIDE_CLUSTER")


def profiled_kernel_ms(torch, fn, calls: int = 50) -> float:
    """Device kernel time per ``fn()`` call, from the profiler: the durations
    of everything the calls run on the device (a fill included), summed,
    over ``calls``; launch gaps are not counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    return sum(spans) / calls / 1e3 if spans else float("nan")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("contract_sweep: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build, launch
    from repro_torch.kernels.semiring_contract import ops
    from repro_torch.kernels.semiring_contract.ref import semiring_contract_ref

    build.build()
    dev = torch.device("cuda", torch.cuda.current_device())
    rows = []
    default = tuple(getattr(launch, k) for k in KNOBS)

    def use(setting):
        for k, v in zip(KNOBS, setting):
            setattr(launch, k, v)
        launch.contract_geometry.cache_clear()

    for shape, layout in [(s, lay) for s in WIDE + TALL for lay in ("contiguous", "view")]:
        g, b, a = shape
        gen = torch.Generator(device=dev).manual_seed(g + b + a)
        m = torch.randint(-20, 21, (g, b), generator=gen, device=dev).float()
        if layout == "view":
            m = m.t().contiguous().t()
        r = torch.randint(-20, 21, (b, a), generator=gen, device=dev).float()
        want = semiring_contract_ref(m, r)
        seen = []
        for setting in SETTINGS if shape in WIDE else [default]:
            use(setting)
            geo = launch.contract_args(m, r, (torch.float32,))
            if geo.fields in seen:
                continue
            seen.append(geo.fields)
            got = ops.contract_op(m, r)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise SystemExit(f"{shape} with {dict(zip(KNOBS, setting))} disagrees")
            row = dict(shape=shape, layout=layout, regime=geo.regime, **dict(zip(KNOBS, setting)),
                       blocks=geo.fields["grid_x"], cluster=geo.fields["cluster"],
                       bound_ms=cs.contract_bound(g, b, a)[0],
                       kernel_ms=profiled_kernel_ms(torch, lambda: ops.contract_op(m, r)),
                       device_ms=cs.device_ms(ops.contract_op, (m, r)))
            rows.append(row)
            print(f"{str(shape):20s} {layout:10s} {row['regime']:5s} {setting} "
                  f"({row['blocks']:4d} blocks, cluster {row['cluster']})  "
                  f"kernel {row['kernel_ms']:.4f} ms  device {row['device_ms']:.4f} ms  "
                  f"bound {row['bound_ms']:.4f} ms", flush=True)
    use(default)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "contract_sweep.json").write_text(json.dumps({"card": cs.card_line(), "rows": rows},
                                                        indent=1))
    print(f"card: {cs.card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
