#!/usr/bin/env python3
"""The contract kernels of an earlier tree against this tree's, on one card.

    python3 tools/contract_old_new.py OLD_ROOT

``OLD_ROOT`` is a copy of the earlier tree in a git-ignored directory, for
example ``mkdir -p build/old && git archive <commit> | tar -x -C build/old``.
The script runs four child processes in turns, old, new, new, old.  Each
imports ``repro_torch`` from one tree's ``src/``, builds that tree's kernels
and, at every shape the dense path and Fig 21 launch (the two record inputs
among them), checks ``semiring_contract`` and ``tropical_contract`` exactly
against the plain version on integer-valued data and times them:

- ``ms``: 50 wrapper calls back to back between CUDA events (what the main path
  pays, host cost included);
- ``device_ms``: the same calls replayed from a CUDA graph, inputs rotated
  past the 50 MB L2 cache (``chip_smoke.device_ms``);
- ``kernel_ms``: the device time of the kernels one call launches (a fill
  included), from ``torch.profiler``, launch gaps excluded;
- ``wrapper_us`` and ``launch_us``: host time of the wrapper call, and of
  the tree's ``kernel.launch`` alone with the output allocated beforehand;
- for float32 sums, ``torch.matmul`` the same two ways.

Both trees get M contiguous; this tree also gets M as a transposed view
(strides (1, G)), the layout its dense plan hands over without a copy.  The
table goes to standard output and ``chiprun_out/contract_old_new.json``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEMIRING = [(16, 100_000, 8), (16, 100_000, 1), (100_000, 16, 1), (1, 50_000, 8),
            (1, 16, 8), (60, 512, 1)]
TROPICAL = [(100_000, 16, 1), (60, 512, 1)]


def child(tree: Path, label: str) -> dict:
    import torch

    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from contract_sweep import profiled_kernel_ms
    from repro_torch.kernels import build
    from repro_torch.kernels.semiring_contract import kernel as sc_kernel
    from repro_torch.kernels.semiring_contract import ops as sc_ops
    from repro_torch.kernels.semiring_contract.ref import semiring_contract_ref
    from repro_torch.kernels.tropical_contract import kernel as tc_kernel
    from repro_torch.kernels.tropical_contract import ops as tc_ops
    from repro_torch.kernels.tropical_contract.ref import tropical_contract_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    build.build()
    new = label == "new"
    dev = torch.device("cuda", torch.cuda.current_device())
    rows = []
    cases = [("semiring_contract", s) for s in SEMIRING] + [("tropical_contract", s)
                                                            for s in TROPICAL]
    for name, (g, b, a) in cases:
        gen = torch.Generator(device=dev).manual_seed(g + 3 * b + 7 * a)
        m = torch.randint(-20, 21, (g, b), generator=gen, device=dev).float()
        r = torch.randint(-20, 21, (b, a), generator=gen, device=dev).float()
        if name == "tropical_contract":
            m[torch.rand(m.shape, generator=gen, device=dev) < 0.3] = float("-inf")
        layouts = [("contiguous", m)] + ([("view", m.t().contiguous().t())] if new else [])
        for layout, mm in layouts:
            out = torch.empty((g, a), device=dev)
            if name == "semiring_contract":
                call, want = sc_ops.contract_op, semiring_contract_ref(mm, r)
                args = (mm, r)
                if new:
                    geom = sc_ops._launch.contract_args(mm, r, (torch.float32,))
                    scratch = sc_kernel.KERNEL.scratch(dev, geom) if geom.ws else (None, None)
                    launch = lambda: sc_kernel.launch(mm, r, None, out, scratch, geom)  # noqa: E731
                else:
                    launch = lambda: sc_kernel.launch(mm, r, None, out)  # noqa: E731
            else:
                call = lambda x, y: tc_ops.contract_op(x, y, is_min=False)  # noqa: E731
                want, args = tropical_contract_ref(mm, r, False), (mm, r)
                if new:
                    geom = tc_ops._launch.contract_args(mm, r, (torch.float32,))
                    scratch = tc_kernel.KERNEL.scratch(dev, geom) if geom.ws else (None, None)
                    launch = lambda: tc_kernel.launch(mm, r, out, scratch, geom,  # noqa: E731
                                                      False)
                else:
                    launch = lambda: tc_kernel.launch(mm, r, out, False)  # noqa: E731
            got = call(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise SystemExit(f"{label} {name} ({g}, {b}) x ({b}, {a}) {layout} disagrees")
            bound, by = cs.contract_bound(g, b, a, tropical=name == "tropical_contract")
            row = dict(kernel=name, g=g, b=b, a=a, layout=layout,
                       ms=cs.time_ms(lambda: call(*args), 50), device_ms=cs.device_ms(call, args),
                       kernel_ms=profiled_kernel_ms(torch, lambda: call(*args)),
                       wrapper_us=cs.host_us(lambda: call(*args)), launch_us=cs.host_us(launch),
                       bound_ms=bound, bound_by=by)
            if name == "semiring_contract":
                row.update(matmul_ms=cs.time_ms(lambda: torch.matmul(mm, r), 50),
                           matmul_device_ms=cs.device_ms(torch.matmul, (mm, r)),
                           matmul_us=cs.host_us(lambda: torch.matmul(mm, r)))
            rows.append(row)
    return {"label": label, "tree": str(tree), "card": cs.card_line(), "rows": rows}


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--child":
        print(json.dumps(child(Path(sys.argv[2]).resolve(), sys.argv[3])))
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    old = Path(sys.argv[1]).resolve()
    if not (old / "src" / "repro_torch").is_dir():
        print(f"{old} holds no src/repro_torch", file=sys.stderr)
        return 2
    runs = []
    for label in ("old", "new", "new", "old"):
        tree = old if label == "old" else ROOT
        proc = subprocess.run([sys.executable, __file__, "--child", str(tree), label],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    print(f"card: {runs[0]['card']}")
    table = {}
    for run in runs:
        for row in run["rows"]:
            key = (row["kernel"], row["g"], row["b"], row["a"], row["layout"])
            table.setdefault(key, {}).setdefault(run["label"], []).append(row)
    keys = ("ms", "device_ms", "kernel_ms", "wrapper_us", "launch_us", "matmul_ms",
            "matmul_device_ms", "matmul_us")
    summary = []
    for (name, g, b, a, layout), by_label in table.items():
        line = dict(kernel=name, g=g, b=b, a=a, layout=layout,
                    bound_ms=next(iter(by_label.values()))[0]["bound_ms"])
        for label, rows in by_label.items():
            for k in keys:
                if k in rows[0]:
                    line[f"{label}_{k}"] = [r[k] for r in rows]
        summary.append(line)
        cells = "  ".join(
            f"{label} ms {statistics.mean(line[f'{label}_ms']):.4f} "
            f"device {statistics.mean(line[f'{label}_device_ms']):.4f} "
            f"kernel {statistics.mean(line[f'{label}_kernel_ms']):.4f}"
            for label in ("old", "new") if f"{label}_ms" in line)
        mm = (f"  matmul ms {statistics.mean(line['new_matmul_ms']):.4f} device "
              f"{statistics.mean(line['new_matmul_device_ms']):.4f}"
              if "new_matmul_ms" in line else "")
        print(f"{name:18s} ({g}, {b}) x ({b}, {a}) {layout:10s} bound {line['bound_ms']:.4f}  "
              f"{cells}{mm}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "contract_old_new.json").write_text(json.dumps({"runs": runs, "summary": summary},
                                                          indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
