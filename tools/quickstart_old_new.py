#!/usr/bin/env python3
"""The quickstart's warm wall time on an earlier tree against this tree's.

    python3 tools/quickstart_old_new.py OLD_ROOT [PAIRS]

``OLD_ROOT`` is a copy of the earlier tree in a git-ignored directory (as
for ``tools/segment_old_new.py``).  The script runs child processes in
turns, old, new, new, old, ``PAIRS`` times (3 by default).  Each imports
``repro_torch`` from one tree's ``src/``, builds that tree's kernels, makes
``chip_smoke.py``'s slice catalog (``schema.salesforce`` x50: 10M
opportunities), runs ``chip_smoke.quickstart`` once on the card (the first
run: a tree with row orders builds them there) and then ``RUNS`` more
times, each timed on the host's clock up to a device sync, with the device
memory segments the caching allocator had to allocate during the run
(``cudaMalloc`` calls) and their sizes.  On a tree with code-ordered
slabs it also times, on the host's clock, the plan layer's calls into them
(``code_order``, ``in_code_order``) in each warm run.  Last, one more warm
run goes under ``cProfile``: its functions with the most host time.  It
prints every child's runs, and per tree the median and quartiles of all its
warm runs; the table goes to ``chiprun_out/quickstart_old_new.json`` too.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RUNS = 10


def timed(module, names: list, spent: dict) -> None:
    """Wrap ``module``'s functions ``names`` to add their calls and host
    seconds to ``spent[name]``."""
    for name in names:
        real = getattr(module, name)

        def wrapper(*args, _real=real, _name=name, **kw):
            t0 = time.perf_counter()
            try:
                return _real(*args, **kw)
            finally:
                spent[_name][0] += 1
                spent[_name][1] += time.perf_counter() - t0

        setattr(module, name, wrapper)


def segments(torch) -> dict:
    """The caching allocator's device segments: address -> bytes."""
    return {seg["address"]: seg["total_size"] for seg in torch.cuda.memory_snapshot()}


def profiled(run) -> list:
    """``run()`` under cProfile: the 40 functions with the most cumulative
    host time, then the 30 with the most of their own, as (function, calls,
    own s, cumulative s)."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    run()
    prof.disable()
    stats = pstats.Stats(prof).stats
    rows = (sorted(stats.items(), key=lambda kv: -kv[1][3])[:40]
            + sorted(stats.items(), key=lambda kv: -kv[1][2])[:30])
    return [(f"{Path(f).name}:{line} {fn}", nc, round(tt, 6), round(ct, 6))
            for (f, line, fn), (_, nc, tt, ct, _) in rows]


def child(tree: Path) -> dict:
    import torch

    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core import Query, Treant
    from repro_torch.core import semiring as sr
    from repro_torch.kernels import build
    from repro_torch.relational import schema
    from repro_torch.relational.relation import mask_in
    from repro_torch.relational.sql import parse

    from repro_torch.kernels.segment_aggregate import ops

    build.build()
    names = [n for n in ("code_order", "in_code_order") if hasattr(ops, n)]
    spent = {n: [0, 0.0] for n in names}
    timed(ops, names, spent)
    cat = schema.salesforce(n_opp=200_000 * cs.SCALE, n_user=2_000 * cs.SCALE,
                            n_camp=500 * cs.SCALE, n_acc=1_000 * cs.SCALE)
    rt = (Treant, Query, sr, mask_in, parse)
    walls, mallocs, sizes, host = [], [], [], []
    for _ in range(RUNS + 1):
        torch.cuda.synchronize()
        allocated = torch.cuda.memory_stats().get("segment.all.allocated", 0)
        held = segments(torch)
        for n in names:
            spent[n] = [0, 0.0]
        t0 = time.perf_counter()
        cs.quickstart(torch, rt, cat, "cuda")
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        mallocs.append(torch.cuda.memory_stats().get("segment.all.allocated", 0) - allocated)
        sizes.append(sorted(b for a, b in segments(torch).items() if a not in held))
        host.append({n: (calls, round(sec * 1e3, 4)) for n, (calls, sec) in spent.items()})
    top = profiled(lambda: (cs.quickstart(torch, rt, cat, "cuda"), torch.cuda.synchronize()))
    return {"card": cs.card_line(), "first_ms": walls[0], "walls_ms": walls[1:],
            "first_mallocs": mallocs[0], "mallocs": mallocs[1:], "malloc_bytes": sizes[1:],
            "code_order_host": host[1:], "profile_top": top}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        print(json.dumps(child(Path(sys.argv[2]).resolve())))
        return 0
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    old = Path(sys.argv[1]).resolve()
    if not (old / "src" / "repro_torch").is_dir():
        print(f"{old} holds no src/repro_torch", file=sys.stderr)
        return 2
    pairs = int(sys.argv[2]) if len(sys.argv) == 3 else 3
    runs = []
    for label in ("old", "new", "new", "old") * pairs:
        proc = subprocess.run([sys.executable, __file__, "--child",
                               str(old if label == "old" else ROOT)],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        run = dict(json.loads(proc.stdout.strip().splitlines()[-1]), label=label)
        runs.append(run)
        print(f"{label}: first run {run['first_ms']:.1f} ms ({run['first_mallocs']} cudaMalloc), "
              f"then {[round(w, 1) for w in run['walls_ms']]} ms ({run['mallocs']} cudaMalloc: "
              f"{[s for s in run['malloc_bytes'] if s]} B); code-order host (calls, ms) "
              f"{run['code_order_host'][-1]}", flush=True)
    print(f"card: {runs[0]['card']}")
    summary = {}
    for label in ("old", "new"):
        walls = sorted(w for r in runs if r["label"] == label for w in r["walls_ms"])
        q1, med, q3 = statistics.quantiles(walls, n=4)
        summary[label] = dict(median_ms=med, q1_ms=q1, q3_ms=q3, runs=len(walls),
                              first_ms=[r["first_ms"] for r in runs if r["label"] == label])
        print(f"{label}: {len(walls)} warm runs, median {med:.1f} ms, quartiles {q1:.1f} / "
              f"{q3:.1f} ms; first runs {[round(x, 1) for x in summary[label]['first_ms']]} ms")
    for label in ("old", "new"):
        run = next(r for r in runs if r["label"] == label)
        print(f"{label}: one warm run under cProfile, by cumulative host time, then by "
              f"own host time:")
        for name, calls, own, cum in run["profile_top"]:
            print(f"    {cum * 1e3:9.2f} ms cum {own * 1e3:8.2f} ms own {calls:7d} calls  {name}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "quickstart_old_new.json").write_text(json.dumps(
        {"card": runs[0]["card"], "summary": summary, "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
