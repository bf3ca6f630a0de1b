#!/usr/bin/env python3
"""The segment kernels of an earlier tree against this tree's, on one card.

    python3 tools/segment_old_new.py OLD_ROOT

``OLD_ROOT`` is a copy of the earlier tree in a git-ignored directory, for
example ``mkdir -p build/old && git archive <commit> | tar -x -C build/old``.
The script runs four child processes in turns, old, new, new, old.  Each
imports ``repro_torch`` from one tree's ``src/``, builds that tree's kernels
and times ``segment_aggregate`` (through ``aggregate_op``) and
``level_segment_aggregate`` (through ``level_aggregate``), checked exactly
against the plain version on integer-valued data first:

- at ``chip_smoke.py`` kernel phase's main shapes: N = 2^24 rows into
  (G, V) = (100,000, 1), (50,000, 3), (12, 8), (16, 1), and the level
  launch of (50,000, 8) and (25,000, 8), for sum and max; and, for sum, at
  one more input per regime of this tree's ``segment_geometry`` (2^24 rows
  into (64, 4), (300, 2) and (1,000, 1); 2^22 rows into (10, 336));
- on the inputs of the quickstart's largest launch of each kernel at 10M
  opportunities (``PERF.md``'s kernel records), for sum and max;
- on the quickstart's largest level launch concatenated into one operand
  (global segment ids, the ⊕-identity in the padding), as the earlier
  tree's ``level_aggregate`` hands it to its kernel: that kernel's time
  without the concatenation (what the earlier tree's ``chip_smoke.py`` timed
  as its kernel record);
- ``ms``: wrapper calls back to back between CUDA events (host cost
  included); ``device_ms``: the calls replayed from a CUDA graph, inputs
  rotated past the 50 MB L2 cache (``chip_smoke.device_ms``);
- the quickstart's wall time (``chip_smoke.quickstart`` on a warm catalog,
  synced), its first run apart: a tree with row orders builds them there
  (and this tree its code-ordered copies of the rowwise inputs); then one
  more warm run under ``torch.profiler`` (``chip_smoke.profile_phase``):
  its device busy time, the gather (``index_select``'s gather kernels) and
  kernels 1 and 2 by device time.

This tree's child also times each sort-regime input in code order (the
values permuted once by its row order, ``ordered=True``, case ``... code
order``; the permutation's own time beside it, and the library call on the
code-ordered inputs), each sort-regime input's row order (``ops.row_order``:
the ``torch.sort`` and the scans) and its bytes, the orders and copies the
first quickstart builds and their bytes, and the one PyTorch call per input
(``index_add_`` / ``scatter_reduce_``).  On the quickstart's launches each
tree times what its own plan hands the kernel (this tree: code-ordered
slabs where the sort regime reduces them).  Each tree also hashes the
gamma-valued sums of one message per regime (``BITS``), and the summary
says which give the earlier tree's bits (this tree's code-ordered form
too).  The table goes to standard output and
``chiprun_out/segment_old_new.json``.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MAIN = [(1 << 24, 100_000, 1), (1 << 24, 50_000, 3), (1 << 24, 12, 8), (1 << 24, 16, 1)]
LEVEL = [(1 << 24, 50_000, 8), (1 << 24, 25_000, 8)]
# one more input per regime of this tree's launch.segment_geometry: thread
# past 48 KiB of copies, thread with column tiles, warp with two columns and
# with one
REGIMES = [(1 << 24, 64, 4), (1 << 22, 10, 336), (1 << 24, 300, 2), (1 << 24, 1000, 1)]
QUICKSTART_RUNS = 5
# gamma-valued sums, one message per regime, whose bits the two trees are
# held to: thread, thread past 48 KiB, warp (two columns, one), sort (one,
# three and eight columns)
BITS = [(1 << 22, 16, 1), (1 << 22, 64, 4), (1 << 22, 300, 2), (1 << 22, 1000, 1),
        (1 << 22, 100_000, 1), (1 << 22, 50_000, 3), (1 << 22, 25_000, 8)]


def child(tree: Path, label: str, first_new: bool) -> dict:
    import torch

    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core import Query, Treant
    from repro_torch.core import semiring as sr
    from repro_torch.kernels import build
    from repro_torch.kernels.segment_aggregate import ops
    from repro_torch.kernels.segment_aggregate.ref import segment_aggregate_ref
    from repro_torch.relational import schema
    from repro_torch.relational.relation import mask_in
    from repro_torch.relational.sql import parse

    new = label == "new"
    build.build()
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(0)

    def message(n, g, v):
        codes = torch.randint(0, g, (n,), generator=gen, device=dev, dtype=torch.int32)
        return codes, torch.randint(-20, 21, (n, v), generator=gen, device=dev).float(), g

    def as_op(items, op):
        if op == "sum":
            return items
        fill = float("inf") if op == "min" else float("-inf")
        return [(c, x.masked_fill(x == 0, fill), g, *rest) for c, x, g, *rest in items]

    rows = []

    def measure(case, name, items, op, exact=True, extra=None):
        run, args = cs.segment_call(ops, name, items, op)
        outs = run(*args)
        outs = outs if isinstance(outs, list) else [outs]
        torch.cuda.synchronize()
        plain = cs.plain_items(ops, items)
        for (c, x, g), o in zip(plain, outs):
            want = segment_aggregate_ref(c, x, g, op)
            ok = torch.equal(o, want) if exact else torch.allclose(o, want, rtol=1e-5, atol=0)
            if not ok:
                raise SystemExit(f"{label} {case} {name} {op} disagrees with the plain version")
        row = dict(case=case, kernel=name, op=op, members=len(items),
                   n=sum(c.shape[0] for c, _, _ in plain), g=sum(g for _, _, g in plain),
                   v=max(x.shape[1] for _, x, _ in plain),
                   ms=cs.time_ms(lambda: run(*args)), device_ms=cs.device_ms(run, args),
                   bound_ms=(cs.items_bound_ms(ops, items) if new else
                             sum(cs.bound_ms(c.shape[0], x.shape[1], g) for c, x, g in plain)),
                   **(extra or {}))
        if first_new:
            cat_codes, cat_vals, total = cs.concatenated(torch, plain, op)
            row["library_ms"] = cs.time_ms(cs.library_call(cat_codes, cat_vals, total, op))
            row["plain_ms"] = cs.time_ms(lambda: [segment_aggregate_ref(c, x, g, op)
                                                  for c, x, g in plain], 3, 3)
        if new:
            from repro_torch.kernels import launch

            row["regimes"] = [launch.segment_geometry(c.shape[0], g, x.shape[1]).name
                              for c, x, g in plain]
            row["code_order"] = [bool(m[3:] and m[3]) for m in items]
            row["orders"] = []
            for (c, x, g, *_), regime in zip(items, row["regimes"]):
                if regime != "sort":
                    continue
                piece = launch.segment_geometry(c.shape[0], g, x.shape[1]).chunk
                order = ops.row_order(c, g, piece)
                row["orders"].append(dict(
                    n=c.shape[0], g=g, nbytes=order.nbytes, n_items=order.n_items,
                    n_splits=order.n_splits,
                    build_ms=cs.time_ms(lambda: ops.row_order(c, g, piece), 1, 5)))
        rows.append(row)

    def both_forms(case, name, items, op):
        """The messages as given, and (this tree) with every sort-regime one
        in code order, the permutation timed on its own."""
        measure(case, name, items, op)
        if not new:
            return
        orders = [ops.code_order(c, g, x.shape[1]) for c, x, g in items]
        if not any(o is not None for o in orders):
            return
        perm_ms = sum(cs.time_ms(lambda: x.index_select(0, o.perm))
                      for (_, x, _), o in zip(items, orders) if o is not None)
        ordered = [(c, x, g) if o is None else (c, x.index_select(0, o.perm), g, True)
                   for (c, x, g), o in zip(items, orders)]
        measure(f"{case}, code order", name, ordered, op, extra={"permutation_ms": perm_ms})

    bits = {}
    gamma = torch.distributions.Gamma(torch.tensor(2.0, device=dev),
                                      torch.tensor(1 / 5000.0, device=dev))
    for n, g, v in BITS:
        torch.manual_seed(n + g + v)
        c = torch.randint(0, g, (n,), device=dev, dtype=torch.int32)
        x = gamma.sample((n, v))
        forms = {"row order": ops.aggregate_op(c, x, g, "sum")}
        order = ops.code_order(c, g, v) if new else None
        if order is not None:
            forms["code order"] = ops.aggregate_op(c, x.index_select(0, order.perm), g, "sum",
                                                   ordered=True)
        bits[f"{n},{g},{v}"] = {k: hashlib.sha256(o.cpu().numpy().tobytes()).hexdigest()
                                for k, o in forms.items()}

    for n, g, v in MAIN:
        base = [message(n, g, v)]
        for op in ("sum", "max"):
            both_forms("kernel phase", "segment_aggregate", as_op(base, op), op)
    for n, g, v in REGIMES:
        both_forms("regime", "segment_aggregate", [message(n, g, v)], "sum")
    base = [message(*spec) for spec in LEVEL]
    for op in ("sum", "max"):
        both_forms("kernel phase", "level_segment_aggregate", as_op(base, op), op)
    del base

    # the quickstart at 10M opportunities: capture each kernel's largest launch
    cat = schema.salesforce(n_opp=200_000 * cs.SCALE, n_user=2_000 * cs.SCALE,
                            n_camp=500 * cs.SCALE, n_acc=1_000 * cs.SCALE)
    rt = (Treant, Query, sr, mask_in, parse)
    captured: dict = {}
    real = {"segment_aggregate": ops.aggregate_op, "level_segment_aggregate": ops.level_aggregate}

    def slab(x, op):
        """A fused member's recipe as the slab it materializes."""
        if isinstance(x, torch.Tensor):
            return x.clone()
        from repro_torch.kernels.segment_aggregate import ref
        return cs.materialize(torch, ref, x, ref.IDENTITY[op])

    def keep(name, items, op):
        size = sum(m[0].numel() * (m[1].lanes if hasattr(m[1], "lanes") else m[1].shape[-1])
                   for m in items)
        if name not in captured or size > captured[name][1]:
            captured[name] = ([(c.clone(), slab(x, op), *rest) for c, x, *rest in items], size,
                              op)

    def aggregate_op(codes, values, num_segments, op="sum", **kw):
        keep("segment_aggregate", [(codes, values if not isinstance(values, torch.Tensor)
                                    or values.dim() == 2 else values[:, None],
                                    num_segments, *kw.values())], op)
        return real["segment_aggregate"](codes, values, num_segments, op, **kw)

    def level_aggregate(items, op="sum"):
        keep("level_segment_aggregate", list(items), op)
        return real["level_segment_aggregate"](items, op=op)

    builds = dict(ops.ORDER_BUILDS) if new else {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cs.quickstart(torch, rt, cat, "cuda")
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    ops.aggregate_op, ops.level_aggregate = aggregate_op, level_aggregate
    try:
        cs.quickstart(torch, rt, cat, "cuda")
    finally:
        ops.aggregate_op, ops.level_aggregate = real["segment_aggregate"], \
            real["level_segment_aggregate"]
    walls = []
    for _ in range(QUICKSTART_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cs.quickstart(torch, rt, cat, "cuda")
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    quick = dict(first_ms=first_s * 1e3, walls_ms=walls, median_ms=statistics.median(walls))
    prof: dict = {}
    cs.profile_phase(torch, "quickstart", lambda: cs.quickstart(torch, rt, cat, "cuda"), prof)
    prof = prof["profile"]["quickstart"]

    def device_ms(*keys, skip=()):
        return sum(r["device_ms"] for r in prof["top"]
                   if all(k in r["name"] for k in keys) and not any(k in r["name"] for k in skip))

    quick["profile"] = dict(
        wall_ms=prof["wall_ms"], busy_ms=prof["device_busy_ms"],
        gather_ms=device_ms("gather_kernel", skip=("scatter",)),
        kernel1_ms=device_ms("segment_aggregate_kernel", skip=("level",)),
        kernel2_ms=device_ms("level_segment_aggregate_kernel"),
        top=[(r["name"][:80], round(r["device_ms"], 3)) for r in prof["top"][:6]])
    if new:
        quick["orders_built"] = ops.ORDER_BUILDS["orders"] - builds["orders"]
        quick["copies_built"] = ops.ORDER_BUILDS["copies"] - builds["copies"]
        bytes_ = ops.cached_bytes()
        quick["order_bytes"], quick["copy_bytes"] = bytes_["orders"], bytes_["copies"]
    for name, (items, _, op) in captured.items():
        for o in (op, "max" if op == "sum" else "sum"):
            measure("quickstart", name, as_op(items, o) if o != op else items, o,
                    exact=o != "sum")
    # the level launch's operands concatenated, as the earlier tree's wrapper
    # hands them to its kernel: that kernel's time without the concatenation
    items, _, op = captured["level_segment_aggregate"]
    codes, values, total = cs.concatenated(torch, cs.plain_items(ops, items), op)
    measure("concatenated", "level_segment_aggregate", [(codes, values, total)], op,
            exact=op != "sum")
    return {"label": label, "tree": str(tree), "card": cs.card_line(), "rows": rows,
            "bits": bits,
            "quickstart": quick}


def main() -> int:
    if len(sys.argv) == 5 and sys.argv[1] == "--child":
        print(json.dumps(child(Path(sys.argv[2]).resolve(), sys.argv[3], sys.argv[4] == "1")))
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    old = Path(sys.argv[1]).resolve()
    if not (old / "src" / "repro_torch").is_dir():
        print(f"{old} holds no src/repro_torch", file=sys.stderr)
        return 2
    runs = []
    first_new = True
    for label in ("old", "new", "new", "old"):
        tree = old if label == "old" else ROOT
        flag = "1" if label == "new" and first_new else "0"
        first_new = first_new and label != "new"
        proc = subprocess.run([sys.executable, __file__, "--child", str(tree), label, flag],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    print(f"card: {runs[0]['card']}")
    table: dict = {}
    for run in runs:
        for row in run["rows"]:
            key = (row["case"], row["kernel"], row["op"], row["n"], row["g"], row["v"])
            table.setdefault(key, {}).setdefault(run["label"], []).append(row)
    summary = []
    for (case, name, op, n, g, v), by_label in table.items():
        new_rows = by_label["new"]
        extra = next(r for r in new_rows if "library_ms" in r)
        line = dict(case=case, kernel=name, op=op, n=n, g=g, v=v,
                    members=new_rows[0]["members"], regimes=new_rows[0]["regimes"],
                    code_order=new_rows[0]["code_order"],
                    bound_ms=new_rows[0]["bound_ms"], library_ms=extra["library_ms"],
                    plain_ms=extra["plain_ms"], orders=new_rows[0]["orders"])
        if "permutation_ms" in new_rows[0]:
            line["permutation_ms"] = [r["permutation_ms"] for r in new_rows]
        for lab in ("old", "new"):  # the code-order cases have no old rows
            line[f"{lab}_ms"] = [r["ms"] for r in by_label.get(lab, [])]
            line[f"{lab}_device_ms"] = [r["device_ms"] for r in by_label.get(lab, [])]
        summary.append(line)
        perm = (f" permutation {[round(x, 4) for x in line['permutation_ms']]}"
                if "permutation_ms" in line else "")
        print(f"{case:12s} {name:24s} {op:3s} N={n:>9d} G={g:>6d} V={v} "
              f"({'+'.join(line['regimes'])}{', code order' if any(line['code_order']) else ''}) "
              f"old ms {line['old_ms']} device {line['old_device_ms']}  new ms {line['new_ms']} "
              f"device {line['new_device_ms']}  bound {line['bound_ms']:.4f} plain "
              f"{line['plain_ms']:.3f} library {line['library_ms']:.4f}{perm}")
        for o in line["orders"]:
            print(f"    row order N={o['n']} G={o['g']}: {o['build_ms']:.3f} ms, "
                  f"{o['nbytes']} B, {o['n_items']} items, {o['n_splits']} split segments")
    for run in runs:
        q = run["quickstart"]
        pr = q["profile"]
        print(f"quickstart {run['label']} profiled: {pr['wall_ms']:.1f} ms wall, busy "
              f"{pr['busy_ms']:.1f} ms, gather {pr['gather_ms']:.2f} ms, kernel 1 "
              f"{pr['kernel1_ms']:.3f} ms, kernel 2 {pr['kernel2_ms']:.3f} ms; top {pr['top']}")
        print(f"quickstart {run['label']}: first run {q['first_ms']:.1f} ms, then "
              f"{[round(w, 1) for w in q['walls_ms']]} ms (median {q['median_ms']:.1f})"
              + (f"; {q['orders_built']} row orders built, {q['order_bytes']} B; "
                 f"{q['copies_built']} code-ordered copies, {q['copy_bytes']} B"
                 if "orders_built" in q else ""))
    old_bits = next(r["bits"] for r in runs if r["label"] == "old")
    new_bits = next(r["bits"] for r in runs if r["label"] == "new")
    for key, forms in new_bits.items():
        same = {form: digest == old_bits[key]["row order"] for form, digest in forms.items()}
        print(f"bits N,G,V={key} (gamma sum): same as the earlier tree's {same}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "segment_old_new.json").write_text(json.dumps(
        {"card": runs[0]["card"], "summary": summary, "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
