"""The multi-pod dry-run's host side: every (arch × shape) cell's abstract
inputs, placements, per-device bytes and matrix-product FLOPs, on ``meta``
tensors that allocate nothing.

The reference lowers and compiles each cell for the production meshes (256
and 512 forced host devices) and reads XLA's memory analysis, cost analysis
and collective schedule.  What one process can do without those devices is
done here:

  - **Inputs** are ``runtime.sharding.AbstractTensor``s under the production
    rules (``input_specs``): a ``meta`` tensor and its placement each.
  - **Memory**: ``argument_bytes`` is one device's share of the parameters,
    optimizer state, batch and caches under their placements;
    ``output_bytes`` that of the step's outputs (train: the new parameters
    and state under the inputs' placements, metrics replicated; prefill and
    decode: logits and caches under the reference prefill's
    ``out_shardings``).  Temp, alias and peak bytes come from XLA's
    ``memory_analysis`` and are ``null``.
  - **FLOPs** (``cost_raw.flops``): ``runtime.compat.compiled_flops`` of the
    cell's step (train with its microbatches, prefill, or one decode step)
    run on the meta tensors at full depth: the whole step's matrix products,
    every layer and microbatch counted (XLA counts a scanned body once).
    Attention and the loss run chunk-free (one block per layer): the port's
    chunked attention computes every block, fully masked ones too, so the
    matrix-product work is that of the production chunking — the CPU tests
    hold the two counts equal, and ``chip_smoke.py`` holds this count equal
    to a real train step's on the card.  ``bytes_accessed`` and the
    collective schedule come from XLA and are ``null``.
  - **Analysis** (``run_analysis``): the reference's 1/2-unit grid — the
    same cell at 1 and 2 layer units with every scan in its batched form and
    chunk-free attention and loss — extrapolated as
    ``total = c1 + (c2 - c1)·(units - 1)``.  The record states how far the
    direct count is from it.

Stays TPU-only: the XLA compile itself, ``memory_analysis()``'s temp,
output and alias bytes, the HLO collective parse and its wire-byte model,
and the ``bytes`` analysis grid.

Usage:
  python -m repro_torch.launch.dryrun --arch dbrx-132b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all            # every cell, both meshes
  python -m repro_torch.launch.dryrun --cell treant    # the paper's own workload

``--all`` runs the cells in worker processes, one per CPU; each cell has
``--timeout`` seconds, and a cell that fails or runs out of time gets an
``error`` record.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import os
import signal
import sys
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"

XLA_ONLY = "XLA's memory_analysis / cost_analysis / compiled HLO: no PyTorch counterpart"


# ---------------------------------------------------------------------------
# Cell construction
# ---------------------------------------------------------------------------

def arch_overrides(name: str, shape_name: str) -> dict:
    """Per-cell production-compile knobs (memory dials; see EXPERIMENTS.md)."""
    out: dict = {}
    if name == "nemotron-4-340b" and shape_name == "train_4k":
        out["scan_groups"] = 12      # √L nested remat
    if name == "llama-3.2-vision-90b" and shape_name == "prefill_32k":
        out["attn_q_chunk"] = 1024
    return out


def train_accum(name: str, shape_name: str) -> int:
    """Microbatch accumulation per arch: the HBM dial that brings every
    train cell under the 16 GiB/chip budget (EXPERIMENTS.md §Dry-run)."""
    if shape_name != "train_4k":
        return 1
    return {
        "nemotron-4-340b": 8,
        "llama-3.2-vision-90b": 8,
        "deepseek-coder-33b": 4,
        "dbrx-132b": 4,
        "nemotron-4-15b": 2,
        "stablelm-12b": 2,
        "rwkv6-7b": 2,
        "zamba2-1.2b": 2,
    }.get(name, 1)


def unit_layers(cfg, k: int) -> int:
    """Layer count for k pattern units (differencing grid)."""
    if cfg.pattern == "vlm":
        return k * cfg.cross_every
    if cfg.pattern == "zamba":
        ng, per, tail = _zamba_layout(cfg)
        return k * per + tail
    return k


def n_units(cfg) -> int:
    if cfg.pattern == "vlm":
        return cfg.n_layers // cfg.cross_every
    if cfg.pattern == "zamba":
        ng, per, tail = _zamba_layout(cfg)
        return ng
    return cfg.n_layers


def _zamba_layout(cfg):
    per = cfg.shared_attn_every
    ng = cfg.n_layers // per
    return ng, per, cfg.n_layers - ng * per


def chunk_free(cfg, shape):
    """``cfg`` with attention and the loss in one chunk of the sequence
    (``divide`` mode keeps its recursion: its depth sets the FLOPs, and its
    flash sub-blocks are single-iteration at q_chunk = S)."""
    seq = shape.seq_len if shape.kind != "decode" else 1
    over = dict(attn_q_chunk=max(seq, 16), attn_kv_chunk=max(seq, 16), loss_chunk=max(seq, 16))
    if cfg.attn_mode != "divide":
        over["attn_min_block"] = max(seq, 16)
    return dataclasses.replace(cfg, **over)


def analysis_cfg(cfg, k_units: int, shape, grid: str = "flops"):
    """Two analysis grids (DESIGN.md §8):

    - ``flops``: every loop unrolled/vectorized, attention chunk-free —
      trip-count-exact FLOPs (identical matmul work to production).
    - ``bytes``: production attention chunking with layer/moe/loss loops
      unrolled (the reference's byte and collective grid; only its config
      is built here).
    """
    cfg = dataclasses.replace(cfg, n_layers=unit_layers(cfg, k_units), unroll_scans=True,
                              scan_groups=None)
    return chunk_free(cfg, shape) if grid == "flops" else cfg


def skip_reason(cfg, shape) -> str | None:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return (
            "full-attention arch: 500k-context decode requires sub-quadratic "
            "attention (brief: skip for pure full-attention archs)"
        )
    return None


def input_specs(arch: str, shape_name: str = "train_4k", mesh=None):
    """``AbstractTensor`` stand-ins for every model input of a cell: shardable,
    no allocation.  For training that's {tokens, labels}; embeddings/vision
    stubs for the [audio]/[vlm] archs; decode shapes add the KV/state cache
    skeletons."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.runtime.sharding import batch_specs, make_rules
    from repro_torch.runtime.step import abstract_caches

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh = mesh or make_production_mesh()
    rules = make_rules(mesh, shape)
    out = batch_specs(cfg, shape, rules, "bfloat16")
    if shape.kind == "decode":
        out["caches"] = abstract_caches(cfg, shape, rules)
    return out


def _tree_bytes(values, shardings) -> int:
    """One device's bytes of a tree of tensors under a tree of shardings."""
    from repro_torch import tree as T

    return sum(T.leaves(T.map_leaves(lambda t, sh: sh.shard_bytes(t), values, shardings)))


def lower_cell(cfg, shape, mesh, rules, accum: int):
    """Build the cell's abstract inputs and run its step on their meta
    tensors under the FLOP counter.  Returns ``(costs, meta)``: ``costs``
    holds ``flops`` (the whole step's matrix products), ``argument_bytes``
    and ``output_bytes`` (one device's share under the placements)."""
    from repro_torch.models.lm import param_specs
    from repro_torch.optim.adamw import AdamWConfig, opt_state_specs
    from repro_torch.runtime import compat
    from repro_torch.runtime.sharding import (
        NamedSharding, Placement, batch_specs, device_bytes, metas, tree_abstract,
        tree_shardings,
    )
    from repro_torch.runtime.step import (
        abstract_caches, abstract_train_state, make_decode_step, make_prefill_step,
        make_train_step, output_shardings,
    )

    inputs = {"batch": batch_specs(cfg, shape, rules, "bfloat16")}
    if shape.kind == "train":
        opt_cfg = AdamWConfig()
        inputs["params"], inputs["opt"] = abstract_train_state(cfg, opt_cfg, rules)
        step = make_train_step(cfg, opt_cfg, rules, accum=accum)
        order = ("params", "opt", "batch")
    else:
        inputs["params"] = tree_abstract(param_specs(cfg), rules, "bfloat16")
        if shape.kind == "prefill":
            step = make_prefill_step(cfg, rules, shape)
            order = ("params", "batch")
        else:
            inputs["caches"] = abstract_caches(cfg, shape, rules)
            step = make_decode_step(cfg, rules)
            order = ("params", "batch", "caches")
    args = [metas(inputs[k]) for k in order]
    if shape.kind == "decode":
        # the write position: the cache's last slot (attention reads the
        # whole cache, masked, whatever the position)
        args.append(shape.seq_len - 1)
    result = {}

    def run():
        result["out"] = step(*args)

    flops = compat.compiled_flops(run)
    if shape.kind == "train":
        new_params, new_opt, metrics = result["out"]
        replicated = NamedSharding(rules.mesh, Placement())
        out_bytes = (_tree_bytes(new_params, tree_shardings(param_specs(cfg), rules))
                     + _tree_bytes(new_opt, tree_shardings(opt_state_specs(cfg, opt_cfg), rules))
                     + sum(replicated.shard_bytes(m) for m in metrics.values()))
    else:
        logits, caches = result["out"]
        logits_sh, cache_sh = output_shardings(cfg, rules, shape)
        out_bytes = logits_sh.shard_bytes(logits) + _tree_bytes(caches, cache_sh)
    costs = {"flops": flops, "argument_bytes": device_bytes(inputs), "output_bytes": out_bytes}
    return costs, {"accum": accum}


def parse_overrides(sets) -> dict:
    """--set key=value perf-variant overrides (nested: moe.group=64)."""
    out: dict = {}
    for kv in sets or []:
        key, val = kv.split("=", 1)
        try:
            val = int(val)
        except ValueError:
            try:
                val = float(val)
            except ValueError:
                pass
        out[key] = val
    return out


def apply_overrides(cfg, overrides: dict):
    moe_over = {k.split(".", 1)[1]: v for k, v in overrides.items() if k.startswith("moe.")}
    flat = {k: v for k, v in overrides.items() if "." not in k}
    if moe_over and cfg.moe is not None:
        flat["moe"] = dataclasses.replace(cfg.moe, **moe_over)
    return dataclasses.replace(cfg, **flat)


def run_cell(arch: str, shape_name: str, mesh_kind: str, analysis: bool = True,
             overrides: dict | None = None) -> dict:
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.runtime.sharding import make_rules

    cfg0 = get_config(arch)
    shape = SHAPES[shape_name]
    rec: dict = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "timestamp": time.time(),
    }
    reason = skip_reason(cfg0, shape)
    if reason:
        rec["status"] = "skipped"
        rec["reason"] = reason
        return rec

    mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
    rules = make_rules(mesh, shape)
    cfg = dataclasses.replace(cfg0, **arch_overrides(arch, shape_name))
    accum = train_accum(arch, shape_name)
    overrides = dict(overrides or {})
    if overrides:
        accum = int(overrides.pop("accum", accum))
        cfg = apply_overrides(cfg, overrides)
        rec["overrides"] = {**overrides, "accum": accum}

    t0 = time.time()
    costs, meta = lower_cell(chunk_free(cfg, shape), shape, mesh, rules, accum)
    rec["lower_s"] = time.time() - t0
    rec["compile_s"] = None
    rec["memory"] = {
        "argument_bytes": costs["argument_bytes"],
        "output_bytes": costs["output_bytes"],
        "temp_bytes": None,
        "alias_bytes": None,
        "peak_per_device_bytes": None,
    }
    rec["cost_raw"] = {"flops": costs["flops"], "bytes_accessed": None}
    rec["collectives_schedule"] = None
    rec["null_reason"] = XLA_ONLY
    rec["flops_scope"] = ("the whole step (every device), matrix products only, counted on "
                          "meta tensors at full depth with attention and loss chunk-free")
    rec["meta"] = meta
    rec["status"] = "ok"

    if analysis and mesh_kind == "single":
        # the roofline table is single-pod
        rec["analysis"] = run_analysis(cfg, shape, mesh, rules)
        extr = rec["analysis"]["extrapolated"]["flops"]
        rec["analysis"]["direct_minus_extrapolated"] = costs["flops"] - extr
    return rec


def run_analysis(cfg, shape, mesh, rules) -> dict:
    """1/2-unit differencing on the ``flops`` grid (the ``bytes`` grid and
    the collective bytes need XLA: ``null``)."""
    units = n_units(cfg)
    costs: dict = {}
    for k in (1, 2):
        c, _ = lower_cell(analysis_cfg(cfg, k, shape, grid="flops"), shape, mesh, rules, accum=1)
        costs[k] = {"flops": c["flops"]}
    c1, c2 = costs[1]["flops"], costs[2]["flops"]
    extr: dict = {"flops": c1 + (c2 - c1) * (units - 1), "flops_per_unit": c2 - c1}
    for key in ("bytes", "operand_bytes", "wire_bytes"):
        extr[key] = extr[f"{key}_per_unit"] = None
    return {"units": units, "unit_costs": costs, "extrapolated": extr, "null_reason": XLA_ONLY}


# ---------------------------------------------------------------------------
# The paper's own workload: distributed CJT calibration on the mesh
# ---------------------------------------------------------------------------

def run_treant_cell(mesh_kind: str, n_measures: int = 1, r: int = 8, d: int = 65536) -> dict:
    """The domain-sharded chain calibration (r factors of (d, d), the
    Appendix D.3 shape) over the production mesh's 16-way ``data`` axis, run
    on a 16-shard ``meta`` mesh.  Per device: argument bytes under the
    factors' placements and FLOPs (the shards' count over the shard count;
    every shard does the same work)."""
    from repro_torch.core.distributed import (
        ShardMesh, chain_factor_specs, chain_multi_specs, make_chain_calibrate,
        make_chain_calibrate_multi, place_rows,
    )
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.runtime import compat
    from repro_torch.runtime.sharding import NamedSharding, Placement

    axis = "data"
    prod = make_production_mesh(multi_pod=mesh_kind == "multi")
    n = prod.shape[axis]
    mesh = ShardMesh.virtual(n, "meta", axis=axis)
    row_sharded = NamedSharding(prod, Placement(axis))
    rec = {"arch": "treant_dashboard", "shape": f"chain_r{r}_d{d}", "mesh": mesh_kind,
           "n_measures": n_measures, "timestamp": time.time()}
    if n_measures > 1:
        fn = make_chain_calibrate_multi(mesh, axis, r, d, n_measures)
        factors, leaf = chain_multi_specs(mesh, axis, r, d, n_measures)
        inputs = factors + [leaf]
        args = ([place_rows(f, mesh) for f in factors], place_rows(leaf, mesh))
    else:
        fn = make_chain_calibrate(mesh, axis, r, d)
        inputs = chain_factor_specs(mesh, axis, r, d)
        args = ([place_rows(f, mesh) for f in inputs],)
    t0 = time.time()
    flops = compat.compiled_flops(fn, *args)
    rec["lower_s"] = time.time() - t0
    rec["compile_s"] = None
    rec["memory"] = {"argument_bytes": sum(row_sharded.shard_bytes(t) for t in inputs),
                     "temp_bytes": None}
    rec["cost_raw"] = {"flops": flops / n, "bytes_accessed": None}
    rec["collectives_schedule"] = None
    rec["null_reason"] = XLA_ONLY
    rec["flops_scope"] = f"one device: the {n} shards' matrix products over {n}"
    rec["status"] = "ok"
    return rec


# ---------------------------------------------------------------------------
# Command line
# ---------------------------------------------------------------------------

def cell_path(arch: str, shape: str, mesh: str, out_dir: Path = ARTIFACTS) -> Path:
    return Path(out_dir) / f"{arch}__{shape}__{mesh}.json"


class CellTimeout(Exception):
    pass


def _on_alarm(signum, frame):
    raise CellTimeout()


def _cell_record(arch: str, shape: str, mesh: str, analysis: bool, sets: list,
                 timeout: int) -> dict:
    """One cell's record, an ``error`` record if it raises or outlives
    ``timeout`` seconds (a SIGALRM in this process's main thread)."""
    previous = signal.signal(signal.SIGALRM, _on_alarm)
    signal.alarm(timeout)
    try:
        over = parse_overrides(sets)
        if arch == "treant_dashboard":
            return run_treant_cell(mesh, n_measures=int(over.get("measures", 1)))
        return run_cell(arch, shape, mesh, analysis=analysis, overrides=over)
    except CellTimeout:
        return {"arch": arch, "shape": shape, "mesh": mesh, "status": "error",
                "reason": f"timeout>{timeout}s"}
    except Exception:
        return {"arch": arch, "shape": shape, "mesh": mesh, "status": "error",
                "traceback": traceback.format_exc()}
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)


def _write(out: Path, rec: dict) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=2))


def main(argv=None) -> list[dict]:
    """Run the cells the flags name; write one JSON record per cell under
    ``--out`` and return the records."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--cell", default=None, help="'treant' for the CJT workload")
    ap.add_argument("--no-analysis", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--timeout", type=int, default=2400, help="seconds per cell")
    ap.add_argument("--set", action="append", default=[],
                    help="perf-variant override key=value (e.g. attn_mode=divide)")
    ap.add_argument("--tag", default=None,
                    help="write to <out>/hillclimb/<cell>__<tag>.json")
    ap.add_argument("--out", type=Path, default=ARTIFACTS, help="directory of the records")
    args = ap.parse_args(argv)
    analysis = not args.no_analysis

    if args.all:
        from repro_torch.configs import ALL_ARCHS, SHAPES

        cells = [(a, s, m) for a in ALL_ARCHS for s in SHAPES for m in ("single", "multi")]
        cells += [("treant_dashboard", "chain", m) for m in ("single", "multi")]
        todo = []
        for a, s, m in cells:
            out = cell_path(a, s, m, args.out)
            if out.exists() and not args.force:
                try:
                    prev = json.loads(out.read_text()).get("status")
                except (OSError, ValueError):
                    prev = None
                if prev in ("ok", "skipped"):
                    print(f"[skip-existing] {out.name}", flush=True)
                    continue
                out.unlink()
            todo.append((a, s, m))
        t0 = time.time()
        workers = max(1, min(os.cpu_count() or 1, len(todo)))
        records = []
        # spawned workers: a fresh interpreter each, no forked threads
        with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as ex:
            futures = [ex.submit(_cell_record, a, s, m, analysis, [], args.timeout)
                       for a, s, m in todo]
            for (a, s, m), fut in zip(todo, futures):
                try:
                    rec = fut.result()
                except Exception as e:  # the worker died (killed, out of memory)
                    rec = {"arch": a, "shape": s, "mesh": m, "status": "error",
                           "reason": f"worker failed: {e!r}"}
                _write(cell_path(a, s, m, args.out), rec)
                records.append(rec)
                print(f"[{rec['status']}] {a} × {s} × {m}", flush=True)
        counts = {k: sum(r["status"] == k for r in records) for k in ("ok", "skipped", "error")}
        print(f"done in {time.time() - t0:.1f} s on {workers} workers: {counts}", flush=True)
        return records

    if args.cell == "treant":
        arch, shape = "treant_dashboard", "chain"
    else:
        arch, shape = args.arch, args.shape
    rec = _cell_record(arch, shape, args.mesh, analysis, args.set, args.timeout)
    out = cell_path(arch, shape, args.mesh, args.out)
    if args.tag:
        out = Path(args.out) / "hillclimb" / f"{arch}__{shape}__{args.mesh}__{args.tag}.json"
    _write(out, rec)
    if rec["status"] == "error":
        print(rec.get("traceback", rec.get("reason")), file=sys.stderr)
    print(json.dumps({k: v for k, v in rec.items() if k != "traceback"}, indent=2)[:2000])
    return [rec]


if __name__ == "__main__":
    sys.exit(1 if any(r["status"] == "error" for r in main()) else 0)
