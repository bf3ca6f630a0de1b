"""End-to-end training entry point with fault tolerance, on one device.

  - config-driven model (--arch, full or --smoke reduced config, --preset)
  - async checkpointing + resume (bitwise-identical restart on the CPU)
  - failure injection (--inject-failure N fails the step loop at step N;
    the loop restores from the last checkpoint, or re-initializes, and
    restarts the data pipeline at that step)
  - straggler monitor (EWMA step-time outlier flagging)
  - Treant telemetry (--telemetry-dashboard): per-step metric relations are
    appended and a CJT dashboard over them is re-rendered and calibrated in
    think time every 10 steps, on the training device; its SUM over the
    ``Steps`` messages runs the segment kernels there.

Runs on ``cuda`` unless ``--device cpu`` is passed; without a card it
raises.  Checkpoints go to ``--ckpt-dir``/<arch name>.

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe-1b-a400m \
      --steps 12 --batch 2 --seq 32 --ckpt-every 4 --inject-failure 6 \
      --telemetry-dashboard --ckpt-dir /tmp/ckpt --device cuda
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

import numpy as np

PRESETS = {
    "tiny": dict(d_model=64, n_layers=2),
    "10m": dict(d_model=256, n_layers=6),
    "100m": dict(d_model=640, n_layers=12),
}

DASHBOARD_EVERY = 10               # steps between telemetry dashboard updates


class InjectedFailure(RuntimeError):
    pass


def build_cfg(args):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import smoke_config

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    if args.preset:
        p = PRESETS[args.preset]
        d = p["d_model"]
        cfg = dataclasses.replace(
            cfg, d_model=d, n_layers=p["n_layers"], d_ff=4 * d,
            n_heads=8, n_kv_heads=4, d_head=d // 8, vocab=args.vocab,
            loss_chunk=128, attn_q_chunk=128, attn_kv_chunk=128, attn_min_block=128,
        )
    return cfg


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-12b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--no-smoke", dest="smoke", action="store_false")
    ap.add_argument("--preset", choices=list(PRESETS), default=None)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--inject-failure", type=int, default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--telemetry-dashboard", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    """Train; returns the loss of every step run, in order (a step run again
    after a restore appears again)."""
    args = _parser().parse_args(argv)

    from repro_torch import tree
    from repro_torch.checkpoint.checkpointer import Checkpointer, restore_pytree
    from repro_torch.core.plans import resolve_device
    from repro_torch.data.pipeline import StragglerMonitor, TokenPipeline
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.runtime.step import make_train_step

    device = resolve_device(args.device)
    cfg = build_cfg(args)
    opt_cfg = AdamWConfig(peak_lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                          total_steps=args.steps, m_dtype="float32")

    def fresh_state():
        params = lm.init_params(cfg, seed=0, device=device)
        return params, init_opt_state(params, opt_cfg)

    def pipeline(start_step):
        return TokenPipeline(cfg.vocab, args.batch, args.seq, mode=cfg.input_mode,
                             d_model=cfg.d_model, n_vision_tokens=cfg.n_vision_tokens,
                             start_step=start_step)

    params, opt_state = fresh_state()
    n_params = sum(t.numel() for t in tree.leaves(params))
    print(f"[train] arch={cfg.name} params={n_params/1e6:.1f}M "
          f"batch={args.batch}x{args.seq} steps={args.steps} device={device}", flush=True)
    step_fn = make_train_step(cfg, opt_cfg, donate=True)

    ckpt = Checkpointer(Path(args.ckpt_dir) / cfg.name, keep=3)
    start_step = 0
    if args.resume and ckpt.latest_step() is not None:
        (params, opt_state), start_step = restore_pytree(
            ckpt.directory, template=(params, opt_state), device=device)
        print(f"[train] resumed from step {start_step}", flush=True)

    pipe = None
    monitor = StragglerMonitor()
    telemetry: list[dict] = []
    dash = _make_telemetry_dashboard(device) if args.telemetry_dashboard else None

    step = start_step
    injected = False
    losses = []
    try:
        pipe = pipeline(start_step)
        while step < args.steps:
            try:
                t0 = time.perf_counter()
                batch = next(pipe)
                if args.inject_failure is not None and step == args.inject_failure and not injected:
                    injected = True
                    raise InjectedFailure(f"injected node failure at step {step}")
                params, opt_state, metrics = step_fn(params, opt_state, batch)
                loss = float(metrics["loss"])
                dt = time.perf_counter() - t0
                slow = monitor.observe(step, dt)
                telemetry.append({"step": step, "loss": loss, "dt": dt, "slow": slow})
                losses.append(loss)
                if step % args.log_every == 0:
                    print(f"[train] step={step} loss={loss:.4f} dt={dt*1e3:.0f}ms"
                          + (" STRAGGLER" if slow else ""), flush=True)
                step += 1
                if step % args.ckpt_every == 0:
                    ckpt.save_async((params, opt_state), step)
                if dash is not None and step % DASHBOARD_EVERY == 0:
                    _update_dashboard(dash, telemetry[-DASHBOARD_EVERY:])
            except InjectedFailure as e:
                print(f"[train] FAILURE: {e}; restoring from checkpoint", flush=True)
                ckpt.wait()
                latest = ckpt.latest_step()
                if latest is None:
                    print("[train] no checkpoint yet; restarting from scratch", flush=True)
                    params, opt_state = fresh_state()
                    step = 0
                else:
                    (params, opt_state), step = restore_pytree(
                        ckpt.directory, template=(params, opt_state), device=device)
                    print(f"[train] restored step {step}", flush=True)
                pipe.close()
                pipe = pipeline(step)
    finally:
        try:
            ckpt.wait()
        finally:
            ckpt.close()
            if pipe is not None:
                pipe.close()

    print(f"[train] done: first-loss={losses[0]:.4f} last-loss={losses[-1]:.4f} "
          f"stragglers={len(monitor.flagged)}", flush=True)
    return losses


# ---------------------------------------------------------------------------
# Treant telemetry dashboard (the paper's system watching the training run)
# ---------------------------------------------------------------------------

def _make_telemetry_dashboard(device):
    from repro_torch.core import Query, Treant
    from repro_torch.core import semiring as sr
    from repro_torch.relational.relation import Catalog, Relation

    steps = Relation(
        name="Steps", attrs=("step_b", "phase"),
        codes={"step_b": np.zeros(1, np.int32), "phase": np.zeros(1, np.int32)},
        domains={"step_b": 64, "phase": 4},
        measures={"loss": np.zeros(1, np.float32), "dt": np.zeros(1, np.float32)},
    )
    phases = Relation(
        name="Phases", attrs=("phase", "phase_kind"),
        codes={"phase": np.arange(4, dtype=np.int32),
               "phase_kind": np.arange(4, dtype=np.int32) % 2},
        domains={"phase": 4, "phase_kind": 2},
    )
    cat = Catalog([steps, phases])
    t = Treant(cat, ring=sr.SUM, device=device)
    q = Query.make(cat, ring="sum", measure=("Steps", "dt"), group_by=("phase_kind",))
    t.register_dashboard("step_time", q)
    return {"treant": t, "cat": cat, "version": 0}


def _update_dashboard(dash, recent):
    from repro_torch.core import Query

    t = dash["treant"]
    cat = dash["cat"]
    dash["version"] += 1
    v = f"v{dash['version']}"
    steps = cat.get("Steps").with_version(
        v,
        codes={
            "step_b": np.array([r["step"] % 64 for r in recent], np.int32),
            "phase": np.array([r["step"] // 16 % 4 for r in recent], np.int32),
        },
        measures={
            "loss": np.array([r["loss"] for r in recent], np.float32),
            "dt": np.array([r["dt"] for r in recent], np.float32),
        },
    )
    cat.put(steps)
    q = Query.make(cat, ring="sum", measure=("Steps", "dt"), group_by=("phase_kind",),
                   versions={"Steps": v})
    t.interact("trainer", "step_time", q)
    # think-time calibration between steps
    t.think_time("trainer", "step_time", budget_messages=2)


if __name__ == "__main__":
    main()
