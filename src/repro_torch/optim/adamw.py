"""AdamW with warmup-cosine schedule, global-norm clipping, and configurable
moment dtypes (m in bf16 + v in float32 by default), as the reference's.

Trees are the port's nested dicts of tensors.  Every update is computed in
float32 and cast back to each leaf's dtype.  A layer-stacked leaf (ndim ≥ 3,
at most 256 layers) is updated one layer slice at a time, so the float32
temporaries are one slice in size (the reference streams such leaves with
``lax.map``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import tree
from repro_torch.models.lm import Spec, map_specs, param_specs

_STREAM_MAX_LAYERS = 256


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    m_dtype: str = "bfloat16"
    v_dtype: str = "float32"


def lr_at(cfg: AdamWConfig, step):
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then cosine decay
    to ``min_lr_ratio · peak_lr`` at ``total_steps``; a float32 scalar on
    ``step``'s device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def init_opt_state(params, cfg: AdamWConfig):
    m_dt, v_dt = getattr(torch, cfg.m_dtype), getattr(torch, cfg.v_dtype)
    return {
        "m": tree.map_leaves(lambda p: torch.zeros(p.shape, dtype=m_dt, device=p.device), params),
        "v": tree.map_leaves(lambda p: torch.zeros(p.shape, dtype=v_dt, device=p.device), params),
        "step": torch.zeros((), dtype=torch.int32, device=next(tree.leaves(params)).device),
    }


def opt_state_specs(model_cfg, cfg: AdamWConfig) -> dict:
    """Spec tree mirroring ``init_opt_state`` (the params' logical axes)."""
    ps = param_specs(model_cfg)
    m_dt, v_dt = getattr(torch, cfg.m_dtype), getattr(torch, cfg.v_dtype)
    m = map_specs(ps, lambda _, s: Spec(s.shape, s.axes, init="zeros", dtype=m_dt))
    v = map_specs(ps, lambda _, s: Spec(s.shape, s.axes, init="zeros", dtype=v_dt))
    return {"m": m, "v": v, "step": Spec((), (), init="zeros", dtype=torch.int32)}


def global_norm(grads):
    """√(Σ leaf²): each leaf squared in its own dtype and summed in float32
    (never a float32 copy of a bf16 leaf)."""
    return torch.sqrt(sum(g.square().sum(dtype=torch.float32) for g in tree.leaves(grads)))


def apply_updates(params, grads, state, cfg: AdamWConfig, inplace: bool = False):
    """One AdamW step; moment and parameter dtypes are kept leaf by leaf.

    Returns ``(params, state, {"lr", "grad_norm"})``.  With ``inplace`` the
    new values are written into the given parameter and moment tensors and
    the same tensors are returned; otherwise the inputs are left untouched.
    """
    step = state["step"] + 1
    dev = step.device
    stepf = step.to(torch.float32)
    lr = lr_at(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    f32 = dict(dtype=torch.float32, device=dev)
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, **f32), stepf)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, **f32), stepf)

    def upd_slice(p, g, m, v, p_out, m_out, v_out):
        g = g.float() * scale
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g.square()
        mhat = m32 / bc1
        vhat = v32 / bc2
        p32 = p.float()
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p32
        p_out.copy_(p32 - lr * delta)
        m_out.copy_(m32)
        v_out.copy_(v32)

    def upd(p, g, m, v):
        outs = (p, m, v) if inplace else tuple(torch.empty_like(t) for t in (p, m, v))
        if p.dim() >= 3 and p.shape[0] <= _STREAM_MAX_LAYERS:
            for i in range(p.shape[0]):
                upd_slice(p[i], g[i], m[i], v[i], *(t[i] for t in outs))
        else:
            upd_slice(p, g, m, v, *outs)
        return outs

    new_params, m, v = tree.unzip(tree.map_leaves(upd, params, grads, state["m"], state["v"]), 3)
    return new_params, {"m": m, "v": v, "step": step}, {"lr": lr, "grad_norm": gnorm}
