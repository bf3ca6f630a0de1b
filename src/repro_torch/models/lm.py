"""LM assembly: param specs + train/prefill/decode forwards for the four
block patterns (uniform, vlm, zamba, rwkv).

Parameters are plain nested dicts of tensors with the reference's layout:
every stacked leaf keeps its leading layer (and group) axes, and the
forwards walk the layers with Python loops over views of those stacks.
``param_specs`` describes every leaf once as (shape, logical axes, init);
``runtime.sharding`` maps the axes onto a mesh, and ``abstract_params``
builds the ``meta``-tensor skeleton the dry-run traces.  The forwards take
the reference's ``acts`` (``runtime.sharding.act_specs``): placements of
activations and per-layer parameters, checked and passed through
(``layers.with_sharding``); on one device they change nothing.

Under autograd, ``cfg.remat`` ("full", "dots", "none") and
``cfg.scan_groups`` checkpoint the blocks where the reference rematerializes
them (``torch.utils.checkpoint``); they change memory and time, not the
result.  Prefill and decode run without autograd and never checkpoint.
``cfg.unroll_scans`` selects the batched-over-chunks form of the SSD and
WKV scans, as in the reference (the same result).

Decode writes the new token's K/V (and the new SSM / RWKV state) into the
caller's cache tensors in place and returns the same tensors.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig
from repro_torch.core.plans import resolve_device

from . import layers as L
from . import ssm as S


@dataclasses.dataclass(frozen=True)
class Spec:
    shape: tuple[int, ...]
    axes: tuple[Any, ...]          # logical axis name (or None) per dim
    init: str = "normal"           # normal | zeros | ones | const:<val>
    dtype: Any = None              # override (defaults to build dtype)


def _is_spec(x):
    return isinstance(x, Spec)


# ---------------------------------------------------------------------------
# Param specs per pattern
# ---------------------------------------------------------------------------

def _attn_specs(cfg: ModelConfig, stack: tuple[int, ...], saxes: tuple) -> dict:
    d, ha, kv = cfg.d_model, cfg.d_attn, cfg.n_kv_heads * cfg.d_head
    return {
        "wq": Spec(stack + (d, ha), saxes + ("embed", "heads_flat")),
        "wk": Spec(stack + (d, kv), saxes + ("embed", "kv_flat")),
        "wv": Spec(stack + (d, kv), saxes + ("embed", "kv_flat")),
        "wo": Spec(stack + (ha, d), saxes + ("heads_flat", "embed")),
    }


def _mlp_specs(cfg: ModelConfig, stack, saxes) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    out = {
        "w1": Spec(stack + (d, f), saxes + ("embed", "mlp")),
        "w2": Spec(stack + (f, d), saxes + ("mlp", "embed")),
    }
    if cfg.mlp == "swiglu":
        out["w3"] = Spec(stack + (d, f), saxes + ("embed", "mlp"))
    return out


def _moe_specs(cfg: ModelConfig, stack, saxes) -> dict:
    d, e, f = cfg.d_model, cfg.moe.n_experts, cfg.moe.d_ff
    out = {
        "router": Spec(stack + (d, e), saxes + ("embed", None)),
        "w1": Spec(stack + (e, d, f), saxes + ("experts", "embed", "mlp")),
        "w2": Spec(stack + (e, f, d), saxes + ("experts", "mlp", "embed")),
    }
    if cfg.mlp == "swiglu":
        out["w3"] = Spec(stack + (e, d, f), saxes + ("experts", "embed", "mlp"))
    return out


def _uniform_layer_specs(cfg: ModelConfig, stack, saxes) -> dict:
    d = cfg.d_model
    out = {
        "ln1": Spec(stack + (d,), saxes + ("embed",), init="ones"),
        "ln2": Spec(stack + (d,), saxes + ("embed",), init="ones"),
        "attn": _attn_specs(cfg, stack, saxes),
    }
    if cfg.moe is not None:
        out["moe"] = _moe_specs(cfg, stack, saxes)
    else:
        out["mlp"] = _mlp_specs(cfg, stack, saxes)
    return out


def _mamba_layer_specs(cfg: ModelConfig, stack, saxes) -> dict:
    d = cfg.d_model
    ssm = cfg.ssm
    d_in = ssm.expand * d
    h = d_in // ssm.head_dim
    n = ssm.state
    proj_out = 2 * d_in + 2 * n + h
    return {
        "ln": Spec(stack + (d,), saxes + ("embed",), init="ones"),
        "in_proj": Spec(stack + (d, proj_out), saxes + ("embed", "ssm_inner")),
        "conv_w": Spec(stack + (ssm.conv, d_in), saxes + (None, "ssm_inner"),
                       init="const:0.25"),
        "conv_b": Spec(stack + (d_in,), saxes + ("ssm_inner",), init="zeros"),
        "dt_bias": Spec(stack + (h,), saxes + (None,), init="const:-2.0"),
        "a_log": Spec(stack + (h,), saxes + (None,), init="zeros"),
        "d_skip": Spec(stack + (h,), saxes + (None,), init="ones"),
        "norm": Spec(stack + (d_in,), saxes + ("ssm_inner",), init="ones"),
        "out_proj": Spec(stack + (d_in, d), saxes + ("ssm_inner", "embed")),
    }


def _rwkv_layer_specs(cfg: ModelConfig, stack, saxes) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    rw = cfg.rwkv
    h = d // rw.head_dim
    mu = lambda: Spec(stack + (d,), saxes + ("embed",), init="const:0.5")  # noqa: E731
    return {
        "ln1": Spec(stack + (d,), saxes + ("embed",), init="ones"),
        "ln2": Spec(stack + (d,), saxes + ("embed",), init="ones"),
        "tm": {
            "mu_r": mu(), "mu_k": mu(), "mu_v": mu(), "mu_g": mu(), "mu_w": mu(),
            "wr": Spec(stack + (d, d), saxes + ("embed", "heads_flat")),
            "wk": Spec(stack + (d, d), saxes + ("embed", "heads_flat")),
            "wv": Spec(stack + (d, d), saxes + ("embed", "heads_flat")),
            "wg": Spec(stack + (d, d), saxes + ("embed", "heads_flat")),
            "wo": Spec(stack + (d, d), saxes + ("heads_flat", "embed")),
            "w_lora_a": Spec(stack + (d, rw.lora_rank), saxes + ("embed", None)),
            "w_lora_b": Spec(stack + (rw.lora_rank, d), saxes + (None, "heads_flat")),
            "w0": Spec(stack + (d,), saxes + ("heads_flat",), init="const:-2.0"),
            "u": Spec(stack + (h, rw.head_dim), saxes + (None, None), init="const:0.1"),
            "ln_x": Spec(stack + (d,), saxes + ("heads_flat",), init="ones"),
        },
        "cm": {
            "mu_k": mu(), "mu_r": mu(),
            "wk": Spec(stack + (d, f), saxes + ("embed", "mlp")),
            "wv": Spec(stack + (f, d), saxes + ("mlp", "embed")),
            "wr_gate": Spec(stack + (d, d), saxes + ("embed", "heads_flat")),
        },
    }


def _cross_layer_specs(cfg: ModelConfig, stack, saxes) -> dict:
    out = _attn_specs(cfg, stack, saxes)
    out["ln"] = Spec(stack + (cfg.d_model,), saxes + ("embed",), init="ones")
    out["gate"] = Spec(stack + (), saxes, init="zeros")
    return out


def vlm_layout(cfg: ModelConfig) -> tuple[int, int]:
    """(n_groups, self_per_group): cross-attn after every ``cross_every``-1
    self layers; total layers = n_groups * cross_every."""
    if cfg.n_layers % cfg.cross_every:
        raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of cross_every "
                         f"{cfg.cross_every}")
    return cfg.n_layers // cfg.cross_every, cfg.cross_every - 1


def zamba_layout(cfg: ModelConfig) -> tuple[int, int, int]:
    """(n_groups, mamba_per_group, tail): shared attn block before each group."""
    per = cfg.shared_attn_every
    n_groups = cfg.n_layers // per
    tail = cfg.n_layers - n_groups * per
    return n_groups, per, tail


def param_specs(cfg: ModelConfig) -> dict:
    d, v = cfg.d_model, cfg.vocab
    out: dict = {}
    if cfg.input_mode != "embeddings":
        out["embed"] = Spec((v, d), ("vocab", "embed"))
    out["final_norm"] = Spec((d,), ("embed",), init="ones")
    out["head"] = Spec((d, v), ("embed", "vocab"))

    if cfg.pattern == "uniform":
        out["layers"] = _uniform_layer_specs(cfg, (cfg.n_layers,), ("layers",))
    elif cfg.pattern == "vlm":
        g, self_per = vlm_layout(cfg)
        out["groups"] = {
            "self": _uniform_layer_specs(cfg, (g, self_per), ("group", "layers")),
            "cross": _cross_layer_specs(cfg, (g,), ("group",)),
            "cross_ln2": Spec((g, d), ("group", "embed"), init="ones"),
            "cross_mlp": _mlp_specs(cfg, (g,), ("group",)),
        }
    elif cfg.pattern == "zamba":
        ng, per, tail = zamba_layout(cfg)
        out["mamba_groups"] = _mamba_layer_specs(cfg, (ng, per), ("group", "layers"))
        if tail:
            out["tail"] = _mamba_layer_specs(cfg, (tail,), ("layers",))
        out["shared"] = {
            "ln1": Spec((d,), ("embed",), init="ones"),
            "ln2": Spec((d,), ("embed",), init="ones"),
            "attn": _attn_specs(cfg, (), ()),
            "mlp": _mlp_specs(cfg, (), ()),
        }
    elif cfg.pattern == "rwkv":
        out["layers"] = _rwkv_layer_specs(cfg, (cfg.n_layers,), ("layers",))
    else:
        raise ValueError(cfg.pattern)
    return out


# ---------------------------------------------------------------------------
# Initialisation
# ---------------------------------------------------------------------------

def _path_seed(path: str, seed: int) -> int:
    """The seed of one leaf's generator: the reference's ``_path_key`` seed
    (its draws come from ``jax.random``, these from ``torch.Generator``)."""
    h = int(hashlib.sha1(path.encode()).hexdigest()[:8], 16)
    return (seed * 1_000_003 + h) % (2**31)


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32, device=None) -> dict:
    """Random parameters on ``device`` (``cuda`` unless the caller passes
    another).  Each leaf draws float32 normals from a generator on that
    device seeded by its path, scales them by 1/√fan_in and casts to
    ``dtype``; the draws depend on the device type."""
    dev = resolve_device(device)

    def build(path: str, spec: Spec):
        dt = spec.dtype or dtype
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dt, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dt, device=dev)
        if spec.init.startswith("const:"):
            return torch.full(spec.shape, float(spec.init[6:]), dtype=dt, device=dev)
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else max(spec.shape[-1], 1)
        gen = torch.Generator(device=dev).manual_seed(_path_seed(path, seed))
        x = torch.randn(spec.shape, generator=gen, dtype=torch.float32, device=dev)
        return x.mul_(1.0 / np.sqrt(fan_in)).to(dt)

    return map_specs(param_specs(cfg), build)


def abstract_params(cfg: ModelConfig, dtype=torch.bfloat16, sharding_fn=None) -> dict:
    """The parameter skeleton as ``meta`` tensors (no allocation), built from
    ``param_specs``.  With ``sharding_fn`` (Spec → ``NamedSharding``) every
    leaf is a ``runtime.sharding.AbstractTensor`` carrying its sharding."""
    from repro_torch.runtime.sharding import AbstractTensor

    def build(path: str, spec: Spec):
        t = torch.empty(spec.shape, dtype=spec.dtype or dtype, device="meta")
        return AbstractTensor(t, sharding_fn(spec)) if sharding_fn else t

    return map_specs(param_specs(cfg), build)


def map_specs(tree, fn, path=""):
    """``fn(path, spec)`` at every leaf of a spec tree (paths like
    ``/layers/attn/wq``)."""
    if _is_spec(tree):
        return fn(path, tree)
    return {k: map_specs(v, fn, f"{path}/{k}") for k, v in tree.items()}


def _at(tree, *idx):
    """One layer's (or group's) parameters: every leaf indexed by ``idx``."""
    if isinstance(tree, dict):
        return {k: _at(v, *idx) for k, v in tree.items()}
    return tree[idx]


def _as_input(x, device):
    return x.to(device) if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x), device=device)


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def compute_dtype(params):
    return next(T.leaves(params)).dtype


def embed_inputs(params, cfg: ModelConfig, batch, acts=None):
    dev = params["head"].device
    if cfg.input_mode == "embeddings":
        h = _as_input(batch["embeds"], dev)
    else:
        h = params["embed"][_as_input(batch["tokens"], dev).long()]
    return L.with_sharding(h.to(compute_dtype(params)), (acts or {}).get("resid"))


def _uniform_block(h, lp, cfg, acts, cache=None, pos=0):
    a_in = L.rms_norm(h, lp["ln1"], cfg.norm_eps)
    a, kv = L.attention_block(a_in, lp["attn"], cfg, cache=cache, pos_offset=pos, acts=acts)
    h = h + a
    m_in = L.rms_norm(h, lp["ln2"], cfg.norm_eps)
    if cfg.moe is not None:
        m, aux = L.moe_block(m_in, lp["moe"], cfg, acts=acts)
    else:
        m, aux = L.mlp_block(m_in, lp["mlp"], cfg, acts=acts), 0.0
    return L.with_sharding(h + m, acts.get("resid")), kv, aux


def _shared_block(h, sp, cfg, acts, cache=None, pos=0):
    a, kv = L.attention_block(
        L.rms_norm(h, sp["ln1"], cfg.norm_eps), sp["attn"], cfg, cache=cache, pos_offset=pos,
        acts=acts)
    h = h + a
    h = h + L.mlp_block(L.rms_norm(h, sp["ln2"], cfg.norm_eps), sp["mlp"], cfg, acts=acts)
    return L.with_sharding(h, acts.get("resid")), kv


def _rwkv_block(h, lp, cfg, acts, state=None):
    tm_state = None if state is None else {"shift": state["tm_shift"], "wkv": state["wkv"]}
    y, new_tm = S.rwkv_time_mix(L.rms_norm(h, lp["ln1"], cfg.norm_eps), lp["tm"], cfg,
                                state=tm_state, acts=acts)
    h = h + y
    y2, new_cm = S.rwkv_channel_mix(
        L.rms_norm(h, lp["ln2"], cfg.norm_eps), lp["cm"],
        state=None if state is None else state["cm_shift"],
    )
    h = L.with_sharding(h + y2, acts.get("resid"))
    return h, {"tm_shift": new_tm["shift"], "wkv": new_tm["wkv"], "cm_shift": new_cm}


def _mamba_block(h, mp, cfg, acts, state=None):
    y, new_state = S.mamba2_mix(L.rms_norm(h, mp["ln"], cfg.norm_eps), mp, cfg, state=state,
                                acts=acts)
    return L.with_sharding(h + y, acts.get("resid")), new_state


def _cross_group(h, gp, cfg, acts, vision=None, kv=None):
    """A vlm group's tail: gated cross-attention, then its MLP."""
    cp = gp["cross"]
    x, xkv = L.cross_attention_block(
        L.rms_norm(h, cp["ln"], cfg.norm_eps), cp, cfg, kv=kv, vision=vision, acts=acts)
    h = h + torch.tanh(cp["gate"]) * x
    h = h + L.mlp_block(L.rms_norm(h, gp["cross_ln2"], cfg.norm_eps), gp["cross_mlp"], cfg,
                        acts=acts)
    return h, xkv


def _layer_slice(layers, i, acts):
    """Layer ``i``'s parameters, each under its per-slice placement
    (``acts["layer_params"]``) when one is given."""
    lp = _at(layers, i)
    if acts.get("layer_params") is not None:
        lp = T.map_leaves(L.with_sharding, lp, acts["layer_params"])
    return lp


# -- rematerialization ----------------------------------------------------------

_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """``dots_with_no_batch_dims_saveable``: keep the outputs of matmuls
    without batch dimensions, recompute everything else."""
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_saveable():
    return create_selective_checkpoint_contexts(_dots_policy)


def _remat(fn, cfg: ModelConfig):
    """The reference's ``_remat``: ``fn`` checkpointed as ``cfg.remat`` says
    ("none" → as it is; "dots" → matmul outputs saved; otherwise the whole
    body recomputed in the backward).  Without autograd (prefill, decode,
    ``no_grad``) ``fn`` runs as it is."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat == "dots":
        return functools.partial(checkpoint, fn, use_reentrant=False, context_fn=_dots_saveable)
    return functools.partial(checkpoint, fn, use_reentrant=False)


# -- mode: train / prefill ----------------------------------------------------

def _vlm_group(h, gp, cfg, vision, collect_cache, acts):
    """One vlm group: its self layers, then the gated cross-attention and
    MLP.  Returns (h, aux, caches): caches are ((k, v) stacked over the self
    layers, (xk, xv)) when collected, else ``None``."""
    aux, ks, vs = 0.0, [], []
    for j in range(gp["self"]["ln1"].shape[0]):
        h, (k, v), a = _uniform_block(h, _at(gp["self"], j), cfg, acts)
        aux = aux + a
        if collect_cache:
            ks.append(k)
            vs.append(v)
    h, xkv = _cross_group(h, gp, cfg, acts, vision=vision)
    h = L.with_sharding(h, acts.get("resid"))
    if not collect_cache:
        return h, aux, None
    return h, aux, ((torch.stack(ks), torch.stack(vs)), xkv)


def _zamba_group(h, sp, gp, cfg, collect_cache, acts):
    """The shared attention block, then one group's Mamba2 layers.  Returns
    (h, caches): caches are ((k, v), conv states, ssm states) stacked over
    the group's layers when collected, else ``None``."""
    h, kv = _shared_block(h, sp, cfg, acts)
    convs, ssms = [], []
    for j in range(gp["ln"].shape[0]):
        h, st = _mamba_block(h, _at(gp, j), cfg, acts)
        if collect_cache:
            convs.append(st["conv"])
            ssms.append(st["ssm"])
    if not collect_cache:
        return h, None
    return h, (kv, torch.stack(convs), torch.stack(ssms))


def backbone(params, cfg: ModelConfig, h, batch, acts=None, collect_cache=False):
    """Run all blocks. Returns (h, caches-or-None, aux_loss).  Under autograd
    the blocks are checkpointed where the reference applies ``_remat``: per
    layer (uniform, rwkv, zamba's tail), per group (vlm, zamba), and per
    group of ``cfg.scan_groups`` layers around the per-layer checkpoints."""
    acts = acts or {}
    if cfg.pattern == "uniform":
        block = _remat(_uniform_block, cfg)
        layers = params["layers"]
        if cfg.scan_groups and not collect_cache:
            # √L nesting: the outer checkpoint keeps only the group inputs
            n_groups = cfg.scan_groups
            if cfg.n_layers % n_groups:
                raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of scan_groups "
                                 f"{n_groups}")
            per = cfg.n_layers // n_groups

            def group(hh, aux, gi):
                for i in range(gi * per, (gi + 1) * per):
                    hh, _, a = block(hh, _layer_slice(layers, i, acts), cfg, acts)
                    aux = aux + a
                return hh, aux

            outer, aux = _remat(group, cfg), 0.0
            for gi in range(n_groups):
                h, aux = outer(h, aux, gi)
            return h, None, aux
        aux, ks, vs = 0.0, [], []
        for i in range(cfg.n_layers):
            h, (k, v), a = block(h, _layer_slice(layers, i, acts), cfg, acts)
            aux = aux + a
            if collect_cache:
                ks.append(k)
                vs.append(v)
        caches = {"k": torch.stack(ks), "v": torch.stack(vs)} if collect_cache else None
        return h, caches, aux

    if cfg.pattern == "vlm":
        vision = _as_input(batch["vision"], h.device).to(h.dtype)
        n_groups, _ = vlm_layout(cfg)
        body = _remat(_vlm_group, cfg)
        aux, ks, vs, xks, xvs = 0.0, [], [], [], []
        for g in range(n_groups):
            h, a, cached = body(h, _at(params["groups"], g), cfg, vision, collect_cache, acts)
            aux = aux + a
            if collect_cache:
                (k, v), (xk, xv) = cached
                ks.append(k)
                vs.append(v)
                xks.append(xk)
                xvs.append(xv)
        caches = None
        if collect_cache:
            caches = {"k": torch.stack(ks), "v": torch.stack(vs),
                      "xk": torch.stack(xks), "xv": torch.stack(xvs)}
        return h, caches, aux

    if cfg.pattern == "zamba":
        n_groups, per, tail = zamba_layout(cfg)
        body = _remat(_zamba_group, cfg)
        sks, svs, convs, ssms = [], [], [], []
        for g in range(n_groups):
            h, cached = body(h, params["shared"], _at(params["mamba_groups"], g), cfg,
                             collect_cache, acts)
            if collect_cache:
                (k, v), conv, ssm_st = cached
                sks.append(k)
                svs.append(v)
                convs.append(conv)
                ssms.append(ssm_st)
        tail_block = _remat(_mamba_block, cfg)
        tail_sts = []
        for j in range(tail):
            h, st = tail_block(h, _at(params["tail"], j), cfg, acts)
            if collect_cache:
                tail_sts.append(st)
        caches = None
        if collect_cache:
            caches = {"shared_k": torch.stack(sks), "shared_v": torch.stack(svs),
                      "conv": torch.stack(convs), "ssm": torch.stack(ssms)}
            if tail:
                caches["tail_conv"] = torch.stack([st["conv"] for st in tail_sts])
                caches["tail_ssm"] = torch.stack([st["ssm"] for st in tail_sts])
        return h, caches, 0.0

    if cfg.pattern == "rwkv":
        block = _remat(_rwkv_block, cfg)
        sts = []
        for i in range(cfg.n_layers):
            h, st = block(h, _at(params["layers"], i), cfg, acts)
            if collect_cache:
                sts.append(st)
        caches = None
        if collect_cache:
            caches = {name: torch.stack([st[name] for st in sts])
                      for name in ("tm_shift", "wkv", "cm_shift")}
        return h, caches, 0.0

    raise ValueError(cfg.pattern)


def _xent_chunk(hb, head_w, lb, acts):
    logits = L.with_sharding((hb @ head_w).float(), acts.get("logits"))
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, lb[..., None], dim=-1)[..., 0]
    return (logz - ll).sum()


def chunked_xent(h, head_w, labels, chunk: int, acts=None):
    """Sequence-chunked softmax cross-entropy (logits O(B·chunk·V) at a
    time).  Under autograd each chunk is checkpointed, so its logits are
    recomputed in the backward rather than kept."""
    b, s, d = h.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the loss chunk {chunk}")
    body = _xent_chunk
    if torch.is_grad_enabled():
        body = functools.partial(checkpoint, _xent_chunk, use_reentrant=False)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, s, chunk):
        total = total + body(h[:, i:i + chunk], head_w, labels[:, i:i + chunk], acts or {})
    return total / (b * s)


def forward_train(params, cfg: ModelConfig, batch, acts=None):
    """The training loss, (xent + 0.01·aux, {"xent", "aux"}), differentiable
    in the parameters' tensors."""
    h = embed_inputs(params, cfg, batch, acts)
    h, _, aux = backbone(params, cfg, h, batch, acts=acts, collect_cache=False)
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    labels = _as_input(batch["labels"], h.device).long()
    loss = chunked_xent(h, params["head"], labels, cfg.loss_chunk, acts)
    return loss + 0.01 * aux, {"xent": loss, "aux": aux}


def forward_prefill(params, cfg: ModelConfig, batch, acts=None):
    """Last-position logits (B, V) in float32 and the decode caches, whose
    attention entries hold the prompt's S positions."""
    h = embed_inputs(params, cfg, batch, acts)
    h, caches, _ = backbone(params, cfg, h, batch, acts=acts, collect_cache=True)
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = (h[:, -1] @ params["head"]).float()
    return logits, caches


# -- mode: decode ----------------------------------------------------------------

def forward_decode(params, cfg: ModelConfig, batch, caches, pos, acts=None):
    """One-token decode against full caches; returns (logits, caches).

    ``pos`` is the write position; attention reads the cache up to it.  The
    caches' tensors are updated in place and returned in a new dict.
    """
    pos = int(pos)
    acts = acts or {}
    h = embed_inputs(params, cfg, batch, acts)     # (B, 1, D)

    if cfg.pattern == "uniform":
        for i in range(cfg.n_layers):
            lp = _at(params["layers"], i)
            h = _decode_attn_update(L.rms_norm(h, lp["ln1"], cfg.norm_eps), h, lp["attn"], cfg,
                                    caches["k"][i], caches["v"][i], pos)
            m_in = L.rms_norm(h, lp["ln2"], cfg.norm_eps)
            if cfg.moe is not None:
                m, _ = L.moe_block(m_in, lp["moe"], cfg, acts=acts)
            else:
                m = L.mlp_block(m_in, lp["mlp"], cfg, acts=acts)
            h = h + m

    elif cfg.pattern == "vlm":
        n_groups, self_per = vlm_layout(cfg)
        for g in range(n_groups):
            gp = _at(params["groups"], g)
            for j in range(self_per):
                lp = _at(gp["self"], j)
                h = _decode_attn_update(L.rms_norm(h, lp["ln1"], cfg.norm_eps), h, lp["attn"],
                                        cfg, caches["k"][g, j], caches["v"][g, j], pos)
                h = h + L.mlp_block(L.rms_norm(h, lp["ln2"], cfg.norm_eps), lp["mlp"], cfg,
                                    acts=acts)
            h, _ = _cross_group(h, gp, cfg, acts, kv=(caches["xk"][g], caches["xv"][g]))

    elif cfg.pattern == "zamba":
        sp = params["shared"]
        n_groups, per, tail = zamba_layout(cfg)

        def mamba(h, mp, conv, ssm_st):
            h, st = _mamba_block(h, mp, cfg, acts, state={"conv": conv, "ssm": ssm_st})
            conv.copy_(st["conv"])
            ssm_st.copy_(st["ssm"])
            return h

        for g in range(n_groups):
            h = _decode_attn_update(L.rms_norm(h, sp["ln1"], cfg.norm_eps), h, sp["attn"], cfg,
                                    caches["shared_k"][g], caches["shared_v"][g], pos)
            h = h + L.mlp_block(L.rms_norm(h, sp["ln2"], cfg.norm_eps), sp["mlp"], cfg,
                                acts=acts)
            for j in range(per):
                h = mamba(h, _at(params["mamba_groups"], g, j),
                          caches["conv"][g, j], caches["ssm"][g, j])
        for j in range(tail):
            h = mamba(h, _at(params["tail"], j), caches["tail_conv"][j], caches["tail_ssm"][j])

    elif cfg.pattern == "rwkv":
        for i in range(cfg.n_layers):
            state = {name: caches[name][i] for name in ("tm_shift", "cm_shift", "wkv")}
            h, st = _rwkv_block(h, _at(params["layers"], i), cfg, acts, state=state)
            for name, t in state.items():
                t.copy_(st[name])
    else:
        raise ValueError(cfg.pattern)

    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = (h[:, -1] @ params["head"]).float()
    return logits, dict(caches)


def _decode_attn_update(x_in, h, p, cfg, ck, cv, pos: int):
    """Project one token, write its k/v into the cache at ``pos`` (in place),
    attend over the cache up to ``pos``, add the residual."""
    b, s, d = x_in.shape
    hN, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = (x_in @ p["wq"]).reshape(b, s, hN, dh)
    k = (x_in @ p["wk"]).reshape(b, s, kh, dh)
    v = (x_in @ p["wv"]).reshape(b, s, kh, dh)
    positions = pos + torch.arange(s, device=x_in.device)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    ck[:, pos:pos + s] = k
    cv[:, pos:pos + s] = v
    o = L.decode_attention(q[:, 0], ck, cv, valid_upto=pos)[:, None]
    return h + o.reshape(b, s, hN * dh) @ p["wo"]


# ---------------------------------------------------------------------------
# Cache skeletons
# ---------------------------------------------------------------------------

def cache_specs(cfg: ModelConfig, batch: int, seq: int, dtype=torch.bfloat16) -> dict:
    """Shape/logical-axes description of the decode cache dict."""
    kh, dh = cfg.n_kv_heads, cfg.d_head
    kv_axes = (None, "act_batch", "cache_seq", "kv_heads", None)

    def kv(*lead):
        return Spec(lead + (batch, seq, kh, dh), (None,) * (len(lead)) + kv_axes[1:], init="zeros")

    if cfg.pattern == "uniform":
        return {"k": kv(cfg.n_layers), "v": kv(cfg.n_layers)}
    if cfg.pattern == "vlm":
        g, self_per = vlm_layout(cfg)
        self_axes = (None, None, "act_batch", "cache_seq", "kv_heads", None)
        cross_axes = (None, "act_batch", None, "kv_heads", None)
        return {
            "k": Spec((g, self_per, batch, seq, kh, dh), self_axes, init="zeros"),
            "v": Spec((g, self_per, batch, seq, kh, dh), self_axes, init="zeros"),
            "xk": Spec((g, batch, cfg.n_vision_tokens, kh, dh), cross_axes, init="zeros"),
            "xv": Spec((g, batch, cfg.n_vision_tokens, kh, dh), cross_axes, init="zeros"),
        }
    if cfg.pattern == "zamba":
        ng, per, tail = zamba_layout(cfg)
        ssm = cfg.ssm
        d_in = ssm.expand * cfg.d_model
        hS = d_in // ssm.head_dim
        out = {
            "shared_k": kv(ng), "shared_v": kv(ng),
            "conv": Spec((ng, per, batch, ssm.conv - 1, d_in),
                         (None, None, "act_batch", None, "ssm_inner"), init="zeros"),
            "ssm": Spec((ng, per, batch, hS, ssm.state, ssm.head_dim),
                        (None, None, "act_batch", None, None, None), init="zeros"),
        }
        if tail:
            out["tail_conv"] = Spec((tail, batch, ssm.conv - 1, d_in),
                                    (None, "act_batch", None, "ssm_inner"), init="zeros")
            out["tail_ssm"] = Spec((tail, batch, hS, ssm.state, ssm.head_dim),
                                   (None, "act_batch", None, None, None), init="zeros")
        return out
    if cfg.pattern == "rwkv":
        rw = cfg.rwkv
        hR = cfg.d_model // rw.head_dim
        lN, d = cfg.n_layers, cfg.d_model
        return {
            "tm_shift": Spec((lN, batch, d), (None, "act_batch", "act_embed"), init="zeros"),
            "cm_shift": Spec((lN, batch, d), (None, "act_batch", "act_embed"), init="zeros"),
            "wkv": Spec((lN, batch, hR, rw.head_dim, rw.head_dim),
                        (None, "act_batch", None, None, None), init="zeros",
                        dtype=torch.float32),
        }
    raise ValueError(cfg.pattern)


class LM:
    """Convenience namespace used by examples/tests."""

    param_specs = staticmethod(param_specs)
    init_params = staticmethod(init_params)
    abstract_params = staticmethod(abstract_params)
    forward_train = staticmethod(forward_train)
    forward_prefill = staticmethod(forward_prefill)
    forward_decode = staticmethod(forward_decode)
    cache_specs = staticmethod(cache_specs)
