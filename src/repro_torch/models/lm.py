"""LM assembly: param specs + train/prefill/decode forwards for the four
block patterns (uniform, vlm, zamba, rwkv).

Parameters are plain nested dicts of tensors with the reference's layout:
every stacked leaf keeps its leading layer (and group) axes, and the
forwards walk the layers with Python loops over views of those stacks.
``param_specs`` describes every leaf once as (shape, logical axes, init);
the axes are kept for parity with the reference and unused on one device.

``cfg.remat`` and ``cfg.scan_groups`` shape the reference's compiled
programs, not a forward's result: they are accepted and ignored here.
``cfg.unroll_scans`` selects the batched-over-chunks form of the SSD and
WKV scans, as in the reference (the same result).

Decode writes the new token's K/V (and the new SSM / RWKV state) into the
caller's cache tensors in place and returns the same tensors.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any

import numpy as np
import torch

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


def map_specs(tree, fn, path=""):
    """``fn(path, spec)`` at every leaf of a spec tree (paths like
    ``/layers/attn/wq``)."""
    if _is_spec(tree):
        return fn(path, tree)
    return {k: map_specs(v, fn, f"{path}/{k}") for k, v in tree.items()}


def _leaves(tree):
    """Leaves in the reference's pytree order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


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
    return next(_leaves(params)).dtype


def embed_inputs(params, cfg: ModelConfig, batch):
    dev = params["head"].device
    if cfg.input_mode == "embeddings":
        h = _as_input(batch["embeds"], dev)
    else:
        h = params["embed"][_as_input(batch["tokens"], dev).long()]
    return h.to(compute_dtype(params))


def _uniform_block(h, lp, cfg, cache=None, pos=0):
    a_in = L.rms_norm(h, lp["ln1"], cfg.norm_eps)
    a, kv = L.attention_block(a_in, lp["attn"], cfg, cache=cache, pos_offset=pos)
    h = h + a
    m_in = L.rms_norm(h, lp["ln2"], cfg.norm_eps)
    if cfg.moe is not None:
        m, aux = L.moe_block(m_in, lp["moe"], cfg)
    else:
        m, aux = L.mlp_block(m_in, lp["mlp"], cfg), 0.0
    return h + m, kv, aux


def _shared_block(h, sp, cfg, cache=None, pos=0):
    a, kv = L.attention_block(
        L.rms_norm(h, sp["ln1"], cfg.norm_eps), sp["attn"], cfg, cache=cache, pos_offset=pos)
    h = h + a
    h = h + L.mlp_block(L.rms_norm(h, sp["ln2"], cfg.norm_eps), sp["mlp"], cfg)
    return h, kv


def _rwkv_block(h, lp, cfg, state=None):
    tm_state = None if state is None else {"shift": state["tm_shift"], "wkv": state["wkv"]}
    y, new_tm = S.rwkv_time_mix(L.rms_norm(h, lp["ln1"], cfg.norm_eps), lp["tm"], cfg,
                                state=tm_state)
    h = h + y
    y2, new_cm = S.rwkv_channel_mix(
        L.rms_norm(h, lp["ln2"], cfg.norm_eps), lp["cm"],
        state=None if state is None else state["cm_shift"],
    )
    return h + y2, {"tm_shift": new_tm["shift"], "wkv": new_tm["wkv"], "cm_shift": new_cm}


def _mamba_block(h, mp, cfg, state=None):
    y, new_state = S.mamba2_mix(L.rms_norm(h, mp["ln"], cfg.norm_eps), mp, cfg, state=state)
    return h + y, new_state


def _cross_group(h, gp, cfg, vision=None, kv=None):
    """A vlm group's tail: gated cross-attention, then its MLP."""
    cp = gp["cross"]
    x, xkv = L.cross_attention_block(
        L.rms_norm(h, cp["ln"], cfg.norm_eps), cp, cfg, kv=kv, vision=vision)
    h = h + torch.tanh(cp["gate"]) * x
    h = h + L.mlp_block(L.rms_norm(h, gp["cross_ln2"], cfg.norm_eps), gp["cross_mlp"], cfg)
    return h, xkv


# -- mode: train / prefill ----------------------------------------------------

def backbone(params, cfg: ModelConfig, h, batch, collect_cache=False):
    """Run all blocks. Returns (h, caches-or-None, aux_loss)."""
    if cfg.pattern == "uniform":
        aux, ks, vs = 0.0, [], []
        for i in range(cfg.n_layers):
            h, (k, v), a = _uniform_block(h, _at(params["layers"], i), cfg)
            aux = aux + a
            ks.append(k)
            vs.append(v)
        caches = {"k": torch.stack(ks), "v": torch.stack(vs)} if collect_cache else None
        return h, caches, aux

    if cfg.pattern == "vlm":
        vision = _as_input(batch["vision"], h.device).to(h.dtype)
        n_groups, self_per = vlm_layout(cfg)
        aux, ks, vs, xks, xvs = 0.0, [], [], [], []
        for g in range(n_groups):
            gp = _at(params["groups"], g)
            gk, gv = [], []
            for j in range(self_per):
                h, (k, v), a = _uniform_block(h, _at(gp["self"], j), cfg)
                aux = aux + a
                gk.append(k)
                gv.append(v)
            h, (xk, xv) = _cross_group(h, gp, cfg, vision=vision)
            ks.append(torch.stack(gk))
            vs.append(torch.stack(gv))
            xks.append(xk)
            xvs.append(xv)
        caches = None
        if collect_cache:
            caches = {"k": torch.stack(ks), "v": torch.stack(vs),
                      "xk": torch.stack(xks), "xv": torch.stack(xvs)}
        return h, caches, aux

    if cfg.pattern == "zamba":
        n_groups, per, tail = zamba_layout(cfg)
        sks, svs, convs, ssms = [], [], [], []
        for g in range(n_groups):
            h, (k, v) = _shared_block(h, params["shared"], cfg)
            sks.append(k)
            svs.append(v)
            gc, gs = [], []
            for j in range(per):
                h, st = _mamba_block(h, _at(params["mamba_groups"], g, j), cfg)
                gc.append(st["conv"])
                gs.append(st["ssm"])
            convs.append(torch.stack(gc))
            ssms.append(torch.stack(gs))
        tail_sts = []
        for j in range(tail):
            h, st = _mamba_block(h, _at(params["tail"], j), cfg)
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
        sts = []
        for i in range(cfg.n_layers):
            h, st = _rwkv_block(h, _at(params["layers"], i), cfg)
            sts.append(st)
        caches = None
        if collect_cache:
            caches = {name: torch.stack([st[name] for st in sts])
                      for name in ("tm_shift", "wkv", "cm_shift")}
        return h, caches, 0.0

    raise ValueError(cfg.pattern)


def chunked_xent(h, head_w, labels, chunk: int):
    """Sequence-chunked softmax cross-entropy (logits O(B·chunk·V) at a time)."""
    b, s, d = h.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the loss chunk {chunk}")
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, s, chunk):
        logits = (h[:, i:i + chunk] @ head_w).float()
        logz = torch.logsumexp(logits, dim=-1)
        ll = torch.take_along_dim(logits, labels[:, i:i + chunk, None], dim=-1)[..., 0]
        total = total + (logz - ll).sum()
    return total / (b * s)


def forward_train(params, cfg: ModelConfig, batch):
    """The training loss's value: (xent + 0.01·aux, {"xent", "aux"})."""
    h = embed_inputs(params, cfg, batch)
    h, _, aux = backbone(params, cfg, h, batch, collect_cache=False)
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    labels = _as_input(batch["labels"], h.device).long()
    loss = chunked_xent(h, params["head"], labels, cfg.loss_chunk)
    return loss + 0.01 * aux, {"xent": loss, "aux": aux}


def forward_prefill(params, cfg: ModelConfig, batch):
    """Last-position logits (B, V) in float32 and the decode caches, whose
    attention entries hold the prompt's S positions."""
    h = embed_inputs(params, cfg, batch)
    h, caches, _ = backbone(params, cfg, h, batch, collect_cache=True)
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = (h[:, -1] @ params["head"]).float()
    return logits, caches


# -- mode: decode ----------------------------------------------------------------

def forward_decode(params, cfg: ModelConfig, batch, caches, pos):
    """One-token decode against full caches; returns (logits, caches).

    ``pos`` is the write position; attention reads the cache up to it.  The
    caches' tensors are updated in place and returned in a new dict.
    """
    pos = int(pos)
    h = embed_inputs(params, cfg, batch)     # (B, 1, D)

    if cfg.pattern == "uniform":
        for i in range(cfg.n_layers):
            lp = _at(params["layers"], i)
            h = _decode_attn_update(L.rms_norm(h, lp["ln1"], cfg.norm_eps), h, lp["attn"], cfg,
                                    caches["k"][i], caches["v"][i], pos)
            m_in = L.rms_norm(h, lp["ln2"], cfg.norm_eps)
            if cfg.moe is not None:
                m, _ = L.moe_block(m_in, lp["moe"], cfg)
            else:
                m = L.mlp_block(m_in, lp["mlp"], cfg)
            h = h + m

    elif cfg.pattern == "vlm":
        n_groups, self_per = vlm_layout(cfg)
        for g in range(n_groups):
            gp = _at(params["groups"], g)
            for j in range(self_per):
                lp = _at(gp["self"], j)
                h = _decode_attn_update(L.rms_norm(h, lp["ln1"], cfg.norm_eps), h, lp["attn"],
                                        cfg, caches["k"][g, j], caches["v"][g, j], pos)
                h = h + L.mlp_block(L.rms_norm(h, lp["ln2"], cfg.norm_eps), lp["mlp"], cfg)
            h, _ = _cross_group(h, gp, cfg, kv=(caches["xk"][g], caches["xv"][g]))

    elif cfg.pattern == "zamba":
        sp = params["shared"]
        n_groups, per, tail = zamba_layout(cfg)

        def mamba(h, mp, conv, ssm_st):
            h, st = _mamba_block(h, mp, cfg, state={"conv": conv, "ssm": ssm_st})
            conv.copy_(st["conv"])
            ssm_st.copy_(st["ssm"])
            return h

        for g in range(n_groups):
            h = _decode_attn_update(L.rms_norm(h, sp["ln1"], cfg.norm_eps), h, sp["attn"], cfg,
                                    caches["shared_k"][g], caches["shared_v"][g], pos)
            h = h + L.mlp_block(L.rms_norm(h, sp["ln2"], cfg.norm_eps), sp["mlp"], cfg)
            for j in range(per):
                h = mamba(h, _at(params["mamba_groups"], g, j),
                          caches["conv"][g, j], caches["ssm"][g, j])
        for j in range(tail):
            h = mamba(h, _at(params["tail"], j), caches["tail_conv"][j], caches["tail_ssm"][j])

    elif cfg.pattern == "rwkv":
        for i in range(cfg.n_layers):
            state = {name: caches[name][i] for name in ("tm_shift", "cm_shift", "wkv")}
            h, st = _rwkv_block(h, _at(params["layers"], i), cfg, state=state)
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
    forward_train = staticmethod(forward_train)
    forward_prefill = staticmethod(forward_prefill)
    forward_decode = staticmethod(forward_decode)
    cache_specs = staticmethod(cache_specs)
