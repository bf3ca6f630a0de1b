"""Step factories: train, prefill and decode, with the reference's
signatures, and the abstract state the dry-run traces.

Given sharding ``rules`` a step hands the model the reference's activation
placements (``runtime.sharding.act_specs``, plus the per-slice placements
of the stacked layers): on one device they change nothing, bit for bit.
The prefill step records the reference's output placements as its
``out_shardings`` attribute (``None`` without rules and a shape).

The train step takes gradients with ``torch.autograd.grad`` over the
parameter leaves and applies AdamW.  ``donate=True`` lets it write the new
parameters and moments into the caller's tensors (the reference donates
them to its jitted step); ``donate=False`` leaves them untouched.

Prefill and decode run under ``torch.inference_mode()``.  Batch entries may
be numpy arrays or tensors; they are moved to the parameters' device.  The
decode step writes the new token's K/V and states into the caller's caches
in place (the reference donates the caches and updates them with
``dynamic_update_slice``).
"""

from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import lm
from repro_torch.optim import adamw

from .sharding import (
    NamedSharding, ShardingRules, act_specs, pspec_for, tree_abstract, tree_shardings,
)


def layer_slice_constraint(cfg: ModelConfig, rules: ShardingRules):
    """Shardings for ONE stacked-layer slice (the reference re-asserts them
    inside its scan body so per-layer weights stay sharded), or ``None``
    when the pattern has no ``layers`` stack."""
    specs = lm.param_specs(cfg)
    if "layers" not in specs:
        return None
    return lm.map_specs(specs["layers"], lambda _, s: NamedSharding(
        rules.mesh, pspec_for(s.shape[1:], s.axes[1:], rules)))


def acts_for(cfg: ModelConfig, rules: ShardingRules | None, layer_params: bool = False) -> dict:
    """The ``acts`` a step hands the model under ``rules`` (none without):
    ``act_specs``, and with ``layer_params`` the stacked layers' per-slice
    placements (the train step's)."""
    if rules is None:
        return {}
    acts = act_specs(cfg, rules)
    lc = layer_slice_constraint(cfg, rules) if layer_params else None
    if lc is not None:
        acts["layer_params"] = lc
    return acts


def loss_and_grads(cfg: ModelConfig, params, batch, acts=None):
    """The training loss, its metrics and the gradient of every parameter
    leaf, in ``tree.paths`` order: ``(loss, metrics, paths, grads)``.  The
    parameters' tensors are not changed and need not require gradients."""
    keys, leaves = zip(*tree.paths(params))
    live = [t.detach().requires_grad_(True) for t in leaves]
    loss, metrics = lm.forward_train(tree.from_paths(keys, live), cfg, batch, acts)
    grads = torch.autograd.grad(loss, live, allow_unused=True, materialize_grads=True)
    return loss.detach(), metrics, keys, grads


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    rules: ShardingRules | None = None, accum: int = 1, donate: bool = True):
    """``train_step(params, opt_state, batch) → (params, opt_state,
    metrics)``: ``metrics`` holds ``loss``, ``lr`` and ``grad_norm`` (and
    ``xent`` and ``aux`` when ``accum == 1``), 0-d tensors.

    With ``accum > 1`` the batch's leading axis splits into ``accum``
    microbatches; their gradients accumulate in bfloat16, as the
    reference's do, and the loss is their mean.
    """
    acts = acts_for(cfg, rules, layer_params=True)

    def train_step(params, opt_state, batch):
        if accum == 1:
            loss, metrics, keys, grads = loss_and_grads(cfg, params, batch, acts)
            metrics = {k: torch.as_tensor(v).detach() for k, v in metrics.items()}
        else:
            g_acc, loss = None, 0.0
            for i in range(accum):
                mb = {k: x.reshape((accum, x.shape[0] // accum) + tuple(x.shape[1:]))[i]
                      for k, x in batch.items()}
                l, _, keys, g = loss_and_grads(cfg, params, mb, acts)
                if g_acc is None:
                    g_acc = [torch.zeros(t.shape, dtype=torch.bfloat16, device=t.device) for t in g]
                g_acc = [a + b.to(a.dtype) for a, b in zip(g_acc, g)]
                loss = loss + l
            grads = [a / accum for a in g_acc]
            loss = loss / accum
            metrics = {}
        params, opt_state, om = adamw.apply_updates(
            params, tree.from_paths(keys, grads), opt_state, opt_cfg, inplace=donate)
        return params, opt_state, dict(metrics, loss=loss, **om)

    return train_step


def output_shardings(cfg: ModelConfig, rules: ShardingRules, shape: ShapeConfig):
    """The reference prefill's ``out_shardings``: (logits, caches), the KV
    and state caches with their sequence over the tensor axis."""
    cache_sh = tree_shardings(lm.cache_specs(cfg, shape.global_batch, shape.seq_len), rules)
    logits_sh = NamedSharding(
        rules.mesh,
        pspec_for((shape.global_batch, cfg.vocab), ("act_batch", "act_vocab"), rules),
    )
    return logits_sh, cache_sh


def make_prefill_step(cfg: ModelConfig, rules: ShardingRules | None = None,
                      shape: ShapeConfig | None = None):
    """``prefill(params, batch) → (logits (B, V) float32, caches)``."""
    acts = acts_for(cfg, rules)

    @torch.inference_mode()
    def prefill(params, batch):
        return lm.forward_prefill(params, cfg, batch, acts)

    prefill.out_shardings = (output_shardings(cfg, rules, shape)
                             if rules is not None and shape is not None else None)
    return prefill


def make_decode_step(cfg: ModelConfig, rules: ShardingRules | None = None):
    """``decode(params, batch, caches, pos) → (logits (B, V) float32,
    caches)``: one token at position ``pos``."""
    acts = acts_for(cfg, rules)

    @torch.inference_mode()
    def decode(params, batch, caches, pos):
        return lm.forward_decode(params, cfg, batch, caches, pos, acts)

    return decode


def abstract_train_state(cfg: ModelConfig, opt_cfg, rules: ShardingRules,
                         param_dtype="bfloat16"):
    """(params, opt_state) as ``AbstractTensor``s with shardings, for the
    dry-run: ``meta`` tensors, nothing allocated."""
    params = tree_abstract(lm.param_specs(cfg), rules, param_dtype)
    opt = tree_abstract(adamw.opt_state_specs(cfg, opt_cfg), rules, "float32")
    return params, opt


def abstract_caches(cfg: ModelConfig, shape: ShapeConfig, rules: ShardingRules,
                    dtype="bfloat16"):
    specs = lm.cache_specs(cfg, shape.global_batch, shape.seq_len)
    return tree_abstract(specs, rules, dtype)
