"""Step factories: train, prefill and decode, the reference's signatures
without its sharding rules and shapes.

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
from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.optim import adamw


def loss_and_grads(cfg: ModelConfig, params, batch):
    """The training loss, its metrics and the gradient of every parameter
    leaf, in ``tree.paths`` order: ``(loss, metrics, paths, grads)``.  The
    parameters' tensors are not changed and need not require gradients."""
    keys, leaves = zip(*tree.paths(params))
    live = [t.detach().requires_grad_(True) for t in leaves]
    loss, metrics = lm.forward_train(tree.from_paths(keys, live), cfg, batch)
    grads = torch.autograd.grad(loss, live, allow_unused=True, materialize_grads=True)
    return loss.detach(), metrics, keys, grads


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, accum: int = 1,
                    donate: bool = True):
    """``train_step(params, opt_state, batch) → (params, opt_state,
    metrics)``: ``metrics`` holds ``loss``, ``lr`` and ``grad_norm`` (and
    ``xent`` and ``aux`` when ``accum == 1``), 0-d tensors.

    With ``accum > 1`` the batch's leading axis splits into ``accum``
    microbatches; their gradients accumulate in bfloat16, as the
    reference's do, and the loss is their mean.
    """

    def train_step(params, opt_state, batch):
        if accum == 1:
            loss, metrics, keys, grads = loss_and_grads(cfg, params, batch)
            metrics = {k: torch.as_tensor(v).detach() for k, v in metrics.items()}
        else:
            g_acc, loss = None, 0.0
            for i in range(accum):
                mb = {k: x.reshape((accum, x.shape[0] // accum) + tuple(x.shape[1:]))[i]
                      for k, x in batch.items()}
                l, _, keys, g = loss_and_grads(cfg, params, mb)
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


def make_prefill_step(cfg: ModelConfig):
    """``prefill(params, batch) → (logits (B, V) float32, caches)``."""

    @torch.inference_mode()
    def prefill(params, batch):
        return lm.forward_prefill(params, cfg, batch)

    return prefill


def make_decode_step(cfg: ModelConfig):
    """``decode(params, batch, caches, pos) → (logits (B, V) float32,
    caches)``: one token at position ``pos``."""

    @torch.inference_mode()
    def decode(params, batch, caches, pos):
        return lm.forward_decode(params, cfg, batch, caches, pos)

    return decode
