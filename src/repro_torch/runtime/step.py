"""Step factories: prefill and decode, the reference's signatures without
its sharding rules, shapes and donation.

Each step runs under ``torch.inference_mode()``.  Batch entries may be numpy
arrays or tensors; they are moved to the parameters' device.  The decode
step writes the new token's K/V and states into the caller's caches in
place (the reference donates the caches and updates them with
``dynamic_update_slice``).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm


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
