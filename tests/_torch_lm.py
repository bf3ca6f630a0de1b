"""Shared inputs of the LM-stack parity tests: every parameter leaf random
from a numpy seed (the reference's init sets conv_w, a_log, mu_*, u and the
VLM gate to constants, under which a flipped conv, swapped mixes or a dead
cross-attention block would still agree), batches from a seed, and the
conversions into both packages (JAX is imported only there)."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import convert, lm

# float32 on both sides: one layer's outputs to RTOL / ATOL, tokens exactly.
# Whole smoke models get STACK_ATOL: the deepest (zamba: two shared blocks and
# 8 Mamba2 layers) differs by up to 2.1e-5 on near-zero logits and cache
# entries (logits reach 4), from float32 summation order alone.
RTOL, ATOL = 1e-4, 1e-5
STACK_ATOL = 5e-5


def random_tree(cfg, seed: int) -> dict:
    """A numpy value for every leaf of ``param_specs`` (the port's specs,
    equal to the reference's: ``test_init_params_follows_specs_and_repeats``),
    so this module needs no JAX and serves the card tests too."""
    rng = np.random.default_rng(seed)

    def build(path: str, spec):
        name = path.rsplit("/", 1)[-1]
        shape = spec.shape
        if name.startswith("mu_"):
            return rng.uniform(0.0, 1.0, shape).astype(np.float32)
        if name == "gate":
            return rng.standard_normal(shape).astype(np.float32)
        if spec.init == "normal":
            fan_in = shape[-2] if len(shape) >= 2 else max(shape[-1], 1)
            return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
        base = {"zeros": 0.0, "ones": 1.0}.get(spec.init)
        if base is None:
            base = float(spec.init[6:])
        return (base + 0.3 * rng.standard_normal(shape)).astype(np.float32)

    return lm.map_specs(lm.param_specs(cfg), build)


def both_params(cfg, seed: int):
    """(numpy tree, the reference's params, the port's CPU params)."""
    import jax.numpy as jnp

    tree = random_tree(cfg, seed)
    jp = _map(tree, jnp.asarray)
    tp = convert.params_from_reference(cfg, tree, device="cpu", dtype=torch.float32)
    return tree, jp, tp


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def make_batch(cfg, b: int, s: int, seed: int, labels: bool = False) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.input_mode == "embeddings":
        out["embeds"] = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    if cfg.input_mode == "tokens+vision":
        out["vision"] = rng.standard_normal((b, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    if labels:
        out["labels"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    return out


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close(port, ref, what: str = "", rtol: float = RTOL, atol: float = ATOL):
    np.testing.assert_allclose(to_np(port), to_np(ref), rtol=rtol, atol=atol, err_msg=what)


def assert_tree_close(port: dict, ref: dict, what: str = "", **tol):
    assert set(port) == set(ref), (what, sorted(port), sorted(ref))
    for k in ref:
        assert_close(port[k], ref[k], f"{what}[{k}]", **tol)
