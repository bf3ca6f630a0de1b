"""The bridge between the reference's parameter and cache pytrees and the
port's.

Both packages lay parameters out the same way (``lm.param_specs``: nested
dicts, stacked leading layer/group axes, projections shaped (d_in, d_out)),
so a conversion checks every leaf's path and shape against the specs and
moves the values; nothing is transposed or unstacked.  The reference side
is numpy arrays (``np.asarray`` of a JAX array; a bfloat16 one, an
``ml_dtypes`` array, is read through its 16-bit pattern).  numpy has no
bfloat16 of its own: ``*_to_reference`` widens a bfloat16 tensor to
float32, exactly.  The optimizer state (``m``, ``v`` and ``step``) crosses
the same way, each moment in its own dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.plans import resolve_device

from . import lm


def _spec_paths(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_spec_paths(v, f"{path}/{k}"))
        return out
    return {path: tree}


def _check(specs: dict, tree: dict, what: str) -> None:
    want = {p: tuple(s.shape) for p, s in _spec_paths(specs).items()}
    got = {p: tuple(np.shape(x)) for p, x in _spec_paths(tree).items()}
    if want != got:
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        wrong = sorted(p for p in set(want) & set(got) if want[p] != got[p])
        raise ValueError(f"{what} do not match the specs: missing {missing}, "
                         f"unexpected {extra}, wrong shape {wrong}")


def _to_torch(tree, dev, dtype):
    if isinstance(tree, dict):
        return {k: _to_torch(v, dev, dtype) for k, v in tree.items()}
    a = np.array(tree, copy=True)
    if a.dtype.name == "bfloat16":          # an ml_dtypes array: its 16-bit pattern
        x = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        x = torch.from_numpy(a)
    return x.to(device=dev, dtype=dtype or x.dtype)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    x = tree.detach().cpu()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


def params_from_reference(cfg, tree: dict, device=None, dtype=None) -> dict:
    """The reference's parameter pytree (numpy leaves) as the port's params
    on ``device`` (``cuda`` unless the caller passes another), cast to
    ``dtype`` if given."""
    _check(lm.param_specs(cfg), tree, "parameters")
    return _to_torch(tree, resolve_device(device), dtype)


def params_to_reference(cfg, params: dict) -> dict:
    """The port's params as the reference's pytree of numpy arrays."""
    _check(lm.param_specs(cfg), params, "parameters")
    return _to_numpy(params)


def caches_from_reference(cfg, tree: dict, device=None, dtype=None) -> dict:
    """A reference decode-cache dict (numpy leaves, ``cache_specs``' keys and
    shapes for its batch and length) as port tensors on ``device``."""
    _check_caches(cfg, tree)
    return _to_torch(tree, resolve_device(device), dtype)


def caches_to_reference(cfg, caches: dict) -> dict:
    _check_caches(cfg, caches)
    return _to_numpy(caches)


def _check_caches(cfg, tree: dict) -> None:
    key = "shared_k" if cfg.pattern == "zamba" else "tm_shift" if cfg.pattern == "rwkv" else "k"
    shape = np.shape(tree[key])
    batch = shape[-2] if cfg.pattern == "rwkv" else shape[-4]
    seq = 0 if cfg.pattern == "rwkv" else shape[-3]
    _check(lm.cache_specs(cfg, batch, seq), tree, "caches")


def opt_state_from_reference(cfg, tree: dict, device=None, dtype=None) -> dict:
    """The reference's AdamW state ``{"m", "v", "step"}`` (numpy leaves; m
    and v shaped like the parameters) as the port's on ``device`` (``cuda``
    unless the caller passes another).  m and v keep their own dtypes unless
    ``dtype`` is given; ``step`` is an int32 scalar."""
    if set(tree) != {"m", "v", "step"}:
        raise ValueError(f"an optimizer state has m, v and step, got {sorted(tree)}")
    specs = lm.param_specs(cfg)
    _check(specs, tree["m"], "first moments")
    _check(specs, tree["v"], "second moments")
    dev = resolve_device(device)
    return {"m": _to_torch(tree["m"], dev, dtype), "v": _to_torch(tree["v"], dev, dtype),
            "step": torch.tensor(np.array(tree["step"], dtype=np.int32), device=dev)}


def opt_state_to_reference(cfg, state: dict) -> dict:
    """The port's AdamW state as the reference's pytree of numpy arrays
    (bfloat16 moments widened to float32)."""
    specs = lm.param_specs(cfg)
    _check(specs, state["m"], "first moments")
    _check(specs, state["v"], "second moments")
    return {"m": _to_numpy(state["m"]), "v": _to_numpy(state["v"]),
            "step": np.asarray(state["step"].detach().cpu().numpy(), dtype=np.int32)}
