"""Batched serving: prefill a prompt batch, then decode N tokens.

A prefill step builds the KV/state caches, the attention caches are padded
out to ``--cache-len``, and a single-token decode step runs greedily,
writing each token's K/V into them in place.  Runs on ``cuda`` unless
``--device cpu`` is passed; without a card it raises.

Example:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b --smoke \
      --batch 4 --prompt-len 64 --gen 32
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F


def _is_attn_cache(name: str) -> bool:
    return name in ("k", "v") or name.endswith(("_k", "_v"))


def pad_caches(caches: dict, cache_len: int) -> dict:
    """Attention caches padded with zeros on the sequence axis (-3) to
    ``cache_len`` slots; state caches as they are."""
    out = {}
    for name, x in caches.items():
        pad = cache_len - x.shape[-3] if _is_attn_cache(name) else 0
        out[name] = F.pad(x, (0, 0, 0, 0, 0, pad)) if pad > 0 else x
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-12b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--no-smoke", dest="smoke", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.configs.base import smoke_config
    from repro_torch.core.plans import resolve_device
    from repro_torch.models import lm
    from repro_torch.runtime.step import make_decode_step, make_prefill_step

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    b, s = args.batch, args.prompt_len
    cache_len = args.cache_len or (s + args.gen)
    rng = np.random.default_rng(0)
    params = lm.init_params(cfg, 0, device=device)

    batch = {}
    if cfg.input_mode == "embeddings":
        batch["embeds"] = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    if cfg.input_mode == "tokens+vision":
        batch["vision"] = rng.standard_normal(
            (b, cfg.n_vision_tokens, cfg.d_model)
        ).astype(np.float32)
    batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}

    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg)

    _sync(device)
    t0 = time.perf_counter()
    logits, caches = prefill(params, batch)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    print(f"[serve] prefill {b}x{s}: {t_prefill*1e3:.1f}ms", flush=True)

    caches = pad_caches(caches, cache_len)

    tok = logits.argmax(-1).to(torch.int32)[:, None]
    out_tokens = [tok]
    t0 = time.perf_counter()
    for i in range(args.gen):
        db = {}
        if cfg.input_mode == "embeddings":
            db["embeds"] = torch.zeros((b, 1, cfg.d_model), dtype=torch.float32, device=device)
        else:
            db["tokens"] = tok
        if cfg.input_mode == "tokens+vision":
            db["vision"] = batch["vision"]
        logits, caches = decode(params, db, caches, s + i)
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        out_tokens.append(tok)
    _sync(device)
    t_dec = time.perf_counter() - t0
    tps = b * args.gen / t_dec
    print(f"[serve] decode {args.gen} steps: {t_dec*1e3:.1f}ms  ({tps:.1f} tok/s)", flush=True)
    seq = torch.cat(out_tokens, dim=1).cpu().numpy()
    print(f"[serve] sample tokens: {seq[0][:16].tolist()}", flush=True)
    return seq


if __name__ == "__main__":
    main()
