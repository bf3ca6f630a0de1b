"""Transformer building blocks: norms, RoPE, GQA attention (chunked online
softmax for prefill, cache attention for decode), MLP variants, MoE.

All functions are pure; parameters are dicts of tensors laid out as
``lm.param_specs`` describes them (a projection ``W`` is (d_in, d_out) and
is applied as ``x @ W``).  The reference's sharding constraints have no
counterpart on one device and are dropped.

Attention compute modes:
  - ``full_masked``  — chunked online-softmax attention over all kv chunks
    with a causal mask.
  - ``divide``       — recursive causal decomposition: causal(S) =
    causal(S/2) ⊕ full(S/2×S/2) ⊕ causal(S/2); the same result in about
    half the FLOPs.

Attention, like the rest of the LM stack, is plain PyTorch: no library
attention kernel stands in for the chunked algorithm.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms / RoPE
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps=1e-5):
    # squares in x.dtype, averages in float32, scales back in x.dtype
    var = x.square().mean(-1, keepdim=True, dtype=torch.float32)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * scale


def rope_freqs(dh: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32, device=device) / dh))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, dh); positions: (..., S) integer.  Rotate-half RoPE."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                    # (dh/2,)
    ang = positions[..., None].to(torch.float32) * freqs       # (..., S, dh/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention — chunked online softmax.  Returns (o, lse); lse lets partial
# attentions merge (the causal-divide decomposition).
# ---------------------------------------------------------------------------

def _expand_kv(x, g):
    """(B, T, K, dh) → (B, T, K·g, dh), each kv head repeated g times in
    place (``jnp.repeat``), so query head h reads kv head h // g."""
    return x.repeat_interleave(g, dim=2) if g > 1 else x


def _n_chunks(s: int, chunk: int) -> tuple[int, int]:
    n = max(s // min(chunk, s), 1)
    if s % n:
        raise ValueError(f"sequence length {s} does not split into {n} equal chunks")
    return n, s // n


def flash_attention(q, k, v, causal=True, q_chunk=512, kv_chunk=512, q_off=0, k_off=0):
    """Exact attention in (q chunk × kv chunk) blocks with an online softmax.

    q (B, Sq, H, dh), k/v (B, Sk, K, dh).  Returns (o in q's dtype, lse
    (B, Sq, H) in float32).  Query i sits at position ``q_off + i`` and key
    j at ``k_off + j`` for the causal mask.
    """
    b, sq, h, dh = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = 1.0 / math.sqrt(dh)
    qc_n, qc = _n_chunks(sq, q_chunk)
    kc_n, kc = _n_chunks(sk, kv_chunk)
    qs = q.float() * scale
    ks = k.float()
    vs = v.float()
    dev = q.device
    outs, lses = [], []
    for qi in range(qc_n):
        qb = qs[:, qi * qc:(qi + 1) * qc]
        qpos = q_off + qi * qc + torch.arange(qc, device=dev)
        o = torch.zeros((b, qc, h, dh), dtype=torch.float32, device=dev)
        m = torch.full((b, qc, h), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, qc, h), dtype=torch.float32, device=dev)
        for kj in range(kc_n):
            kb = _expand_kv(ks[:, kj * kc:(kj + 1) * kc], g)
            vb = _expand_kv(vs[:, kj * kc:(kj + 1) * kc], g)
            s = torch.einsum("bqhd,bthd->bhqt", qb, kb)
            if causal:
                kpos = k_off + kj * kc + torch.arange(kc, device=dev)
                s = torch.where((qpos[:, None] >= kpos[None, :])[None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1).transpose(1, 2))
            p = torch.exp(s - m_new.transpose(1, 2)[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1).transpose(1, 2)
            o = o * corr[..., None] + torch.einsum("bhqt,bthd->bqhd", p, vb)
            m = m_new
        lses.append(m + torch.log(torch.clamp(l, min=1e-30)))
        outs.append(o / torch.clamp(l, min=1e-30)[..., None])
    o = torch.cat(outs, dim=1)
    lse = torch.cat(lses, dim=1)
    return o.to(q.dtype), lse


def _merge_attn(a, b):
    """Merge two normalized partial attentions via their lse."""
    o_a, lse_a = a
    o_b, lse_b = b
    lse = torch.logaddexp(lse_a, lse_b)
    wa = torch.exp(lse_a - lse)[..., None]
    wb = torch.exp(lse_b - lse)[..., None]
    return o_a * wa + o_b * wb, lse


def _causal_divide(q, k, v, q_off, k_off, min_block, q_chunk, kv_chunk):
    """Exact causal attention in ~half the FLOPs: causal(S) = causal(S/2) ⊕
    full(upper·lower) ⊕ causal(S/2), recursively."""
    s = q.shape[1]
    if s <= min_block:
        return flash_attention(q, k, v, True, q_chunk, kv_chunk, q_off, k_off)
    half = s // 2
    a1 = _causal_divide(q[:, :half], k[:, :half], v[:, :half],
                        q_off, k_off, min_block, q_chunk, kv_chunk)
    a2d = _causal_divide(q[:, half:], k[:, half:], v[:, half:],
                         q_off + half, k_off + half, min_block, q_chunk, kv_chunk)
    a2f = flash_attention(q[:, half:], k[:, :half], v[:, :half],
                          False, q_chunk, kv_chunk, q_off + half, k_off)
    a2 = _merge_attn(a2d, a2f)
    return tuple(torch.cat([x1, x2], dim=1) for x1, x2 in zip(a1, a2))


def causal_attention(q, k, v, *, mode: str = "full_masked", q_chunk: int = 512,
                     kv_chunk: int = 512, min_block: int = 1024, offset: int = 0):
    """Causal self attention. q (B,S,H,dh), k/v (B,S,K,dh) → (B,S,H,dh)."""
    s = q.shape[1]
    if mode == "divide" and s > min_block:
        o, _ = _causal_divide(q, k, v, offset, offset, min_block, q_chunk, kv_chunk)
    else:
        o, _ = flash_attention(q, k, v, True, q_chunk, kv_chunk, offset, offset)
    return o.to(q.dtype)


def cross_attention(q, k, v, *, kv_chunk: int = 512):
    """Full (non-causal) attention against precomputed kv (VLM image tokens)."""
    o, _ = flash_attention(q, k, v, False, 512, kv_chunk, 0, 0)
    return o.to(q.dtype)


def decode_attention(q, cache_k, cache_v, valid_upto=None):
    """One-token attention against a full KV cache.

    q: (B, H, dh); cache_k/v: (B, T, K, dh).  Query heads are grouped as
    (K, g) so the cache is never head-expanded.  ``valid_upto`` (inclusive
    position) masks unwritten cache slots with ``NEG_INF``.
    """
    b, h, dh = q.shape
    t, kh = cache_k.shape[1], cache_k.shape[2]
    g = h // kh
    scale = 1.0 / math.sqrt(dh)
    qg = (q.float() * scale).reshape(b, kh, g, dh)
    s = torch.einsum("bkgd,btkd->bkgt", qg, cache_k.float())
    if valid_upto is not None:
        mask = torch.arange(t, device=q.device) <= valid_upto
        s = torch.where(mask[None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,btkd->bkgd", p, cache_v.float())
    return o.reshape(b, h, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# Attention block (projections + modes)
# ---------------------------------------------------------------------------

def attention_block(x, p, cfg, *, cache=None, pos_offset=0):
    """Self-attention with GQA + RoPE.

    prefill: cache is None → returns (y, (k, v)) so callers can build a
    prefill cache.  decode: cache = (k, v), the full cache, attended whole.
    """
    b, s, d = x.shape
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = (x @ p["wq"]).reshape(b, s, h, dh)
    k = (x @ p["wk"]).reshape(b, s, kh, dh)
    v = (x @ p["wv"]).reshape(b, s, kh, dh)
    pos = pos_offset + torch.arange(s, device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    if cache is not None:
        ck, cv = cache
        o = decode_attention(q[:, 0], ck, cv)[:, None]
    else:
        o = causal_attention(
            q, k, v, mode=cfg.attn_mode, q_chunk=cfg.attn_q_chunk,
            kv_chunk=cfg.attn_kv_chunk, min_block=cfg.attn_min_block,
        )
    y = o.reshape(b, s, h * dh) @ p["wo"]
    return y, (k, v)


def cross_attention_block(x, p, cfg, kv=None, vision=None):
    """Cross-attention against vision tokens (llama-3.2-vision style).

    ``kv`` (cached projected vision K/V) or ``vision`` (embeddings) must be
    given; returns (y, (k, v)).
    """
    b, s, d = x.shape
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = (x @ p["wq"]).reshape(b, s, h, dh)
    if kv is None:
        t = vision.shape[1]
        k = (vision @ p["wk"]).reshape(b, t, kh, dh)
        v = (vision @ p["wv"]).reshape(b, t, kh, dh)
    else:
        k, v = kv
    if s == 1:
        o = decode_attention(q[:, 0], k, v)[:, None]
    else:
        o = cross_attention(q, k, v, kv_chunk=cfg.attn_kv_chunk)
    y = o.reshape(b, s, h * dh) @ p["wo"]
    return y, (k, v)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def _activation(cfg, a, b=None):
    if cfg.mlp == "swiglu":
        return F.silu(a) * b
    if cfg.mlp == "squared_relu":          # nemotron-4
        return F.relu(a).square()
    if cfg.mlp == "gelu":                  # jax.nn.gelu's default: the tanh form
        return F.gelu(a, approximate="tanh")
    raise ValueError(cfg.mlp)


def mlp_block(x, p, cfg):
    hdn = _activation(cfg, x @ p["w1"], x @ p["w3"] if cfg.mlp == "swiglu" else None)
    return hdn @ p["w2"]


# ---------------------------------------------------------------------------
# Mixture of Experts (dropping, grouped one-hot dispatch)
# ---------------------------------------------------------------------------

def _top_k(x, k: int):
    """Largest k along the last axis, ties to the lower index (``lax.top_k``'s
    order; ``torch.topk`` does not promise one)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _capacity_slots(onehot, cap: int):
    """Buffer slot of each (token, choice) in its expert, and whether it fits
    under ``cap``.  Slots count in choice-major order (every token's first
    choice before any token's second), so a full expert drops later choices
    first.  onehot: (ng, g, k, e) → slot, in_cap (ng, g, k, e)."""
    ng, g, k, e = onehot.shape
    flat = onehot.transpose(1, 2).reshape(ng, k * g, e)
    pos = torch.cumsum(flat, dim=1) - flat
    pos = pos.reshape(ng, k, g, e).transpose(1, 2)
    in_cap = (pos < cap) & (onehot > 0)
    return torch.where(in_cap, pos, 0.0).long(), in_cap


def _moe_groups(xt, p, cfg, g: int, cap: int):
    """Dispatch + expert compute + combine for a slab of token groups.

    xt: (ng, g, d).  Returns (y (ng, g, d), aux scalar).
    """
    moe = cfg.moe
    e, k = moe.n_experts, moe.top_k
    ng = xt.shape[0]
    logits = torch.einsum("ngd,de->nge", xt, p["router"]).float()
    gates = torch.softmax(logits, dim=-1)
    topv, topi = _top_k(gates, k)                                  # (ng, g, k)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)

    onehot = F.one_hot(topi, e).float()                            # (ng, g, k, e)
    slot, in_cap = _capacity_slots(onehot, cap)
    slot_oh = F.one_hot(slot, cap).to(xt.dtype) * in_cap[..., None].to(xt.dtype)
    dispatch = slot_oh.sum(dim=2)                                  # (ng,g,e,cap)
    combine = torch.einsum("ngkec,ngk->ngec", slot_oh, topv.to(xt.dtype))

    xin = torch.einsum("ngec,ngd->necd", dispatch, xt)             # (ng,e,cap,d)
    a = torch.einsum("necd,edf->necf", xin, p["w1"])
    b = torch.einsum("necd,edf->necf", xin, p["w3"]) if cfg.mlp == "swiglu" else None
    hdn = F.silu(a) * b if cfg.mlp == "swiglu" else F.relu(a).square()
    out = torch.einsum("necf,efd->necd", hdn, p["w2"])
    y = torch.einsum("ngec,necd->ngd", combine, out)
    return y, _load_balance_loss(gates, onehot)


def moe_block(x, p, cfg):
    """Top-k MoE with capacity-bounded one-hot dispatch.

    Tokens are processed in groups of ``cfg.moe.group``, the groups in up to
    16 slabs (the reference's checkpointed scan); the aux loss is the mean
    of the slabs'.
    """
    moe = cfg.moe
    b, s, d = x.shape
    e, k = moe.n_experts, moe.top_k
    g = min(moe.group, b * s)
    n = b * s
    if n % g:
        raise ValueError(f"{n} tokens do not split into MoE groups of {g}")
    ng = n // g
    cap = min(int(math.ceil(g * k * moe.capacity_factor / e)), g)
    xt = x.reshape(ng, g, d)

    steps = min(16, ng)
    while ng % steps:
        steps -= 1
    if steps <= 1:
        y, aux = _moe_groups(xt, p, cfg, g, cap)
        return y.reshape(b, s, d).to(x.dtype), aux
    ys, auxs = zip(*(_moe_groups(slab, p, cfg, g, cap)
                     for slab in xt.reshape(steps, ng // steps, g, d)))
    y = torch.cat(ys, dim=0)
    return y.reshape(b, s, d).to(x.dtype), torch.stack(auxs).mean()


def _load_balance_loss(gates, onehot):
    # Switch-style auxiliary load-balance loss
    e = gates.shape[-1]
    frac_tokens = onehot.sum(2).mean(dim=(0, 1))   # (e,)
    frac_gates = gates.mean(dim=(0, 1))
    return e * (frac_tokens * frac_gates).sum() / onehot.shape[2]
