"""State-space blocks: Mamba2 (SSD chunked form) and RWKV6 (chunked WKV).

Both run in their chunked-parallel forms: within a chunk the recurrence is
a masked matmul, and only the chunk-to-chunk state carry is sequential (a
Python loop over chunks).  The sequential single-step references
(``*_reference``) are the oracles for the tests, and the ``*_decode_step``
functions are the O(1)-state decode steps.

Numerical note (WKV6): the intra-chunk decay matrix is computed with the
exact pairwise log-difference ``exp(pc_t - cum_s)`` (always ≤ 1 under the
strictly-lower-triangular mask), avoiding the separable form's overflow.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import rms_norm


def _pad_seq(x, pad: int):
    """Zero-pad axis 1 at its end by ``pad``."""
    return F.pad(x, (0, 0) * (x.ndim - 2) + (0, pad))


def _chunks(x, nc: int, chunk: int):
    """(B, nc·Q, ...) → (nc, B, Q, ...)."""
    return x.reshape(x.shape[0], nc, chunk, *x.shape[2:]).transpose(0, 1)


def _unchunk(y, b: int, s: int):
    """(nc, B, Q, ...) → (B, nc·Q, ...)."""
    return y.transpose(0, 1).reshape(b, s, *y.shape[3:])


# ---------------------------------------------------------------------------
# Mamba2 SSD
# ---------------------------------------------------------------------------

def ssd_chunked(xh, log_a, B_t, C_t, chunk: int, vectorized: bool = False):
    """Chunked SSD scan.

    xh:    (B, S, H, P)  dt-scaled inputs
    log_a: (B, S, H)     per-step log decay (≤ 0)
    B_t:   (B, S, N)     input projections (shared across heads)
    C_t:   (B, S, N)     output projections
    Returns y (B, S, H, P) and final state (B, H, N, P).  ``vectorized``
    computes every chunk's intra-chunk terms at once and loops only over the
    state carry; the result is the same.
    """
    b, s, h, p = xh.shape
    n = B_t.shape[-1]
    pad = (-s) % chunk
    if pad:  # state-neutral padding: zero input, decay 1
        y, S_fin = ssd_chunked(_pad_seq(xh, pad), _pad_seq(log_a, pad), _pad_seq(B_t, pad),
                               _pad_seq(C_t, pad), chunk, vectorized)
        return y[:, :s], S_fin
    nc = s // chunk
    xh_c, la_c, b_c, c_c = (_chunks(t, nc, chunk) for t in (xh, log_a, B_t, C_t))
    tril = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=xh.device))
    S = torch.zeros((b, h, n, p), dtype=torch.float32, device=xh.device)
    if vectorized:
        cum = torch.cumsum(la_c, dim=2)                                  # (nc,B,Q,H)
        cb = torch.einsum("cbtn,cbsn->cbts", c_c, b_c)
        dec = torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :])
        m = torch.where(tril[None, None, :, :, None], cb[..., None] * dec, 0.0)
        y_intra = torch.einsum("cbtsh,cbshp->cbthp", m, xh_c)
        w = torch.exp(cum[:, :, -1:, :] - cum)
        S_in = torch.einsum("cbshp,cbsn->cbhnp", w[..., None] * xh_c, b_c)  # per-chunk input state
        gain = torch.exp(cum[:, :, -1])                                  # (nc,B,H)
        S_prev = []                                                      # state BEFORE each chunk
        for i in range(nc):
            S_prev.append(S)
            S = gain[i][:, :, None, None] * S + S_in[i]
        y_int = torch.einsum("cbtn,cbhnp->cbthp", c_c, torch.stack(S_prev))
        y = y_intra + torch.exp(cum)[..., None] * y_int
        return _unchunk(y, b, s), S
    ys = []
    for x_i, la_i, b_i, c_i in zip(xh_c, la_c, b_c, c_c):                # (B,Q,...)
        cum = torch.cumsum(la_i, dim=1)                                  # (B,Q,H)
        cb = torch.einsum("btn,bsn->bts", c_i, b_i)                      # (B,Q,Q)
        dec = torch.exp(cum[:, :, None, :] - cum[:, None, :, :])         # (B,t,s,H)
        m = torch.where(tril[None, :, :, None], cb[..., None] * dec, 0.0)
        y = torch.einsum("btsh,bshp->bthp", m, x_i)                      # intra
        y = y + torch.einsum("bth,btn,bhnp->bthp", torch.exp(cum), c_i, S)  # inter
        w = torch.exp(cum[:, -1:, :] - cum)                              # (B,Q,H)
        S = torch.exp(cum[:, -1])[:, :, None, None] * S + torch.einsum(
            "bsh,bsn,bshp->bhnp", w, b_i, x_i)
        ys.append(y)
    return _unchunk(torch.stack(ys), b, s), S


def ssd_reference(xh, log_a, B_t, C_t):
    """Sequential oracle: S_t = a_t S_{t-1} + B_t ⊗ x_t ; y_t = C_t · S_t."""
    b, s, h, p = xh.shape
    n = B_t.shape[-1]
    S = torch.zeros((b, h, n, p), dtype=torch.float32, device=xh.device)
    ys = []
    for t in range(s):
        S, y = ssd_decode_step(S, xh[:, t], log_a[:, t], B_t[:, t], C_t[:, t])
        ys.append(y)
    return torch.stack(ys, dim=1), S


def ssd_decode_step(S, x_t, log_a_t, b_t, c_t):
    """One decode step; S (B,H,N,P), x_t (B,H,P), log_a_t (B,H), b/c_t (B,N)."""
    S = torch.exp(log_a_t)[:, :, None, None] * S + torch.einsum("bn,bhp->bhnp", b_t, x_t)
    y = torch.einsum("bn,bhnp->bhp", c_t, S)
    return S, y


def mamba2_mix(x, p, cfg, state=None):
    """Full Mamba2 mixer: in_proj → causal depthwise conv → SSD → gated out.

    state (decode): dict(conv=(B, conv-1, d_in), ssm=(B,H,N,P)) or None.
    Returns (y, new_state).
    """
    ssm = cfg.ssm
    b, s = x.shape[0], x.shape[1]
    d_in = ssm.expand * cfg.d_model
    h = d_in // ssm.head_dim
    n, pdim = ssm.state, ssm.head_dim

    zxbcdt = x @ p["in_proj"]
    z, xr, b_t, c_t, dt = torch.split(zxbcdt, [d_in, d_in, n, n, h], dim=-1)
    # causal depthwise conv (kernel ssm.conv) on xr: output t weights input
    # t - conv + 1 + i by conv_w[i]
    if state is None:
        lead = torch.zeros((b, ssm.conv - 1, d_in), dtype=xr.dtype, device=xr.device)
    else:
        lead = state["conv"].to(xr.dtype)
    xp = torch.cat([lead, xr], dim=1)
    new_conv = xp[:, -(ssm.conv - 1):]
    xc = sum(xp[:, i:i + s] * p["conv_w"][i][None, None, :] for i in range(ssm.conv)) + p["conv_b"]
    xc = F.silu(xc)

    dt = F.softplus(dt.float() + p["dt_bias"])                        # (B,S,H)
    log_a = -torch.exp(p["a_log"])[None, None, :] * dt                # (B,S,H)
    xh = xc.reshape(b, s, h, pdim).float() * dt[..., None]
    b_t = b_t.float()
    c_t = c_t.float()

    if state is None:
        y, S_fin = ssd_chunked(xh, log_a, b_t, c_t, min(ssm.chunk, s),
                               vectorized=cfg.unroll_scans)
    else:
        S_fin, y1 = ssd_decode_step(state["ssm"], xh[:, 0], log_a[:, 0], b_t[:, 0], c_t[:, 0])
        y = y1[:, None]
    y = y + p["d_skip"][None, None, :, None] * xc.reshape(b, s, h, pdim).float()
    y = y.reshape(b, s, d_in)
    y = rms_norm(y.to(x.dtype) * F.silu(z), p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"]
    return out, {"conv": new_conv, "ssm": S_fin}


# ---------------------------------------------------------------------------
# RWKV6 (Finch)
# ---------------------------------------------------------------------------

def wkv_chunked(r, k, v, log_w, u, chunk: int, vectorized: bool = False):
    """Chunked WKV6: S_t = diag(w_t) S_{t-1} + kᵀv ; o_t = r·(S_{t-1} + diag(u) kᵀv).

    r, k, log_w: (B, S, H, K); v: (B, S, H, V); u: (H, K).
    Returns o (B, S, H, V) and final state (B, H, K, V).
    """
    b, s, h, kk = r.shape
    vv = v.shape[-1]
    pad = (-s) % chunk
    if pad:  # state-neutral padding: r=k=v=0, decay 1 (log_w=0)
        o, S_fin = wkv_chunked(_pad_seq(r, pad), _pad_seq(k, pad), _pad_seq(v, pad),
                               _pad_seq(log_w, pad), u, chunk, vectorized)
        return o[:, :s], S_fin
    nc = s // chunk
    rs, ks, vs, ws = (_chunks(t, nc, chunk) for t in (r, k, v, log_w))
    strict = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=r.device), diagonal=-1)
    S = torch.zeros((b, h, kk, vv), dtype=torch.float32, device=r.device)
    if vectorized:
        cum = torch.cumsum(ws, dim=2)                                    # (nc,B,Q,H,K)
        pc = cum - ws
        dec = torch.exp(torch.clamp(pc[:, :, :, None] - cum[:, :, None, :], max=0.0))
        a = torch.einsum("cbtshk,cbshk->cbths", rs[:, :, :, None] * dec, ks)
        a = torch.where(strict[None, None, :, None, :], a, 0.0)
        o = torch.einsum("cbths,cbshv->cbthv", a, vs)
        o = o + (rs * u[None, None, None] * ks).sum(-1)[..., None] * vs
        decay_to_end = torch.exp(cum[:, :, -1][:, :, None] - cum)
        S_in = torch.einsum("cbshk,cbshv->cbhkv", ks * decay_to_end, vs)
        gain = torch.exp(cum[:, :, -1])                                  # (nc,B,H,K)
        S_prev = []
        for i in range(nc):
            S_prev.append(S)
            S = gain[i][..., None] * S + S_in[i]
        o = o + torch.einsum("cbthk,cbhkv->cbthv", rs * torch.exp(pc), torch.stack(S_prev))
        return _unchunk(o, b, s), S
    os_ = []
    for r_i, k_i, v_i, w_i in zip(rs, ks, vs, ws):                      # (B,Q,H,K/V)
        cum = torch.cumsum(w_i, dim=1)               # cum_t = Σ_{j≤t} log w
        pc = cum - w_i                               # cum_{t-1}
        # inter-chunk: o += (r ⊙ exp(pc)) · S
        o = torch.einsum("bthk,bhkv->bthv", r_i * torch.exp(pc), S)
        # intra-chunk strictly-lower: A[t,s] = Σ_K r_t k_s exp(pc_t - cum_s)
        dec = torch.exp(torch.clamp(pc[:, :, None] - cum[:, None, :], max=0.0))  # (B,t,s,H,K)
        a = torch.einsum("bthk,bshk,btshk->bths", r_i, k_i, dec)
        a = torch.where(strict[None, :, None, :], a, 0.0)
        o = o + torch.einsum("bths,bshv->bthv", a, v_i)
        # diagonal bonus term: (r ⊙ u ⊙ k) per step
        o = o + (r_i * u[None, None] * k_i).sum(-1)[..., None] * v_i
        # state update: S' = diag(Πw) S + Σ_s exp(cum_Q - cum_s) k_s ⊗ v_s
        decay_to_end = torch.exp(cum[:, -1][:, None] - cum)           # (B,Q,H,K) ≤ 1
        S = torch.exp(cum[:, -1])[..., None] * S + torch.einsum(
            "bshk,bshv->bhkv", k_i * decay_to_end, v_i)
        os_.append(o)
    return _unchunk(torch.stack(os_), b, s), S


def wkv_reference(r, k, v, log_w, u):
    """Sequential oracle for WKV6."""
    b, s, h, kk = r.shape
    S = torch.zeros((b, h, kk, v.shape[-1]), dtype=torch.float32, device=r.device)
    os_ = []
    for t in range(s):
        S, o = wkv_decode_step(S, r[:, t], k[:, t], v[:, t], log_w[:, t], u)
        os_.append(o)
    return torch.stack(os_, dim=1), S


def wkv_decode_step(S, r_t, k_t, v_t, log_w_t, u):
    kv = torch.einsum("bhk,bhv->bhkv", k_t, v_t)
    o = torch.einsum("bhk,bhkv->bhv", r_t, S + u[None][..., None] * kv)
    S = torch.exp(log_w_t)[..., None] * S + kv
    return S, o


def _token_shift(x, state):
    """(previous token, new shift state); the first token's previous is the
    state (decode) or zero (prefill)."""
    if state is None:
        prev = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
    else:
        prev = state[:, None].to(x.dtype)
    return prev, x[:, -1]


def rwkv_time_mix(x, p, cfg, state=None):
    """RWKV6 time-mix with data-dependent decay.

    state (decode): dict(shift=(B, D), wkv=(B,H,K,V)).  Returns (y, new_state).
    """
    rw = cfg.rwkv
    b, s, d = x.shape
    h = d // rw.head_dim
    kk = rw.head_dim

    prev, new_shift = _token_shift(x, None if state is None else state["shift"])
    dx = prev - x

    def mix(mu):
        return x + dx * mu[None, None, :]

    r = (mix(p["mu_r"]) @ p["wr"]).reshape(b, s, h, kk)
    kx = (mix(p["mu_k"]) @ p["wk"]).reshape(b, s, h, kk)
    vx = (mix(p["mu_v"]) @ p["wv"]).reshape(b, s, h, kk)
    g = F.silu(mix(p["mu_g"]) @ p["wg"])
    # data-dependent decay (the Finch contribution): w = exp(-exp(w0 + lora(x)))
    ddd = torch.tanh(mix(p["mu_w"]) @ p["w_lora_a"]) @ p["w_lora_b"]
    log_w = -torch.exp(torch.clamp(p["w0"][None, None, :] + ddd.float(), max=8.0))
    log_w = log_w.reshape(b, s, h, kk)

    r32, k32, v32 = (t.float() for t in (r, kx, vx))
    if state is None:
        o, S_fin = wkv_chunked(r32, k32, v32, log_w, p["u"], min(rw.chunk, s),
                               vectorized=cfg.unroll_scans)
    else:
        S_fin, o1 = wkv_decode_step(state["wkv"], r32[:, 0], k32[:, 0], v32[:, 0],
                                    log_w[:, 0], p["u"])
        o = o1[:, None]
    # per-head groupnorm, with the population variance (``jnp.var``)
    o = o.reshape(b, s, h, kk)
    mean = o.mean(-1, keepdim=True)
    var = o.var(-1, keepdim=True, correction=0)
    o = (o - mean) * torch.rsqrt(var + 64e-5)
    o = o.reshape(b, s, d) * p["ln_x"][None, None, :]
    y = (o.to(x.dtype) * g) @ p["wo"]
    return y, {"shift": new_shift, "wkv": S_fin}


def rwkv_channel_mix(x, p, state=None):
    """RWKV6 channel-mix; state (decode): (B, D) shift."""
    prev, new_shift = _token_shift(x, state)
    dx = prev - x
    xk = x + dx * p["mu_k"][None, None, :]
    xr = x + dx * p["mu_r"][None, None, :]
    k = F.relu(xk @ p["wk"]).square()
    y = torch.sigmoid(xr @ p["wr_gate"]) * (k @ p["wv"])
    return y, new_shift
