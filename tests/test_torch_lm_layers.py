"""The port's LM layers (``repro_torch.models.layers`` / ``ssm``) against the
reference's (``repro.models.layers`` / ``ssm``) on the same numpy inputs,
float32 on both sides: rtol 1e-4 / atol 1e-5 (``tests/_torch_lm.py``),
atol 1e-4 for the WKV scans (``tests/test_models.py``'s).

Where a port could pick a plausible wrong variant — erf GELU, the sample
variance, ``Tensor.repeat`` for GQA, a flipped conv, token-major MoE
slots — the test also runs that variant and shows it outside the
tolerance.  Then the port-only mirrors of ``tests/test_models.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from _torch_lm import ATOL, RTOL, assert_close, to_np
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import MoEConfig as JMoE, RWKVConfig as JRWKV, SSMConfig as JSSM
from repro.models import layers as JL
from repro.models import ssm as JS
from repro_torch.configs.base import ModelConfig, MoEConfig, RWKVConfig, SSMConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as S


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def J(fn, *arrays, **static):
    """A reference function under ``jax.jit``: ``arrays`` traced, keyword
    arguments fixed at trace time."""
    return jax.jit(lambda *a: fn(*a, **static))(*arrays)


def _t(x):
    return torch.as_tensor(x)


def _tree(d, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in d.items()}


def _cfgs(**kw):
    """The same config in both packages."""
    base = dict(name="t", family="x", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                d_head=8, d_ff=64, vocab=64, attn_q_chunk=8, attn_kv_chunk=8,
                attn_min_block=8)
    base.update(kw)
    j = dict(base)
    for key, jt in (("moe", JMoE), ("ssm", JSSM), ("rwkv", JRWKV)):
        if key in j:
            j[key] = jt(**dataclasses.asdict(j[key]))
    return JModelConfig(**j), ModelConfig(**base)


def naive_attention(q, k, v, causal=True):
    b, s, h, dh = q.shape
    g = h // k.shape[2]
    ke = k.repeat_interleave(g, dim=2)
    ve = v.repeat_interleave(g, dim=2)
    sc = torch.einsum("bqhd,bthd->bhqt", q / np.sqrt(dh), ke)
    if causal:
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool))
        sc = torch.where(mask[None, None], sc, -1e30)
    return torch.einsum("bhqt,bthd->bqhd", torch.softmax(sc, -1), ve)


# ---------------------------------------------------------------------------
# norms, RoPE, attention
# ---------------------------------------------------------------------------

def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x, scale = _rand(rng, 2, 5, 16), _rand(rng, 16)
    assert_close(L.rms_norm(_t(x), _t(scale), 1e-5), J(JL.rms_norm, x, scale, eps=1e-5))
    q = _rand(rng, 2, 7, 3, 8)
    pos = np.arange(7) + 5
    assert_close(L.apply_rope(_t(q), _t(pos), 10_000.0), J(JL.apply_rope, q, pos, theta=10_000.0))


def test_rms_norm_keeps_bf16_and_matches_float64():
    g = torch.Generator().manual_seed(0)
    x = (5 * torch.randn(3, 4096, generator=g)).to(torch.bfloat16)
    scale = (1 + 0.1 * torch.randn(4096, generator=g)).to(torch.bfloat16)
    out = L.rms_norm(x, scale)
    assert out.dtype == torch.bfloat16
    x64 = x.double()
    want = x64 / torch.sqrt(x64.square().mean(-1, keepdim=True) + 1e-5) * scale.double()
    # three bf16 roundings (the rsqrt, x·r, ·scale) of 2^-8 each
    torch.testing.assert_close(out.double(), want, rtol=3 * 2**-8, atol=0)


@pytest.mark.parametrize("qc,kc", [(32, 32), (128, 64), (64, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_reference(qc, kc, causal):
    rng = np.random.default_rng(1)
    q, k, v = _rand(rng, 2, 128, 4, 16), _rand(rng, 2, 128, 2, 16), _rand(rng, 2, 128, 2, 16)
    for q_off, k_off in ((0, 0), (40, 8)):
        o, lse = L.flash_attention(_t(q), _t(k), _t(v), causal, qc, kc, q_off, k_off)
        jo, jlse = J(JL.flash_attention, q, k, v, causal=causal, q_chunk=qc, kv_chunk=kc,
                     q_off=q_off, k_off=k_off)
        assert_close(o, jo, f"o {q_off} {k_off}")
        assert_close(lse, jlse, f"lse {q_off} {k_off}")


def test_gqa_expands_kv_heads_in_place_not_tiled(monkeypatch):
    rng = np.random.default_rng(2)
    q, k, v = _rand(rng, 1, 16, 4, 8), _rand(rng, 1, 16, 2, 8), _rand(rng, 1, 16, 2, 8)
    jo, _ = J(JL.flash_attention, q, k, v, q_chunk=16, kv_chunk=16)
    assert_close(L.flash_attention(_t(q), _t(k), _t(v), True, 16, 16)[0], jo)
    monkeypatch.setattr(L, "_expand_kv", lambda x, g: x.repeat(1, 1, g, 1))
    tiled = L.flash_attention(_t(q), _t(k), _t(v), True, 16, 16)[0]
    assert not np.allclose(to_np(tiled), np.asarray(jo), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", ["full_masked", "divide"])
def test_causal_attention_matches_reference(mode):
    rng = np.random.default_rng(3)
    q, k, v = _rand(rng, 1, 128, 4, 8), _rand(rng, 1, 128, 2, 8), _rand(rng, 1, 128, 2, 8)
    kw = dict(mode=mode, q_chunk=16, kv_chunk=32, min_block=32)
    assert_close(L.causal_attention(_t(q), _t(k), _t(v), **kw),
                 J(JL.causal_attention, q, k, v, **kw))


def test_decode_attention_masks_past_valid_upto():
    rng = np.random.default_rng(4)
    q, ck, cv = _rand(rng, 2, 4, 8), _rand(rng, 2, 10, 2, 8), _rand(rng, 2, 10, 2, 8)
    for upto in (None, 6):
        assert_close(L.decode_attention(_t(q), _t(ck), _t(cv), upto),
                     J(JL.decode_attention, q, ck, cv, valid_upto=upto), f"valid_upto={upto}")
    # slots past valid_upto do not matter
    junk = ck.copy()
    junk[:, 7:] = 1e3
    assert_close(L.decode_attention(_t(q), _t(junk), _t(cv), 6),
                 J(JL.decode_attention, q, ck, cv, valid_upto=6))


def _attn_params(rng, d, h, kh, dh):
    return {"wq": _rand(rng, d, h * dh, scale=d ** -0.5), "wk": _rand(rng, d, kh * dh, scale=d ** -0.5),
            "wv": _rand(rng, d, kh * dh, scale=d ** -0.5), "wo": _rand(rng, h * dh, d, scale=0.3)}


def test_attention_block_prefill_and_decode_match_reference():
    jc, tc = _cfgs()
    rng = np.random.default_rng(5)
    p = _attn_params(rng, 32, 4, 2, 8)
    tp = _tree(p, _t)
    x = _rand(rng, 2, 16, 32)
    y, (k, v) = L.attention_block(_t(x), tp, tc, pos_offset=3)
    jy, (jk, jv) = J(JL.attention_block, x, p, cfg=jc, pos_offset=3)
    for a, b, w in ((y, jy, "y"), (k, jk, "k"), (v, jv, "v")):
        assert_close(a, b, w)
    x1 = _rand(rng, 2, 1, 32)
    cache = (_rand(rng, 2, 12, 2, 8), _rand(rng, 2, 12, 2, 8))
    y1, _ = L.attention_block(_t(x1), tp, tc, cache=tuple(map(_t, cache)), pos_offset=11)
    jy1, _ = J(JL.attention_block, x1, p, cfg=jc, cache=cache, pos_offset=11)
    assert_close(y1, jy1, "decode")


def test_cross_attention_block_prefill_and_single_token_match_reference():
    jc, tc = _cfgs()
    rng = np.random.default_rng(6)
    p = _attn_params(rng, 32, 4, 2, 8)
    tp = _tree(p, _t)
    x, vision = _rand(rng, 2, 16, 32), _rand(rng, 2, 8, 32)
    y, (k, v) = L.cross_attention_block(_t(x), tp, tc, vision=_t(vision))
    jy, (jk, jv) = J(JL.cross_attention_block, x, p, cfg=jc, vision=vision)
    for a, b, w in ((y, jy, "y"), (k, jk, "k"), (v, jv, "v")):
        assert_close(a, b, w)
    x1 = _rand(rng, 2, 1, 32)
    y1, _ = L.cross_attention_block(_t(x1), tp, tc, kv=(k, v))
    jy1, _ = J(JL.cross_attention_block, x1, p, cfg=jc, kv=(jk, jv))
    assert_close(y1, jy1, "s == 1")


# ---------------------------------------------------------------------------
# MLPs and MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mlp", ["swiglu", "squared_relu", "gelu"])
def test_mlp_block_matches_reference(mlp):
    jc, tc = _cfgs(mlp=mlp)
    rng = np.random.default_rng(7)
    p = {"w1": _rand(rng, 32, 64, scale=0.5), "w2": _rand(rng, 64, 32, scale=0.2)}
    if mlp == "swiglu":
        p["w3"] = _rand(rng, 32, 64, scale=0.5)
    x = _rand(rng, 2, 9, 32)
    ref = J(JL.mlp_block, x, p, cfg=jc)
    assert_close(L.mlp_block(_t(x), _tree(p, _t), tc), ref)
    if mlp == "gelu":  # jax.nn.gelu is the tanh form; the erf form is not within tolerance
        erf = F.gelu(_t(x) @ _t(p["w1"])) @ _t(p["w2"])
        assert not np.allclose(to_np(erf), np.asarray(ref), rtol=RTOL, atol=ATOL)


def _moe_params(rng, e, d, f):
    return {"router": _rand(rng, d, e), "w1": _rand(rng, e, d, f, scale=d ** -0.5),
            "w3": _rand(rng, e, d, f, scale=d ** -0.5), "w2": _rand(rng, e, f, d, scale=f ** -0.5)}


@pytest.mark.parametrize("capacity_factor,group", [(2.0, 32), (1.25, 16), (0.5, 16)])
def test_moe_block_matches_reference(capacity_factor, group):
    """(2.0, 32): no token dropped, one slab; (1.25, 16): four slabs (the
    reference's scan), aux averaged over them; (0.5, 16): capacity 4 of 16
    tokens' 32 choices, so most are dropped."""
    jc, tc = _cfgs(moe=MoEConfig(4, 2, 16, capacity_factor=capacity_factor, group=group))
    rng = np.random.default_rng(8)
    p = _moe_params(rng, 4, 32, 16)
    x = _rand(rng, 2, 32, 32)
    y, aux = L.moe_block(_t(x), _tree(p, _t), tc)
    jy, jaux = J(JL.moe_block, x, p, cfg=jc)
    assert_close(y, jy, "y")
    assert_close(aux, jaux, "aux")


def test_moe_drops_later_choices_first(monkeypatch):
    """A capacity that drops: slots count choice-major; a token-major count
    keeps other (token, choice) pairs and is outside the tolerance."""
    jc, tc = _cfgs(moe=MoEConfig(4, 2, 16, capacity_factor=0.5, group=32))
    rng = np.random.default_rng(9)
    p = _moe_params(rng, 4, 32, 16)
    x = _rand(rng, 1, 32, 32)
    tp = _tree(p, _t)
    jy, _ = J(JL.moe_block, x, p, cfg=jc)
    assert_close(L.moe_block(_t(x), tp, tc)[0], jy)
    roomy = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, capacity_factor=4.0))
    assert not np.allclose(to_np(L.moe_block(_t(x), tp, roomy)[0]), np.asarray(jy))  # drops

    def token_major(onehot, cap):
        ng, g, k, e = onehot.shape
        flat = onehot.reshape(ng, g * k, e)
        pos = (torch.cumsum(flat, dim=1) - flat).reshape(ng, g, k, e)
        in_cap = (pos < cap) & (onehot > 0)
        return torch.where(in_cap, pos, 0.0).long(), in_cap

    monkeypatch.setattr(L, "_capacity_slots", token_major)
    wrong = L.moe_block(_t(x), tp, tc)[0]
    assert not np.allclose(to_np(wrong), np.asarray(jy), rtol=RTOL, atol=ATOL)


def test_moe_top_k_breaks_ties_to_the_lower_index():
    jc, tc = _cfgs(moe=MoEConfig(4, 2, 16, capacity_factor=2.0, group=16))
    rng = np.random.default_rng(10)
    p = _moe_params(rng, 4, 32, 16)
    p["router"][:] = 0.0          # every gate 1/4: a four-way tie for every token
    x = _rand(rng, 1, 16, 32)
    assert_close(L.moe_block(_t(x), _tree(p, _t), tc)[0], J(JL.moe_block, x, p, cfg=jc)[0])
    gates = torch.full((3, 4), 0.25)
    assert L._top_k(gates, 2)[1].tolist() == [[0, 1]] * 3
    assert np.asarray(jax.lax.top_k(jnp.full((3, 4), 0.25), 2)[1]).tolist() == [[0, 1]] * 3


# ---------------------------------------------------------------------------
# SSD and WKV scans
# ---------------------------------------------------------------------------

def _ssd_inputs(rng, b, s, h, p, n):
    return (_rand(rng, b, s, h, p), -rng.random((b, s, h)).astype(np.float32),
            _rand(rng, b, s, n), _rand(rng, b, s, n))


@pytest.mark.parametrize("vectorized", [False, True])
@pytest.mark.parametrize("s", [64, 50])          # 50: the padding branch
def test_ssd_matches_reference(vectorized, s):
    rng = np.random.default_rng(11)
    xs = _ssd_inputs(rng, 2, s, 3, 4, 5)
    y, st = S.ssd_chunked(*map(_t, xs), chunk=16, vectorized=vectorized)
    jy, jst = J(JS.ssd_chunked, *xs, chunk=16, vectorized=vectorized)
    assert_close(y, jy, "y")
    assert_close(st, jst, "state")
    y, st = S.ssd_reference(*map(_t, xs))
    jy, jst = J(JS.ssd_reference, *xs)
    assert_close(y, jy, "reference y")
    assert_close(st, jst, "reference state")
    S0 = _rand(rng, 2, 3, 5, 4)
    step = [x[:, 0] for x in xs]
    for a, b in zip(S.ssd_decode_step(_t(S0), *map(_t, step)), J(JS.ssd_decode_step, S0, *step)):
        assert_close(a, b, "decode step")


def _wkv_inputs(rng, b, s, h, kk):
    return (_rand(rng, b, s, h, kk), _rand(rng, b, s, h, kk), _rand(rng, b, s, h, kk),
            -(0.1 + rng.random((b, s, h, kk))).astype(np.float32), _rand(rng, h, kk, scale=0.1))


@pytest.mark.parametrize("vectorized", [False, True])
@pytest.mark.parametrize("s", [64, 40])
def test_wkv_matches_reference(vectorized, s):
    rng = np.random.default_rng(12)
    r, k, v, w, u = _wkv_inputs(rng, 2, s, 3, 8)
    o, st = S.wkv_chunked(*map(_t, (r, k, v, w, u)), chunk=16, vectorized=vectorized)
    jo, jst = J(JS.wkv_chunked, r, k, v, w, u, chunk=16, vectorized=vectorized)
    assert_close(o, jo, "o", atol=1e-4)
    assert_close(st, jst, "state", atol=1e-4)
    o, st = S.wkv_reference(*map(_t, (r, k, v, w, u)))
    jo, jst = J(JS.wkv_reference, r, k, v, w, u)
    assert_close(o, jo, "reference o", atol=1e-4)
    assert_close(st, jst, "reference state", atol=1e-4)
    S0 = _rand(rng, 2, 3, 8, 8)
    step = [x[:, 0] for x in (r, k, v, w)]
    for a, b in zip(S.wkv_decode_step(_t(S0), *map(_t, step), _t(u)),
                    J(JS.wkv_decode_step, S0, *step, u)):
        assert_close(a, b, "decode step")


def _mamba_cfgs():
    return _cfgs(ssm=SSMConfig(state=8, head_dim=8, expand=2, conv=4, chunk=8))


def _mamba_params(rng, d=32, d_in=64, n=8, h=8, conv=4):
    return {"in_proj": _rand(rng, d, 2 * d_in + 2 * n + h, scale=d ** -0.5),
            "conv_w": _rand(rng, conv, d_in, scale=0.5), "conv_b": _rand(rng, d_in, scale=0.1),
            "dt_bias": -2.0 + _rand(rng, h, scale=0.5), "a_log": _rand(rng, h, scale=0.3),
            "d_skip": 1.0 + _rand(rng, h, scale=0.3), "norm": 1.0 + _rand(rng, d_in, scale=0.2),
            "out_proj": _rand(rng, d_in, d, scale=d_in ** -0.5)}


@pytest.mark.parametrize("vectorized", [False, True])
def test_mamba2_mix_prefill_then_decode_matches_reference(vectorized):
    jc, tc = _mamba_cfgs()
    jc = dataclasses.replace(jc, unroll_scans=vectorized)
    tc = dataclasses.replace(tc, unroll_scans=vectorized)
    rng = np.random.default_rng(13)
    p = _mamba_params(rng)
    tp = _tree(p, _t)
    x, x1 = _rand(rng, 2, 20, 32), _rand(rng, 2, 1, 32)
    y, st = S.mamba2_mix(_t(x), tp, tc)
    jy, jst = J(JS.mamba2_mix, x, p, cfg=jc)
    assert_close(y, jy, "prefill y")
    for name in ("conv", "ssm"):
        assert_close(st[name], jst[name], name)
    y1, st1 = S.mamba2_mix(_t(x1), tp, tc, state=st)
    jy1, jst1 = J(JS.mamba2_mix, x1, p, cfg=jc, state=jst)
    assert_close(y1, jy1, "decode y")
    for name in ("conv", "ssm"):
        assert_close(st1[name], jst1[name], f"decode {name}")


def test_mamba2_conv_weights_are_not_flipped():
    jc, tc = _mamba_cfgs()
    rng = np.random.default_rng(14)
    p = _mamba_params(rng)
    x = _rand(rng, 2, 20, 32)
    jy, _ = J(JS.mamba2_mix, x, p, cfg=jc)
    assert_close(S.mamba2_mix(_t(x), _tree(p, _t), tc)[0], jy)
    flipped = _tree(p, _t)
    flipped["conv_w"] = flipped["conv_w"].flip(0)
    assert not np.allclose(to_np(S.mamba2_mix(_t(x), flipped, tc)[0]), np.asarray(jy),
                           rtol=RTOL, atol=ATOL)


def _rwkv_cfgs():
    return _cfgs(rwkv=RWKVConfig(head_dim=8, lora_rank=4, chunk=8), n_kv_heads=4)


def _rwkv_params(rng, d=32, f=64, h=4, hd=8, rank=4):
    tm = {f"mu_{c}": rng.uniform(0, 1, d).astype(np.float32) for c in "rkvgw"}
    tm.update({n: _rand(rng, d, d, scale=d ** -0.5) for n in ("wr", "wk", "wv", "wg", "wo")})
    tm.update(w_lora_a=_rand(rng, d, rank, scale=0.5), w_lora_b=_rand(rng, rank, d, scale=0.5),
              w0=-2.0 + _rand(rng, d, scale=0.5), u=_rand(rng, h, hd, scale=0.3),
              ln_x=1.0 + _rand(rng, d, scale=0.2))
    cm = {"mu_k": rng.uniform(0, 1, d).astype(np.float32),
          "mu_r": rng.uniform(0, 1, d).astype(np.float32),
          "wk": _rand(rng, d, f, scale=d ** -0.5), "wv": _rand(rng, f, d, scale=f ** -0.5),
          "wr_gate": _rand(rng, d, d, scale=d ** -0.5)}
    return tm, cm


@pytest.mark.parametrize("vectorized", [False, True])
def test_rwkv_mixes_prefill_then_decode_match_reference(vectorized):
    jc, tc = _rwkv_cfgs()
    jc = dataclasses.replace(jc, unroll_scans=vectorized)
    tc = dataclasses.replace(tc, unroll_scans=vectorized)
    rng = np.random.default_rng(15)
    tm, cm = _rwkv_params(rng)
    ttm, tcm = _tree(tm, _t), _tree(cm, _t)
    x, x1 = _rand(rng, 2, 20, 32), _rand(rng, 2, 1, 32)
    y, st = S.rwkv_time_mix(_t(x), ttm, tc)
    jy, jst = J(JS.rwkv_time_mix, x, tm, cfg=jc)
    assert_close(y, jy, "time-mix y")
    for name in ("shift", "wkv"):
        assert_close(st[name], jst[name], name)
    y1, _ = S.rwkv_time_mix(_t(x1), ttm, tc, state=st)
    jy1, _ = J(JS.rwkv_time_mix, x1, tm, cfg=jc, state=jst)
    assert_close(y1, jy1, "time-mix decode")
    c, sh = S.rwkv_channel_mix(_t(x), tcm)
    jcm, jsh = J(JS.rwkv_channel_mix, x, cm)
    assert_close(c, jcm, "channel-mix")
    assert_close(sh, jsh, "channel-mix shift")
    assert_close(S.rwkv_channel_mix(_t(x1), tcm, state=sh)[0],
                 J(JS.rwkv_channel_mix, x1, cm, state=jsh)[0], "channel-mix decode")


def test_rwkv_groupnorm_uses_the_population_variance(monkeypatch):
    jc, tc = _rwkv_cfgs()
    rng = np.random.default_rng(16)
    tm, _ = _rwkv_params(rng)
    x = _rand(rng, 2, 8, 32)
    jy, _ = J(JS.rwkv_time_mix, x, tm, cfg=jc)
    assert_close(S.rwkv_time_mix(_t(x), _tree(tm, _t), tc)[0], jy)
    var = torch.Tensor.var
    monkeypatch.setattr(torch.Tensor, "var", lambda t, *a, **kw: var(t, *a, **{**kw, "correction": 1}))
    sample = S.rwkv_time_mix(_t(x), _tree(tm, _t), tc)[0]
    assert not np.allclose(to_np(sample), np.asarray(jy), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# port-only mirrors of tests/test_models.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qc,kc", [(32, 32), (128, 64), (64, 128)])
def test_flash_matches_naive(qc, kc):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 128, 4, 16, generator=g)
    k = torch.randn(2, 128, 2, 16, generator=g)
    v = torch.randn(2, 128, 2, 16, generator=g)
    o, _ = L.flash_attention(q, k, v, True, qc, kc, 0, 0)
    torch.testing.assert_close(o, naive_attention(q, k, v), rtol=2e-4, atol=2e-5)


def _flops(fn, *args):
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()


def test_divide_mode_exact_and_halves_flops():
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(1, 256, 2, 8, generator=g) for _ in range(3))
    o1 = L.causal_attention(q, k, v, mode="full_masked", q_chunk=64, kv_chunk=64)
    o2 = L.causal_attention(q, k, v, mode="divide", q_chunk=32, kv_chunk=32, min_block=64)
    torch.testing.assert_close(o1, o2, rtol=2e-4, atol=2e-5)
    f_full = _flops(lambda: L.causal_attention(q, k, v, mode="full_masked", q_chunk=256,
                                               kv_chunk=256))
    f_div = _flops(lambda: L.causal_attention(q, k, v, mode="divide", q_chunk=64, kv_chunk=64,
                                              min_block=64))
    assert 0 < f_div < 0.72 * f_full, (f_div, f_full)


def test_ssd_chunked_matches_reference():
    rng = np.random.default_rng(3)
    xs = tuple(map(_t, _ssd_inputs(rng, 2, 64, 3, 4, 5)))
    y2, s2 = S.ssd_reference(*xs)
    for vectorized in (False, True):
        y1, s1 = S.ssd_chunked(*xs, chunk=16, vectorized=vectorized)
        torch.testing.assert_close(y1, y2, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(s1, s2, rtol=1e-4, atol=1e-5)


def test_wkv_chunked_matches_reference():
    rng = np.random.default_rng(4)
    xs = tuple(map(_t, _wkv_inputs(rng, 2, 64, 3, 8)))
    o2, s2 = S.wkv_reference(*xs)
    for vectorized in (False, True):
        o1, s1 = S.wkv_chunked(*xs, chunk=16, vectorized=vectorized)
        torch.testing.assert_close(o1, o2, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(s1, s2, rtol=1e-4, atol=1e-4)


def test_moe_capacity_and_balance():
    from repro_torch.models import lm
    _, cfg = _cfgs(moe=MoEConfig(4, 2, 64, group=32, capacity_factor=2.0))
    x = torch.randn(2, 32, 32, generator=torch.Generator().manual_seed(6))
    p = {k: v[0] for k, v in lm.init_params(cfg, 0, device="cpu")["layers"]["moe"].items()}
    y, aux = L.moe_block(x, p, cfg)
    assert y.shape == x.shape
    assert torch.isfinite(aux)
    # with huge capacity, every token is routed: y is a convex combo of experts
    assert not torch.allclose(y, torch.zeros_like(y))
