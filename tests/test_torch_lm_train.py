"""The port's LM training path against the reference's, float32 on both
sides, inputs from numpy seeds: ``flash_attention``'s backward (GQA, query
and key offsets, causal and not, the lse cotangent, ``attn_mode="divide"``)
against ``jax.grad`` of the reference's custom VJP and against autograd
through a naive attention; rematerialization (``cfg.remat`` full / dots /
none and ``scan_groups`` give the same gradients, and checkpoint only under
autograd); AdamW (``apply_updates`` on the same numpy gradients and state,
``lr_at``, ``global_norm``); and mirrors of the reference's training tests
in ``test_models.py`` and ``test_archs_smoke.py``.

Tolerances.  Port against reference flash gradients: rtol 1e-4 / atol 1e-5
(float32 summation order; the largest seen is 2e-6).  Against the naive
oracle: ``test_flash_grads_match_naive``'s rtol 3e-3 / atol 3e-4.  Remat
modes recompute the same arithmetic: rtol 1e-6 / atol 1e-7.  AdamW on
identical inputs: parameters and v to rtol 1e-5 / atol 1e-7 (float32
rounding of a few operations, which XLA may fuse differently); m to one
bfloat16 ulp (at most 2^-7 of the value) when it is stored in bfloat16,
since float32 values one ulp apart can round to either neighbour.  The whole-model
gradients are in ``test_torch_lm_grads.py``.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_lm import random_tree
from repro.models import layers as JL
from repro.optim import adamw as jadamw
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.configs.base import ModelConfig, MoEConfig, RWKVConfig, SSMConfig, smoke_config
from repro_torch.models import convert, layers as L, lm
from repro_torch.optim import adamw
from repro_torch.runtime import step as tstep

FLASH_TOL = dict(rtol=1e-4, atol=1e-5)
NAIVE_TOL = dict(rtol=3e-3, atol=3e-4)
REMAT_TOL = dict(rtol=1e-6, atol=1e-7)


def _t(x, grad=True):
    return torch.tensor(np.asarray(x), requires_grad=grad)


def naive_attention(q, k, v, causal, q_off=0, k_off=0):
    """Autograd oracle: the whole (Sq, Sk) score matrix, softmax, and its lse."""
    b, sq, h, dh = q.shape
    sk, g = k.shape[1], h // k.shape[2]
    ke, ve = k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)
    s = torch.einsum("bqhd,bthd->bhqt", q / math.sqrt(dh), ke)
    if causal:
        mask = (q_off + torch.arange(sq))[:, None] >= (k_off + torch.arange(sk))[None, :]
        s = torch.where(mask[None, None], s, L.NEG_INF)
    o = torch.einsum("bhqt,bthd->bqhd", torch.softmax(s, -1), ve)
    return o, torch.logsumexp(s, -1).transpose(1, 2)


def _objective(o, lse, w):
    """A loss that reads both outputs, so lse gets a cotangent."""
    return (o.sin().sum() + (lse * w).cos().sum()) if lse is not None else o.sin().sum()


# (b, sq, sk, h, kh, dh, causal, q_chunk, kv_chunk, q_off, k_off)
FLASH_CASES = [
    (2, 64, 64, 4, 2, 8, True, 16, 16, 0, 0),         # test_flash_grads_match_naive's shape
    (2, 64, 64, 4, 1, 8, True, 32, 16, 0, 0),         # 4 query heads on one kv head
    (1, 32, 64, 4, 2, 8, True, 16, 32, 32, 0),        # queries after the keys' start
    (2, 48, 80, 2, 2, 8, False, 16, 16, 0, 0),        # non-causal, Sq != Sk
    (1, 64, 64, 6, 3, 16, True, 64, 64, 5, 5),        # one block, offset
]


@pytest.mark.parametrize("with_lse", [True, False])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_grads_match_reference_and_naive(case, with_lse):
    b, sq, sk, h, kh, dh, causal, qc, kc, q_off, k_off = case
    rng = np.random.default_rng(sq + sk + h)
    qn = rng.standard_normal((b, sq, h, dh)).astype(np.float32)
    kn = rng.standard_normal((b, sk, kh, dh)).astype(np.float32)
    vn = rng.standard_normal((b, sk, kh, dh)).astype(np.float32)
    wn = rng.standard_normal((b, sq, h)).astype(np.float32) * 0.1

    def jf(q, k, v):
        o, lse = JL.flash_attention(q, k, v, causal, qc, kc, q_off, k_off)
        return jnp.sum(jnp.sin(o)) + (jnp.sum(jnp.cos(lse * wn)) if with_lse else 0.0)

    want = jax.grad(jf, argnums=(0, 1, 2))(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn))
    q, k, v = _t(qn), _t(kn), _t(vn)
    o, lse = L.flash_attention(q, k, v, causal, qc, kc, q_off, k_off)
    got = torch.autograd.grad(_objective(o, lse if with_lse else None, torch.tensor(wn)),
                              (q, k, v))
    q2, k2, v2 = _t(qn), _t(kn), _t(vn)
    o2, lse2 = naive_attention(q2, k2, v2, causal, q_off, k_off)
    oracle = torch.autograd.grad(_objective(o2, lse2 if with_lse else None, torch.tensor(wn)),
                                 (q2, k2, v2))
    for name, g, r, n in zip("qkv", got, want, oracle):
        assert g.dtype == torch.float32 and g.shape == n.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **FLASH_TOL, err_msg=f"d{name}")
        np.testing.assert_allclose(g.numpy(), n.numpy(), **NAIVE_TOL, err_msg=f"d{name} naive")


def test_flash_lse_alone_has_a_gradient():
    """A loss of lse alone: do is absent, ds = p·dlse."""
    rng = np.random.default_rng(3)
    q, k, v = (_t(rng.standard_normal((1, 32, 2, 8)).astype(np.float32)) for _ in range(3))
    _, lse = L.flash_attention(q, k, v, True, 8, 8)
    got = torch.autograd.grad(lse.sum(), (q, k, v), allow_unused=True, materialize_grads=True)
    q2, k2, v2 = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    _, lse2 = naive_attention(q2, k2, v2, True)
    want = torch.autograd.grad(lse2.sum(), (q2, k2, v2), allow_unused=True, materialize_grads=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **NAIVE_TOL)
    assert not got[2].any()                           # v does not reach lse


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_grads_come_back_in_the_input_dtypes(dtype):
    rng = np.random.default_rng(4)
    q = torch.tensor(rng.standard_normal((1, 32, 4, 8)), dtype=dtype, requires_grad=True)
    k = torch.tensor(rng.standard_normal((1, 32, 2, 8)), dtype=dtype, requires_grad=True)
    v = torch.tensor(rng.standard_normal((1, 32, 2, 8)), dtype=torch.float32, requires_grad=True)
    o, _ = L.flash_attention(q, k, v, True, 16, 16)
    assert o.dtype == dtype
    dq, dk, dv = torch.autograd.grad(o.float().sum(), (q, k, v))
    assert (dq.dtype, dk.dtype, dv.dtype) == (dtype, dtype, torch.float32)


def test_divide_mode_grads_match_reference_and_full_masked():
    """``attn_mode="divide"`` merges partial attentions through their lse,
    so its gradient needs the lse cotangent."""
    rng = np.random.default_rng(5)
    qn = rng.standard_normal((1, 128, 4, 8)).astype(np.float32)
    kn = rng.standard_normal((1, 128, 2, 8)).astype(np.float32)
    vn = rng.standard_normal((1, 128, 2, 8)).astype(np.float32)
    kw = dict(q_chunk=16, kv_chunk=16, min_block=32)

    def jf(q, k, v):
        return jnp.sum(jnp.sin(JL.causal_attention(q, k, v, mode="divide", **kw)))

    want = jax.grad(jf, argnums=(0, 1, 2))(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn))
    grads = {}
    for mode in ("divide", "full_masked"):
        q, k, v = _t(qn), _t(kn), _t(vn)
        o = L.causal_attention(q, k, v, mode=mode, **kw)
        grads[mode] = torch.autograd.grad(o.sin().sum(), (q, k, v))
    for name, g, r, f in zip("qkv", grads["divide"], want, grads["full_masked"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **FLASH_TOL, err_msg=f"d{name}")
        np.testing.assert_allclose(g.numpy(), f.numpy(), **FLASH_TOL, err_msg=f"d{name} full")


class _LargestOutput(TorchDispatchMode):
    """The most elements of any tensor (of ``dtype``, if given) that an op
    returns while active."""

    def __init__(self, dtype=None):
        super().__init__()
        self.dtype, self.largest = dtype, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and self.dtype in (None, t.dtype):
                self.largest = max(self.largest, t.numel())
        return out


def test_flash_backward_works_one_block_at_a_time():
    """Memory O(S·d): no tensor of the backward is larger than one
    (q chunk × kv chunk) block of scores, a sixteenth of the (S, S) one."""
    b, s, h, dh, c = 1, 128, 2, 8, 32
    rng = np.random.default_rng(6)
    q, k, v = (_t(rng.standard_normal((b, s, h, dh)).astype(np.float32)) for _ in range(3))
    o, lse = L.flash_attention(q, k, v, True, c, c)
    loss = o.sin().sum() + lse.cos().sum()
    with _LargestOutput() as watch:
        torch.autograd.grad(loss, (q, k, v))
    assert watch.largest <= b * h * c * c < b * h * s * s


def test_flash_without_autograd_runs_the_forward_alone(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the autograd function ran without a gradient to record")

    monkeypatch.setattr(L._FlashAttention, "apply", refuse)
    x = torch.ones((1, 8, 2, 4))
    with torch.inference_mode():
        L.flash_attention(x, x, x, True, 4, 4)
    L.flash_attention(x, x, x, True, 4, 4)           # no input needs a gradient


# ---------------------------------------------------------------------------
# rematerialization
# ---------------------------------------------------------------------------

def _mk_cfg(pattern, **kw):
    """``test_models.py``'s small configs."""
    base = dict(name="t", family="x", n_layers=2, d_model=32, n_heads=4,
                n_kv_heads=2, d_head=8, d_ff=64, vocab=64, loss_chunk=16,
                attn_q_chunk=16, attn_kv_chunk=16, attn_min_block=16)
    base.update(kw)
    if pattern == "moe":
        return ModelConfig(**base, moe=MoEConfig(4, 2, 64, group=16, capacity_factor=2.0))
    if pattern == "zamba":
        base.update(n_layers=7, n_kv_heads=4)
        return ModelConfig(**base, pattern="zamba", shared_attn_every=3,
                           ssm=SSMConfig(state=8, head_dim=8, chunk=8), sub_quadratic=True)
    if pattern == "rwkv":
        return ModelConfig(**base, pattern="rwkv",
                           rwkv=RWKVConfig(head_dim=8, lora_rank=8, chunk=8), sub_quadratic=True)
    if pattern == "vlm":
        base.update(n_layers=6)
        return ModelConfig(**base, pattern="vlm", cross_every=3, n_vision_tokens=4,
                           input_mode="tokens+vision")
    return ModelConfig(**base)


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.input_mode == "tokens+vision":
        out["vision"] = rng.standard_normal((b, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    return out


def _grads(cfg, params, batch):
    loss, _, paths, grads = tstep.loss_and_grads(cfg, params, batch)
    return loss, dict(zip(paths, grads))


@pytest.mark.parametrize("pattern,scan_groups", [("uniform", None), ("uniform", 2), ("moe", None),
                                                 ("vlm", None), ("zamba", None), ("rwkv", None)])
def test_remat_modes_give_equal_grads(pattern, scan_groups, monkeypatch):
    """full / dots / none give the same loss and gradients; "dots" asks its
    policy about the ops it runs and saves the plain matmuls, "full" never
    asks, and "none" checkpoints no block (the loss chunks are checkpointed
    in every mode, as the reference's are)."""
    base = _mk_cfg(pattern, n_layers=4) if scan_groups else _mk_cfg(pattern)
    params = convert.params_from_reference(base, random_tree(base, 7), "cpu")
    batch = _batch(base, 2, 32, 8)
    asked, saved = [], []
    real_policy, real_checkpoint = lm._dots_policy, lm.checkpoint

    def policy(ctx, op, *a, **k):
        asked.append(op)
        decision = real_policy(ctx, op, *a, **k)
        if decision == lm.CheckpointPolicy.MUST_SAVE:
            saved.append(op)
        return decision

    calls = []

    def counted_checkpoint(fn, *a, **k):
        calls.append(fn)
        return real_checkpoint(fn, *a, **k)

    monkeypatch.setattr(lm, "_dots_policy", policy)
    monkeypatch.setattr(lm, "checkpoint", counted_checkpoint)
    runs = {}
    for mode in ("none", "full", "dots"):
        cfg = dataclasses.replace(base, remat=mode, scan_groups=scan_groups)
        asked.clear(), saved.clear(), calls.clear()
        runs[mode] = _grads(cfg, params, batch)
        blocks = [fn for fn in calls if fn is not lm._xent_chunk]
        assert len(calls) - len(blocks) == 32 // cfg.loss_chunk     # the loss chunks, always
        assert bool(blocks) == (mode != "none"), mode
        if mode == "dots":
            assert saved and set(saved) <= {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}
        else:
            assert not asked, mode
    loss0, g0 = runs["none"]
    for mode in ("full", "dots"):
        loss, g = runs[mode]
        torch.testing.assert_close(loss, loss0, **REMAT_TOL)
        for path in g0:
            torch.testing.assert_close(g[path], g0[path], **REMAT_TOL, msg=f"{mode} {path}")


def test_remat_applies_only_under_autograd(monkeypatch):
    """Prefill and decode (``inference_mode``) and ``no_grad`` never
    checkpoint, so their results and cost stay as they were."""
    def refuse(*a, **k):
        raise AssertionError("checkpointed without autograd")

    monkeypatch.setattr(lm, "checkpoint", refuse)
    monkeypatch.setattr(L, "checkpoint", refuse)
    cfg = _mk_cfg("moe", remat="full")
    params = lm.init_params(cfg, 0, device="cpu")
    batch = _batch(cfg, 2, 32, 9)
    logits, caches = tstep.make_prefill_step(cfg)(params, {"tokens": batch["tokens"]})
    assert logits.shape == (2, cfg.vocab)
    with torch.no_grad():
        loss, _ = lm.forward_train(params, cfg, batch)
    assert torch.isfinite(loss)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _np_tree(tree, fn):
    return {k: _np_tree(v, fn) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32) if x.dtype == jnp.bfloat16 else x)


@pytest.mark.parametrize("grad_scale", [0.01, 30.0])     # clipping off, on
@pytest.mark.parametrize("m_dtype", ["bfloat16", "float32"])
def test_apply_updates_matches_reference(m_dtype, grad_scale):
    cfg = smoke_config(get_config("granite-moe-1b-a400m"))   # stacked 3-d and 4-d leaves
    rng = np.random.default_rng(10)
    p_np = random_tree(cfg, 11)
    g_np = _np_tree(p_np, lambda a: (grad_scale * rng.standard_normal(a.shape)).astype(np.float32))
    m_np = _np_tree(p_np, lambda a: (0.01 * rng.standard_normal(a.shape)).astype(np.float32))
    v_np = _np_tree(p_np, lambda a: (1e-4 * rng.random(a.shape)).astype(np.float32))
    ocfg = dict(peak_lr=1e-3, warmup_steps=3, total_steps=20, m_dtype=m_dtype)
    for step in (1, 6):                                        # warmup, cosine decay
        jstate = {"m": _np_tree(m_np, lambda a: jnp.asarray(a, m_dtype)),
                  "v": _np_tree(v_np, jnp.asarray), "step": jnp.int32(step - 1)}
        jp, js, jm = jadamw.apply_updates(_np_tree(p_np, jnp.asarray), _np_tree(g_np, jnp.asarray),
                                          jstate, jadamw.AdamWConfig(**ocfg))
        tstate = {"m": _np_tree(m_np, lambda a: torch.tensor(a).to(getattr(torch, m_dtype))),
                  "v": _np_tree(v_np, torch.tensor),
                  "step": torch.tensor(step - 1, dtype=torch.int32)}
        tp0 = _np_tree(p_np, torch.tensor)
        tp, ts, tm = adamw.apply_updates(tp0, _np_tree(g_np, torch.tensor), tstate,
                                         adamw.AdamWConfig(**ocfg))
        assert int(ts["step"]) == int(js["step"]) == step
        np.testing.assert_allclose(_np(tm["lr"]), _np(jm["lr"]), rtol=1e-6)
        np.testing.assert_allclose(_np(tm["grad_norm"]), _np(jm["grad_norm"]), rtol=1e-5)
        for path, t in _flat(tp).items():
            np.testing.assert_allclose(_np(t), _np(_flat(jp)[path]), rtol=1e-5, atol=1e-7,
                                       err_msg=f"param {path} step {step}")
        m_tol = dict(rtol=2.0 ** -7, atol=0) if m_dtype == "bfloat16" else dict(rtol=1e-5, atol=1e-9)
        for path, t in _flat(ts["m"]).items():
            assert t.dtype == getattr(torch, m_dtype)
            np.testing.assert_allclose(_np(t), _np(_flat(js["m"])[path]), **m_tol,
                                       err_msg=f"m {path} step {step}")
        for path, t in _flat(ts["v"]).items():
            assert t.dtype == torch.float32
            np.testing.assert_allclose(_np(t), _np(_flat(js["v"])[path]), rtol=1e-5, atol=1e-12,
                                       err_msg=f"v {path} step {step}")
        for path, t in _flat(tp0).items():                      # not in place
            np.testing.assert_array_equal(t.numpy(), _flat(p_np)[path])


def test_lr_at_matches_reference_over_warmup_and_decay():
    cfg = dict(peak_lr=3e-4, warmup_steps=7, total_steps=40, min_lr_ratio=0.1)
    for step in range(0, 46):
        got = adamw.lr_at(adamw.AdamWConfig(**cfg), step)
        want = jadamw.lr_at(jadamw.AdamWConfig(**cfg), step)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, err_msg=f"step {step}")
    assert adamw.lr_at(adamw.AdamWConfig(**cfg), 7).item() == pytest.approx(3e-4)
    assert adamw.lr_at(adamw.AdamWConfig(**cfg), 45).item() == pytest.approx(3e-5)


def test_global_norm_matches_reference_with_bf16_leaves():
    rng = np.random.default_rng(12)
    tree = {"a": rng.standard_normal((3, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal(7).astype(np.float32),
                  "d": rng.standard_normal((2, 2, 2)).astype(np.float32)}}
    want = jadamw.global_norm({"a": jnp.asarray(tree["a"]),
                               "b": {"c": jnp.asarray(tree["b"]["c"], jnp.bfloat16),
                                     "d": jnp.asarray(tree["b"]["d"])}})
    got = adamw.global_norm({"a": torch.tensor(tree["a"]),
                             "b": {"c": torch.tensor(tree["b"]["c"]).bfloat16(),
                                   "d": torch.tensor(tree["b"]["d"])}})
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_apply_updates_streams_stacked_leaves_one_slice_at_a_time():
    """A bf16 (layers, d, f) leaf's float32 temporaries are one (d, f)
    slice (the gradient norm squares the whole leaf in bf16, as the
    reference's does)."""
    rng = np.random.default_rng(13)
    shape = (4, 16, 32)
    p = {"w": torch.tensor(rng.standard_normal(shape), dtype=torch.bfloat16)}
    g = {"w": torch.tensor(rng.standard_normal(shape), dtype=torch.bfloat16)}
    cfg = adamw.AdamWConfig()
    state = adamw.init_opt_state(p, cfg)
    with _LargestOutput(torch.float32) as watch:
        adamw.apply_updates(p, g, state, cfg, inplace=True)
    assert watch.largest == shape[1] * shape[2]


def test_opt_state_specs_mirror_init_opt_state():
    cfg = smoke_config(get_config("zamba2-1.2b"))
    ocfg = adamw.AdamWConfig()
    specs = adamw.opt_state_specs(cfg, ocfg)
    state = adamw.init_opt_state(lm.init_params(cfg, 0, device="cpu"), ocfg)
    for part in ("m", "v"):
        for path, spec in _flat(lm.map_specs(specs[part], lambda _, s: s)).items():
            t = _flat(state[part])[path]
            assert tuple(t.shape) == spec.shape and t.dtype == spec.dtype
    assert state["step"].dtype == specs["step"].dtype == torch.int32


# ---------------------------------------------------------------------------
# the train step: mirrors of the reference's tests
# ---------------------------------------------------------------------------

def test_train_step_decreases_loss_on_memorizable_batch():
    cfg = _mk_cfg("uniform")
    rng = np.random.default_rng(7)
    batch = {
        "tokens": rng.integers(0, cfg.vocab, (4, 32)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab, (4, 32)).astype(np.int32),
    }
    opt_cfg = adamw.AdamWConfig(peak_lr=3e-3, warmup_steps=2, total_steps=60, m_dtype="float32")
    params = lm.init_params(cfg, 0, device="cpu")
    opt = adamw.init_opt_state(params, opt_cfg)
    step = tstep.make_train_step(cfg, opt_cfg, donate=False)
    losses = []
    for _ in range(25):
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses[:3] + losses[-3:]


def test_accum_equals_full_batch_grads():
    cfg = _mk_cfg("uniform")
    rng = np.random.default_rng(8)
    batch = {
        "tokens": rng.integers(0, cfg.vocab, (4, 32)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab, (4, 32)).astype(np.int32),
    }
    opt_cfg = adamw.AdamWConfig(peak_lr=1e-3, m_dtype="float32")
    p0 = lm.init_params(cfg, 0, device="cpu")
    o0 = adamw.init_opt_state(p0, opt_cfg)
    s1 = tstep.make_train_step(cfg, opt_cfg, accum=1, donate=False)
    s2 = tstep.make_train_step(cfg, opt_cfg, accum=2, donate=False)
    p1, _, m1 = s1(p0, o0, batch)
    p2, _, m2 = s2(p0, o0, batch)
    assert set(m1) == {"loss", "xent", "aux", "lr", "grad_norm"}
    assert set(m2) == {"loss", "lr", "grad_norm"}
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=1e-5)
    # the reference's tolerance: gradients accumulate in bfloat16
    for path, a in _flat(p1).items():
        np.testing.assert_allclose(a.numpy(), _flat(p2)[path].numpy(), rtol=5e-2, atol=5e-4)


@pytest.mark.parametrize("donate", [True, False])
def test_train_step_donation(donate):
    """donate=True writes the new values into the caller's tensors;
    donate=False leaves them as they were."""
    cfg = _mk_cfg("moe")
    params = lm.init_params(cfg, 0, device="cpu")
    opt_cfg = adamw.AdamWConfig(peak_lr=1e-2, warmup_steps=1)
    state = adamw.init_opt_state(params, opt_cfg)
    before = _np_tree(params, lambda t: t.clone())
    p1, s1, _ = tstep.make_train_step(cfg, opt_cfg, donate=donate)(params, state, _batch(cfg, 2, 32, 3))
    for path, t in _flat(params).items():
        same_tensor = _flat(p1)[path] is t
        unchanged = torch.equal(t, _flat(before)[path])
        assert same_tensor == donate and unchanged != donate, path
    assert int(s1["step"]) == 1 and int(state["step"]) == 0
    assert (s1["m"]["layers"]["attn"]["wq"] is state["m"]["layers"]["attn"]["wq"]) == donate


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_smoke_forward_and_train_step(arch):
    """``test_archs_smoke.py``'s check on the port: a finite loss and
    logits of the right shape, and one optimizer step moves parameters."""
    cfg = smoke_config(get_config(arch))
    params = lm.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"labels": rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32)}
    if cfg.input_mode == "embeddings":
        batch["embeds"] = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    if cfg.input_mode == "tokens+vision":
        batch["vision"] = rng.standard_normal((2, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    with torch.no_grad():
        loss, _ = lm.forward_train(params, cfg, batch)
    assert np.isfinite(float(loss)), arch
    logits, _ = tstep.make_prefill_step(cfg)(params, batch)
    assert logits.shape == (2, cfg.vocab) and bool(torch.isfinite(logits).all()), arch
    opt_cfg = adamw.AdamWConfig(m_dtype="float32")
    opt = adamw.init_opt_state(params, opt_cfg)
    p2, _, m = tstep.make_train_step(cfg, opt_cfg, donate=False)(params, opt, batch)
    assert np.isfinite(float(m["loss"]))
    np.testing.assert_allclose(float(m["loss"]), float(loss), rtol=1e-6)
    moved = any(not torch.allclose(a, _flat(p2)[k]) for k, a in _flat(params).items())
    assert moved, arch
