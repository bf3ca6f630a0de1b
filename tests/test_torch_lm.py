"""The port's LM stack (``repro_torch.models.lm``, ``runtime.step``,
``launch.serve``) against the reference's, float32 on both sides, every
parameter leaf random through ``convert.py`` (``tests/_torch_lm.py``):
logits, caches and losses to rtol 1e-4 / atol 5e-5, tokens exactly.
Then the port-only mirror of ``test_decode_matches_prefill``, the converter's
round trip, ``init_params`` and the serve entry point."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import STACK_ATOL, assert_close, assert_tree_close, both_params, make_batch, random_tree, to_np
from repro.configs import get_config as jget_config
from repro.configs.base import smoke_config as jsmoke_config
from repro.models import lm as jlm
from repro.runtime import step as jstep
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.configs.base import ModelConfig, MoEConfig, RWKVConfig, SSMConfig, smoke_config
from repro_torch.launch import serve
from repro_torch.models import convert, lm
from repro_torch.runtime import step

B, S = 2, 20           # S = 20: the SSD / WKV chunks (16) take the padding branch


def _both_cfgs(arch):
    return jsmoke_config(jget_config(arch)), smoke_config(get_config(arch))


def _jpad(caches, cache_len):
    """The reference serve entry point's padding of attention caches (axis -3)."""
    out = {}
    for name, x in caches.items():
        if name in ("k", "v") or name.endswith(("_k", "_v")):
            pad = [(0, 0)] * x.ndim
            pad[-3] = (0, cache_len - x.shape[-3])
            x = jnp.pad(x, pad)
        out[name] = x
    return out


@pytest.mark.slow
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_smoke_config_matches_reference(arch):
    """Prefill (logits, every cache entry), three decode steps on padded
    caches (logits each step, caches after), and the train loss."""
    jc, tc = _both_cfgs(arch)
    _, jp, tp = both_params(jc, seed=1)
    batch = make_batch(jc, B, S, seed=2, labels=True)
    n_dec = 3
    nxt = make_batch(jc, B, n_dec, seed=3)

    jl, jcache = jax.jit(lambda p, b: jlm.forward_prefill(p, jc, b))(jp, batch)
    tl, tcache = lm.forward_prefill(tp, tc, batch)
    assert_close(tl, jl, "prefill logits", atol=STACK_ATOL)
    assert_tree_close(tcache, jcache, "prefill caches", atol=STACK_ATOL)

    jcache = _jpad(jcache, S + n_dec)
    tcache = serve.pad_caches(tcache, S + n_dec)
    jdec = jax.jit(lambda p, b, c, pos: jlm.forward_decode(p, jc, b, c, pos))
    for i in range(n_dec):
        db = {k: v[:, i:i + 1] for k, v in nxt.items() if k != "vision"}
        if "vision" in batch:
            db["vision"] = batch["vision"]
        jl, jcache = jdec(jp, db, jcache, jnp.int32(S + i))
        tl, tcache = lm.forward_decode(tp, tc, db, tcache, S + i)
        assert_close(tl, jl, f"decode {i} logits", atol=STACK_ATOL)
    assert_tree_close(tcache, jcache, "caches after decode", atol=STACK_ATOL)

    jloss, jm = jax.jit(lambda p, b: jlm.forward_train(p, jc, b))(jp, batch)
    tloss, tm = lm.forward_train(tp, tc, batch)
    assert_close(tloss, jloss, "loss", atol=STACK_ATOL)
    assert_close(tm["xent"], jm["xent"], "xent", atol=STACK_ATOL)
    assert_close(tm["aux"], jm["aux"], "aux", atol=STACK_ATOL)


def _mk_cfg(pattern):
    base = dict(name="t", family="x", n_layers=2, d_model=32, n_heads=4,
                n_kv_heads=2, d_head=8, d_ff=64, vocab=64, loss_chunk=16,
                attn_q_chunk=16, attn_kv_chunk=16, attn_min_block=16)
    if pattern == "moe":
        return ModelConfig(**base, moe=MoEConfig(4, 2, 64, group=32, capacity_factor=2.0))
    if pattern == "zamba":
        base.update(n_layers=6, n_kv_heads=4)
        return ModelConfig(**base, pattern="zamba", shared_attn_every=3,
                           ssm=SSMConfig(state=8, head_dim=8, chunk=8), sub_quadratic=True)
    if pattern == "rwkv":
        return ModelConfig(**base, pattern="rwkv",
                           rwkv=RWKVConfig(head_dim=8, lora_rank=8, chunk=8),
                           sub_quadratic=True)
    if pattern == "vlm":
        base.update(n_layers=6)
        return ModelConfig(**base, pattern="vlm", cross_every=3, n_vision_tokens=4,
                           input_mode="tokens+vision")
    return ModelConfig(**base)


@pytest.mark.parametrize("pattern", ["uniform", "zamba", "rwkv", "vlm", "moe"])
def test_decode_matches_prefill(pattern):
    """Teacher-forced: prefill S tokens, then decode token S given the cache —
    logits must match a prefill of S+1 tokens."""
    cfg = _mk_cfg(pattern)
    rng = np.random.default_rng(5)
    # moe: 2·15 prompt and 2·16 full tokens both split into groups of ≤ 32
    b, s = 2, 15 if pattern == "moe" else 16
    params = lm.init_params(cfg, 0, device="cpu")
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    batch_s = {"tokens": toks[:, :s]}
    batch_s1 = {"tokens": toks}
    if pattern == "vlm":
        vis = rng.standard_normal((b, 4, cfg.d_model)).astype(np.float32)
        batch_s["vision"] = vis
        batch_s1["vision"] = vis
    lg_full, _ = lm.forward_prefill(params, cfg, batch_s1)
    _, caches = lm.forward_prefill(params, cfg, batch_s)
    caches = serve.pad_caches(caches, s + 1)
    db = {"tokens": toks[:, s:s + 1]}
    if pattern == "vlm":
        db["vision"] = vis
    lg_dec, _ = lm.forward_decode(params, cfg, db, caches, s)
    torch.testing.assert_close(lg_dec, lg_full, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", ["stablelm-12b", "zamba2-1.2b"])
def test_greedy_tokens_through_steps_match_reference(arch):
    """8 greedy tokens through the port's prefill/decode steps equal the
    reference's ``repro.runtime.step`` on the same weights."""
    jc, tc = _both_cfgs(arch)
    _, jp, tp = both_params(jc, seed=4)
    batch = make_batch(jc, B, 16, seed=5)
    gen = 8

    def run(prefill, decode, params, pad, as_np):
        logits, caches = prefill(params, batch)
        caches = pad(caches, 16 + gen)
        toks = [as_np(logits).argmax(-1)]
        for i in range(gen - 1):
            db = {"tokens": toks[-1][:, None].astype(np.int32)}
            logits, caches = decode(params, db, caches, i + 16)
            toks.append(as_np(logits).argmax(-1))
        return np.stack(toks, 1)

    ref = run(jstep.make_prefill_step(jc), jstep.make_decode_step(jc, donate=False), jp,
              _jpad, np.asarray)
    got = run(step.make_prefill_step(tc), step.make_decode_step(tc), tp,
              serve.pad_caches, to_np)
    assert got.shape == (B, gen)
    np.testing.assert_array_equal(got, ref)


def _spec_rows(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_spec_rows(v, f"{path}/{k}"))
        return out
    d = tree.dtype
    dtype = None if d is None else str(d).removeprefix("torch.") if isinstance(d, torch.dtype) \
        else np.dtype(d).name
    return {path: (tuple(tree.shape), tuple(tree.axes), tree.init, dtype)}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_full_size_specs_equal_reference(arch):
    """Every parameter and cache leaf of the full config: path, shape,
    logical axes, init and dtype override (zamba2-1.2b: 6 groups of 6
    Mamba2 layers and a tail of 2, each with caches of its own)."""
    cfg, ref = get_config(arch), jget_config(arch)
    assert _spec_rows(lm.param_specs(cfg)) == _spec_rows(jlm.param_specs(ref))
    assert _spec_rows(lm.cache_specs(cfg, 4, 96)) == _spec_rows(jlm.cache_specs(ref, 4, 96))
    if arch == "zamba2-1.2b":
        assert lm.zamba_layout(cfg) == (6, 6, 2)
        assert lm.cache_specs(cfg, 4, 96)["tail_ssm"].shape == (2, 4, 64, 64, 64)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_convert_round_trip_is_bit_exact(arch):
    cfg = smoke_config(get_config(arch))
    tree = random_tree(cfg, seed=6)
    back = convert.params_to_reference(cfg, convert.params_from_reference(cfg, tree, "cpu"))
    _assert_trees_equal(back, tree)
    caches = {name: np.random.default_rng(7).standard_normal(spec.shape).astype(np.float32)
              for name, spec in lm.cache_specs(cfg, 2, 9).items()}
    back = convert.caches_to_reference(cfg, convert.caches_from_reference(cfg, caches, "cpu"))
    _assert_trees_equal(back, caches)


def test_convert_rejects_a_tree_of_another_shape():
    cfg = smoke_config(get_config("stablelm-12b"))
    tree = random_tree(cfg, seed=6)
    tree["layers"]["attn"]["wq"] = tree["layers"]["attn"]["wq"][:, :, :-1]
    with pytest.raises(ValueError, match="wrong shape.*wq"):
        convert.params_from_reference(cfg, tree, "cpu")


def _assert_trees_equal(a, b):
    assert set(a) == set(b)
    for k in b:
        if isinstance(b[k], dict):
            _assert_trees_equal(a[k], b[k])
        else:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-7b", "dbrx-132b", "llama-3.2-vision-90b"])
def test_init_params_follows_specs_and_repeats(arch):
    cfg = smoke_config(get_config(arch))
    specs = lm.param_specs(cfg)
    jspecs = jlm.param_specs(jsmoke_config(jget_config(arch)))
    for dtype in (torch.float32, torch.bfloat16):
        p = lm.init_params(cfg, 3, dtype=dtype, device="cpu")
        flat = _flat(p)
        assert {k: tuple(v.shape) for k, v in flat.items()} == \
            {k: s.shape for k, s in _flat(specs).items()} == \
            {k: s.shape for k, s in _flat(jspecs).items()}
        assert {v.dtype for v in flat.values()} == {dtype}
    a, b = _flat(lm.init_params(cfg, 3, device="cpu")), _flat(lm.init_params(cfg, 3, device="cpu"))
    c = _flat(lm.init_params(cfg, 4, device="cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a)
    normal = [k for k, s in _flat(specs).items() if s.init == "normal"]
    assert normal and all(not torch.equal(a[k], c[k]) for k in normal)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}"))
        return out
    return {path: tree}


def test_serve_main_on_cpu_returns_greedy_tokens(capsys):
    out = serve.main(["--device", "cpu", "--arch", "zamba2-1.2b", "--batch", "2",
                      "--prompt-len", "16", "--gen", "4"])
    assert isinstance(out, np.ndarray) and out.shape == (2, 5)
    assert np.issubdtype(out.dtype, np.integer)
    assert ((out >= 0) & (out < smoke_config(get_config("zamba2-1.2b")).vocab)).all()
    printed = capsys.readouterr().out
    assert "[serve] prefill 2x16" in printed and "[serve] decode 4 steps" in printed


def test_entry_points_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    cfg = smoke_config(get_config("stablelm-12b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "stablelm-12b", "--batch", "1", "--prompt-len", "4", "--gen", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.params_from_reference(cfg, random_tree(cfg, 0))


def test_decode_writes_the_callers_cache_in_place():
    cfg = smoke_config(get_config("stablelm-12b"))
    params = lm.init_params(cfg, 0, device="cpu")
    batch = make_batch(cfg, 1, 8, seed=8)
    _, caches = step.make_prefill_step(cfg)(params, batch)
    caches = serve.pad_caches(caches, 10)
    k = caches["k"]
    assert not k[:, :, 8].any()
    _, out = step.make_decode_step(cfg)(params, {"tokens": np.array([[3]], np.int32)}, caches, 8)
    assert out["k"] is k and k[:, :, 8].abs().sum() > 0 and not k[:, :, 9].any()
