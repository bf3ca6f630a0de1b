"""The port's sharding surface against the reference's: ``make_rules`` (with
its long-context decode branch), ``pspec_for`` (divisibility fallback, each
mesh axis once), the placements and per-device bytes of every parameter,
optimizer-state and cache leaf of all ten full configs on both production
meshes, ``act_specs``, ``batch_specs``, ``abstract_params`` and
``abstract_train_state``, and ``with_sharding`` on one device.

The reference side runs on ``jax.sharding.AbstractMesh`` meshes (no devices);
its ``NamedSharding.shard_shape`` gives a device's block.  Everything is
compared exactly: placements as tuples, per-device bytes as integers, shapes
and dtypes of the meta skeletons.  No full-size tensor is allocated on
either side.
"""

import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.models import lm as jlm
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.runtime import sharding as jsh
from repro.runtime import step as jstep
from repro_torch.configs import ALL_ARCHS, SHAPES, get_config
from repro_torch.configs.base import smoke_config
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import sharding as sh
from repro_torch.runtime import step
from repro_torch.runtime.compat import make_mesh

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(kind):
    sizes, names = MESHES[kind]
    return make_production_mesh(multi_pod=kind == "multi"), jax.sharding.AbstractMesh(sizes, names)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def _ref_bytes(s) -> int:
    return math.prod(s.sharding.shard_shape(s.shape)) * np.dtype(s.dtype).itemsize


def _assert_same_leaves(port, ref, what):
    port, ref = dict(_flat(port)), dict(_flat(ref))
    assert port.keys() == ref.keys(), what
    for k, r in ref.items():
        p = port[k]
        assert p.tensor.is_meta, (what, k)
        assert p.shape == tuple(r.shape) and _dtype_name(p.dtype) == str(r.dtype), (what, k)
        assert tuple(p.sharding.spec) == tuple(r.sharding.spec), (what, k, p.sharding.spec)
        assert p.shard_shape() == tuple(r.sharding.shard_shape(r.shape)), (what, k)
        assert p.device_bytes == _ref_bytes(r), (what, k)
    return sum(p.device_bytes for p in port.values())


def test_sharding_rules_divisibility_fallback():
    rules = sh.make_rules(make_host_mesh(), multi_pod=False)
    fake = sh.ShardingRules(mesh=make_mesh((16, 16), ("data", "model")), table=rules.table)
    p = sh.pspec_for((49155, 1024), ("vocab", "embed"), fake)
    assert p[0] is None          # 49155 % 16 != 0 → replicated
    assert p[1] == "data"
    p2 = sh.pspec_for((100352, 1024), ("vocab", "embed"), fake)
    assert p2[0] == "model"
    # same mesh axis never used twice
    p3 = sh.pspec_for((64, 64), ("embed", "act_batch"), fake)
    assert p3[0] == "data" and (len(p3) < 2 or p3[1] is None)
    # a placement is a tuple, trailing Nones dropped, as a PartitionSpec
    assert sh.pspec_for((7, 8), (None, None), fake) == () and isinstance(p, tuple)


@pytest.mark.parametrize("kind", MESHES)
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_state_and_cache_placements_and_bytes_match_reference(arch, kind):
    """Every parameter, AdamW-state and decode-cache leaf of the full config:
    the same placement, shard shape and per-device bytes as the reference."""
    mesh, jmesh = _meshes(kind)
    cfg, jcfg = get_config(arch), jget_config(arch)
    params, opt = step.abstract_train_state(cfg, AdamWConfig(), sh.make_rules(mesh))
    jparams, jopt = jstep.abstract_train_state(jcfg, JAdamWConfig(), jsh.make_rules(jmesh))
    total = _assert_same_leaves(params, jparams, "params")
    total += _assert_same_leaves(opt, jopt, "opt")
    assert total == sh.device_bytes(params) + sh.device_bytes(opt)
    for name in ("decode_32k", "long_500k"):
        caches = step.abstract_caches(cfg, SHAPES[name], sh.make_rules(mesh, SHAPES[name]))
        jcaches = jstep.abstract_caches(jcfg, JSHAPES[name], jsh.make_rules(jmesh, JSHAPES[name]))
        _assert_same_leaves(caches, jcaches, name)


@pytest.mark.parametrize("kind", MESHES)
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_act_and_batch_specs_match_reference(arch, kind):
    """``act_specs`` and ``batch_specs`` for every shape, the long-context
    decode branch (batch 1 below the fsdp width) included."""
    mesh, jmesh = _meshes(kind)
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name in SHAPES:
        rules, jrules = sh.make_rules(mesh, SHAPES[name]), jsh.make_rules(jmesh, JSHAPES[name])
        assert rules.table == {k: tuple(v) for k, v in jrules.table.items()}, name
        acts, jacts = sh.act_specs(cfg, rules), jsh.act_specs(jcfg, jrules)
        assert acts.keys() == jacts.keys()
        for k, ref in jacts.items():
            assert tuple(acts[k].spec) == tuple(ref.spec), (name, k)
        _assert_same_leaves(sh.batch_specs(cfg, SHAPES[name], rules, "bfloat16"),
                            jsh.batch_specs(jcfg, JSHAPES[name], jrules, "bfloat16"), name)
    long = sh.make_rules(mesh, SHAPES["long_500k"])
    fsdp = ("pod", "data") if kind == "multi" else ("data",)
    assert long.table["act_batch"] == () and long.table["cache_seq"] == fsdp + ("model",)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_abstract_params_are_meta_tensors_of_the_reference_skeleton(arch):
    """``abstract_params`` (and ``LM.abstract_params``): meta tensors, no
    storage, shapes and dtypes of the reference's ``ShapeDtypeStruct``s; with
    a ``sharding_fn`` each leaf carries the placement it returns.  The full
    configs' skeletons would not fit in memory if they were allocated."""
    cfg = get_config(arch)
    jparams = dict(_flat(jlm.abstract_params(jget_config(arch))))
    for tree in (lm.abstract_params(cfg), lm.LM.abstract_params(cfg, torch.bfloat16)):
        got = dict(_flat(tree))
        assert got.keys() == jparams.keys()
        for k, r in jparams.items():
            t = got[k]
            assert t.is_meta, k
            assert tuple(t.shape) == tuple(r.shape) and _dtype_name(t.dtype) == str(r.dtype), k
    rules = sh.make_rules(make_production_mesh())
    placed = lm.abstract_params(cfg, sharding_fn=lambda s: sh.sharding_for(s, rules))
    specs = dict(_flat(lm.param_specs(cfg)))
    for k, a in _flat(placed):
        assert a.tensor.is_meta and a.sharding == sh.sharding_for(specs[k], rules)


def test_with_sharding_returns_its_input_and_checks_the_rank():
    x = torch.arange(24.0).reshape(2, 3, 4)
    rules = sh.make_rules(make_production_mesh())
    three = sh.NamedSharding(rules.mesh, sh.Placement("data", None, "model"))
    assert L.with_sharding(x, three) is x and L.with_sharding(x, None) is x
    with pytest.raises(ValueError, match="more entries"):
        L.with_sharding(x[0], three)


def test_step_factories_pass_the_reference_placements():
    """The acts a step hands the model: ``act_specs`` plus, for the train
    step, the per-slice placements of the stacked layers
    (``layer_slice_constraint``) equal to the reference's; the prefill step's
    ``out_shardings`` equal the reference's."""
    mesh, jmesh = _meshes("multi")
    cfg, jcfg = get_config("dbrx-132b"), jget_config("dbrx-132b")
    shape, jshape = SHAPES["prefill_32k"], JSHAPES["prefill_32k"]
    rules, jrules = sh.make_rules(mesh, shape), jsh.make_rules(jmesh, jshape)
    lc, jlc = step.layer_slice_constraint(cfg, rules), jstep.layer_slice_constraint(jcfg, jrules)
    for (k, s), (jk, js) in zip(_flat(lc), _flat(jlc)):
        assert k == jk and tuple(s.spec) == tuple(js.spec), k
    assert step.layer_slice_constraint(get_config("zamba2-1.2b"), rules) is None
    assert step.make_prefill_step(cfg).out_shardings is None
    logits_sh, cache_sh = step.make_prefill_step(cfg, rules, shape).out_shardings
    # what the reference's make_prefill_step passes as out_shardings
    jlogits = jsh.pspec_for((jshape.global_batch, jcfg.vocab), ("act_batch", "act_vocab"), jrules)
    jcache_sh = jsh.tree_shardings(jlm.cache_specs(jcfg, jshape.global_batch, jshape.seq_len),
                                   jrules)
    assert tuple(logits_sh.spec) == tuple(jlogits)
    for (k, s), (jk, js) in zip(_flat(cache_sh), _flat(jcache_sh)):
        assert k == jk and tuple(s.spec) == tuple(js.spec), k


def test_shard_shape_refuses_what_does_not_split():
    mesh = make_production_mesh()
    with pytest.raises(ValueError, match="does not split"):
        sh.NamedSharding(mesh, sh.Placement("model")).shard_shape((10, 4))
    assert sh.NamedSharding(mesh, sh.Placement(None, ("data", "model"))).shard_shape(
        (3, 512)) == (3, 2)


def test_smoke_state_shardings_on_the_host_mesh_are_whole():
    """On ``make_host_mesh()`` (1 × 1) every placement keeps the whole array:
    per-device bytes are the arrays' bytes."""
    cfg = smoke_config(get_config("granite-moe-1b-a400m"))
    params, opt = step.abstract_train_state(cfg, AdamWConfig(), sh.make_rules(make_host_mesh()))
    for tree in (params, opt):
        for _, a in _flat(tree):
            assert a.shard_shape() == a.shape
            assert a.device_bytes == a.tensor.numel() * a.tensor.element_size()
