"""The port's dry-run host side against the reference's ``launch/dryrun.py``:
the config helpers on every arch and shape (``analysis_cfg`` field by field
on both grids), ``input_specs`` on both production meshes, the step factories
with ``rules=`` bit for bit against ``rules=None``, the FLOP count (by hand,
against XLA's count of the same step, chunked against chunk-free, direct
against the 1/2-unit extrapolation, ``aten.mv`` and ``aten.dot`` counted),
the chain cell against its analytic count, and ``main`` on one cell.

The reference module sets ``XLA_FLAGS`` (512 host devices) when imported;
the ``jdry`` fixture starts the JAX backend first and restores the variable,
so the rest of the process keeps its one device.  Tolerances: everything
exact except the band against XLA's ``compiled_flops``, which also counts
elementwise work (see that test).
"""

import dataclasses
import json
import os
import time

import jax
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from _torch_lm import make_batch, random_tree
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import smoke_config as jsmoke_config
from repro.launch.mesh import make_host_mesh as jhost_mesh
from repro.runtime import compat as jcompat
from repro.runtime import sharding as jsh
from repro_torch.configs import ALL_ARCHS, SHAPES, ShapeConfig, get_config
from repro_torch.configs.base import smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.serve import pad_caches
from repro_torch.models import convert
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.runtime import compat
from repro_torch.runtime import sharding as sh
from repro_torch.runtime import step
from test_torch_sharding import MESHES, _assert_same_leaves


@pytest.fixture(scope="module")
def jdry():
    jax.devices()      # the backend starts with this process's flags
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as module
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    assert jax.device_count() == 1
    return module


def _fields(cfg) -> dict:
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_config_helpers_match_reference(jdry, arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert dryrun.n_units(cfg) == jdry.n_units(jcfg)
    assert dryrun._zamba_layout(cfg) == jdry._zamba_layout(jcfg)
    for k in (1, 2, 3):
        assert dryrun.unit_layers(cfg, k) == jdry.unit_layers(jcfg, k)
    for name in SHAPES:
        shape, jshape = SHAPES[name], JSHAPES[name]
        assert dryrun.arch_overrides(arch, name) == jdry.arch_overrides(arch, name)
        assert dryrun.train_accum(arch, name) == jdry.train_accum(arch, name)
        assert dryrun.skip_reason(cfg, shape) == jdry.skip_reason(jcfg, jshape)
        for grid in ("flops", "bytes"):
            for k in (1, 2):
                assert _fields(dryrun.analysis_cfg(cfg, k, shape, grid)) == \
                    _fields(jdry.analysis_cfg(jcfg, k, jshape, grid)), (name, grid, k)


def test_overrides_match_reference(jdry):
    sets = ["moe.group=64", "attn_mode=divide", "accum=2", "moe.capacity_factor=1.5",
            "attn_q_chunk=1024"]
    over = dryrun.parse_overrides(sets)
    assert over == jdry.parse_overrides(sets)
    over.pop("accum")
    for arch in ("dbrx-132b", "stablelm-12b"):
        assert _fields(dryrun.apply_overrides(get_config(arch), over)) == \
            _fields(jdry.apply_overrides(jget_config(arch), over))


@pytest.mark.parametrize("kind", MESHES)
def test_input_specs_match_reference(jdry, kind):
    sizes, names = MESHES[kind]
    jmesh = jax.sharding.AbstractMesh(sizes, names)
    mesh = make_production_mesh(multi_pod=kind == "multi")
    for arch in ALL_ARCHS:
        for name in SHAPES:
            _assert_same_leaves(dryrun.input_specs(arch, name, mesh),
                                jdry.input_specs(arch, name, mesh=jmesh), (arch, name))
    assert dryrun.input_specs("zamba2-1.2b", "long_500k")["caches"]["shared_k"].sharding.spec \
        == sh.Placement(None, None, ("data", "model"))


def _equal_trees(a, b, what):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _equal_trees(a[k], b[k], f"{what}/{k}")
    else:
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b)), what


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "llama-3.2-vision-90b", "zamba2-1.2b",
                                  "rwkv6-7b"])
def test_steps_with_rules_are_bit_equal_to_rules_none(arch):
    """A train step (loss, metrics, gradients, new parameters and moments), a
    prefill and two decode steps under the multi-pod rules, against no
    rules: on one device the placements change nothing."""
    cfg = smoke_config(get_config(arch))
    rules = sh.make_rules(make_production_mesh(multi_pod=True))
    tree = random_tree(cfg, 3)
    batch = {k: torch.as_tensor(v) for k, v in make_batch(cfg, 2, 32, seed=4, labels=True).items()}
    opt_cfg = AdamWConfig(warmup_steps=1)
    runs = []
    for r in (None, rules):
        params = convert.params_from_reference(cfg, tree, "cpu")
        acts = step.acts_for(cfg, r, layer_params=True)
        loss, _, _, grads = step.loss_and_grads(cfg, params, batch, acts)
        new = step.make_train_step(cfg, opt_cfg, r, donate=False)(
            params, init_opt_state(params, opt_cfg), batch)
        prompt = {k: v for k, v in batch.items() if k != "labels"}
        logits, caches = step.make_prefill_step(cfg, r, SHAPES["prefill_32k"])(params, prompt)
        decode, live = step.make_decode_step(cfg, r), pad_caches(caches, 34)
        caches = {k: v.clone() for k, v in caches.items()}
        outs = [logits]
        for i in range(2):
            db = ({"embeds": torch.zeros((2, 1, cfg.d_model))} if cfg.input_mode == "embeddings"
                  else {"tokens": outs[-1].argmax(-1)[:, None].to(torch.int32)})
            outs.append(decode(params, db, live, 32 + i)[0])
        caches["decoded"] = live
        runs.append({"loss": loss, "grads": dict(enumerate(grads)), "new": new[:2],
                     "metrics": new[2], "logits": dict(enumerate(outs)), "caches": caches})
    ref, got = runs
    for key in ("loss", "grads", "metrics", "logits", "caches"):
        _equal_trees(got[key], ref[key], key)
    _equal_trees(got["new"][0], ref["new"][0], "params")
    _equal_trees(got["new"][1], ref["new"][1], "opt")


def _hand_count(cfg, b: int, s: int, train: bool) -> int:
    """Matrix-product FLOPs of a dense uniform model (no MoE, tokens input,
    squared-relu MLP), attention and loss in one chunk, 2 per multiply-add.
    Prefill: every layer's forward and the head on the last position.
    Train with ``remat="none"``: every projection forward and backward (dX,
    dW: 3×), attention's two einsums forward and five in the flash backward
    (the scores recomputed, dV, dP, dQ, dK), the head over every position
    forward, recomputed once in its checkpointed loss chunk, and backward
    (4×)."""
    t = b * s
    d, dh, h, kh = cfg.d_model, cfg.d_head, cfg.n_heads, cfg.n_kv_heads
    proj = d * h * dh + 2 * d * kh * dh + h * dh * d + 2 * d * cfg.d_ff
    attn_unit = 2 * b * h * s * s * dh
    if train:
        per_layer = 3 * 2 * t * proj + 7 * attn_unit
        return cfg.n_layers * per_layer + 4 * 2 * t * d * cfg.vocab
    return cfg.n_layers * (2 * t * proj + 2 * attn_unit) + 2 * b * d * cfg.vocab


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_flop_count_equals_the_hand_count(kind):
    cfg = dataclasses.replace(smoke_config(get_config("nemotron-4-15b")), unroll_scans=True,
                              remat="none")
    b, s = (4, 64) if kind == "train" else (2, 64)
    shape = ShapeConfig("hand", kind, s, b)
    costs, _ = dryrun.lower_cell(dryrun.chunk_free(cfg, shape), shape, None,
                                 sh.make_rules(make_host_mesh(), shape), 1)
    assert costs["flops"] == _hand_count(cfg, b, s, kind == "train")


def test_flop_count_against_the_reference_compile(jdry):
    """stablelm-12b's smoke train step with every scan unrolled, on the
    flops grid: XLA's ``flops`` of the jitted step against the port's count.
    XLA's count holds every matrix product the port counts plus the
    elementwise work (norms, RoPE, softmax, the loss, AdamW's update), which
    at smoke width (d_model 64) adds 14-17 % (measured: 1.168×), so the
    band is [1, 1.25]."""
    arch, b, s = "stablelm-12b", 4, 64
    cfg = dataclasses.replace(smoke_config(get_config(arch)), unroll_scans=True)
    jcfg = dataclasses.replace(jsmoke_config(jget_config(arch)), unroll_scans=True)
    shape, jshape = ShapeConfig("x", "train", s, b), JShapeConfig("x", "train", s, b)
    units = dryrun.n_units(cfg)
    lowered, _ = jdry.lower_cell(jdry.analysis_cfg(jcfg, units, jshape), jshape, jhost_mesh(),
                                 jsh.make_rules(jhost_mesh(), jshape), 1)
    xla = jcompat.compiled_flops(lowered.compile())
    mine, _ = dryrun.lower_cell(dryrun.analysis_cfg(cfg, units, shape), shape, None,
                                sh.make_rules(make_host_mesh(), shape), 1)
    assert 1.0 <= xla / mine["flops"] <= 1.25, (xla, mine["flops"])


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_direct_count_equals_chunked_and_the_extrapolation(arch):
    """With ``unroll_scans=True``: the chunk-free count equals the count at
    the smoke chunking (several attention and loss blocks: the port computes
    every block, masked ones too), and the 1/2-unit extrapolation equals
    the direct count at full smoke depth (uniform archs cut to 4 layers)."""
    cfg = dataclasses.replace(smoke_config(get_config(arch)), unroll_scans=True)
    if cfg.pattern == "uniform":
        cfg = dataclasses.replace(cfg, n_layers=4)
    shape = ShapeConfig("x", "train", 64, 2)
    rules = sh.make_rules(make_host_mesh(), shape)
    direct, _ = dryrun.lower_cell(dryrun.chunk_free(cfg, shape), shape, None, rules, 1)
    chunked, _ = dryrun.lower_cell(cfg, shape, None, rules, 1)
    assert chunked["flops"] == direct["flops"]
    analysis = dryrun.run_analysis(cfg, shape, None, rules)
    assert analysis["units"] >= 2 and analysis["extrapolated"]["flops"] == direct["flops"]
    assert analysis["extrapolated"]["bytes"] is None


def test_divide_mode_counts_the_same_chunked_and_chunk_free():
    cfg = dataclasses.replace(smoke_config(get_config("stablelm-12b")), attn_mode="divide")
    shape = ShapeConfig("x", "prefill", 128, 2)
    rules = sh.make_rules(make_host_mesh(), shape)
    direct, _ = dryrun.lower_cell(dryrun.chunk_free(cfg, shape), shape, None, rules, 1)
    chunked, _ = dryrun.lower_cell(cfg, shape, None, rules, 1)
    full, _ = dryrun.lower_cell(dataclasses.replace(cfg, attn_mode="full_masked"), shape, None,
                                rules, 1)
    assert chunked["flops"] == direct["flops"] < full["flops"]


def test_matrix_vector_and_vector_products_are_counted():
    """``FlopCounterMode``'s own table counts ``aten.mv`` and ``aten.dot`` as
    0; ``compat.cost_analysis`` adds them (2 per multiply-add)."""
    a, v, w = torch.ones(64, 128), torch.ones(128), torch.ones(64)
    with FlopCounterMode(display=False) as plain:
        a @ v
    assert plain.get_total_flops() == 0
    assert compat.compiled_flops(lambda: a @ v) == 2 * 64 * 128
    assert compat.compiled_flops(lambda: v @ v) == 2 * 128
    assert compat.compiled_flops(lambda: w @ a) == 2 * 64 * 128       # through mm
    assert compat.cost_analysis(lambda: torch.addmm(v[:64, None], a, a.T[:, :1])) == {
        "flops": 2.0 * 64 * 128}


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_chain_cell_matches_its_analytic_count(kind):
    """The chain cell on a 16-shard meta mesh: per device, r (d, d) float32
    factors in 16 row blocks; FLOPs (r - 1) forward vector-matrix products,
    r - 1 backward matrix-vector products and the bag-0 absorption, each
    2·(d/16)·d; with V measures every product carries V columns, and the
    last bag's absorption 2·(d/16)·V."""
    r, d, n, v = 4, 64, 16, 3
    rec = dryrun.run_treant_cell(kind, r=r, d=d)
    assert rec["status"] == "ok" and rec["mesh"] == kind
    assert rec["memory"]["argument_bytes"] == r * (d // n) * d * 4
    assert rec["cost_raw"]["flops"] == (2 * (r - 1) + 1) * 2 * (d // n) * d
    multi = dryrun.run_treant_cell(kind, n_measures=v, r=r, d=d)
    assert multi["memory"]["argument_bytes"] == r * (d // n) * d * 4 + (d // n) * v * 4
    assert multi["cost_raw"]["flops"] == 2 * (r - 1) * 2 * (d // n) * d * v + 2 * (d // n) * v


SMALL = {"train_4k": ShapeConfig("train_4k", "train", 64, 8),
         "prefill_32k": ShapeConfig("prefill_32k", "prefill", 64, 2),
         "decode_32k": ShapeConfig("decode_32k", "decode", 64, 2),
         "long_500k": ShapeConfig("long_500k", "decode", 128, 1)}


@pytest.fixture
def smoke_cells(monkeypatch):
    """The dry-run's cells at smoke size: ``get_config`` gives smoke configs
    and the shapes are cut (the production mesh and rules stay)."""
    import repro_torch.configs as configs

    full = configs.get_config
    monkeypatch.setattr(configs, "get_config", lambda name: smoke_config(full(name)))
    for name, shape in SMALL.items():
        monkeypatch.setitem(SHAPES, name, shape)


def test_main_writes_a_cell_record(smoke_cells, tmp_path):
    recs = dryrun.main(["--arch", "granite-moe-1b-a400m", "--shape", "train_4k",
                        "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "granite-moe-1b-a400m__train_4k__single.json").read_text())
    assert json.loads(json.dumps(recs)) == [rec] and rec["status"] == "ok"
    assert rec["meta"] == {"accum": 1}
    cfg = smoke_config(get_config("granite-moe-1b-a400m"))
    rules = sh.make_rules(make_production_mesh(), SMALL["train_4k"])
    params, opt = step.abstract_train_state(cfg, AdamWConfig(), rules)
    batch = sh.batch_specs(cfg, SMALL["train_4k"], rules, "bfloat16")
    assert rec["memory"]["argument_bytes"] == sh.device_bytes(
        {"p": params, "o": opt, "b": batch})
    # the step's outputs: new parameters and state under the same placements,
    # five replicated float32 metrics
    assert rec["memory"]["output_bytes"] == sh.device_bytes({"p": params, "o": opt}) + 5 * 4
    assert rec["memory"]["temp_bytes"] is None and rec["collectives_schedule"] is None
    assert rec["cost_raw"]["flops"] > 0 and rec["analysis"]["direct_minus_extrapolated"] == 0
    skipped = dryrun.main(["--arch", "stablelm-12b", "--shape", "long_500k", "--mesh", "multi",
                           "--out", str(tmp_path)])[0]
    assert skipped["status"] == "skipped" and "sub-quadratic" in skipped["reason"]


def test_a_failing_or_slow_cell_gets_an_error_record(smoke_cells, tmp_path, monkeypatch):
    rec = dryrun.main(["--arch", "stablelm-12b", "--shape", "train_4k", "--set", "n_layers=3",
                       "--set", "scan_groups=2", "--out", str(tmp_path), "--tag", "bad"])[0]
    assert rec["status"] == "error" and "scan_groups" in rec["traceback"]
    assert (tmp_path / "hillclimb" / "stablelm-12b__train_4k__single__bad.json").exists()

    def slow(*args, **kwargs):
        time.sleep(30)

    monkeypatch.setattr(dryrun, "lower_cell", slow)
    t0 = time.perf_counter()
    rec = dryrun.main(["--arch", "stablelm-12b", "--shape", "decode_32k", "--timeout", "1",
                       "--out", str(tmp_path)])[0]
    assert rec["status"] == "error" and rec["reason"] == "timeout>1s"
    assert time.perf_counter() - t0 < 10
