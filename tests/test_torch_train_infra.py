"""The port's training substrate against the reference's: checkpointing
(async, atomic, retention, restore onto another device, files the reference
writes and reads, bfloat16 leaves), the data pipeline (bit-equal batches,
deterministic restart, a producer that stops and reports its errors), the
straggler monitor, int8 gradient compression (``compress_int8`` and
``psum_compressed`` against the reference's), the optimizer-state
conversion, and ``launch.train`` on the CPU (failure recovery, a restart
whose losses are bit-equal to an uninterrupted run, ``--resume``).

Mirrors ``test_runtime_infra.py`` but for
``test_sharding_rules_divisibility_fallback``, which
``test_torch_sharding.py`` mirrors.  Every test writes only under
``tmp_path``, passes ``--ckpt-dir`` to ``launch.train``, and closes every
pipeline and checkpointer it starts.
Tolerances: compression against the reference to rtol 1e-6 (the same
float32 operations); everything else exact.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import random_tree
from repro.checkpoint import checkpointer as jckpt
from repro.data import pipeline as jpipe
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro_torch.checkpoint.checkpointer import Checkpointer, restore_pytree, save_pytree
from repro_torch.configs import get_config
from repro_torch.configs.base import smoke_config
from repro_torch.core.distributed import ShardMesh
from repro_torch.data import pipeline
from repro_torch.data.pipeline import StragglerMonitor, TokenPipeline, synth_batch
from repro_torch.launch import train
from repro_torch.models import convert
from repro_torch.optim.compression import compress_int8, decompress_int8, psum_compressed


def _steps_on_disk(d) -> list[int]:
    return sorted(int(p.name.split("_")[1]) for p in Path(d).glob("step_*"))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": {"c": np.float32(3.5), "d": np.arange(4, dtype=np.int32)}}
    save_pytree(tree, tmp_path, 7)
    got, step = restore_pytree(tmp_path, template=tree)
    assert step == 7
    np.testing.assert_array_equal(got["a"], tree["a"])
    np.testing.assert_array_equal(got["b"]["d"], tree["b"]["d"])
    assert got["b"]["c"].item() == 3.5 and got["b"]["d"].dtype == torch.int32


def test_checkpoint_async_retention(tmp_path):
    tree = {"w": np.zeros(4, np.float32)}
    with Checkpointer(tmp_path, keep=2) as ck:
        for s in (1, 2, 3, 4):
            ck.save_async({"w": torch.full((4,), float(s))}, s)
        ck.wait()
        assert ck.saved_steps == [1, 2, 3, 4] and ck.latest_step() == 4
    assert not ck._worker.is_alive()
    assert _steps_on_disk(tmp_path) == [3, 4]
    got, s = restore_pytree(tmp_path, template=tree)
    assert s == 4 and got["w"][0] == 4.0


def test_checkpoint_snapshot_is_taken_when_saved(tmp_path):
    """``save_async`` copies the tree before returning: an in-place update
    of the same tensor afterwards (a donated train step) is not saved."""
    w = torch.zeros(1000)
    with Checkpointer(tmp_path) as ck:
        ck.save_async({"w": w}, 1)
        w.add_(1.0)
        ck.wait()
    got, _ = restore_pytree(tmp_path)
    assert not got["/w"].any()


def test_checkpoint_snapshot_walks_lists_and_tuples(tmp_path):
    """Leaves inside lists and tuples are copied by ``save_async`` too, and
    come back in their containers through the template."""
    tree = {"layers": [torch.zeros(3), (torch.ones(2), torch.arange(4))]}
    with Checkpointer(tmp_path) as ck:
        ck.save_async(tree, 1)
        for t in (tree["layers"][0], *tree["layers"][1]):
            t.add_(5)
        ck.wait()
    got, _ = restore_pytree(tmp_path, template=tree)
    assert isinstance(got["layers"], list) and isinstance(got["layers"][1], tuple)
    assert torch.equal(got["layers"][0], torch.zeros(3))
    assert torch.equal(got["layers"][1][0], torch.ones(2))
    assert torch.equal(got["layers"][1][1], torch.arange(4))


def test_checkpoint_restore_onto_another_device(tmp_path):
    """The counterpart of ``test_checkpoint_elastic_reshard``: one device
    for every leaf, or a tree of devices matching the template."""
    tree = {"w": np.arange(16, dtype=np.float32).reshape(4, 4), "b": np.ones(3, np.float32)}
    save_pytree(tree, tmp_path, 1)
    got, _ = restore_pytree(tmp_path, template=tree, device="cpu")
    np.testing.assert_array_equal(got["w"].numpy(), tree["w"])
    got, _ = restore_pytree(tmp_path, template=tree, device={"w": "cpu", "b": "meta"})
    assert got["w"].device.type == "cpu" and got["b"].device.type == "meta"
    assert got["b"].shape == (3,) and got["b"].dtype == torch.float32
    np.testing.assert_array_equal(got["w"].numpy(), tree["w"])


def test_checkpointer_wait_raises_the_writers_error(tmp_path):
    """The reference's ``wait()`` spins forever after its writer raised;
    the port's raises the error and the writer still stops on ``close()``."""
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("x")
    ck = Checkpointer(blocker, keep=1)
    try:
        ck.save_async({"w": torch.ones(2)}, 1)
        with pytest.raises(RuntimeError, match="checkpoint save failed"):
            ck.wait()
        assert ck._worker.is_alive()              # the writer survives its error
        ck.wait()                                 # raised once, then clear
    finally:
        ck.close()
    assert not ck._worker.is_alive()


def test_bf16_leaf_goes_to_disk_as_its_bit_pattern(tmp_path):
    x = torch.tensor([1.0, -2.5, 3.0e-3, 65504.0, float("inf")]).bfloat16()
    save_pytree({"m": x, "v": x.float()}, tmp_path, 3)
    manifest = json.loads((tmp_path / "step_00000003" / "manifest.json").read_text())
    assert manifest["keys"]["/m"]["dtype"] == "bfloat16"
    with np.load(tmp_path / "step_00000003" / "arrays.npz") as z:
        assert z["|m"].dtype == np.uint16
    got, _ = restore_pytree(tmp_path)
    assert got["/m"].dtype == torch.bfloat16
    assert torch.equal(got["/m"].view(torch.int16), x.view(torch.int16))


def test_checkpoints_interchange_with_the_reference(tmp_path):
    """float32 and int32 leaves written by either package restore in the
    other; the reference's bfloat16 leaf (stored as ``|V2``, which the
    reference's own restore hands back unusable) restores as bfloat16 in
    the port."""
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "opt": {"step": np.int32(5), "m": rng.standard_normal(6).astype(np.float32)}}
    jckpt.save_pytree(jax.tree_util.tree_map(jnp.asarray, tree), tmp_path / "ref", 2)
    got, step = restore_pytree(tmp_path / "ref", template=tree)
    assert step == 2
    np.testing.assert_array_equal(got["w"].numpy(), tree["w"])
    np.testing.assert_array_equal(got["opt"]["m"].numpy(), tree["opt"]["m"])
    assert got["opt"]["step"].dtype == torch.int32 and got["opt"]["step"].item() == 5

    save_pytree({"w": torch.tensor(tree["w"]), "opt": {"step": torch.tensor(5, dtype=torch.int32),
                                                      "m": torch.tensor(tree["opt"]["m"])}},
                tmp_path / "port", 4)
    back, step = jckpt.restore_pytree(tmp_path / "port", template=tree)
    assert step == 4
    np.testing.assert_array_equal(back["w"], tree["w"])
    np.testing.assert_array_equal(back["opt"]["m"], tree["opt"]["m"])
    assert back["opt"]["step"] == 5

    b = jnp.asarray(rng.standard_normal(8), jnp.bfloat16)
    jckpt.save_pytree({"m": b}, tmp_path / "bf16", 1)
    got, _ = restore_pytree(tmp_path / "bf16")
    assert got["/m"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["/m"].float().numpy(), np.asarray(b, np.float32))


def test_optimizer_state_converts_both_ways():
    cfg = smoke_config(get_config("granite-moe-1b-a400m"))
    tree = random_tree(cfg, 4)
    state = jadamw.init_opt_state(jax.tree_util.tree_map(jnp.asarray, tree), jadamw.AdamWConfig())
    state = {"m": jax.tree_util.tree_map(lambda a: (a + 0.37).astype(jnp.bfloat16), state["m"]),
             "v": jax.tree_util.tree_map(lambda a: a + 0.5, state["v"]), "step": jnp.int32(9)}
    np_state = jax.tree_util.tree_map(np.asarray, state)
    port = convert.opt_state_from_reference(cfg, np_state, device="cpu")
    assert port["m"]["layers"]["moe"]["w1"].dtype == torch.bfloat16
    assert port["v"]["head"].dtype == torch.float32 and port["step"].item() == 9
    back = convert.opt_state_to_reference(cfg, port)
    np.testing.assert_array_equal(back["m"]["embed"], np.asarray(state["m"]["embed"], np.float32))
    np.testing.assert_array_equal(back["v"]["layers"]["ln1"], np_state["v"]["layers"]["ln1"])
    assert int(back["step"]) == 9
    with pytest.raises(ValueError, match="m, v and step"):
        convert.opt_state_from_reference(cfg, {"m": np_state["m"]}, device="cpu")


# ---------------------------------------------------------------------------
# data pipeline, straggler monitor
# ---------------------------------------------------------------------------

def test_pipeline_deterministic_restart():
    with TokenPipeline(100, 2, 8, start_step=5) as p1:
        b1 = next(p1)
    with TokenPipeline(100, 2, 8, start_step=5) as p2:
        b2 = next(p2)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    direct = synth_batch(100, 2, 8, 5)
    np.testing.assert_array_equal(b1["tokens"], direct["tokens"])
    assert not p1._t.is_alive() and not p2._t.is_alive()


@pytest.mark.parametrize("mode", ["tokens", "embeddings", "tokens+vision"])
def test_pipeline_batches_equal_the_references_bit_for_bit(mode):
    kw = dict(mode=mode, d_model=16, n_vision_tokens=3, start_step=11)
    ref = jpipe.TokenPipeline(50, 2, 8, **kw)
    try:
        with TokenPipeline(50, 2, 8, **kw) as mine:
            for _ in range(3):
                a, b = next(mine), next(ref)
                assert set(a) == set(b)
                for k in b:
                    assert a[k].dtype == b[k].dtype
                    np.testing.assert_array_equal(a[k], b[k])
    finally:
        ref.close()


def test_pipeline_producer_error_is_raised_and_close_joins(monkeypatch):
    def broken(*a, **k):
        raise ValueError("no data")

    monkeypatch.setattr(pipeline, "synth_batch", broken)
    p = TokenPipeline(10, 1, 4)
    try:
        with pytest.raises(RuntimeError, match="producer failed"):
            next(p)
    finally:
        p.close()
    assert not p._t.is_alive()


def test_straggler_monitor_flags_outliers():
    m = StragglerMonitor(threshold=2.0, warmup=2)
    for i in range(8):
        assert not m.observe(i, 0.1)
    assert m.observe(8, 0.5)
    assert m.flagged == [(8, 0.5)]
    assert not m.observe(9, 0.11)  # ewma not polluted by the outlier


# ---------------------------------------------------------------------------
# int8 gradient compression
# ---------------------------------------------------------------------------

def test_int8_compression_error_feedback():
    rng = np.random.default_rng(0)
    g = {"w": torch.tensor(rng.standard_normal(128), dtype=torch.float32)}
    q, scales, err = compress_int8(g)
    deq = decompress_int8(q, scales)
    rel = np.linalg.norm(deq["w"].numpy() - g["w"].numpy()) / np.linalg.norm(g["w"].numpy())
    assert rel < 0.02
    # feeding the error back makes the SUM over steps exact-ish
    q2, s2, err2 = compress_int8(g, error=err)
    total = decompress_int8(q, scales)["w"].numpy() + decompress_int8(q2, s2)["w"].numpy()
    want = 2 * g["w"].numpy()
    assert np.linalg.norm(total - want) / np.linalg.norm(want) < 0.02


def test_int8_compression_matches_reference():
    rng = np.random.default_rng(1)
    tree = {"a": rng.standard_normal((4, 5)).astype(np.float32),
            "b": {"c": (100 * rng.standard_normal(9)).astype(np.float32)}}
    err = {"a": (0.01 * rng.standard_normal((4, 5))).astype(np.float32),
           "b": {"c": (0.1 * rng.standard_normal(9)).astype(np.float32)}}
    jq, js, je = jcomp.compress_int8(jax.tree_util.tree_map(jnp.asarray, tree),
                                     error=jax.tree_util.tree_map(jnp.asarray, err))
    tq, ts, te = compress_int8(jax.tree_util.tree_map(torch.tensor, tree),
                               error=jax.tree_util.tree_map(torch.tensor, err))
    for path in (("a",), ("b", "c")):
        pick = lambda t: t[path[0]] if len(path) == 1 else t[path[0]][path[1]]  # noqa: E731
        assert pick(tq).dtype == torch.int8
        np.testing.assert_array_equal(pick(tq).numpy(), np.asarray(pick(jq)))
        np.testing.assert_allclose(pick(ts).item(), float(pick(js)), rtol=1e-6)
        np.testing.assert_allclose(pick(te).numpy(), np.asarray(pick(je)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k", [1, 3])
def test_psum_compressed_matches_reference(k):
    """The port over a virtual mesh of k CPU shards against the reference's
    ``psum_compressed`` with its collectives over a ``vmap`` axis of k."""
    rng = np.random.default_rng(2 + k)
    grads = [{"w": rng.standard_normal((3, 4)).astype(np.float32) * (i + 1),
              "b": rng.standard_normal(5).astype(np.float32)} for i in range(k)]
    errs = [{"w": (0.01 * rng.standard_normal((3, 4))).astype(np.float32),
             "b": (0.01 * rng.standard_normal(5)).astype(np.float32)} for _ in range(k)]
    stack = lambda trees: {n: jnp.stack([t[n] for t in trees]) for n in trees[0]}  # noqa: E731
    js, je = jax.vmap(lambda g, e: jcomp.psum_compressed(g, "i", e), axis_name="i")(
        stack(grads), stack(errs))
    summed, new_err = psum_compressed(
        [{n: torch.tensor(v) for n, v in g.items()} for g in grads], ShardMesh.virtual(k, "cpu"),
        error=[{n: torch.tensor(v) for n, v in e.items()} for e in errs])
    assert len(new_err) == k
    for n in ("w", "b"):
        np.testing.assert_allclose(summed[n].numpy(), np.asarray(js[n][0]), rtol=1e-6, atol=1e-6)
        for i in range(k):
            np.testing.assert_allclose(new_err[i][n].numpy(), np.asarray(je[n][i]),
                                       rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="mesh of"):
        psum_compressed(grads[:1], ShardMesh.virtual(2, "cpu"))


# ---------------------------------------------------------------------------
# the train entry point
# ---------------------------------------------------------------------------

def _train(tmp_path, *extra, steps=10):
    return train.main(["--device", "cpu", "--arch", "granite-moe-1b-a400m", "--steps", str(steps),
                       "--batch", "2", "--seq", "32", "--ckpt-every", "4",
                       "--ckpt-dir", str(tmp_path), "--log-every", "5", *extra])


def test_train_driver_failure_recovery(tmp_path, capsys):
    losses = _train(tmp_path, "--inject-failure", "6")
    assert len(losses) >= 10
    assert all(np.isfinite(l) for l in losses)
    out = capsys.readouterr().out
    assert "FAILURE: injected node failure at step 6" in out and "restored step 4" in out
    assert _steps_on_disk(tmp_path / "granite-moe-1b-a400m-smoke") == [4, 8]


def test_train_restart_is_bit_equal_to_an_uninterrupted_run(tmp_path):
    """Interrupted at step 6 and restored from step 4: the losses of steps
    4-9 equal an uninterrupted run's bit for bit (the checkpoint holds the
    float32 state exactly; the pipeline restarts at the restored step)."""
    plain = _train(tmp_path / "a")
    failed = _train(tmp_path / "b", "--inject-failure", "6")
    assert len(plain) == 10 and len(failed) == 12
    assert failed[:6] == plain[:6]
    assert failed[6:] == plain[4:]


def test_train_resume(tmp_path):
    """``--resume`` picks up the latest checkpoint of the run's directory."""
    full = _train(tmp_path, steps=12)
    run_dir = tmp_path / "granite-moe-1b-a400m-smoke"
    assert _steps_on_disk(run_dir) == [4, 8, 12]
    for s in (8, 12):
        for p in run_dir.glob(f"step_{s:08d}"):
            for f in p.iterdir():
                f.unlink()
            p.rmdir()
    resumed = _train(tmp_path, "--resume", steps=12)
    assert resumed == full[4:]


def test_train_telemetry_dashboard(tmp_path, monkeypatch):
    """The dashboard is built on the train device and, every 10 steps,
    re-rendered with the recent steps and calibrated in think time."""
    seen = []
    real = train._update_dashboard

    def spy(dash, recent):
        real(dash, recent)
        seen.append((dash["version"], [r["step"] for r in recent], dash["treant"].device.type))

    monkeypatch.setattr(train, "_update_dashboard", spy)
    losses = _train(tmp_path, "--telemetry-dashboard", steps=10)
    assert len(losses) == 10
    assert seen == [(1, list(range(10)), "cpu")]


def test_train_entry_point_defaults_to_cuda_and_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "granite-moe-1b-a400m", "--steps", "1", "--ckpt-dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())
