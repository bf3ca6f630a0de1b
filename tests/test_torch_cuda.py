"""The port on a CUDA card: the hand-written kernels (segment-aggregate,
semiring_contract, tropical_contract) held against their plain PyTorch
versions on the same card, and the quickstart slice — sparse, and with every
dimension table dense — on ``cuda`` held against the same slice on the CPU.

Every test here is marked ``gpu`` and skips without a card (decided inside
the ``cuda`` fixture).  The file imports neither JAX nor the JAX package, so
it runs on a machine with a card and no JAX:
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py``.

Tolerances: min/max and sums of integer-valued floats must match exactly;
the segment kernels' gamma-valued sums agree to rtol 1e-5 with the float64
plain version (float32 sums, in an order fixed by each message) and give
the same bits on every launch, stream and graph replay; float16
and uniform float32 contractions to the reference file's rtol 5e-3 /
atol 1e-3.  The contract kernels sum in a fixed order (split partials merge
in block order), so two calls on the same inputs give the same bits.

The LM stack's smoke configs run on the card in float32 with TF32 off and
are held against the port on the CPU, every parameter leaf random: logits
and caches to rtol / atol 5e-4 (summation order only), greedy tokens
exactly.  Training: ``flash_attention``'s gradients on the card against
the CPU to rtol / atol 5e-4; one smoke train step's loss to rtol 1e-5 and
every gradient leaf to rtol 1e-3 plus 5e-4 of the leaf's largest element
(the card's embedding and MoE backward add with atomics, in any order);
AdamW on identical gradients to rtol 1e-5 / atol 1e-7, its bfloat16 first
moment to one bf16 ulp.  Steps under the sharding rules equal steps without
them bit for bit."""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_lm import make_batch, random_tree
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.configs.base import smoke_config
from repro_torch.core import Query, Treant
from repro_torch.core import semiring as sr
from repro_torch.kernels import launch
from repro_torch.kernels.segment_aggregate import ops
from repro_torch.kernels.segment_aggregate.ref import (IDENTITY, recipe_values,
                                                       segment_aggregate_ref)
from repro_torch.kernels.semiring_contract import ops as sc_ops
from repro_torch.kernels.semiring_contract.ref import semiring_contract_ref
from repro_torch.kernels.tropical_contract import ops as tc_ops
from repro_torch.kernels.tropical_contract.ref import tropical_contract_ref
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.serve import pad_caches
from repro_torch.checkpoint.checkpointer import restore_pytree, save_pytree
from repro_torch import tree as lm_tree
from repro_torch.models import convert
from repro_torch.models import layers as lm_layers
from repro_torch.optim import adamw
from repro_torch.runtime import sharding as lm_sharding
from repro_torch.runtime import step as lm_step
from repro_torch.runtime.step import make_decode_step, make_prefill_step
from repro_torch.relational import schema
from repro_torch.relational.relation import Catalog, mask_in, mask_range

pytestmark = pytest.mark.gpu

SHAPES = [(64, 8, 1), (1000, 64, 3), (77, 13, 5), (4096, 300, 2),
          (1 << 20, 100_000, 1), (1 << 20, 12, 8)]
LEVEL_SPECS = [
    [(64, 8, 1)],
    [(64, 8, 2), (100, 13, 2), (256, 64, 2)],
    [(30, 5, 1), (1000, 64, 4), (77, 13, 3)],
    [(7, 3, 1), (9, 300, 2)],
]


# tests/test_kernels.py's shapes, then the dense path's skinny ones
CONTRACT_SHAPES = [(8, 8, 8), (64, 64, 64), (100, 70, 130), (256, 128, 200), (1, 300, 5),
                   (192, 100_000, 8), (1_200_000, 16, 1), (60, 512, 1)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ (run these tests on the card)")
    return torch.device("cuda")


def _inputs(n, g, v, seed, device):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, g, n).astype(np.int32)
    vals = rng.integers(-20, 21, (n, v)).astype(np.float32)
    vals[rng.random(n) < 0.3] = 0.0  # identity-heavy rows, as σ and row padding make them
    return torch.as_tensor(codes, device=device), torch.as_tensor(vals, device=device)


def _as_op_input(vals, op):
    if op == "sum":
        return vals
    return vals.masked_fill(vals == 0, float("inf") if op == "min" else float("-inf"))


@pytest.mark.parametrize("n,g,v", SHAPES)
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_cuda_aggregate_matches_plain_version(cuda, n, g, v, op):
    c, x = _inputs(n, g, v, n + g, cuda)
    x = _as_op_input(x, op)
    before = ops.LAUNCHES["segment_aggregate"]
    got = ops.aggregate_op(c, x, g, op)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["segment_aggregate"] == before + 1
    assert torch.equal(got, segment_aggregate_ref(c, x, g, op))


def test_cuda_aggregate_gamma_sums_within_tolerance(cuda):
    rng = np.random.default_rng(7)
    c = torch.as_tensor(rng.integers(0, 12, 1 << 20).astype(np.int32), device=cuda)
    x = torch.as_tensor(rng.gamma(2.0, 5000.0, (1 << 20, 3)).astype(np.float32), device=cuda)
    got = ops.aggregate_op(c, x, 12, "sum")
    torch.testing.assert_close(got, segment_aggregate_ref(c, x, 12, "sum"), rtol=1e-5, atol=0)


@pytest.mark.parametrize("specs", LEVEL_SPECS, ids=lambda s: f"{len(s)}msg")
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_cuda_level_aggregate_matches_plain_version(cuda, specs, op):
    items = []
    for i, (n, g, v) in enumerate(specs):
        c, x = _inputs(n, g, v, i, cuda)
        items.append((c, _as_op_input(x, op), g))
    before = ops.LAUNCHES["level_segment_aggregate"]
    got = ops.level_aggregate(items, op=op)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["level_segment_aggregate"] == before + 1
    for (c, x, g), o in zip(items, got):
        assert torch.equal(o, segment_aggregate_ref(c, x, g, op))


def test_cuda_level_kernel_skips_pad_rows_and_fills_empty_segments(cuda):
    codes = torch.tensor([0, -1, 2, -1, 0], dtype=torch.int32, device=cuda)
    vals = torch.tensor([[1.0], [100.0], [3.0], [-100.0], [2.0]], device=cuda)
    for op, want in (("sum", [3.0, 0.0, 3.0, 0.0]), ("min", [1.0, np.inf, 3.0, np.inf]),
                     ("max", [2.0, -np.inf, 3.0, -np.inf])):
        got = ops.level_segment_aggregate(codes, vals, 4, op)[:, 0].tolist()
        assert got == want


def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    codes = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        ops.aggregate_op(codes, torch.zeros(8, 2, dtype=torch.float64, device=cuda), 3)
    with pytest.raises(ValueError):
        ops.aggregate_op(codes, torch.zeros(2, 8, device=cuda).t(), 3)
    with pytest.raises(ValueError):
        ops.aggregate_op(codes, torch.zeros(8, 2), 3)


def test_cuda_quickstart_matches_cpu_and_launches_both_kernels(cuda):
    cat = schema.salesforce(n_opp=20_000, n_user=500, n_camp=100, n_acc=200)
    runs = {}
    for dev in ("cpu", "cuda"):
        ops.reset_launches()
        t = Treant(cat, ring=sr.SUM, device=dev)
        total = Query.make(cat, ring="sum", measure=("Opp", "amount"))
        pie = total.with_group_by("camp_type")
        cal = [t.register_dashboard("total", total), t.register_dashboard("pie", pie)]
        q1 = pie.with_predicate(mask_in(cat.domains()["role_name"], [1], attr="role_name"))
        res = [t.interact("anna", "pie", q1)]
        t.think_time("anna", "pie")
        res.append(t.interact("anna", "pie", q1.add_group_by("title")))
        qm = Query.make(cat, ring="tropical_max", measure=("Opp", "amount"), group_by=("stage",))
        f, st = t.engine_for("tropical_max").execute(qm)
        runs[dev] = (cal, res, (f, st), dict(ops.LAUNCHES))
    (ccal, cres, cmax, claunch), (gcal, gres, gmax, glaunch) = runs["cpu"], runs["cuda"]
    assert claunch == {"segment_aggregate": 0, "level_segment_aggregate": 0}
    assert glaunch["segment_aggregate"] > 0 and glaunch["level_segment_aggregate"] > 0
    for a, b in zip(ccal, gcal):
        assert (a.messages_computed, a.messages_reused, a.calibration_dispatches) == (
            b.messages_computed, b.messages_reused, b.calibration_dispatches)
    for a, b in zip(cres, gres):
        assert (a.stats.messages_computed, a.stats.messages_reused) == (
            b.stats.messages_computed, b.stats.messages_reused)
        torch.testing.assert_close(b.factor.field.cpu(), a.factor.field, rtol=1e-5, atol=0)
    assert torch.equal(gmax[0].field.cpu(), cmax[0].field)


def _contract_inputs(g, b, a, seed, device, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    m = torch.as_tensor(rng.integers(-20, 21, (g, b)).astype(np.float32), device=device)
    r = torch.as_tensor(rng.integers(-20, 21, (b, a)).astype(np.float32), device=device)
    return m.to(dtype), r.to(dtype)


@pytest.mark.parametrize("g,b,a", CONTRACT_SHAPES)
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "mask"])
def test_cuda_semiring_contract_integer_data_is_exact(cuda, g, b, a, masked):
    m, r = _contract_inputs(g, b, a, g + b, cuda)
    mask = (torch.rand(b, device=cuda) > 0.4).float() if masked else None
    before = sc_ops.LAUNCHES["semiring_contract"]
    got = sc_ops.contract_op(m, r, mask)
    torch.cuda.synchronize()
    assert sc_ops.LAUNCHES["semiring_contract"] == before + 1
    assert torch.equal(got, semiring_contract_ref(m, r, mask))


@pytest.mark.parametrize("g,b,a", CONTRACT_SHAPES[:5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_cuda_semiring_contract_uniform_data(cuda, g, b, a, dtype):
    gen = torch.Generator(device=cuda).manual_seed(g * 1000 + b)
    m = torch.rand((g, b), generator=gen, device=cuda).to(dtype)
    r = torch.rand((b, a), generator=gen, device=cuda).to(dtype)
    got = sc_ops.contract_op(m, r)
    torch.testing.assert_close(got, semiring_contract_ref(m, r), rtol=5e-3, atol=1e-3)


@pytest.mark.parametrize("g,b,a", CONTRACT_SHAPES)
@pytest.mark.parametrize("is_min", [True, False], ids=["min", "max"])
def test_cuda_tropical_contract_is_exact(cuda, g, b, a, is_min):
    m, r = _contract_inputs(g, b, a, g + a, cuda)
    ident = float("inf") if is_min else float("-inf")
    m[torch.rand(m.shape, device=cuda) < 0.3] = ident  # absent tuples
    before = tc_ops.LAUNCHES["tropical_contract"]
    got = tc_ops.contract_op(m, r, is_min=is_min)
    torch.cuda.synchronize()
    assert tc_ops.LAUNCHES["tropical_contract"] == before + 1
    assert not torch.isnan(got).any()
    assert torch.equal(got, tropical_contract_ref(m, r, is_min))


def test_cuda_dense_quickstart_matches_cpu_and_launches_the_contract_kernels(cuda):
    cat = schema.salesforce(n_opp=20_000, n_user=500, n_camp=100, n_acc=200)
    runs = {}
    for dev in ("cpu", "cuda"):
        sc_ops.reset_launches()
        tc_ops.reset_launches()
        t = Treant(cat, ring=sr.SUM, device=dev, dense_rows_threshold=500)
        pie = Query.make(cat, ring="sum", measure=("Opp", "amount"), group_by=("camp_type",))
        cal = t.register_dashboard("pie", pie)
        q1 = pie.with_predicate(mask_in(cat.domains()["role_name"], [1], attr="role_name"))
        res = t.interact("anna", "pie", q1.add_group_by("title"))
        qm = Query.make(cat, ring="tropical_max", measure=("Opp", "amount"), group_by=("stage",))
        f, _ = t.engine_for("tropical_max").execute(qm)
        runs[dev] = (cal, res, f, sc_ops.LAUNCHES["semiring_contract"],
                     tc_ops.LAUNCHES["tropical_contract"])
    (ccal, cres, cf, csc, ctc), (gcal, gres, gf, gsc, gtc) = runs["cpu"], runs["cuda"]
    assert (csc, ctc) == (0, 0) and gsc > 0 and gtc > 0
    assert (ccal.messages_computed, ccal.calibration_dispatches) == (
        gcal.messages_computed, gcal.calibration_dispatches)
    torch.testing.assert_close(gres.factor.field.cpu(), cres.factor.field, rtol=1e-5, atol=0)
    assert torch.equal(gf.field.cpu(), cf.field)


def test_cuda_dense_int64_count_matches_cpu(cuda):
    """int64 COUNT contracts dense bags by elimination: CUDA has no int64
    matrix product for einsum to call."""
    cat = schema.salesforce(n_opp=5_000, n_user=100, n_camp=40, n_acc=60)
    q = Query.make(cat, ring="count_i64", group_by=("camp_type",))
    outs = [Treant(cat, ring=sr.get("count_i64"), device=dev, dense_rows_threshold=100)
            .engine.execute(q)[0].field.cpu() for dev in ("cpu", "cuda")]
    assert outs[0].dtype == torch.int64 and torch.equal(outs[0], outs[1])


def test_cuda_contract_wrappers_reject_what_the_kernels_do_not_take(cuda):
    m = torch.zeros(4, 3, device=cuda)
    with pytest.raises(TypeError):
        sc_ops.contract_op(m, torch.zeros(3, 2, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):  # neither axis of r is unit-stride
        sc_ops.contract_op(m, torch.zeros(3, 4, device=cuda)[:, ::2])
    with pytest.raises(ValueError):
        tc_ops.contract_op(torch.zeros(8, 6, device=cuda)[::2, ::2], torch.zeros(3, 2, device=cuda))
    with pytest.raises(ValueError):
        tc_ops.contract_op(m, torch.zeros(4, 2, device=cuda))
    with pytest.raises(TypeError):
        tc_ops.contract_op(m.half(), torch.zeros(3, 2, device=cuda).half())


# the regimes of csrc/contract.cuh at the dense path's record shapes and at
# their edges: tall (B ≤ 64, A ≤ 32), wide (G·A ≤ 1024), tiled (the rest)
REGIME_SHAPES = [
    ((100_000, 16, 1), "tall"), ((100_000, 16, 8), "tall"), ((1, 16, 8), "tall"),
    ((1000, 1, 3), "tall"), ((513, 64, 32), "tall"), ((77, 63, 5), "tall"),
    ((16, 100_000, 8), "wide"), ((16, 100_000, 1), "wide"), ((1, 50_000, 8), "wide"),
    ((60, 512, 1), "wide"), ((32, 10_000, 32), "wide"), ((1024, 3000, 1), "wide"),
    ((1, 65, 1), "wide"), ((33, 4001, 31), "wide"), ((7, 100_003, 3), "wide"),
    ((100, 70, 130), "tiled"), ((192, 100_000, 8), "tiled"), ((1025, 70, 1), "tiled"),
]


def _layouts(m, r):
    """The operands as they lie, and as transposed views of (B, G) and
    (A, B) tensors: the same values, the other unit-stride axis."""
    yield "as_is", m, r
    yield "transposed", m.t().contiguous().t(), r.t().contiguous().t()


@pytest.mark.parametrize("shape,regime", REGIME_SHAPES, ids=[str(s) for s, _ in REGIME_SHAPES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16], ids=["f32", "f16"])
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "mask"])
def test_cuda_semiring_contract_regimes_are_exact(cuda, shape, regime, dtype, masked):
    g, b, a = shape
    m, r = _contract_inputs(g, b, a, g + 7 * a, cuda, dtype)
    mask = (torch.rand(b, device=cuda) > 0.4).float() if masked else None
    want = semiring_contract_ref(m, r, mask)
    for label, mm, rr in _layouts(m, r):
        assert launch.contract_args(mm, rr, (dtype,)).regime == regime
        got = sc_ops.contract_op(mm, rr, mask)
        torch.cuda.synchronize()
        assert torch.equal(got, want), label


@pytest.mark.parametrize("shape,regime", REGIME_SHAPES, ids=[str(s) for s, _ in REGIME_SHAPES])
@pytest.mark.parametrize("is_min", [True, False], ids=["min", "max"])
def test_cuda_tropical_contract_regimes_are_exact(cuda, shape, regime, is_min):
    g, b, a = shape
    m, r = _contract_inputs(g, b, a, g + 5 * a, cuda)
    ident = float("inf") if is_min else float("-inf")
    m[torch.rand(m.shape, device=cuda) < 0.3] = ident  # absent tuples
    m[0] = ident                                          # a row with no tuple at all
    want = tropical_contract_ref(m, r, is_min)
    for label, mm, rr in _layouts(m, r):
        got = tc_ops.contract_op(mm, rr, is_min=is_min)
        torch.cuda.synchronize()
        assert not torch.isnan(got).any(), label
        assert (got[0] == ident).all(), label
        assert torch.equal(got, want), label


def test_cuda_contract_reads_sliced_views_in_place(cuda):
    """Views whose rows start off 16-byte alignment take the scalar loads."""
    m, r = _contract_inputs(40, 20_003, 9, 3, cuda)
    mm, rr = m[1:, 1:], r[1:, 1:]
    assert not mm.is_contiguous() and not rr.is_contiguous()
    assert torch.equal(sc_ops.contract_op(mm, rr), semiring_contract_ref(mm, rr))
    assert torch.equal(tc_ops.contract_op(mm, rr), tropical_contract_ref(mm, rr))
    mt = m.t().contiguous().t()[:, 2:]
    assert torch.equal(sc_ops.contract_op(mt, r[2:]), semiring_contract_ref(mt, r[2:]))


@pytest.mark.parametrize("shape", [(16, 100_000, 8), (192, 100_000, 8), (100_000, 16, 8)],
                         ids=["wide", "tiled", "tall"])
def test_cuda_semiring_contract_is_deterministic(cuda, shape):
    """Gamma-valued float32 data: split partials merge in block order, so
    two calls give the same bits."""
    g, b, a = shape
    torch.manual_seed(g + b)
    gamma = torch.distributions.Gamma(torch.tensor(2.0, device=cuda),
                                      torch.tensor(1 / 5000.0, device=cuda))
    m, r = gamma.sample((g, b)), gamma.sample((b, a)) / 1e4
    first, second = sc_ops.contract_op(m, r), sc_ops.contract_op(m, r)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    torch.testing.assert_close(first, semiring_contract_ref(m, r), rtol=1e-5, atol=0)


@pytest.mark.parametrize("shape", [(16, 100_000, 8), (192, 100_000, 8)], ids=["wide", "tiled"])
@pytest.mark.parametrize("kernel", ["semiring", "tropical"])
def test_cuda_split_contract_on_two_streams_at_once_is_exact(cuda, shape, kernel):
    """Split launches on two streams overlap; each stream has its own
    workspace and tickets, so neither merges the other's partials."""
    g, b, a = shape
    run, plain = ((sc_ops.contract_op, semiring_contract_ref) if kernel == "semiring" else
                  (tc_ops.contract_op, tropical_contract_ref))
    streams = torch.cuda.Stream(), torch.cuda.Stream()
    pairs = [_contract_inputs(g, b, a, seed, cuda) for seed in (1, 2)]
    assert launch.contract_args(*pairs[0], (torch.float32,)).ws > 0
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(8):
        for st, pair, got in zip(streams, pairs, outs):
            with torch.cuda.stream(st):
                got.append(run(*pair))
    torch.cuda.synchronize()
    for pair, got in zip(pairs, outs):
        want = plain(*pair)
        assert all(torch.equal(x, want) for x in got)


# ---------------------------------------------------------------------------
# live dashboards: batched fan-out, a flush tick, a dense-bag update
# ---------------------------------------------------------------------------

def _live_spec():
    from repro_torch.core import DashboardSpec, VizSpec

    amount = ("Opp", "amount")
    return DashboardSpec(vizzes=tuple(
        VizSpec(f"by_{g}", measure=amount, ring="sum", group_by=(g,))
        for g in ("stage", "state", "camp_type", "title")
    ) + (VizSpec("max_by_stage", measure=amount, ring="tropical_max", group_by=("stage",)),))


def _small_salesforce():
    return schema.salesforce(n_opp=20_000, n_user=500, n_camp=100, n_acc=200)


def test_cuda_batched_fanout_matches_cpu_one_level_launch_per_group(cuda):
    from repro_torch.core import SetFilter

    runs = {}
    for dev in ("cpu", "cuda"):
        t = Treant(_small_salesforce(), ring=sr.SUM, device=dev)
        sess = t.open_session(_live_spec(), name="s")
        ops.reset_launches()
        before = t.engine.plans.stats.batched_execs
        res = sess.apply(SetFilter("state", values=(0, 1, 2, 3, 4), source="by_state"))
        runs[dev] = (res, ops.LAUNCHES["level_segment_aggregate"],
                     t.engine.plans.stats.batched_execs - before)
    (cres, _, cgroups), (gres, glaunches, ggroups) = runs["cpu"], runs["cuda"]
    assert ggroups == cgroups >= 1
    assert glaunches == ggroups
    assert gres.affected == cres.affected
    for viz in gres.affected:
        g, c = gres.results[viz], cres.results[viz]
        assert (g.stats.messages_computed, g.stats.batch_width) == (
            c.stats.messages_computed, c.stats.batch_width)
        torch.testing.assert_close(g.factor.field.cpu(), c.factor.field, rtol=1e-5, atol=0)


def test_cuda_segment_launches_link_to_kernels_launch_spans(cuda):
    """Under a CUDA profiler, every kernel 1-2 launch (made through
    ``ctypes``) links by correlation id to the ``kernels.launch`` span open
    on the host when it was launched, and the spans add no device-side
    annotation to the trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import trace
    from repro_torch.core import Drill, SetFilter

    cat = _small_salesforce()
    events = (SetFilter("state", values=(0, 1, 2, 3, 4), source="by_state"),
              Drill("by_stage", "title"))
    # a first run loads every kernel the second launches (the profiler links
    # a kernel's first launch to CUDA's lazy loading of its function)
    for _ in range(2):
        sess = Treant(cat, ring=sr.SUM, device=cuda).open_session(_live_spec(), name="s")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for ev in events:
                sess.apply(ev)
            torch.cuda.synchronize()
    trace.take()
    kineto = prof.profiler.kineto_results.events()
    host = {e.correlation_id(): e for e in kineto
            if e.device_type() == DeviceType.CPU and not e.name().startswith("cu")}
    device = [e for e in kineto if e.device_type() == DeviceType.CUDA]
    segment = [e for e in device if "segment_aggregate" in e.name()]
    assert segment
    linked = [host.get(e.linked_correlation_id()) for e in segment]
    assert [h.name() if h is not None else None for h in linked] == ["kernels.launch"] * len(
        segment)
    program = ("session.", "cjt.", "plans.", "kernels.")
    assert not [e.name() for e in device if e.name().startswith(program)]


def test_cuda_flush_tick_matches_cpu(cuda):
    runs = {}
    for dev in ("cpu", "cuda"):
        cat = _small_salesforce()
        t = Treant(cat, ring=sr.SUM, device=dev, compaction_threshold=0.0)
        sess = t.open_session(_live_spec(), name="s")
        rng = np.random.default_rng(5)
        buf = t.stream("Opp")
        opp = cat.get("Opp")
        for _ in range(4):
            buf.append({a: rng.integers(0, opp.domains[a], 500) for a in opp.attrs},
                       measures={"amount": rng.gamma(2.0, 5000.0, 500).astype(np.float32)})
        mask = np.zeros(opp.num_rows + buf.pending_appends, bool)
        mask[rng.choice(opp.num_rows, 20, replace=False)] = True
        buf.delete(mask)
        ops.reset_launches()
        res = t.flush()
        launches = ops.LAUNCHES["segment_aggregate"]
        reads = {v: sess.read(v) for v in sess.vizzes}
        runs[dev] = (res, launches, reads, t.catalog.watermark)
    (cres, _, creads, cwm), (gres, glaunches, greads, gwm) = runs["cpu"], runs["cuda"]
    assert glaunches > 0 and gwm == cwm
    assert [(u.queries_maintained, u.queries_fallback) for u in gres.updates] == [
        (u.queries_maintained, u.queries_fallback) for u in cres.updates]
    for viz, g in greads.items():
        c = creads[viz]
        assert g.stats.messages_computed == c.stats.messages_computed == 0
        if viz == "max_by_stage":
            assert torch.equal(g.factor.field.cpu(), c.factor.field)
        else:
            torch.testing.assert_close(g.factor.field.cpu(), c.factor.field, rtol=1e-5, atol=0)


def test_cuda_dense_role_update_launches_semiring_contract_and_matches_cpu(cuda):
    runs = {}
    for dev in ("cpu", "cuda"):
        cat = _small_salesforce()
        t = Treant(cat, ring=sr.SUM, device=dev, dense_rows_threshold=1_000)
        sess = t.open_session(_live_spec(), name="s")
        role = cat.get("Role")
        rng = np.random.default_rng(3)
        new_rel, delta = role.append_rows(
            {a: rng.integers(0, role.domains[a], 4) for a in role.attrs})
        sc_ops.reset_launches()
        res = t.update(new_rel, delta)
        launches = sc_ops.LAUNCHES["semiring_contract"]
        runs[dev] = (res, launches, {v: sess.read(v) for v in sess.vizzes})
    (cres, clx, creads), (gres, glx, greads) = runs["cpu"], runs["cuda"]
    assert clx == 0 and glx > 0
    assert gres.queries_fallback == cres.queries_fallback == 0
    for viz, g in greads.items():
        c = creads[viz]
        assert g.stats.messages_computed == c.stats.messages_computed
        if viz == "max_by_stage":
            assert torch.equal(g.factor.field.cpu(), c.factor.field)
        else:
            torch.testing.assert_close(g.factor.field.cpu(), c.factor.field, rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# think-time bin cubes and the serving tier
# ---------------------------------------------------------------------------

def _flight_spec():
    from repro_torch.core import DashboardSpec, VizSpec

    return DashboardSpec(vizzes=tuple(
        VizSpec(f"by_{g}", measure=None, ring="sum", group_by=(g,))
        for g in ("airport_state", "month", "carrier_group", "dow")
    ) + (VizSpec("state_by_size", measure=None, ring="sum",
                 group_by=("airport_state", "airport_size")),))


@pytest.mark.parametrize("ring", ["sum", "tropical_max", "moments"])
def test_cuda_cube_slices_match_cpu(cuda, ring):
    """A γ∪{dim} bin cube built on the card and sliced under several σ masks
    (range, IN-list, none) equals the same cube and slices on the CPU
    (integer COUNT-valued cells: exact; MOMENTS rtol 1e-5)."""
    from repro_torch.core import plans

    masks = [np.arange(12) >= 3, np.isin(np.arange(12), [0, 5, 11])]
    out = {}
    for dev in ("cpu", "cuda"):
        cat = schema.flight(n_flights=20_000)
        t = Treant(cat, ring=sr.get(ring), device=dev)
        measure = None if ring == "sum" else ("Flights", "dep_delay")
        q = Query.make(cat, ring=ring, measure=measure,
                       group_by=("airport_state", "month"))
        cube = t.engine_for(q.ring_name, q.measure).execute(q)[0]
        out[dev] = plans.slice_bin_cubes(
            [(cube, "month", masks, ("airport_state",)),
             (cube, "month", masks[1:], ("airport_state",)),
             (cube, "month", [], ("airport_state",))])
    for g, c in zip(out["cuda"], out["cpu"]):
        assert g.attrs == c.attrs
        for gl, cl in zip(sr.leaves(g.field), sr.leaves(c.field)):
            if ring == "tropical_max":
                assert torch.equal(gl.cpu(), cl)
            else:
                torch.testing.assert_close(gl.cpu(), cl, rtol=1e-5, atol=0)


def test_cuda_four_session_storm_matches_cpu(cuda):
    """Four served sessions drag a brush on the card, with a predictive
    think-time policy between rounds: every read equals the same storm on
    the CPU bit for bit (COUNT-valued sums), with equal serving counters,
    and the segment kernels launched."""
    from repro_torch.core import PredictiveThinkTime, SetFilter
    from repro_torch.serve import TreantServer

    runs = {}
    for dev in ("cpu", "cuda"):
        cat = schema.flight(n_flights=20_000)
        t = Treant(cat, ring=sr.SUM, device=dev)
        server = TreantServer(t, policy=PredictiveThinkTime(prefetch_k=2))
        handles = [server.open_session(_flight_spec(), name=f"s{i}") for i in range(4)]
        ops.reset_launches()
        for rnd in range(3):
            for step in range(3):
                for i, h in enumerate(handles):
                    lo = (5 * i + 7 * rnd + step) % 48
                    h.submit(SetFilter("airport_state", lo=lo, hi=lo + 2 + rnd,
                                       source="by_airport_state"))
            while server.queue_depth:
                server.step()
            server.idle()
        launches = dict(ops.LAUNCHES)
        reads = {(h.id, v): h.read(v).factor.field.cpu() for h in handles for v in h.session.vizzes}
        st = server.stats()
        runs[dev] = (reads, {k: st[k] for k in ("events_processed", "coalesced_events",
                                                "cross_session_batch_width", "dedup_hits",
                                                "pool_cube_hits", "shared_prefetch_hits")},
                     launches)
    (creads, cst, _), (greads, gst, glaunches) = runs["cpu"], runs["cuda"]
    assert gst == cst and gst["cross_session_batch_width"] > 1
    assert glaunches["segment_aggregate"] > 0 and glaunches["level_segment_aggregate"] > 0
    for key, g in greads.items():
        assert torch.equal(g, creads[key]), key


def test_cuda_split_level_launch_matches_one_launch_and_cpu(cuda, monkeypatch):
    """A level launch split over several launches (padded operands past
    ``plans.ROWWISE_MAX_ELEMS``) gives, on the card, the same messages bit
    for bit as one launch and as the CPU.  MOMENTS members keep their slabs,
    so the lowered cut splits them; the SUM ring's members are fused (a
    recipe, no slab) and hold nothing until the launch, so it splits none
    of them.  The delays are small integers, so every sum is exact in
    float32 whatever its order and row blocks."""
    from repro_torch.core import plans

    base = schema.flight(n_flights=20_000)
    fl = base.get("Flights")
    delay = np.minimum(np.rint(fl.measures["dep_delay"] / 4.0), 15.0).astype(np.float32)
    rels = [dataclasses.replace(fl, measures={"dep_delay": delay}) if name == "Flights"
            else base.get(name) for name in base.names()]

    def run(dev, ring, measure):
        cat = Catalog(rels)
        t = Treant(cat, ring=getattr(sr, ring.upper()), device=dev, use_plans=True)
        q = Query.make(cat, ring=ring, measure=measure,
                       group_by=("airport_state", "month", "carrier_group"))
        eng = t.engine_for(q.ring_name, q.measure)
        ops.reset_launches()
        eng.calibrate(q)
        out = [sr.leaves(eng.execute(q.with_group_by(*g))[0].field)
               for g in (("airport_state", "month", "carrier_group"), ("dow",),
                         ("airport_size", "delay_bucket"))]
        return [x.cpu() for leaves in out for x in leaves], ops.LAUNCHES[
            "level_segment_aggregate"], sum(ops.FUSED_MEMBERS.values())

    rings = (("sum", None), ("moments", ("Flights", "dep_delay")))
    runs = {}
    for ring, measure in rings:
        runs[ring, "one"] = run("cuda", ring, measure)
        runs[ring, "cpu"] = run("cpu", ring, measure)
    monkeypatch.setattr(plans, "ROWWISE_MAX_ELEMS", 1 << 16)
    for ring, measure in rings:
        runs[ring, "split"] = run("cuda", ring, measure)
    for ring, _ in rings:
        (one, one_launches, fused), (split, split_launches, _), (cpu, _, _) = (
            runs[ring, k] for k in ("one", "split", "cpu"))
        if ring == "sum":
            assert split_launches == one_launches > 0 and fused > 0
        else:
            assert split_launches > one_launches > 0 and fused == 0
        for a, b, c in zip(one, split, cpu):
            assert torch.equal(a, b) and torch.equal(b, c), ring


# float32 sum of n terms in any order: within λ·√n·u of the exact sum
# (u = 2^-24, λ = 4; chip_smoke.py's audit tolerance, floor 1e-5)
def _sum_rtol(n: int) -> float:
    return max(1e-5, 4.0 * n ** 0.5 * 2.0 ** -24)


@pytest.mark.parametrize("kernel", ["segment_aggregate", "level_segment_aggregate"])
def test_cuda_float_segment_sums_repeat(cuda, kernel):
    """A float SUM at a contended shape (2^23 gamma-valued rows into 30
    segments) and at a segment-major one (2^22 rows into 50,000 segments)
    gives the same bits over 5 launches, on a second stream and in a CUDA
    graph replay, and stays within the float32 sum bound of the float64
    plain version."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    for n, g in ((1 << 23, 30), (1 << 22, 50_000)):
        codes = torch.randint(0, g, (n,), device=cuda, dtype=torch.int32, generator=gen)
        vals = torch.empty((n, 1), device=cuda).exponential_(generator=gen).mul_(100.0)

        def run():
            if kernel == "segment_aggregate":
                return ops.aggregate_op(codes, vals, g, "sum")
            return ops.level_aggregate([(codes, vals, g)], op="sum")[0]

        before = ops.LAUNCHES[kernel]
        outs = [run() for _ in range(5)]
        torch.cuda.synchronize()
        assert ops.LAUNCHES[kernel] == before + 5
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            outs.append(run())  # warms the side stream's scratch before the capture
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side):
                captured = run()
        graph.replay()
        torch.cuda.synchronize()
        outs.append(captured)
        for out in outs[1:]:
            assert torch.equal(out, outs[0]), f"{kernel} N={n} G={g}: a repeat differs"
        want = segment_aggregate_ref(codes, vals, g, "sum")
        rows = torch.bincount(codes.long(), minlength=g).max().item()
        torch.testing.assert_close(outs[0], want, rtol=_sum_rtol(rows), atol=0)


def _gamma_message(n, g, v, seed, device, skew=False):
    gen = torch.Generator(device=device).manual_seed(seed)
    codes = torch.randint(0, g, (n,), device=device, dtype=torch.int32, generator=gen)
    if skew:  # half the rows in segment 0: it is cut into many pieces
        codes[torch.rand(n, device=device, generator=gen) < 0.5] = 0
    vals = torch.distributions.Gamma(torch.tensor(2.0, device=device),
                                     torch.tensor(1 / 5000.0, device=device)).sample((n, v))
    return codes, vals, g


# one message per regime of launch.segment_geometry (thread, thread with
# column tiles, warp with one and with several columns, sort, sort with
# split segments and with wide rows), with gamma-valued values
MEMBER_SPECS = [(30_000, 6, 1), (20_000, 20, 300), (40_000, 300, 2), (20_000, 100, 14),
                (60_000, 5_000, 1), (50_000, 3_000, 3, True), (200_000, 400, 72, True)]


def test_cuda_segment_sums_do_not_depend_on_the_launch(cuda):
    """The contract of csrc/segment_aggregate.cuh at small size: each
    message's float sums have the same bits through ``aggregate_op``, alone
    through ``level_aggregate``, as any member of a mixed level launch, in
    a launch split into two (as a level plan past ``ROWWISE_MAX_ELEMS``
    splits it) and past ``SEG_MAX_MEMBERS`` members (two launches); and are
    within the float32 sum bound of the plain version."""
    msgs = [_gamma_message(n, g, v, i, cuda, *skew)
            for i, (n, g, v, *skew) in enumerate(MEMBER_SPECS)]
    regimes = {launch.segment_geometry(c.shape[0], g, x.shape[1]).name for c, x, g in msgs}
    assert regimes == {"thread", "warp", "sort"}
    alone = [ops.aggregate_op(c, x, g, "sum") for c, x, g in msgs]
    lone_level = [ops.level_aggregate([m], op="sum")[0] for m in msgs]
    mixed = ops.level_aggregate(msgs, op="sum")
    reversed_ = ops.level_aggregate(msgs[::-1], op="sum")[::-1]
    split = ops.level_aggregate(msgs[:2], op="sum") + ops.level_aggregate(msgs[2:], op="sum")
    before = ops.LAUNCHES["level_segment_aggregate"]
    many = ops.level_aggregate(msgs * 9, op="sum")
    assert ops.LAUNCHES["level_segment_aggregate"] == before + 2
    torch.cuda.synchronize()
    for j, (c, x, g) in enumerate(msgs):
        for other in (lone_level[j], mixed[j], reversed_[j], split[j],
                      *many[j::len(msgs)]):
            assert torch.equal(other, alone[j]), f"message {j} {MEMBER_SPECS[j]}"
        rows = torch.bincount(c.long(), minlength=g).max().item()
        torch.testing.assert_close(alone[j], segment_aggregate_ref(c, x, g, "sum"),
                                   rtol=_sum_rtol(rows), atol=0)


# sort-regime messages: one value column, three (split segments), wide rows
# (several 128-column blocks), 100,000 segments, and -1 pad codes
ORDER_SPECS = [(60_000, 5_000, 1, False), (50_000, 3_000, 3, True), (200_000, 400, 72, True),
               (1 << 20, 100_000, 1, False), (1 << 20, 50_000, 8, True)]


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_cuda_code_ordered_values_give_the_gathered_bits(cuda, op):
    """A sort-regime message whose values arrive in code order (row i is
    row perm[i], perm its row order) has the bits of the same message read
    through the order: alone, through ``level_aggregate``, and as members
    of a level launch with thread- and warp-regime messages, on gamma data
    (sum) and with ±inf where min/max find nothing."""
    msgs = []
    for i, (n, g, v, skew) in enumerate(ORDER_SPECS):
        c, x, g = _gamma_message(n, g, v, 40 + i, cuda, skew)
        c[::97] = -1                                   # pad rows match nothing
        msgs.append((c, _as_op_input(x.masked_fill(x < 1000.0, 0.0), op), g))
    others = [_gamma_message(n, g, v, 60 + i, cuda)
              for i, (n, g, v) in enumerate([(30_000, 6, 1), (40_000, 300, 2)])]
    others = [(c, _as_op_input(x, op), g) for c, x, g in others]
    want = [ops.aggregate_op(c, x, g, op) for c, x, g in msgs]
    ordered = []
    for c, x, g in msgs:
        order = ops.code_order(c, g, x.shape[1])
        assert order is not None, "not the sort regime"
        ordered.append((c, x.index_select(0, order.perm), g, True))
    alone = [ops.aggregate_op(c, x, g, op, ordered=True) for c, x, g, _ in ordered]
    level = ops.level_aggregate(ordered, op=op)
    mixed = ops.level_aggregate(others + ordered[::-1], op=op)[len(others):][::-1]
    torch.cuda.synchronize()
    for j, w in enumerate(want):
        for got in (alone[j], level[j], mixed[j]):
            assert torch.equal(got, w), f"{ORDER_SPECS[j]} {op}: code order gives other bits"
    for (c, x, g), w in zip(msgs, want):
        if op != "sum":
            assert torch.equal(w, segment_aggregate_ref(c, x, g, op))


# warp-regime messages: G just past the thread regime, two columns, the
# widest copy of one column, 14 columns of 100 segments
WARP_SPECS = [(1 << 20, 97, 1), (1 << 20, 300, 2), (1 << 20, 1_000, 1), (1 << 20, 1_472, 1),
              (1 << 20, 100, 14)]


@pytest.mark.parametrize("n,g,v", WARP_SPECS)
def test_cuda_warp_regime_is_exact_and_repeats(cuda, n, g, v):
    """The warp regime (lane masks per code, rounds by rank) equals the
    plain version exactly on integer data, for sum, min and max, through
    both wrappers; on gamma data its sums repeat bit for bit over launches,
    a second stream and a graph replay, within the float32 sum bound."""
    assert launch.segment_geometry(n, g, v).name == "warp"
    c, x = _inputs(n, g, v, n + g, cuda)
    for op in ("sum", "min", "max"):
        y = _as_op_input(x, op)
        want = segment_aggregate_ref(c, y, g, op)
        assert torch.equal(ops.aggregate_op(c, y, g, op), want)
        assert torch.equal(ops.level_aggregate([(c, y, g)], op=op)[0], want)
    c, x, g = _gamma_message(n, g, v, 3, cuda)
    outs = [ops.aggregate_op(c, x, g, "sum") for _ in range(3)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        outs.append(ops.aggregate_op(c, x, g, "sum"))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            captured = ops.aggregate_op(c, x, g, "sum")
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    for out in outs[1:] + [captured]:
        assert torch.equal(out, outs[0])
    rows = torch.bincount(c.long(), minlength=g).max().item()
    torch.testing.assert_close(outs[0], segment_aggregate_ref(c, x, g, "sum"),
                               rtol=_sum_rtol(rows), atol=0)


def test_cuda_warm_interaction_builds_no_order_and_reads_code_order(cuda):
    """On the card the first calibration builds its sort-regime messages'
    row orders and code-ordered copies and launches them in code order; the
    same interaction again on the warm Treant builds neither; a second fresh
    Treant over the same catalog builds no order and copies only its own
    lift (the gather indices' and σ codes' copies live with the catalog's
    codes), and the answers of the two Treants are the same bits."""
    cat = schema.salesforce(n_opp=50_000, n_user=2_000, n_camp=100, n_acc=200)
    answers, built = [], []
    for _ in range(2):
        before = dict(ops.ORDER_BUILDS)
        t = Treant(cat, ring=sr.SUM, device="cuda")
        q = Query.make(cat, ring="sum", measure=("Opp", "amount")).with_group_by("user_id")
        ops.reset_launches()
        t.register_dashboard("by_user", q)
        first = t.interact("anna", "by_user", q.with_group_by("camp_type"))
        assert ops.MEMBERS["sort_ordered"] > 0
        warm = dict(ops.ORDER_BUILDS)
        again = t.interact("anna", "by_user", q.with_group_by("camp_type"))
        torch.cuda.synchronize()
        assert ops.ORDER_BUILDS == warm
        assert torch.equal(first.factor.field, again.factor.field)
        answers.append(first.factor.field.cpu())
        built.append({k: ops.ORDER_BUILDS[k] - before[k] for k in before})
    assert torch.equal(answers[0], answers[1])
    assert built[0]["orders"] > 0 and built[0]["copies"] > 0
    assert built[1]["orders"] == 0 and 0 < built[1]["copies"] <= built[0]["copies"]


def test_cuda_covariance_fits_repeat_through_the_segment_kernels(cuda):
    """Fig 18's regression on the card: the covariance ring's segment ⊕
    launches the segment kernels, and two fresh fits give the same element
    and weights bit for bit."""
    from repro_torch.core import FactorizedLinearRegression, FeatureSpec

    cat = schema.favorita(n_sales=20_000, n_stores=12, n_items=300, n_dates=40)
    fits = []
    for _ in range(2):
        ops.reset_launches()
        model = FactorizedLinearRegression(
            cat, [FeatureSpec("Sales", "unit_sales"), FeatureSpec("Items", "item_weight")],
            FeatureSpec("Trans", "transactions"), device="cuda")
        res = model.fit()
        assert ops.LAUNCHES["segment_aggregate"] + ops.LAUNCHES["level_segment_aggregate"] > 0
        el = [leaf.cpu() for leaf in model.engine.execute(model._base_query())[0].field]
        fits.append((el, res.weights))
    (e0, w0), (e1, w1) = fits
    assert all(torch.equal(a, b) for a, b in zip(e0, e1))
    assert np.array_equal(np.asarray(w0), np.asarray(w1))


def test_cuda_covariance_fit_and_augmentation_match_cpu(cuda):
    """Factorized regression on ``cuda`` against the port on the CPU (the
    covariance ring's segment ⊕ goes through the segment kernels on the card
    and ``index_add_`` on the CPU): the base element and
    R², an augmentation's R² and every message count.  The weights are not
    compared: the intercept and the one-hot blocks are collinear, so the
    ridge alone pins them, and float sums in another order move them."""
    from repro_torch.core import FactorizedLinearRegression, FeatureSpec

    fits = {}
    for dev in ("cuda", "cpu"):
        cat = schema.favorita(n_sales=8_000, n_stores=12, n_items=30, n_dates=20)
        model = FactorizedLinearRegression(
            cat, [FeatureSpec("Sales", "unit_sales"),
                  FeatureSpec("Stores", "store_type", categorical=True),
                  FeatureSpec("Items", "perishable", categorical=True)],
            FeatureSpec("Trans", "transactions"), device=dev)
        base = model.fit()
        el = [leaf.cpu() for leaf in model.engine.execute(model._base_query())[0].field]
        model.calibrate()
        aug = schema.favorita_augmentations(cat, n_per_key=1)
        res = [model.fit_augmented(a) for a in aug]
        fits[dev] = (base, el, res)
    (gb, gel, gres), (cb, cel, cres) = fits["cuda"], fits["cpu"]
    for g, c in zip(gel, cel):
        torch.testing.assert_close(g, c, rtol=_sum_rtol(8_000), atol=1e-3)
    assert abs(gb.r2 - cb.r2) < 1e-5
    for g, c in zip(gres, cres):
        assert (g.stats.messages_computed, g.stats.messages_reused) == (
            c.stats.messages_computed, c.stats.messages_reused)
        assert g.stats.messages_computed <= 1 and abs(g.r2 - c.r2) < 1e-5


def test_cuda_cube_matches_cpu(cuda):
    """A COUNT cube (h = 2, pivot k = 1) on ``cuda``: the CPU's cuboids bit
    for bit (integer counts), equal message counts and store bytes, and the
    segment kernels launched."""
    from repro_torch.core import CJTEngine, build_cube, jt_from_catalog

    cat = schema.flight(n_flights=10_000)
    reps = {}
    ops.reset_launches()
    for dev in ("cuda", "cpu"):
        eng = CJTEngine(jt_from_catalog(cat), cat, sr.COUNT, device=dev)
        reps[dev] = build_cube(eng, Query.make(cat, ring="count"),
                               ("carrier_group", "month", "dow"), h=2, pivot_k=1)
    assert ops.LAUNCHES["segment_aggregate"] > 0 and ops.LAUNCHES["level_segment_aggregate"] > 0
    g, c = reps["cuda"], reps["cpu"]
    assert (g.messages_computed, g.store_bytes) == (c.messages_computed, c.store_bytes)
    for combo, f in c.cuboids.items():
        assert torch.equal(g.cuboids[combo].field.cpu(), f.field)


@pytest.mark.parametrize("measure", ["integer", "gamma"])
def test_cuda_sharded_level_plan_matches_unsharded(cuda, measure):
    """Calibration on a 4-shard virtual ``cuda`` mesh at 2^23 fact rows: every
    level plan runs one ``level_segment_aggregate`` launch per shard, then
    ⊕-folds.  On integer data (0/1 amounts: every sum stays below 2^24, so
    float32 is exact in any order) the answer equals a float64 numpy sum and
    every message is bit-equal to the unsharded engine's; on gamma data both
    answers stay within max(1e-5, 4·√n·2^-24) of the float64 sum, n the rows
    of the fact's largest segment."""
    from repro_torch.core import CJTEngine, MessageStore, jt_from_catalog
    from repro_torch.core import distributed as dist
    from repro_torch.relational.relation import catalog_from_arrays

    n = 1 << 23
    rng = np.random.default_rng(17)
    doms = {"a": 50, "b": 40, "c": 30}
    fact = {x: rng.integers(0, doms[x], n).astype(np.int32) for x in ("a", "b")}
    m = (rng.random(n) < 1 / 16 if measure == "integer" else rng.gamma(2.0, 50.0, n))
    m = m.astype(np.float32)
    dim = {x: rng.integers(0, doms[x], 4_000).astype(np.int32) for x in ("b", "c")}
    arrays = [dict(name="F", attrs=("a", "b"), codes=fact, domains=doms, measures={"m": m}),
              dict(name="S", attrs=("b", "c"), codes=dim, domains=doms, measures={})]
    runs = {}
    for k in (1, 4):
        cat = catalog_from_arrays(arrays)
        mesh = dist.ShardMesh.virtual(k, "cuda") if k > 1 else None
        eng = CJTEngine(jt_from_catalog(cat), cat, sr.SUM, store=MessageStore(), mesh=mesh,
                        device="cuda")
        q = Query.make(cat, ring="sum", measure=("F", "m"), group_by=("c",))
        ops.reset_launches()
        eng.calibrate(q, batch=True)
        torch.cuda.synchronize()
        launches = ops.LAUNCHES["level_segment_aggregate"]
        placement = eng.place_predicates(q)
        msgs = {e: eng.message(q, *e, placement).field.cpu() for e in eng.jt.directed_edges()}
        runs[k] = (launches, eng.execute(q)[0].field.cpu(), msgs, eng.plans.stats)
    (l1, a1, m1, s1), (l4, a4, m4, s4) = runs[1], runs[4]
    assert s1.shard_execs == 0 and s4.shard_execs >= s4.fused_level_launches > 0
    assert s4.fused_level_launches == s1.fused_level_launches and l4 == 4 * l1 > 0
    assert s4.shard_imbalance == pytest.approx(dist.shard_imbalance(4_000, 4_096, 4))  # S
    pairs = np.zeros((doms["b"], doms["c"]))
    np.add.at(pairs, (dim["b"], dim["c"]), 1.0)
    want = torch.from_numpy(np.bincount(fact["b"], m.astype(np.float64), doms["b"]) @ pairs)
    if measure == "integer":
        assert float(want.max()) < 2 ** 24
        assert torch.equal(a1.double(), want) and torch.equal(a4, a1)
        for e, f in m1.items():
            assert torch.equal(f, m4[e]), e
        return
    rtol = _sum_rtol(int(np.bincount(fact["b"]).max()))
    for got in (a1, a4):
        torch.testing.assert_close(got.double(), want, rtol=rtol, atol=0)


LM_TOL = dict(rtol=5e-4, atol=5e-4)


@pytest.fixture
def no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cuda_lm_smoke_config_matches_cpu(cuda, no_tf32, arch):
    """Prefill logits and every cache entry, then four greedy decode steps
    (the CPU's tokens fed to both), on the card against the CPU."""
    cfg = smoke_config(get_config(arch))
    tree = random_tree(cfg, 1)
    b, s, gen = 2, 20, 4
    batch = make_batch(cfg, b, s, seed=2)
    runs = {}
    for dev in ("cpu", cuda):
        params = convert.params_from_reference(cfg, tree, dev)
        prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
        logits, caches = prefill(params, batch)
        runs[str(dev)] = [(logits, {k: v.clone() for k, v in caches.items()})]
        caches = pad_caches(caches, s + gen)
        for i in range(gen):
            tok = runs["cpu"][i][0].argmax(-1)[:, None].to(torch.int32).numpy()
            db = {"embeds": np.zeros((b, 1, cfg.d_model), np.float32)} \
                if cfg.input_mode == "embeddings" else {"tokens": tok}
            logits, caches = decode(params, db, caches, s + i)
            runs[str(dev)].append((logits, None))
    cpu, card = runs["cpu"], runs[str(cuda)]
    for name, ref in cpu[0][1].items():
        torch.testing.assert_close(card[0][1][name].cpu(), ref, **LM_TOL, msg=name)
    for i, ((lc, _), (lg, _)) in enumerate(zip(cpu, card)):
        torch.testing.assert_close(lg.cpu(), lc, **LM_TOL, msg=f"step {i}")
        assert torch.equal(lg.argmax(-1).cpu(), lc.argmax(-1)), f"greedy token, step {i}"


# (b, sq, sk, h, kh, dh, causal, chunk, q_off, k_off, mode)
FLASH_CASES = [(2, 256, 256, 8, 2, 32, True, 64, 0, 0, "full_masked"),
               (1, 128, 256, 4, 4, 16, True, 32, 128, 0, "full_masked"),
               (2, 96, 160, 4, 2, 16, False, 32, 0, 0, "full_masked"),
               (1, 256, 256, 4, 2, 16, True, 32, 0, 0, "divide")]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_cuda_flash_backward_matches_cpu(cuda, no_tf32, case):
    """``flash_attention``'s gradients (through o and lse) on the card
    against the CPU; ``divide`` reaches lse through ``_merge_attn``."""
    b, sq, sk, h, kh, dh, causal, c, q_off, k_off, mode = case
    rng = np.random.default_rng(sq + sk)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((b, sq, h, dh), (b, sk, kh, dh), (b, sk, kh, dh), (b, sq, h))]
    grads = {}
    for dev in ("cpu", cuda):
        q, k, v, w = (torch.tensor(a, device=dev, requires_grad=i < 3) for i, a in enumerate(arrays))
        if mode == "divide":
            o = lm_layers.causal_attention(q, k, v, mode="divide", q_chunk=c, kv_chunk=c,
                                           min_block=2 * c)
            loss = o.sin().sum()
        else:
            o, lse = lm_layers.flash_attention(q, k, v, causal, c, c, q_off, k_off)
            loss = o.sin().sum() + (lse * w * 0.1).cos().sum()
        grads[str(dev)] = torch.autograd.grad(loss, (q, k, v))
    for name, gc, gg in zip("qkv", grads["cpu"], grads[str(cuda)]):
        torch.testing.assert_close(gg.cpu(), gc, **LM_TOL, msg=f"d{name}")


# float32 leaves; the step exactly; the bfloat16 first moment to one bf16 ulp
# (2^-7 of the value at most): float32 values one ulp apart can round to
# either bf16 neighbour
ADAMW_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-7),
             torch.bfloat16: dict(rtol=2.0 ** -7, atol=0.0), torch.int32: dict(rtol=0, atol=0)}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cuda_lm_smoke_train_step_matches_cpu(cuda, no_tf32, arch):
    """One smoke train step: the loss and every gradient leaf on the card
    against the CPU, then AdamW on the CPU's gradients on both devices."""
    cfg = smoke_config(get_config(arch))
    tree = random_tree(cfg, 1)
    batch = make_batch(cfg, 2, 32, seed=2, labels=True)
    runs = {}
    for dev in ("cpu", cuda):
        runs[str(dev)] = lm_step.loss_and_grads(cfg, convert.params_from_reference(cfg, tree, dev),
                                                batch)
    (lc, _, paths, gcpu), (lg, _, _, ggpu) = runs["cpu"], runs[str(cuda)]
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-5, atol=0)
    for path, a, b in zip(paths, gcpu, ggpu):
        scale = float(a.abs().max())
        torch.testing.assert_close(b.cpu(), a, rtol=1e-3, atol=5e-4 * scale, msg=str(path))
    opt_cfg = adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=1)
    out = {}
    for dev in ("cpu", cuda):
        params = convert.params_from_reference(cfg, tree, dev)
        grads = lm_tree.from_paths(paths, [g.to(dev) for g in gcpu])
        out[str(dev)] = adamw.apply_updates(params, grads, adamw.init_opt_state(params, opt_cfg),
                                            opt_cfg)
    for part in (0, 1):
        flat_c = dict(lm_tree.paths(out["cpu"][part]))
        for path, t in lm_tree.paths(out[str(cuda)][part]):
            torch.testing.assert_close(t.cpu(), flat_c[path], **ADAMW_TOL[t.dtype], msg=str(path))


@pytest.fixture
def deterministic():
    old = torch.are_deterministic_algorithms_enabled(), \
        torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.use_deterministic_algorithms(old[0], warn_only=old[1])


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "zamba2-1.2b"])
def test_cuda_steps_with_sharding_rules_are_bit_equal(cuda, no_tf32, deterministic, arch):
    """``with_sharding`` is the identity on the card: the loss and gradients,
    a prefill and a decode step under the multi-pod rules equal those without
    rules, bit for bit (deterministic algorithms, so the embedding's
    backward adds in one order)."""
    cfg = smoke_config(get_config(arch))
    tree = random_tree(cfg, 1)
    batch = make_batch(cfg, 2, 32, seed=2, labels=True)
    prompt = {k: v for k, v in batch.items() if k != "labels"}
    rules = lm_sharding.make_rules(make_production_mesh(multi_pod=True))
    runs = []
    for r in (None, rules):
        params = convert.params_from_reference(cfg, tree, cuda)
        acts = lm_step.acts_for(cfg, r, layer_params=True)
        loss, _, _, grads = lm_step.loss_and_grads(cfg, params, batch, acts)
        logits, caches = lm_step.make_prefill_step(cfg, r)(params, prompt)
        caches = pad_caches(caches, 33)
        tok = {"tokens": logits.argmax(-1)[:, None].to(torch.int32)}
        step_logits, caches = lm_step.make_decode_step(cfg, r)(params, tok, caches, 32)
        runs.append([loss, *grads, logits, step_logits, *caches.values()])
    for i, (a, b) in enumerate(zip(*runs)):
        assert torch.equal(a, b), i


def test_cuda_checkpoint_restores_onto_the_card(cuda, tmp_path):
    tree = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4).to(cuda),
            "m": torch.linspace(-2, 2, 7).bfloat16().to(cuda)}
    save_pytree(tree, tmp_path, 1)
    got, step = restore_pytree(tmp_path, template=tree, device={"w": cuda, "m": "cpu"})
    assert step == 1 and got["w"].device.type == cuda.type and got["m"].device.type == "cpu"
    assert torch.equal(got["w"], tree["w"]) and torch.equal(got["m"], tree["m"].cpu())


# ---------------------------------------------------------------------------
# fused members: the kernels compute each value from a recipe (lift, gathered
# messages, σ) with the bits of the slab that the rowwise stage writes
# ---------------------------------------------------------------------------

# (N, G, lanes of each message; a message of lanes 0 is a broadcast of 3
# columns' first), regime: the thread grid (one column, several, tiles of
# 256), warp, sort (W = 1 and W = 4) and the brush shape (G = 17, 52 × 12)
FUSED_SHAPES = [
    ((1 << 16, 17, ()), "thread"),
    ((1 << 16, 17, (4, 3)), "thread"),
    ((1 << 20, 17, (52, 12)), "thread"),
    ((1 << 15, 300, (2, 2)), "warp"),
    ((1 << 15, 5_000, (3,)), "sort"),
    ((1 << 15, 5_000, (2, 2, 0)), "sort"),
]


def _recipe(n, lane_dims, n_preds, seed, device, op, broadcast=False):
    """A fused member's recipe of ``n`` rows: a gamma lift, a message per
    entry of ``lane_dims`` (rows of 50 to 400, gamma values, index in
    range; 0 lanes: a broadcast message read at its first column; with
    ``broadcast`` the last message is a broadcast one), lanes row-major over
    the messages, and ``n_preds`` σ predicates keeping about 70 % of rows."""
    rng = np.random.default_rng(seed)
    dims = [d or 1 for d in lane_dims]
    lanes = int(np.prod(dims)) if dims else 1
    coords = np.indices(dims).reshape(len(dims), lanes) if dims else np.zeros((0, 1), np.int64)
    f32 = lambda a: torch.as_tensor(a.astype(np.float32), device=device)  # noqa: E731
    i32 = lambda a: torch.as_tensor(a.astype(np.int32), device=device)  # noqa: E731
    messages = []
    for k, d in enumerate(lane_dims):
        bcast = d == 0 or (broadcast and k == len(lane_dims) - 1)
        rows = 1 if bcast else int(rng.integers(50, 400))
        table = f32(rng.gamma(2.0, 2.0, (rows, max(d, 3))))
        messages.append((None if bcast else i32(rng.integers(0, rows, n)), table,
                         i32(coords[k] if d else np.zeros(lanes))))
    preds = [(i32(rng.integers(0, 11, n)), torch.as_tensor(rng.random(11) < 0.85, device=device))
             for _ in range(n_preds)]
    return ops.Recipe(f32(rng.gamma(2.0, 5.0, n)), tuple(messages), tuple(preds),
                      add=op != "sum", lanes=lanes)


def _in_code_order(codes, recipe, g):
    """``recipe`` with its row columns in the row order of ``codes``."""
    perm = ops.code_order(codes, g, recipe.lanes).perm.long()
    return ops.Recipe(recipe.lift[perm], tuple((None if i is None else i[perm], t, l)
                                               for i, t, l in recipe.messages),
                      tuple((c[perm], m) for c, m in recipe.preds), recipe.add, recipe.lanes)


@pytest.mark.parametrize("shape,regime", FUSED_SHAPES, ids=[str(s) for s, _ in FUSED_SHAPES])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_cuda_fused_member_gives_the_slab_bits(cuda, shape, regime, op):
    """A fused member through kernel 1 and as a member of a kernel-2 launch
    beside slab members gives the bits of the same member reduced from the
    slab its recipe materializes (``recipe_values``, as the rowwise stage
    writes it), for 0, 1 and 2 σ predicates and a broadcast message, in
    row order and (sort) in code order; two runs repeat bit for bit."""
    n, g, lane_dims = shape
    codes = torch.as_tensor(np.random.default_rng(g).integers(0, g, n).astype(np.int32),
                            device=cuda)
    for n_preds in (0, 1, 2):
        rc = _recipe(n, lane_dims, n_preds, n + g + n_preds, cuda, op,
                     broadcast=n_preds == 1)
        assert launch.segment_geometry(n, g, rc.lanes).name == regime
        slab = recipe_values(rc, IDENTITY[op])
        want = ops.aggregate_op(codes, slab, g, op)
        before = dict(ops.FUSED_MEMBERS)
        got = ops.aggregate_op(codes, rc, g, op)
        assert torch.equal(got, want)
        assert torch.equal(ops.aggregate_op(codes, rc, g, op), got)
        assert sum(ops.FUSED_MEMBERS.values()) == sum(before.values()) + 2
        other_c, other_x = _inputs(4096, 300, 2, n_preds, cuda)
        level = ops.level_aggregate([(other_c, _as_op_input(other_x, op), 300), (codes, rc, g),
                                     (codes, slab, g)], op=op)
        assert torch.equal(level[1], want) and torch.equal(level[2], want)
        if regime == "sort":
            rc_o = _in_code_order(codes, rc, g)
            assert torch.equal(ops.aggregate_op(codes, rc_o, g, op, ordered=True), want)
            assert torch.equal(ops.level_aggregate([(codes, rc_o, g, True), (codes, slab, g)],
                                                   op=op)[0], want)
        del slab
    if op == "sum" and n >= 1 << 20:
        torch.testing.assert_close(got, segment_aggregate_ref(codes, recipe_values(
            rc, 0.0), g, op), rtol=1e-4, atol=0)


def test_cuda_wrapper_rejects_a_malformed_recipe(cuda):
    codes = torch.zeros(8, dtype=torch.int32, device=cuda)
    rc = _recipe(8, (3,), 1, 0, cuda, "sum")
    (idx, table, lanes), = rc.messages
    with pytest.raises(TypeError):
        ops.aggregate_op(codes, ops.Recipe(rc.lift.double(), rc.messages, rc.preds,
                                           lanes=3), 2)
    with pytest.raises(ValueError):
        ops.aggregate_op(codes, ops.Recipe(rc.lift.cpu(), rc.messages, rc.preds, lanes=3), 2)
    with pytest.raises(ValueError):
        ops.aggregate_op(codes, ops.Recipe(rc.lift, ((idx, table.t(), lanes),), rc.preds,
                                           lanes=3), 2)
    with pytest.raises(ValueError):
        ops.level_aggregate([(codes, ops.Recipe(rc.lift, rc.messages * 4, lanes=3), 2)])


def test_cuda_brush_session_fuses_every_sum_flights_contraction(cuda):
    """A brush-like session over flights (a viz by state × month, 52 × 12
    lanes carried into Flights from two dimension bags, σ on two of
    Flights' attributes) hands the kernels a recipe for every SUM
    contraction over Flights on the card (``fused_execs`` equals the
    kernel-route executions over Flights, and every segment launch over
    Flights' rows is a fused member) and answers as the CPU does.  The
    other kernel-route executions are the dimension tables' bare lifts (no
    message, no σ), whose slab is the lift itself."""
    from repro_torch import trace

    cat = schema.flight(n_flights=300_000)
    base = Query.make(cat, ring="sum", measure=("Flights", "dep_delay"))
    grid = base.with_group_by("airport_state", "month")
    brushes = [grid.with_predicate(mask_range(10, 2, 6, attr="delay_bucket")),
               grid.with_predicate(mask_range(10, 0, 4, attr="delay_bucket"))
               .with_predicate(mask_in(8, [1, 3], attr="distance_bucket")),
               base.with_group_by("carrier_id").with_predicate(
                   mask_in(8, [2], attr="distance_bucket"))]
    runs = {}
    for dev in ("cpu", "cuda"):
        t = Treant(cat, ring=sr.SUM, device=dev)
        trace.take()
        trace.enable()
        try:
            t.register_dashboard("state_month", grid)
            t.register_dashboard("carrier", base.with_group_by("carrier_id"))
            answers = [t.interact("anna", "state_month", q).factor.field.cpu() for q in brushes]
        finally:
            trace.disable()
        runs[dev] = answers, t.cache_stats()["plans"], trace.take()
    (cpu, cpu_stats, _), (gpu, stats, records) = runs["cpu"], runs["cuda"]
    assert cpu_stats["fused_execs"] == 0
    members = [r for r in records if r.get("kind") == "plans.member"]
    assert len(members) == stats["kernel_execs"]
    assert stats["fused_execs"] == sum(r["rel"] == "Flights" for r in members) > 0
    assert all(not r["in_elems"] and not r["sigma_cols"] for r in members
               if r["rel"] != "Flights")
    bucket = cat.get("Flights").row_bucket
    flights = [r for r in records if r.get("kind") == "kernels.segment" and r["n"] == bucket]
    assert flights and all(r["fused"] for r in flights)
    assert max(r["v"] for r in flights) == 52 * 12
    for a, b in zip(cpu, gpu):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=0)
