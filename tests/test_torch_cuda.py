"""The port on a CUDA card: the hand-written kernels (segment-aggregate,
semiring_contract, tropical_contract) held against their plain PyTorch
versions on the same card, and the quickstart slice — sparse, and with every
dimension table dense — on ``cuda`` held against the same slice on the CPU.

Every test here is marked ``gpu`` and skips without a card (decided inside
the ``cuda`` fixture).  The file imports neither JAX nor the JAX package, so
it runs on a machine with a card and no JAX:
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py``.

Tolerances: min/max and sums of integer-valued floats must match exactly;
the segment kernels' gamma-valued sums agree to rtol 1e-5 (they add in
float32 with atomics, in an order that changes from run to run); float16
and uniform float32 contractions to the reference file's rtol 5e-3 /
atol 1e-3.  The contract kernels sum in a fixed order (split partials merge
in block order), so two calls on the same inputs give the same bits.

The LM stack's smoke configs run on the card in float32 with TF32 off and
are held against the port on the CPU, every parameter leaf random: logits
and caches to rtol / atol 5e-4 (summation order only), greedy tokens
exactly."""

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
from repro_torch.kernels.segment_aggregate.ref import segment_aggregate_ref
from repro_torch.kernels.semiring_contract import ops as sc_ops
from repro_torch.kernels.semiring_contract.ref import semiring_contract_ref
from repro_torch.kernels.tropical_contract import ops as tc_ops
from repro_torch.kernels.tropical_contract.ref import tropical_contract_ref
from repro_torch.launch.serve import pad_caches
from repro_torch.models import convert
from repro_torch.runtime.step import make_decode_step, make_prefill_step
from repro_torch.relational import schema
from repro_torch.relational.relation import mask_in

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
    """A fused level launch split over several launches (padded operands
    past ``plans.ROWWISE_MAX_ELEMS``) gives, on the card, the same messages
    bit for bit as one launch and as the CPU (COUNT-valued sums)."""
    from repro_torch.core import plans

    def run(dev):
        cat = schema.flight(n_flights=20_000)
        t = Treant(cat, ring=sr.SUM, device=dev, use_plans=True)
        q = Query.make(cat, ring="sum", group_by=("airport_state", "month", "carrier_group"))
        eng = t.engine_for(q.ring_name, q.measure)
        ops.reset_launches()
        eng.calibrate(q)
        out = [eng.execute(q.with_group_by(*g))[0].field.cpu()
               for g in (("airport_state", "month", "carrier_group"), ("dow",),
                         ("airport_size", "delay_bucket"))]
        return out, ops.LAUNCHES["level_segment_aggregate"]

    one, one_launches = run("cuda")
    cpu, _ = run("cpu")
    monkeypatch.setattr(plans, "ROWWISE_MAX_ELEMS", 1 << 16)
    split, split_launches = run("cuda")
    assert split_launches > one_launches > 0
    for a, b, c in zip(one, split, cpu):
        assert torch.equal(a, b) and torch.equal(b, c)


# float32 sum of n terms in any order: within λ·√n·u of the exact sum
# (u = 2^-24, λ = 4; chip_smoke.py's audit tolerance, floor 1e-5)
def _sum_rtol(n: int) -> float:
    return max(1e-5, 4.0 * n ** 0.5 * 2.0 ** -24)


@pytest.mark.parametrize("kernel", ["segment_aggregate", "level_segment_aggregate"])
def test_cuda_float_segment_sums_repeat(cuda, kernel):
    """One float SUM launch at a contended shape (2^23 gamma-valued rows into
    30 segments), run twice on the same inputs: prints whether the two
    outputs are bit-equal and their largest relative difference, and holds
    both to the float64 plain version within the float32 sum bound (the
    kernels add with atomics, so the order of a sum may change)."""
    n, g = 1 << 23, 30
    gen = torch.Generator(device=cuda).manual_seed(7)
    codes = torch.randint(0, g, (n,), device=cuda, dtype=torch.int32, generator=gen)
    vals = torch.empty((n, 1), device=cuda).exponential_(generator=gen).mul_(100.0)

    def run():
        if kernel == "segment_aggregate":
            return ops.aggregate_op(codes, vals, g, "sum")
        return ops.level_aggregate([(codes, vals, g)], op="sum")[0]

    before = ops.LAUNCHES[kernel]
    a, b = run(), run()
    torch.cuda.synchronize()
    assert ops.LAUNCHES[kernel] == before + 2
    want = segment_aggregate_ref(codes, vals, g, "sum")
    rows = torch.bincount(codes.long(), minlength=g).max().item()
    spread = ((a - b).abs() / want.abs()).max().item()
    print(f"\nDETERMINISM {kernel}: n={n} G={g} bit-equal={torch.equal(a, b)} "
          f"max relative difference of the repeats {spread:.3g} (bound {_sum_rtol(rows):.3g} "
          f"for a segment of {rows} rows)")
    for out in (a, b):
        torch.testing.assert_close(out, want, rtol=_sum_rtol(rows), atol=0)


def test_cuda_covariance_fit_and_augmentation_match_cpu(cuda):
    """Factorized regression on ``cuda`` against the port on the CPU (the
    covariance ring reduces in plain torch on both): the base element and
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
