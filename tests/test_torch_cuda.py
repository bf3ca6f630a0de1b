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
in block order), so two calls on the same inputs give the same bits."""

import numpy as np
import pytest
import torch

from repro_torch.core import Query, Treant
from repro_torch.core import semiring as sr
from repro_torch.kernels import launch
from repro_torch.kernels.segment_aggregate import ops
from repro_torch.kernels.segment_aggregate.ref import segment_aggregate_ref
from repro_torch.kernels.semiring_contract import ops as sc_ops
from repro_torch.kernels.semiring_contract.ref import semiring_contract_ref
from repro_torch.kernels.tropical_contract import ops as tc_ops
from repro_torch.kernels.tropical_contract.ref import tropical_contract_ref
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
