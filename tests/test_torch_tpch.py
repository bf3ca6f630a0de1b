"""The port on a tiny TPC-H snowflake (Lineitem → Orders → Customer →
CNation, Lineitem → Supplier → SNation, Lineitem → Part), on the CPU.

A session's answers against a plain group-by over the join and against
the JAX package's session over the same catalog, bit for bit (integer
revenues: every float32 sum is exact), for a viz whose group-by spans both
branches (Q7's supplier nation × customer nation) and for one three levels
below the fact (the customer's region);
and the port's fixes for the deployment at full size, each at a size that
reaches it: union-carry calibration passes bounded by their widest
message's elements, one stable sort per codes tensor shared by every piece,
several attributes' codes combined on the device, the root kept so that
the wider γ does not cross the orders separator, and a bounded message
store that still answers right.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import assert_factors_match, jax_catalog_from_port
import repro.core as jcore
from repro_torch import trace
from repro_torch.core import (ClearFilter, DashboardSpec, Drill, Query, SetFilter, Treant,
                              VizSpec)
from repro_torch.core import calibration
from repro_torch.kernels.segment_aggregate import ops
from repro_torch.relational.relation import catalog_from_arrays

NATION_REGION = (0, 1, 1, 1, 4, 0, 3, 3, 2, 2, 4, 4, 2, 4, 0, 0, 0, 1, 2, 3, 4, 2, 3, 3, 1)
WIDTHS = {"l_shipmode": 7, "l_returnflag": 3, "o_ordermonth": 80, "o_orderpriority": 5,
          "c_mktsegment": 5, "c_nationkey": 25, "s_nationkey": 25, "c_regionkey": 5,
          "s_regionkey": 5, "p_brand": 25}
MEASURE = ("Lineitem", "revenue")


def snowflake(seed=0, orders=400, lines=1600, customers=120, parts=150, suppliers=40):
    """Tables (name → codes) and the catalog of a tiny TPC-H snowflake, its
    keys dense and every foreign key found."""
    rng = np.random.default_rng(seed)
    doms = dict(WIDTHS, orderkey=orders, custkey=customers, partkey=parts, suppkey=suppliers)

    def draw(n, *attrs):
        return {a: rng.integers(0, doms[a], n) for a in attrs}

    nations = np.arange(25)
    t = {
        "Lineitem": dict(orderkey=np.sort(rng.integers(0, orders, lines)),
                         **draw(lines, "partkey", "suppkey", "l_shipmode", "l_returnflag")),
        "Orders": dict(orderkey=np.arange(orders),
                       **draw(orders, "custkey", "o_ordermonth", "o_orderpriority")),
        "Customer": dict(custkey=np.arange(customers),
                         **draw(customers, "c_nationkey", "c_mktsegment")),
        "CNation": dict(c_nationkey=nations, c_regionkey=np.asarray(NATION_REGION)),
        "Supplier": dict(suppkey=np.arange(suppliers), **draw(suppliers, "s_nationkey")),
        "SNation": dict(s_nationkey=nations, s_regionkey=np.asarray(NATION_REGION)),
        "Part": dict(partkey=np.arange(parts), **draw(parts, "p_brand")),
    }
    revenue = rng.integers(1, 1000, lines).astype(np.float32)   # exact float32 sums
    cat = catalog_from_arrays([
        dict(name=name, attrs=tuple(codes), codes=codes, domains=doms,
             measures={"revenue": revenue} if name == "Lineitem" else {})
        for name, codes in t.items()])
    return t, revenue, doms, cat


def joined(t):
    """Every attribute gathered to Lineitem's rows."""
    li = dict(t["Lineitem"])
    o, c, s = t["Orders"], t["Customer"], t["Supplier"]
    for a in ("custkey", "o_ordermonth", "o_orderpriority"):
        li[a] = o[a][li["orderkey"]]
    for a in ("c_nationkey", "c_mktsegment"):
        li[a] = c[a][li["custkey"]]
    li["c_regionkey"] = t["CNation"]["c_regionkey"][li["c_nationkey"]]
    li["s_nationkey"] = s["s_nationkey"][li["suppkey"]]
    li["s_regionkey"] = t["SNation"]["s_regionkey"][li["s_nationkey"]]
    li["p_brand"] = t["Part"]["p_brand"][li["partkey"]]
    return li


def plain(cols, revenue, doms, group_by, filters):
    """SUM(revenue) over the join, grouped and filtered ({attr: mask})."""
    keep = np.ones(revenue.shape[0], bool)
    for a, mask in filters.items():
        keep &= mask[cols[a]]
    idx = np.zeros(revenue.shape[0], np.int64)
    for a in group_by:
        idx = idx * doms[a] + cols[a]
    out = np.zeros(int(np.prod([doms[a] for a in group_by])), np.float64)
    np.add.at(out, idx[keep], revenue[keep].astype(np.float64))
    return out.reshape([doms[a] for a in group_by])


VIZZES = (("by_ordermonth", ("o_ordermonth",)), ("by_cust_nation", ("c_nationkey",)),
          ("by_supp_nation", ("s_nationkey",)), ("by_region", ("c_regionkey",)),
          ("supp_by_cust_nation", ("s_nationkey", "c_nationkey")))


def spec(core=None):
    """The dashboard, in the port's classes or in those of ``core``."""
    ds, vs = (DashboardSpec, VizSpec) if core is None else (core.DashboardSpec, core.VizSpec)
    return ds(vizzes=tuple(vs(name, measure=MEASURE, ring="sum", group_by=gb)
                           for name, gb in VIZZES))


def reference(cat, **kw):
    """The JAX package's Treant over the port catalog's arrays."""
    return jcore.Treant(jax_catalog_from_port(cat), **kw)


def mask(doms, attr, values=(), lo=None, hi=None):
    m = np.zeros(doms[attr], bool)
    if values:
        m[list(values)] = True
    else:
        m[lo:hi] = True
    return m


EVENTS = [
    SetFilter("c_mktsegment", values=(1,)),
    SetFilter("o_orderpriority", values=(0, 1)),
    SetFilter("c_nationkey", lo=3, hi=11, source="by_cust_nation"),
    SetFilter("o_ordermonth", lo=10, hi=40, source="by_ordermonth"),
    Drill("supp_by_cust_nation", "s_regionkey"),
    SetFilter("s_nationkey", values=(2, 7, 19), source="by_supp_nation"),
    Drill("by_region", "o_orderpriority"),
    ClearFilter("c_nationkey"),
]


def replay(treant, t, revenue, doms, ref):
    """Apply EVENTS to a session of ``treant`` and of ``ref`` (the JAX
    package's Treant over the same catalog), checking every rendered viz
    against the plain join and against the reference's, bit for bit."""
    cols = joined(t)
    sess = treant.open_session(spec(), name="a")
    ref_sess = ref.open_session(spec(jcore), name="a")
    group_by = dict(VIZZES)
    filters: dict = {}
    for ev in EVENTS:
        res = sess.apply(ev)
        ref_res = ref_sess.apply(getattr(jcore, type(ev).__name__)(**dataclasses.asdict(ev)))
        assert sorted(res.results) == sorted(ref_res.results)
        if isinstance(ev, SetFilter):
            filters[ev.attr] = (mask(doms, ev.attr, ev.values, ev.lo, ev.hi), ev.source)
        elif isinstance(ev, ClearFilter):
            filters.pop(ev.attr)
        else:
            group_by[ev.viz] = group_by[ev.viz] + (ev.attr,)
        assert res.results
        for viz, r in res.results.items():
            want = plain(cols, revenue, doms, group_by[viz],
                         {a: m for a, (m, src) in filters.items() if src != viz})
            got = r.factor.project_to(group_by[viz]).field
            np.testing.assert_array_equal(got.numpy().astype(np.float64), want, err_msg=viz)
            assert_factors_match(ref_res.results[viz].factor, r.factor, exact=True)
        yield sess


def test_two_branch_and_depth_three_vizzes_match_the_plain_join():
    t, revenue, doms, cat = snowflake()
    treant = Treant(cat, device="cpu")
    # the customer's nation is three levels below the fact
    assert treant.jt.height("bag:Lineitem", "bag:Part") == 3
    assert len(treant.jt.calibration_levels("bag:Lineitem")) == 6
    for _ in replay(treant, t, revenue, doms, reference(cat)):
        pass


def test_message_spans_carry_their_calibration_level():
    t, revenue, doms, cat = snowflake(seed=1)
    treant = Treant(cat, device="cpu")
    trace.enable()
    try:
        for _ in replay(treant, t, revenue, doms, reference(cat)):
            pass
    finally:
        trace.disable()
    msgs = [r for r in trace.take() if r.get("name") == "cjt.message"]
    assert msgs
    for r in msgs:
        u, v = r["attrs"]["edge"].split("->")
        assert r["attrs"]["level"] == treant.jt.height(u, v)
        assert r["attrs"]["rows"] == cat.get(u.split(":")[1]).num_rows
        assert r["attrs"]["from_measure"] == (u == "bag:Lineitem")
    assert {r["attrs"]["level"] for r in msgs} >= {0, 1}


def test_union_calibration_passes_stop_at_their_widest_messages_elements(monkeypatch):
    """Vizzes grouped by order month and order priority share a union pass
    of 400 lanes unless the pass's widest message, Orders → Lineitem over
    every orderkey, passes UNION_MAX_ELEMS; the answers are the same."""
    t, revenue, doms, cat = snowflake(seed=2)
    eng = Treant(cat, device="cpu").engine
    qs = [Query.make(cat, ring="sum", measure=MEASURE, group_by=(a,))
          for a in ("o_ordermonth", "o_orderpriority")]
    both = qs[0].with_group_by("o_ordermonth", "o_orderpriority")
    assert eng.widest_message(both) == doms["orderkey"] * 80 * 5
    assert [q.group_by for q in eng._union_carry(qs)] == [("o_ordermonth", "o_orderpriority")]
    monkeypatch.setattr(calibration, "UNION_MAX_ELEMS", doms["orderkey"] * 400 - 1)
    assert [q.group_by for q in eng._union_carry(qs)] == [("o_ordermonth",),
                                                         ("o_orderpriority",)]
    # a pass that is too wide alone still calibrates
    assert [q.group_by for q in eng._union_carry(qs[:1])] == [("o_ordermonth",)]
    for _ in replay(Treant(cat, device="cpu"), t, revenue, doms, reference(cat)):
        pass


def test_wide_gamma_stays_off_the_orders_separator():
    """Drilled to the supplier's region, Q7's matrix carries 125 supplier
    lanes and 25 customer lanes: the root is chosen so that the message over
    the orderkey separator carries the 25."""
    _, _, doms, cat = snowflake(seed=3, orders=2000, lines=8000)
    eng = Treant(cat, device="cpu").engine
    for drill, narrow in (("s_regionkey", ("c_nationkey",)), ("c_regionkey", ("s_nationkey",))):
        q = Query.make(cat, ring="sum", measure=MEASURE,
                       group_by=("s_nationkey", "c_nationkey", drill))
        root = eng.choose_root(q)
        side = "bag:Lineitem" if eng.jt.path(root, "bag:Orders")[-2:] == \
            ["bag:Lineitem", "bag:Orders"] else "bag:Orders"
        other = "bag:Orders" if side == "bag:Lineitem" else "bag:Lineitem"
        assert eng.gamma_carry(q, other, side) == narrow, (drill, root)


def test_row_orders_share_one_sort_per_codes_tensor():
    """One stable sort per codes tensor serves every piece size, and pieces
    of at least the longest segment's rows share their work items, which
    are those row_order cuts for that piece."""
    rng = np.random.default_rng(4)
    g = 3000
    codes = torch.as_tensor(np.sort(rng.integers(0, g, 12_000)).astype(np.int32))
    longest = int(torch.bincount(codes.long()).max())
    built = ops.ORDER_BUILDS["orders"]
    orders = {p: ops.cached_row_order(codes, g, p) for p in (2, longest, 64, 512)}
    assert ops.ORDER_BUILDS["orders"] == built + 1
    assert orders[64] is orders[512] is orders[longest] and orders[2] is not orders[64]
    assert orders[2].perm is orders[64].perm
    for p, order in orders.items():
        fresh = ops.row_order(codes, g, p)
        for a, b in ((order.perm, fresh.perm), (order.offsets, fresh.offsets),
                     (order.table, fresh.table)):
            assert torch.equal(a, b), p
        assert (order.n_items, order.n_splits, order.n_slots) == (
            fresh.n_items, fresh.n_splits, fresh.n_slots)
    kept = ops.cached_bytes()["orders"]
    perm_offsets = orders[2].perm.nbytes + orders[2].offsets.nbytes
    assert kept >= perm_offsets + orders[2].table.nbytes + orders[64].table.nbytes
    del orders, codes


@pytest.mark.parametrize("budget", [0, 200_000])
def test_a_bounded_store_answers_as_an_unbounded_one(budget):
    """With ``max_cache_bytes`` the store evicts what no dispatch holds,
    staying within its bound or its pinned bytes, and the answers are the
    plain join's still."""
    t, revenue, doms, cat = snowflake(seed=5)
    treant = Treant(cat, device="cpu", max_cache_bytes=budget)
    for sess in replay(treant, t, revenue, doms, reference(cat, max_cache_bytes=budget)):
        store = treant.store
        pinned = sum(store._sizes[s] for s in store._pinned if s in store._sizes)
        assert store.nbytes <= max(budget, pinned)
    assert treant.store.evictions > 0


def test_flat_codes_of_several_attributes_are_combined_on_the_device():
    """A new attribute set's codes come from each attribute's cached codes,
    combined where they live: the same int32 codes as the host's
    ``flat_codes``, zero past the rows, cached."""
    _, _, doms, cat = snowflake(seed=6)
    li = cat.get("Lineitem")
    attrs = ("orderkey", "l_shipmode", "l_returnflag")
    got, total = cat.dev_flat_codes(li, attrs, "cpu")
    idx, want_total = li.flat_codes(attrs)
    assert total == want_total == doms["orderkey"] * 7 * 3 and got.dtype == torch.int32
    assert got.shape == (li.row_bucket,) and not got[li.num_rows:].any()
    np.testing.assert_array_equal(got[:li.num_rows].numpy(), idx)
    assert cat.dev_flat_codes(li, attrs, "cpu")[0] is got
    assert cat.dev_flat_codes(li, ("l_shipmode",), "cpu")[0] is \
        cat.dev_flat_codes(li, ("l_shipmode",), "cpu")[0]
