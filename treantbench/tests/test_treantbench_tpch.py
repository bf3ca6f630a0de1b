"""The TPC-H deployment at a tiny size on the CPU: the generator keeps
dbgen's code lists, keys and rules, and ``tpch.brush`` is correct, while
the controls and a stale answer after a customer-nation brush fail."""

from __future__ import annotations

import copy

import numpy as np
import pytest

from treantbench.tests import tiny
from treantbench.harness import bench
from treantbench.data import tpch

CELL = "tpch.brush"


def _config() -> dict:
    spec = bench.load_benchmark()
    config = copy.deepcopy(bench.config_of(spec, bench.cell(spec, CELL)["config"]))
    tiny.shrink(config, {})
    return config


@pytest.fixture(scope="module")
def tables():
    return _config(), tpch.generate(_config(), 2**31 + 77)


def test_rows_codes_and_keys(tables):
    config, t = tables
    assert {n: t[n].num_rows for n in t.tables} == config["rows"]
    for name, table in t.tables.items():
        for attr, col in table.codes.items():
            assert col.dtype == np.int32 and 0 <= col.min() and col.max() < t.domains[attr], attr
    # every code of each of dbgen's lists occurs
    for attr in ("l_shipmode", "l_returnflag", "l_linestatus", "o_orderpriority",
                 "o_orderstatus", "c_mktsegment", "p_mfgr", "p_brand", "p_container", "p_size",
                 "c_nationkey"):
        rel = next(r for r in t.tables.values() if attr in r.codes and r.name not in
                   ("CNation", "SNation"))
        assert np.unique(rel.codes[attr]).size == config["widths"][attr], attr
    # each relation's key is unique, and every foreign key finds its row
    for rel, (key, parent) in t.joins.items():
        keys = t[rel].codes[key]
        assert np.unique(keys).size == keys.size == t.domains[key], rel
        assert np.isin(t[parent].codes[key], keys).all(), rel
    assert t.fact == "Lineitem" and np.bincount(t["CNation"].codes["c_regionkey"]).tolist() \
        == [5] * 5


def test_dbgen_rules(tables):
    _, t = tables
    li, o = t["Lineitem"], t["Orders"]
    counts = np.bincount(li.codes["orderkey"], minlength=o.num_rows)
    assert counts.sum() == li.num_rows and counts.min() >= 1 and counts.max() <= 7
    assert np.all(np.diff(li.codes["orderkey"]) >= 0)          # in order of orderkey
    assert np.all(o.codes["custkey"] % 3 != 2)                   # 1-based keys not divisible by 3
    # ship month: order month + 1..121 days; orders to 1998-08, ships to 1998-12
    om = o.codes["o_ordermonth"][li.codes["orderkey"]]
    lag = li.codes["l_shipmonth"] - om
    assert lag.min() >= 0 and lag.max() <= 5
    assert o.codes["o_ordermonth"].max() == 79 and li.codes["l_shipmonth"].max() <= 83
    # one of the part's 4 suppliers, by PARTSUPP's formula
    n_s = t["Supplier"].num_rows
    pk = li.codes["partkey"].astype(np.int64) + 1
    four = np.stack([(pk + i * (n_s // 4 + (pk - 1) // n_s)) % n_s for i in range(4)])
    assert (four == li.codes["suppkey"]).any(axis=0).all()
    # status: N lines are unshipped by 1995-06-17 or so; an order is F or O when all its lines are
    status = li.codes["l_linestatus"]
    first = np.concatenate(([0], np.cumsum(counts)[:-1]))
    lo, hi = np.minimum.reduceat(status, first), np.maximum.reduceat(status, first)
    want = np.where(hi == 0, 0, np.where(lo == 1, 1, 2))
    assert np.array_equal(o.codes["o_orderstatus"], want)
    assert set(np.unique(li.codes["l_returnflag"][status == 1])) == {1}   # O lines: N
    # P_BRAND belongs to its manufacturer; revenue is positive and at most 50 * 2098.99
    part = t["Part"]
    assert np.array_equal(part.codes["p_brand"] // 5, part.codes["p_mfgr"])
    rev = li.measures["revenue"]
    assert rev.dtype == np.float32 and 0 < rev.min() and rev.max() <= 50 * 2098.99


@pytest.mark.parametrize("orders,lines", [(1000, 1000), (1000, 4000), (1000, 7000),
                                          (15_000, 59_986)])
def test_line_counts_sum_to_the_rows(orders, lines):
    counts = tpch.line_counts(np.random.default_rng(orders + lines), orders, lines)
    assert counts.sum() == lines and counts.min() >= 1 and counts.max() <= 7


def test_generator_repeats_for_a_seed():
    config = _config()
    a, b, c = (tpch.generate(config, s) for s in (2**32 + 5, 2**32 + 5, 2**32 + 6))
    same = lambda x, y: all(np.array_equal(x[n].codes[k], y[n].codes[k])  # noqa: E731
                            for n in x.tables for k in x[n].codes)
    assert same(a, b) and not same(a, c)


def test_sound_run_is_correct():
    line, _ = tiny.execute(CELL, events=16)
    assert line["correct"], line["check"]
    assert line["check"]["render_mismatch"]["value"] == 0


@pytest.mark.parametrize("control", ["bf16_sum", "bf16_inputs"])
def test_control_fails(control):
    line, _ = tiny.execute(CELL, events=16, control=True)
    limits = {k: v["limit"] for k, v in line["check"].items()}
    got = line["control"][control]
    assert any(got[k] > v for k, v in limits.items()), got


def _stale_after_a_nation_brush(treant, session):
    """Fault: after an event that brushes ``c_nationkey``, every viz it
    renders keeps its previous answer."""
    from repro_torch.core import dashboard as D

    last = {}
    real = type(session).apply
    brushed = []

    def apply(self, event):
        res = real(self, event)
        stale = isinstance(event, D.SetFilter) and event.attr == "c_nationkey"
        brushed.append(stale)
        for viz, r in res.results.items():
            fresh = r.factor
            if stale and viz in last:
                r.factor = last[viz]
            last[viz] = fresh
        return res

    session.apply = apply.__get__(session)
    session.brushed = brushed


def test_stale_answer_after_a_customer_nation_brush_fails():
    seen = {}

    def plant(treant, session):
        _stale_after_a_nation_brush(treant, session)
        seen["session"] = session

    line, _ = tiny.execute(CELL, events=48, prepare=plant)
    assert any(seen["session"].brushed)
    assert not line["correct"], line["check"]


def test_inner_messages_leave_out_the_facts_by_its_measure():
    """``cjt.inner_messages_per_event`` counts a large message only when its
    source bag is not the one holding the measure: a message out of
    Lineitem is the fact's at any size, one out of Orders is inner whether
    or not the slice reads Lineitem."""
    reader = bench.metric("cjt.inner_messages_per_event")
    run, _ = reader.CASE()
    base = reader.read(run)
    run.trace["records"].append(
        {"id": 0, "parent": 0, "root": 0, "name": "cjt.message", "t0": 0, "t1": 0,
         "prof": True, "attrs": {"edge": "bag:Lineitem->bag:Part", "rows": 60_000_000,
                                 "level": 3, "from_measure": True}})
    assert reader.read(run) == base == 1.0
    # a program whose spans carry no from_measure reads nothing
    for r in run.trace["records"]:
        r.get("attrs", {}).pop("from_measure", None)
    assert reader.read(run) is None
