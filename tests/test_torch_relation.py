"""Port relational layer held against the JAX package: the schema generators
emit the same arrays, and every digest that keys the message store
(``Relation.digest``, ``Predicate.digest``, ``Query.digest``/``sig_key``)
comes out equal.  Also the join tree, the catalog's version protocol, the SQL
front end, and the package's import hygiene."""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_factors_match, port_catalog
from repro.core import Query as JQuery
from repro.core import jt_from_catalog as j_jt
from repro.core import semiring as jsr
from repro.relational import schema as jschema
from repro.relational.relation import mask_in as j_mask_in
from repro.relational.relation import mask_range as j_mask_range
from repro.relational.sql import parse as j_parse
from repro_torch.core import semiring as tsr
from repro_torch.core.hypertree import jt_from_catalog as t_jt
from repro_torch.core.query import Query as TQuery
from repro_torch.relational import schema as tschema
from repro_torch.relational.relation import LRU, Catalog, Relation, row_bucket
from repro_torch.relational.relation import mask_in as t_mask_in
from repro_torch.relational.relation import mask_range as t_mask_range
from repro_torch.relational.sql import parse as t_parse

SRC = Path(__file__).resolve().parents[1] / "src"

GENERATORS = {
    "salesforce": dict(n_opp=3000, n_user=50),
    "chain": dict(r=3, fanout=2, domain=16),
    "flight": dict(n_flights=2000),
    "favorita": dict(n_sales=1500),
    "tpch": dict(n_lineitem=2000, n_orders=400, n_cust=60, n_supp=20),
    "tpcds_star": dict(n_sales=2000),
}


@pytest.mark.parametrize("gen", sorted(GENERATORS))
def test_schema_generators_match_reference(gen):
    jcat = getattr(jschema, gen)(**GENERATORS[gen])
    tcat = getattr(tschema, gen)(**GENERATORS[gen])
    assert jcat.names() == tcat.names()
    assert jcat.domains() == tcat.domains()
    for name in jcat.names():
        jr, tr = jcat.get(name), tcat.get(name)
        assert (jr.attrs, jr.version, jr.digest) == (tr.attrs, tr.version, tr.digest)
        for a in jr.attrs:
            np.testing.assert_array_equal(jr.codes[a], tr.codes[a])
            assert tr.codes[a].dtype == np.int32
        assert sorted(jr.measures) == sorted(tr.measures)
        for m in jr.measures:
            np.testing.assert_array_equal(jr.measures[m], tr.measures[m])
    jjt, tjt = j_jt(jcat), t_jt(tcat)
    assert (jjt.bags, jjt.adj, jjt.mapping) == (tjt.bags, tjt.adj, tjt.mapping)
    root = sorted(jjt.bags)[0]
    assert jjt.calibration_levels(root) == tjt.calibration_levels(root)


def test_catalog_from_arrays_keeps_digests_and_codes():
    jcat = jschema.salesforce(n_opp=1000, n_user=40)
    tcat = port_catalog(jcat)
    for name in jcat.names():
        jr, tr = jcat.get(name), tcat.get(name)
        assert jr.digest == tr.digest and jr.row_bucket == tr.row_bucket
        for attrs in ((), tr.attrs[:1], tr.attrs):
            ji, jt_ = jr.flat_codes(attrs)
            ti, tt_ = tr.flat_codes(attrs)
            np.testing.assert_array_equal(ji, ti)
            assert jt_ == tt_
            dev, total = tcat.dev_flat_codes(tr, attrs, "cpu")
            jdev, _ = jcat.dev_flat_codes(jr, attrs)
            assert dev.dtype == torch.int32 and total == tt_
            np.testing.assert_array_equal(np.asarray(jdev), dev.numpy())  # 0-padded bucket


@pytest.mark.parametrize("ring", ["count", "sum", "tropical_min", "moments", "bool"])
def test_to_factor_matches_reference(ring):
    jcat = jschema.salesforce(n_opp=800, n_user=30, n_camp=20)
    tcat = port_catalog(jcat)
    measure = None if ring in ("count", "bool") else "budget"
    jf = jcat.get("Camp").to_factor(jsr.get(ring), measure)
    tf = tcat.get("Camp").to_factor(tsr.get(ring), measure)
    assert_factors_match(jf, tf, exact=ring != "moments")


def test_predicate_and_query_digests_match_reference():
    jcat = jschema.salesforce(n_opp=500)
    tcat = tschema.salesforce(n_opp=500)
    d = jcat.domains()
    jp = [j_mask_in(d["role_name"], [1, 3], attr="role_name"), j_mask_range(d["state"], 2, 9, attr="state")]
    tp = [t_mask_in(d["role_name"], [1, 3], attr="role_name"), t_mask_range(d["state"], 2, 9, attr="state")]
    assert [p.digest for p in jp] == [p.digest for p in tp]
    assert [p.label for p in jp] == [p.label for p in tp]
    jq = JQuery.make(jcat, ring="sum", measure=("Opp", "amount"), group_by=("camp_type",))
    tq = TQuery.make(tcat, ring="sum", measure=("Opp", "amount"), group_by=("camp_type",))
    variants = [
        lambda q, ps: q,
        lambda q, ps: q.with_predicate(ps[0]),
        lambda q, ps: q.with_filters(ps).add_group_by("title"),
        lambda q, ps: q.with_removed("Acc").without_predicate("state"),
        lambda q, ps: q.with_version("Opp", "v7").with_measure("Camp", "budget", ring="moments"),
        lambda q, ps: q.with_relation_toggled("Role").with_group_by(),
    ]
    for v in variants:
        a, b = v(jq, jp), v(tq, tp)
        assert (a.digest, a.sig_key) == (b.digest, b.sig_key)


def test_sql_parses_to_the_same_query():
    jcat = jschema.salesforce(n_opp=500)
    tcat = tschema.salesforce(n_opp=500)
    for text in [
        "SELECT camp_type, SUM(amount) FROM Opp WHERE state IN (1,2,3) GROUP BY camp_type",
        "SELECT COUNT(*) FROM Opp WHERE stage BETWEEN 1 AND 3",
        "SELECT title, AVG(amount) FROM Opp, User WHERE role_id = 2 GROUP BY title",
    ]:
        assert j_parse(text, jcat).digest == t_parse(text, tcat).digest
        assert j_parse(text, jcat, True).digest == t_parse(text, tcat, True).digest


def test_catalog_versions_commit_and_watermark():
    cat = tschema.salesforce(n_opp=200)
    wm0 = cat.watermark
    opp = cat.get("Opp")
    cat.put(opp.with_version("v1"), make_latest=False)
    assert cat.latest_version("Opp") == "v0" and cat.watermark == wm0
    with pytest.raises(KeyError):
        cat.commit({"Opp": "v9"})
    pinned = cat.pin_watermark()
    assert cat.commit({"Opp": "v1"}) == wm0 + 1
    assert cat.get("Opp").version == "v1"
    assert any(wm == pinned for wm, _ in cat.commit_log)
    cat.release_watermark(pinned)
    with cat.snapshot_read() as (wm, versions):
        assert wm == cat.watermark and versions["Opp"] == "v1"


def test_row_bucket_and_lru():
    assert [row_bucket(n) for n in (0, 64, 65, 1000, 10_000_000)] == [64, 64, 128, 1024, 1 << 24]
    lru = LRU(2)
    lru.put("a", 1)
    lru.put("b", 2)
    lru.get("a")
    lru.put("c", 3)
    assert "a" in lru and "b" not in lru and len(lru) == 2


def test_lift_pads_nothing_and_keeps_weights():
    rel = Relation("R", ("A",), {"A": np.array([0, 1, 1], np.int32)}, {"A": 2},
                   measures={"x": np.array([1.0, 2.0, 4.0], np.float32)},
                   weights=np.array([1.0, -1.0, 2.0], np.float32))
    cat = Catalog([rel])
    f = cat.get("R").to_factor(tsr.SUM, "x")
    assert f.field.tolist() == [1.0, 6.0]


def _fresh(code: str) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=120)


def test_relational_imports_before_core_and_without_jax():
    """``repro_torch.relational`` imports first in a fresh interpreter (the
    reference raises ImportError there), and nothing of the port, the LM
    stack included, pulls in JAX or the JAX package."""
    code = (
        "import sys\n"
        "import repro_torch.relational\n"
        "import repro_torch.core\n"
        "from repro_torch.core import Treant, CJTEngine, Query, steiner\n"
        "from repro_torch.relational import sql, schema\n"
        "from repro_torch.kernels.segment_aggregate import ops, kernel, ref\n"
        "from repro_torch.kernels.semiring_contract import ops, kernel, ref\n"
        "from repro_torch.kernels.tropical_contract import ops, kernel, ref\n"
        "from repro_torch.kernels import build\n"
        "import repro_torch.core.predictive\n"
        "from repro_torch.core import FactorizedLinearRegression, FeatureSpec, FitResult\n"
        "from repro_torch.core import build_cube, CubeReport, naive_cube_cost\n"
        "from repro_torch.kernels import costs\n"
        "import repro_torch.core.distributed\n"
        "from repro_torch.core import distributed\n"
        "from repro_torch.serve import TreantServer, ServerSession, QueueFull, ServeStats\n"
        "import repro_torch.configs\n"
        "import repro_torch.models.lm\n"
        "import repro_torch.models.convert\n"
        "import repro_torch.runtime.step\n"
        "import repro_torch.launch.serve\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = _fresh(code)
    assert out.returncode == 0, out.stdout + out.stderr
    ref = _fresh("import repro.relational")
    assert ref.returncode != 0 and "ImportError" in ref.stderr
