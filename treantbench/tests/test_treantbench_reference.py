"""The plain reference against a join worked out by hand."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from treantbench.tests import tiny  # noqa: F401
from treantbench.data.tables import Table, Tables
from treantbench.reference.dashboard import DashState
from treantbench.reference.join import JoinedFact, VizQuery


def _tables() -> Tables:
    fact = Table("F", ("k", "g"), {"k": np.array([0, 1, 1, 2, 0], np.int32),
                                   "g": np.array([0, 0, 1, 1, 1], np.int32)},
                 {"x": np.array([1.0, 2.0, 4.0, 8.0, 16.0], np.float32)})
    dim = Table("D", ("k", "c"), {"k": np.array([2, 0, 1], np.int32),
                                  "c": np.array([1, 0, 1], np.int32)})
    return Tables({"F": fact, "D": dim}, {"k": 3, "g": 2, "c": 2}, "F", {"D": ("k", "F")})


def _mask(domain, values):
    m = np.zeros(domain, bool)
    m[list(values)] = True
    return m


def test_sums_by_a_joined_attribute():
    fact = JoinedFact(_tables())
    # rows' c through D: k=0 -> 0, k=1 -> 1, k=2 -> 1
    attrs, s = fact.answer(VizQuery("sum", ("F", "x"), ("c",), ()))
    assert attrs == ("c",) and s.tolist() == [1.0 + 16.0, 2.0 + 4.0 + 8.0]
    _, n = fact.answer(VizQuery("sum", ("F", "x"), ("c", "g"), ()))
    assert n.tolist() == [[1.0, 16.0], [2.0, 12.0]]
    with pytest.raises(ValueError):
        fact.answer(VizQuery("tropical_max", ("F", "x"), ("c",), ()))
    _, f = fact.answer(VizQuery("sum", ("F", "x"), ("g",), (("c", _mask(2, [1])),)))
    assert f.tolist() == [2.0, 12.0]


def test_rows_without_a_key_match_leave_the_join():
    t = _tables()
    t.tables["D"] = Table("D", ("k", "c"), {"k": np.array([2, 0], np.int32),
                                            "c": np.array([1, 0], np.int32)})
    _, s = JoinedFact(t).answer(VizQuery("sum", ("F", "x"), (), ()))
    assert s.item() == 1.0 + 8.0 + 16.0
    with pytest.raises(ValueError):
        JoinedFact(Tables(t.tables | {"D": Table("D", ("k", "c"), {
            "k": np.array([0, 0, 1], np.int32), "c": np.array([0, 1, 1], np.int32)})},
            t.domains, "F", t.joins))


def test_lower_precisions():
    fact = JoinedFact(_tables())
    q = VizQuery("sum", ("F", "x"), ("g",), ())
    _, c = fact.answer(q, dtype=torch.bfloat16)
    assert c.dtype == torch.bfloat16
    big = _tables()
    big["F"].measures["x"] = np.array([1.0, 2.0, 4.0, 8.0, 1.0 + 2**-10], np.float32)
    _, exact = JoinedFact(big).answer(q)
    _, rounded = JoinedFact(big).answer(q, dtype=torch.float32, inputs=torch.bfloat16)
    assert rounded.dtype == torch.float32
    assert exact[1].item() == 13.0 + 2**-10 and rounded[1].item() == 13.0


def test_dash_state_renders_what_changed():
    t = _tables()
    vizzes = [{"name": "by_c", "measure": ["F", "x"], "ring": "sum", "group_by": ["c"]},
              {"name": "by_g", "measure": ["F", "x"], "ring": "sum", "group_by": ["g"]}]
    s = DashState(vizzes, t.domains)
    s.apply({"kind": "set_filter", "attr": "c", "values": [1], "source": "by_c"})
    assert set(s.render()) == {"by_g"}
    assert s.query("by_g").filters[0][0] == "c" and s.query("by_c").filters == ()
    s.apply({"kind": "drill", "viz": "by_c", "attr": "g"})
    assert set(s.render()) == {"by_c"} and s.query("by_c").group_by == ("c", "g")
    s.apply({"kind": "set_filter", "attr": "c", "values": [1], "source": "by_c"})
    assert s.render() == {}
    s.apply({"kind": "clear_filter", "attr": "c"})
    assert set(s.render()) == {"by_g"}
    s.apply({"kind": "rollup", "viz": "by_c"})
    assert set(s.render()) == {"by_c"} and s.query("by_c").group_by == ("c",)
