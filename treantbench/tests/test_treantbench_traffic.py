"""Each traffic mix yields the mix of events it states."""

from __future__ import annotations

import copy
import json
from collections import Counter

import pytest

from treantbench.tests import tiny  # noqa: F401
from treantbench.harness import bench
from treantbench.harness.events import EventGenerator
from treantbench.reference.dashboard import DashState

MIXES = [w for w in bench.load_benchmark()["workloads"]
         if "events" in bench.traffic_of(w["traffic"])]

# event kinds each weighted kind may emit
EMITS = {"range_drag": {"set_filter"}, "in_jump": {"set_filter"},
         "switch_dim": {"set_filter"}, "clear": {"clear_filter"}, "drill": {"drill", "rollup"}}


def _events(cell: dict, n: int, seed: int = 11):
    spec = bench.load_benchmark()
    config = copy.deepcopy(bench.config_of(spec, cell["config"]))
    mix = bench.traffic_of(cell["traffic"])
    tiny.shrink(config, mix)
    tables = bench.generator_of(config).generate(config, 1)
    state = DashState(mix["dashboard"], tables.domains)
    gen = EventGenerator(mix["events"], mix["dashboard"], tables.domains, seed, stream=1)
    out = []
    for _ in range(n):
        ev = gen.next(state)
        state.apply(ev)
        state.render()
        out.append(ev)
    return mix, out


@pytest.mark.parametrize("cell", MIXES, ids=[c["name"] for c in MIXES])
def test_mix_matches_its_weights(cell):
    n = 3000
    mix, events = _events(cell, n)
    weights = mix["events"]["weights"]
    total = sum(weights.values())
    group = {e: frozenset(EMITS[wk]) for wk in weights for e in EMITS[wk]}
    got = Counter(group[ev["kind"]] for ev in events)
    for g in set(group.values()):
        share = sum(w for wk, w in weights.items() if frozenset(EMITS[wk]) == g) / total
        assert abs(got[g] / n - share) < 0.035, (sorted(g), got[g] / n, share)
    assert sum(got.values()) == n


@pytest.mark.parametrize("cell", MIXES, ids=[c["name"] for c in MIXES])
def test_same_seed_same_events(cell):
    a, b, c = (_events(cell, 300, seed=s)[1] for s in (5, 5, 6))
    assert a == b and a != c
    # another seed moves the values, not the shape of the stream
    def shape(events):
        return [(e["kind"], e.get("attr"), e.get("viz"), len(e.get("values", ())),
                 e.get("hi", 0) - e.get("lo", 0)) for e in events]

    assert shape(a) == shape(c)


@pytest.mark.parametrize("cell", MIXES, ids=[c["name"] for c in MIXES])
def test_brush_sources_and_ranges_stay_in_the_domain(cell):
    mix, events = _events(cell, 2000)
    dims = mix["events"]["brush_dims"]
    doms = json.loads((bench.BENCH_DIR / "configs" / f"{cell['config']}.json").read_text())["widths"]
    for ev in events:
        if ev["kind"] == "set_filter":
            assert ev["source"] == dims[ev["attr"]]
            if "lo" in ev:
                assert 0 <= ev["lo"] < ev["hi"] <= doms[ev["attr"]]
