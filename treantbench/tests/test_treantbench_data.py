"""The frozen generator: the same seed gives the same tables, another seed
other tables; the codes keep BTS's code lists and the calendar, and the
Zipf keys carry the stated shares."""

from __future__ import annotations

import copy
import json

import numpy as np
import pytest

from treantbench.tests import tiny  # noqa: F401  (puts the checkout on sys.path)
from treantbench.harness import bench
from treantbench.data.tables import zipf_p

CONFIG = "flights-bts-2019"


def _small(rows: int = 20_000) -> dict:
    config = json.loads((bench.BENCH_DIR / "configs" / f"{CONFIG}.json").read_text())
    config = copy.deepcopy(config)
    config["rows"]["Flights"] = rows
    return config


def _tables(rows: int = 20_000, seed: int = 3):
    config = _small(rows)
    return config, bench.generator_of(config).generate(config, seed)


def _same(a, b) -> bool:
    return all(
        np.array_equal(a[n].codes[c], b[n].codes[c]) for n in a.tables for c in a[n].codes
    ) and all(
        np.array_equal(a[n].measures[m], b[n].measures[m]) for n in a.tables for m in a[n].measures
    )


def test_generator_repeats_for_a_seed():
    config = _small()
    gen = bench.generator_of(config)
    seed = 2**32 + 7
    a, b, c = gen.generate(config, seed), gen.generate(config, seed), gen.generate(config, seed + 1)
    assert _same(a, b)
    assert not _same(a, c)
    for t in a.tables.values():
        for attr, col in t.codes.items():
            assert col.dtype == np.int32 and col.min() >= 0 and col.max() < a.domains[attr]


def test_every_code_of_the_bts_lists_occurs():
    config, t = _tables(200_000)
    f = t["Flights"]
    for attr in ("carrier_id", "origin_id", "dest_id", "date_id", "dep_delay_group",
                 "distance_group"):
        assert np.unique(f.codes[attr]).size == config["widths"][attr], attr
    assert not np.any(f.codes["origin_id"] == f.codes["dest_id"])


def test_delay_minutes_and_groups_agree():
    _, t = _tables()
    f = t["Flights"]
    minutes, group = f.measures["dep_delay_minutes"], f.codes["dep_delay_group"]
    assert minutes.dtype == np.float32 and minutes.min() == 0.0
    # early departures (groups -2 and -1, codes 0 and 1) count 0 minutes
    assert np.all(minutes[group <= 1] == 0.0) and np.all(minutes[group >= 2] >= 0.0)
    late = group >= 3
    assert np.all(minutes[late] >= 15.0 * (group[late] - 2))
    assert np.all(minutes[late & (group < 14)] < 15.0 * (group[late & (group < 14)] - 1))


def test_calendar_of_2019():
    _, t = _tables(1000)
    d = t["Dates"]
    assert np.bincount(d.codes["month"]).tolist() == [31, 28, 31, 30, 31, 30, 31, 31, 30,
                                                      31, 30, 31]
    assert d.codes["dow"][0] == 1      # 1 January 2019 was a Tuesday (Monday is 0)
    assert np.bincount(d.codes["dow"]).tolist() == [52, 53, 52, 52, 52, 52, 52]


@pytest.mark.parametrize("side", ["Origin", "Dest"])
def test_hub_classes_follow_popularity(side):
    config, t = _tables(400_000)
    prefix = side.lower()
    sizes = t[side].codes[f"{prefix}_size"]
    assert np.bincount(sizes, minlength=4)[::-1][:3].tolist() == \
        config["assumed_parameters"]["hubs_large_medium_small"]
    flights = np.bincount(t["Flights"].codes[f"{prefix}_id"], minlength=360)
    # the large hubs are the busiest airports
    assert flights[sizes == 3].min() > flights[sizes <= 1].max()


def test_zipf_share_of_the_top_airports():
    p = zipf_p(360, 1.0)
    assert 0.61 < p[:30].sum() < 0.63   # H(30) / H(360)
    _, t = _tables(400_000)
    codes = t["Flights"].codes["origin_id"]
    top = np.sort(np.bincount(codes, minlength=360))[::-1][:30].sum()
    assert 0.60 < top / codes.size < 0.64
