"""``correct`` on the CPU at a tiny size: a sound run passes; the controls
(the reference at lower precisions) and each fault planted in the timed
path fail."""

from __future__ import annotations

import dataclasses

import pytest

from treantbench.harness import check
from treantbench.tests import tiny

CELLS = ("flight.brush", "flight.explore")


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    line, _ = tiny.execute(cell)
    assert line["correct"], line["check"]
    assert line["check"]["render_mismatch"]["value"] == 0
    assert line["attempted"] >= 12


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("control", ["bf16_sum", "bf16_inputs"])
def test_control_fails(cell, control):
    line, _ = tiny.execute(cell, control=True)
    limits = {k: v["limit"] for k, v in line["check"].items()}
    got = line["control"][control]
    assert any(got[k] > v for k, v in limits.items()), got


def _wrap_results(treant, session, change):
    """Pass every rendered result through ``change(viz, result)`` after
    ``Session.apply``."""
    real = type(session).apply

    def apply(self, event):
        res = real(self, event)
        for viz, r in res.results.items():
            change(viz, r)
        return res

    session.apply = apply.__get__(session)


def _stale(treant, session):
    """Fault: an event returns each viz's previous answer (state unchanged)."""
    last = {}

    def change(key, r):
        fresh = r.factor
        if key in last:
            r.factor = last[key]
        last[key] = fresh

    _wrap_results(treant, session, change)


def _half_rows(treant, session, monkeypatch):
    """Fault: every segment reduction leaves out the second half of its rows."""
    from repro_torch.kernels.segment_aggregate import ops

    ident = {"sum": 0.0, "min": float("inf"), "max": float("-inf")}

    def halve(codes, values, op):
        values = values.clone()
        values[codes.shape[0] // 2:] = ident[op]
        return values

    real_one, real_level = ops.aggregate_op, ops.level_aggregate

    def aggregate_op(codes, values, num_segments, op="sum", **kw):
        return real_one(codes, halve(codes, values, op), num_segments, op=op, **kw)

    def level_aggregate(items, op="sum"):
        return real_level([(c, halve(c, v, op), *rest) for c, v, *rest in items], op=op)

    monkeypatch.setattr(ops, "aggregate_op", aggregate_op)
    monkeypatch.setattr(ops, "level_aggregate", level_aggregate)


def _altered(treant, session):
    """Fault: one cell of every answer is altered where it is produced."""
    def change(key, r):
        f = r.factor.field.clone()
        if f.numel():
            f.reshape(-1)[0] = f.reshape(-1)[0] * 1.01 + 1.0
            r.factor = dataclasses.replace(r.factor, field=f)

    _wrap_results(treant, session, change)


@pytest.mark.parametrize("cell,fault", [
    ("flight.brush", "stale"), ("flight.brush", "half_rows"), ("flight.brush", "altered"),
    ("flight.explore", "stale"), ("flight.explore", "half_rows"), ("flight.explore", "altered"),
])
def test_fault_fails(cell, fault, monkeypatch):
    plant = {
        "stale": _stale, "altered": _altered,
        "half_rows": lambda t, s: _half_rows(t, s, monkeypatch),
    }[fault]
    line, _ = tiny.execute(cell, prepare=plant)
    assert not line["correct"], line["check"]


@pytest.mark.parametrize("count", [5, 128, 129, 1000, 7300])
def test_reservoir_repeats_for_a_seed_and_keeps_at_most_sample(count):
    def picks(seed):
        r = check.Reservoir(seed)
        for i in range(count):
            r.offer(lambda i=i: i)
        return r.checks()

    seed = 2**31 + 99
    a, b = picks(seed), picks(seed)
    assert a == b == sorted(a) and len(set(a)) == len(a) == min(count, check.SAMPLE)
    assert all(0 <= i < count for i in a)
    if count > 2 * check.SAMPLE:
        assert picks(seed + 1) != a and max(a) >= check.SAMPLE


def _stale_in(indices):
    """Fault: the timed events at ``indices`` return each viz's previous
    answer."""
    def plant(treant, session):
        last, seen = {}, [0]
        real = type(session).apply

        def apply(self, event):
            res = real(self, event)
            k, seen[0] = seen[0], seen[0] + 1
            for viz, r in res.results.items():
                fresh = r.factor
                if k in indices and viz in last:
                    r.factor = last[viz]
                last[viz] = fresh
            return res

        session.apply = apply.__get__(session)
    return plant


@pytest.mark.parametrize("cell", CELLS)
def test_stale_answer_in_a_sampled_event_fails(cell, monkeypatch):
    monkeypatch.setattr(check, "SAMPLE", 4)
    seed, events = 2**31 + 12345, 16
    r = check.Reservoir(seed)
    for i in range(events):
        r.offer(lambda i=i: i)
    late = [i for i in r.checks() if i >= check.SAMPLE]   # drawn in place of a kept one
    assert late
    sound, notes = tiny.execute(cell, seed=seed, events=events)
    assert sound["correct"], sound["check"]
    answers = int(next(n for n in notes if "answers" in n).split("answers ")[1].split()[0])
    assert 0 < answers <= 4 * 8
    line, _ = tiny.execute(cell, seed=seed, events=events, prepare=_stale_in(set(late)))
    assert not line["correct"], line["check"]
