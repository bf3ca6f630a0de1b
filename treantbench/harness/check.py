"""Decide ``correct``: the rendered factors of a sample of the window's
events against the plain reference.

Numbers compared (each against the cell's limit in ``limits/<cell>.json``):

- ``sum_rel_gap``: the widest |program − reference| / |reference| over
  every cell of every SUM answer compared (0 where both are 0);
- ``answer_mismatch``: answers whose group-by attributes or shape differ
  from the reference's;
- ``render_mismatch``: events after which the set of vizzes re-rendered
  differs from the vizzes whose query changed (every event, warm-up
  included).

Two controls put the reference in the program's place, each at a
precision below the float32 the measures are stated in: ``bf16_sum``
accumulates every sum in bfloat16, ``bf16_inputs`` rounds each measure
value to bfloat16 and accumulates in float32 (a program that stores its
measures in bfloat16).
"""

from __future__ import annotations

import numpy as np

from treantbench.reference.join import JoinedFact

SAMPLE = 128
CONTROLS = ("bf16_sum", "bf16_inputs")


class Reservoir:
    """Up to ``SAMPLE`` of a window's events, a uniform sample drawn from
    ``[seed, 7]`` as they come (Algorithm R): the i-th event (from 0) takes
    slot i while i < ``SAMPLE``, and after that the slot of a number drawn
    from [0, i], if that is a slot.  The same seed and count of events give
    the same sample, and only a sampled event's check is made."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng([seed, 7])
        self.seen = 0
        self.kept: list = []     # slot -> (event index, check)

    def offer(self, make) -> None:
        """Count one more event, and keep ``make()`` if it is drawn."""
        i = self.seen
        self.seen += 1
        j = i if i < SAMPLE else int(self.rng.integers(0, i + 1))
        if j < SAMPLE:
            entry = (i, make())
            if j == len(self.kept):
                self.kept.append(entry)
            else:
                self.kept[j] = entry

    def checks(self) -> list:
        """The kept checks, in event order."""
        return [c for _, c in sorted(self.kept, key=lambda e: e[0])]


def reference(tables, device: str) -> JoinedFact:
    return JoinedFact(tables, device=device)


def compare(torch, fact: JoinedFact, checks: list, render_mismatch: int,
            control: str | None = None) -> dict:
    """The numbers compared, over ``checks``.  With ``control`` (one of
    ``CONTROLS``) the program's answers are replaced by the reference's at
    that precision."""
    lower = {"bf16_sum": {"dtype": torch.bfloat16},
             "bf16_inputs": {"dtype": torch.float32, "inputs": torch.bfloat16}}
    gap, mismatch, answers = 0.0, 0, 0
    for c in checks:
        for viz, q in c.queries.items():
            if viz not in c.outputs:
                continue
            ref_attrs, ref = fact.answer(q)
            if control:
                got_attrs, got = fact.answer(q, **lower[control])
            else:
                got_attrs, got = c.outputs[viz]
            answers += 1
            if tuple(got_attrs) != tuple(ref_attrs) or tuple(got.shape) != tuple(ref.shape):
                mismatch += 1
                continue
            r = ref.to(torch.float64)
            g = got.to(device=r.device, dtype=torch.float64)
            den = r.abs()
            err = (g - r).abs()
            rel = torch.where(den > 0, err / den.clamp(min=1e-300),
                              torch.where(err > 0, torch.inf, 0.0))
            worst = float(torch.nan_to_num(rel, nan=float("inf")).max()) if rel.numel() else 0.0
            gap = max(gap, worst)
    return {"sum_rel_gap": gap, "answer_mismatch": mismatch,
            "render_mismatch": 0 if control else render_mismatch, "answers_compared": answers}
