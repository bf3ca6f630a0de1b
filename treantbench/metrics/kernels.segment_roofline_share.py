"""Segment kernels 1-2 against their roofline, in the traced slice: the
least time of the slice's ``kernels.segment`` records (each the slower of
its bytes at the card's HBM peak and its FP32 operations at the FP32 peak,
:mod:`treantbench.harness.roofline`) over the device time of the kernels
whose name holds ``segment_aggregate``, in %."""

from treantbench.harness import roofline


def CASE():
    """The synthetic run (treantbench/tests/synthetic.py) and what read() gives on it."""
    from treantbench.tests import synthetic

    # a slab message bound by its bytes and a fused member bound by its operations
    least = (roofline.roofline_s(4 * 1000 + 1000 * 2 * 4 + 4 * 10 * 2, 1000 * 2)
             + roofline.roofline_s(4 * 10**6 + 8 * 10**6 + 4 * 17 * 100, 10**6 * 100 * 3))
    return synthetic.run(), 100 * least / 600e-6


def read(run):
    if run.trace is None:
        return None
    device_s = sum(e - s for name, s, e, *_ in run.trace["kernels"]
                   if "segment_aggregate" in name) / 1e6
    least = sum(roofline.roofline_s(*roofline.segment_cost(r))
                for r in run.trace["records"] if r.get("kind") == "kernels.segment" and r["prof"])
    if device_s <= 0 or least <= 0:
        return None
    return 100.0 * least / device_s
