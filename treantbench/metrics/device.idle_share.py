"""Share of the traced slice's wall time in which no kernel or copy ran on
the device: 1 - (union of device activity) / (slice length)."""


def read(run):
    t = run.trace
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
