"""Kernel launches per event: the port's launch counters (segment kernels
1-2, contract kernels 3-4) inside each event's ``Session.apply``, over the
window's events."""


def read(run):
    if not run.events:
        return None
    return sum(e.launches for e in run.events) / len(run.events)
