"""Share of the messages the window's events needed that the message store
served: reused / (computed + reused), from each event's ``ExecStats``."""


def read(run):
    computed = sum(e.computed for e in run.events)
    reused = sum(e.reused for e in run.events)
    if computed + reused == 0:
        return None
    return 100.0 * reused / (computed + reused)
