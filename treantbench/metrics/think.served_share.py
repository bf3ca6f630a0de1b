"""Share of rendered vizzes that think time served: bin-cube and prefetch
hits (each result's ``ExecStats``) over the vizzes the window's events
rendered."""


def read(run):
    rendered = sum(e.rendered for e in run.events)
    if rendered == 0:
        return None
    return 100.0 * sum(e.cube_hits + e.prefetch_hits for e in run.events) / rendered
