"""Plans built per event: ``PlanStats.plans_built`` over the window (every
engine of the Treant), over the window's events."""


def read(run):
    if not run.events:
        return None
    return run.plans_built / len(run.events)
