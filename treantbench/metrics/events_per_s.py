"""Events completed in the window over the window's seconds."""


def read(run):
    if not run.events or run.window_s <= 0:
        return None
    return len(run.events) / run.window_s
