"""Seconds from the script's start to the window's first event: kernel
builds (a checkout's first run), data, catalog, ``open_session``, context
and warm-up."""


def read(run):
    return run.setup_s
