"""Seconds from the script's start to the window's first event: kernel
builds (a checkout's first run), data, catalog, ``open_session``, context
and warm-up."""


def CASE():
    """The synthetic run (treantbench/tests/synthetic.py) and what read() gives on it."""
    from treantbench.tests import synthetic

    return synthetic.run(), 12.5


def read(run):
    return run.setup_s
