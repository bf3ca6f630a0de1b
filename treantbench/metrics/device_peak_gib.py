"""``torch.cuda.max_memory_allocated()`` over the whole process, set-up
included, in GiB."""


def CASE():
    """The synthetic run (treantbench/tests/synthetic.py) and what read() gives on it."""
    from treantbench.tests import synthetic

    return synthetic.run(), 3.0


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
