from .pipeline import TokenPipeline, StragglerMonitor, synth_batch  # noqa: F401
