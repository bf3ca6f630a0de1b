"""The LM stack's models in PyTorch: layers, SSM blocks, the four block
patterns' forwards, and the bridge to the reference's pytrees."""

from .lm import LM, cache_specs, init_params, param_specs  # noqa: F401
