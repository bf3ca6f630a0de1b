"""Architecture registry: ``get_config(name)`` / ``--arch <id>``."""

ALL_ARCHS = [
    "musicgen-medium",
    "dbrx-132b",
    "granite-moe-1b-a400m",
    "nemotron-4-15b",
    "nemotron-4-340b",
    "deepseek-coder-33b",
    "stablelm-12b",
    "llama-3.2-vision-90b",
    "zamba2-1.2b",
    "rwkv6-7b",
]

from .base import ModelConfig, MoEConfig, SSMConfig, RWKVConfig, ShapeConfig, SHAPES, get_config, list_archs  # noqa: F401,E402
from . import (  # noqa: F401,E402 — populate the registry
    musicgen_medium, dbrx_132b, granite_moe_1b_a400m, nemotron_4_15b,
    nemotron_4_340b, deepseek_coder_33b, stablelm_12b, llama_3_2_vision_90b,
    zamba2_1_2b, rwkv6_7b,
)
