"""AdamW and int8 gradient compression for the port's LM training."""

from .adamw import AdamWConfig, init_opt_state, apply_updates, opt_state_specs, lr_at  # noqa: F401
from .compression import compress_int8, decompress_int8, CompressionState  # noqa: F401
