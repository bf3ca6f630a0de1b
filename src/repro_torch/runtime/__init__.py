"""Step factories of the LM stack: prefill and decode."""

from .step import make_decode_step, make_prefill_step  # noqa: F401
