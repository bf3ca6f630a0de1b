"""Step factories of the LM stack: train, prefill and decode."""

from .step import make_decode_step, make_prefill_step, make_train_step  # noqa: F401
