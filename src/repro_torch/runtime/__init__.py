"""The LM stack's runtime: step factories (train, prefill, decode), the
sharding rules (``sharding``) and the mesh and FLOP-count shims (``compat``)."""

from .step import make_decode_step, make_prefill_step, make_train_step  # noqa: F401
