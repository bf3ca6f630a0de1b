"""Nemotron-4 340B: GQA + squared-ReLU MLP [arXiv:2402.16819; unverified]."""
from .base import ModelConfig, register


@register("nemotron-4-340b")
def make() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-340b", family="dense",
        n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8, d_head=192,
        d_ff=73728, vocab=256000, mlp="squared_relu",
        source="[arXiv:2402.16819; unverified]",
    )
