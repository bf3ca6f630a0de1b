"""Nemotron-4 15B: GQA + squared-ReLU MLP [arXiv:2402.16819; unverified]."""
from .base import ModelConfig, register


@register("nemotron-4-15b")
def make() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b", family="dense",
        n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
        d_ff=24576, vocab=256000, mlp="squared_relu",
        source="[arXiv:2402.16819; unverified]",
    )
