"""Granite-3.0 1B-a400m MoE [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""
from .base import ModelConfig, MoEConfig, register


@register("granite-moe-1b-a400m")
def make() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m", family="moe",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, d_head=64,
        d_ff=512, vocab=49155, mlp="swiglu",
        moe=MoEConfig(n_experts=32, top_k=8, d_ff=512, group=128),
        source="[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]",
    )
