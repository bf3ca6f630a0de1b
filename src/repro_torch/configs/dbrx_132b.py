"""DBRX-Base: 132B-total / 36B-active fine-grained MoE [hf:databricks/dbrx-base; unverified]."""
from .base import ModelConfig, MoEConfig, register


@register("dbrx-132b")
def make() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b", family="moe",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
        d_ff=10752, vocab=100352, mlp="swiglu",
        moe=MoEConfig(n_experts=16, top_k=4, d_ff=10752),
        rope_theta=500_000.0,
        source="[hf:databricks/dbrx-base; unverified]",
    )
