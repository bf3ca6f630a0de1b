"""Zamba2-1.2B: Mamba2 backbone + shared attention block [arXiv:2411.15242; hf].

Hybrid (sub-quadratic state): eligible for long_500k decode.
"""
from .base import ModelConfig, SSMConfig, register


@register("zamba2-1.2b")
def make() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b", family="hybrid",
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_head=64,
        d_ff=8192, vocab=32000, mlp="swiglu",
        ssm=SSMConfig(state=64, head_dim=64, expand=2, conv=4, chunk=64),
        pattern="zamba", shared_attn_every=6, sub_quadratic=True,
        source="[arXiv:2411.15242; hf]",
    )
