"""RWKV6-7B "Finch": attention-free, data-dependent decay [arXiv:2404.05892; hf].

SSM family (O(1) state): eligible for long_500k decode.
"""
from .base import ModelConfig, RWKVConfig, register


@register("rwkv6-7b")
def make() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b", family="ssm",
        n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, d_head=64,
        d_ff=14336, vocab=65536, mlp="squared_relu",
        rwkv=RWKVConfig(head_dim=64, lora_rank=64, chunk=32),
        pattern="rwkv", sub_quadratic=True,
        source="[arXiv:2404.05892; hf]",
    )
