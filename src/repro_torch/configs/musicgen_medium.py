"""MusicGen-Medium decoder backbone over EnCodec tokens [arXiv:2306.05284; hf].

[audio]: the EnCodec frontend is a STUB — ``input_specs`` feeds precomputed
frame embeddings (B, S, d_model); the backbone + 2048-way codebook head are
modeled in full.
"""
from .base import ModelConfig, register


@register("musicgen-medium")
def make() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium", family="audio",
        n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, d_head=64,
        d_ff=6144, vocab=2048, mlp="gelu", input_mode="embeddings",
        source="[arXiv:2306.05284; hf]",
    )
