"""Llama-3.2-Vision 90B backbone: cross-attn image layers every 5th layer
[hf:meta-llama/Llama-3.2-11B-Vision; unverified].

[vlm]: the vision tower is a STUB — ``input_specs`` feeds precomputed patch
embeddings (B, n_vision_tokens, d_model); the 100-layer text backbone with 20
gated cross-attention layers is modeled in full.
"""
from .base import ModelConfig, register


@register("llama-3.2-vision-90b")
def make() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b", family="vlm",
        n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
        d_ff=28672, vocab=128256, mlp="swiglu", rope_theta=500_000.0,
        pattern="vlm", cross_every=5, n_vision_tokens=1024,
        input_mode="tokens+vision",
        source="[hf:meta-llama/Llama-3.2-11B-Vision; unverified]",
    )
