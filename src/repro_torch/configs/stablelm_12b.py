"""StableLM-2 12B: llama-style GQA [hf:stabilityai/stablelm-2-12b; hf]."""
from .base import ModelConfig, register


@register("stablelm-12b")
def make() -> ModelConfig:
    return ModelConfig(
        name="stablelm-12b", family="dense",
        n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_head=160,
        d_ff=13824, vocab=100352, mlp="swiglu",
        source="[hf:stabilityai/stablelm-2-1_6b; hf]",
    )
