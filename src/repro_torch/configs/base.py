"""Model/shape configuration schema + registry for the assigned architectures."""

from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden
    capacity_factor: float = 1.25
    group: int = 256               # dispatch group size (tokens)


@dataclasses.dataclass(frozen=True)
class SSMConfig:                   # Mamba2 / SSD
    state: int = 64
    head_dim: int = 64
    expand: int = 2
    conv: int = 4
    chunk: int = 64


@dataclasses.dataclass(frozen=True)
class RWKVConfig:                  # RWKV6 "Finch"
    head_dim: int = 64
    lora_rank: int = 64
    chunk: int = 32


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    mlp: str = "swiglu"            # swiglu | squared_relu | gelu
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    rwkv: RWKVConfig | None = None
    pattern: str = "uniform"       # uniform | vlm | zamba | rwkv
    cross_every: int = 5           # vlm: 1 cross-attn layer per this many
    n_vision_tokens: int = 1024
    shared_attn_every: int = 6     # zamba: shared block period
    input_mode: str = "tokens"     # tokens | embeddings | tokens+vision
    sub_quadratic: bool = False    # eligible for long_500k
    # attention implementation knobs (hillclimb dials)
    attn_mode: str = "full_masked"     # full_masked | divide
    # context-parallel attention: shard q/k/v on the SEQUENCE dim over the
    # tensor axis (for archs whose head count doesn't divide it)
    attn_seq_shard: bool = False
    # shard the residual stream's d_model over the tensor axis (Megatron-SP
    # style; saves activation memory but all-gathers at every matmul input)
    resid_shard: bool = True
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 512
    attn_min_block: int = 1024
    # compile-shape knobs
    remat: str = "full"            # full | dots | none
    loss_chunk: int = 512          # sequence chunking for the xent loss
    scan_groups: int | None = None  # √L nested layer scan (activation memory dial)
    # analysis mode: unroll every lax.scan so XLA cost analysis counts each
    # iteration (HloCostAnalysis visits while bodies ONCE — see DESIGN.md §8)
    unroll_scans: bool = False
    # source provenance, e.g. "[arXiv:2306.05284; hf]"
    source: str = ""

    @property
    def d_attn(self) -> int:
        return self.n_heads * self.d_head

    def n_params(self) -> int:
        """Total parameter count (embedding + blocks + head)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        attn = d * self.d_attn + 2 * d * self.n_kv_heads * self.d_head + self.d_attn * d
        if self.mlp == "swiglu":
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        per_layer = attn + mlp + 2 * d
        if self.moe:
            e_f = self.moe.d_ff
            expert = (3 if self.mlp == "swiglu" else 2) * d * e_f
            per_layer = attn + self.moe.n_experts * expert + d * self.moe.n_experts + 2 * d
        if self.pattern == "rwkv":
            # time-mix ≈ 4.5 d² + lora, channel-mix = 2 d f
            per_layer = int(4.5 * d * d) + 2 * d * f + 2 * d
        if self.pattern == "zamba":
            ssm = self.ssm
            d_in = ssm.expand * d
            per_layer = d * (2 * d_in + 2 * ssm.state + d_in // ssm.head_dim) + d_in * d + 2 * d
        emb = v * d * (1 if self.input_mode == "embeddings" else 2)
        n = per_layer * self.n_layers + emb + d
        if self.pattern == "zamba":  # add the shared block once
            n += 4 * d * self.d_attn + 3 * d * self.d_ff
        return n

    def n_active_params(self) -> int:
        """Active parameters per token (MoE discounts inactive experts)."""
        if not self.moe:
            return self.n_params()
        d = self.d_model
        e_f = self.moe.d_ff
        expert = (3 if self.mlp == "swiglu" else 2) * d * e_f
        inactive = (self.moe.n_experts - self.moe.top_k) * expert * self.n_layers
        return self.n_params() - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str                      # train | prefill | decode
    seq_len: int
    global_batch: int
    microbatch: int | None = None  # gradient-accumulation microbatch (train)


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def smoke_config(cfg: ModelConfig, d_model: int = 64, vocab: int = 128) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests (small layers/width,
    few experts, tiny embeddings), per the brief's smoke-test requirement."""
    kw: dict = dict(
        name=f"{cfg.name}-smoke", d_model=d_model, vocab=vocab,
        n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_head=d_model // 4, d_ff=d_model * 2,
        loss_chunk=32, attn_q_chunk=32, attn_kv_chunk=32, attn_min_block=32,
    )
    if cfg.pattern == "uniform":
        kw["n_layers"] = 2
    elif cfg.pattern == "vlm":
        kw.update(n_layers=6, cross_every=3, n_vision_tokens=8)
    elif cfg.pattern == "zamba":
        kw.update(
            n_layers=8, shared_attn_every=3,
            ssm=SSMConfig(state=16, head_dim=16, expand=2, conv=4, chunk=16),
            n_kv_heads=4,
        )
    elif cfg.pattern == "rwkv":
        kw.update(
            n_layers=2, rwkv=RWKVConfig(head_dim=16, lora_rank=8, chunk=16),
            n_kv_heads=4,
        )
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(n_experts=4, top_k=2, d_ff=d_model, group=64,
                              capacity_factor=cfg.moe.capacity_factor)
    return dataclasses.replace(cfg, **kw)


_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    from . import ALL_ARCHS  # noqa: F401 — ensure modules imported
    return _REGISTRY[name]()


def list_archs() -> list[str]:
    from . import ALL_ARCHS
    return list(ALL_ARCHS)
