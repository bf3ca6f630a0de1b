"""The port's LM configs (``repro_torch.configs``) against the reference's:
every field of every arch, its smoke config, the shapes and the registry
are equal; then the port-only mirrors of ``tests/test_archs_smoke.py``'s
config tests."""

import dataclasses

import pytest

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro_torch import configs
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.configs import base


def test_registry_and_shapes_equal_reference():
    assert configs.ALL_ARCHS == jconfigs.ALL_ARCHS
    assert base.list_archs() == jbase.list_archs()
    assert {k: dataclasses.asdict(v) for k, v in base.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_config_equals_reference(arch):
    cfg, ref = get_config(arch), jconfigs.get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert dataclasses.asdict(base.smoke_config(cfg)) == \
        dataclasses.asdict(jbase.smoke_config(ref))
    assert (cfg.n_params(), cfg.n_active_params(), cfg.d_attn) == \
        (ref.n_params(), ref.n_active_params(), ref.d_attn)


def test_stablelm_source_keeps_the_reference_text():
    # the reference names stablelm-2-1_6b as the 12B config's source; kept
    assert get_config("stablelm-12b").source == "[hf:stabilityai/stablelm-2-1_6b; hf]"


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_full_config_matches_assignment(arch):
    """Pin the exact published hyperparameters."""
    cfg = get_config(arch)
    expect = {
        "musicgen-medium": (48, 1536, 24, 24, 6144, 2048),
        "dbrx-132b": (40, 6144, 48, 8, 10752, 100352),
        "granite-moe-1b-a400m": (24, 1024, 16, 8, 512, 49155),
        "nemotron-4-15b": (32, 6144, 48, 8, 24576, 256000),
        "nemotron-4-340b": (96, 18432, 96, 8, 73728, 256000),
        "deepseek-coder-33b": (62, 7168, 56, 8, 19200, 32256),
        "stablelm-12b": (40, 5120, 32, 8, 13824, 100352),
        "llama-3.2-vision-90b": (100, 8192, 64, 8, 28672, 128256),
        "zamba2-1.2b": (38, 2048, 32, 32, 8192, 32000),
        "rwkv6-7b": (32, 4096, 64, 64, 14336, 65536),
    }[arch]
    got = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab)
    assert got == expect, (arch, got, expect)
    if arch == "dbrx-132b":
        assert (cfg.moe.n_experts, cfg.moe.top_k) == (16, 4)
    if arch == "granite-moe-1b-a400m":
        assert (cfg.moe.n_experts, cfg.moe.top_k) == (32, 8)
    if arch == "zamba2-1.2b":
        assert cfg.ssm.state == 64 and cfg.sub_quadratic
    if arch == "rwkv6-7b":
        assert cfg.sub_quadratic and cfg.pattern == "rwkv"
    if arch == "llama-3.2-vision-90b":
        assert cfg.pattern == "vlm"


def test_param_counts_plausible():
    """n_params() sits near the advertised sizes."""
    expect_b = {
        "dbrx-132b": (110, 150), "nemotron-4-340b": (300, 380),
        "deepseek-coder-33b": (28, 38), "stablelm-12b": (10, 14),
        "llama-3.2-vision-90b": (75, 100), "rwkv6-7b": (6, 9),
        "nemotron-4-15b": (13, 18),
    }
    for arch, (lo, hi) in expect_b.items():
        n = get_config(arch).n_params() / 1e9
        assert lo <= n <= hi, (arch, n)
    n_active = get_config("dbrx-132b").n_active_params() / 1e9
    assert 30 <= n_active <= 45, n_active
