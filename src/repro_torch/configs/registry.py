"""Registry: ``--arch <id>`` resolution + reduced smoke-test variants.

A copy of ``repro/configs/registry.py`` over the port's copies of the ten
architecture modules (``repro_torch/configs/<arch>.py``).
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig

# id -> module name (one module per assigned architecture)
ARCH_MODULES: Dict[str, str] = {
    "phi3_vision_4p2b": "repro_torch.configs.phi3_vision_4p2b",
    "qwen2_7b": "repro_torch.configs.qwen2_7b",
    "yi_9b": "repro_torch.configs.yi_9b",
    "phi3_mini_3p8b": "repro_torch.configs.phi3_mini_3p8b",
    "gemma2_27b": "repro_torch.configs.gemma2_27b",
    "dbrx_132b": "repro_torch.configs.dbrx_132b",
    "llama4_maverick_400b": "repro_torch.configs.llama4_maverick_400b",
    "jamba_1p5_large_398b": "repro_torch.configs.jamba_1p5_large_398b",
    "rwkv6_7b": "repro_torch.configs.rwkv6_7b",
    "whisper_base": "repro_torch.configs.whisper_base",
}

ARCH_IDS = tuple(ARCH_MODULES)

# Friendly aliases (dashes etc.)
_ALIASES = {name.replace("_", "-"): name for name in ARCH_MODULES}
_ALIASES.update({
    "phi-3-vision-4.2b": "phi3_vision_4p2b",
    "qwen2-7b": "qwen2_7b",
    "yi-9b": "yi_9b",
    "phi3-mini-3.8b": "phi3_mini_3p8b",
    "gemma2-27b": "gemma2_27b",
    "dbrx-132b": "dbrx_132b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b",
    "jamba-1.5-large-398b": "jamba_1p5_large_398b",
    "rwkv6-7b": "rwkv6_7b",
    "whisper-base": "whisper_base",
})


def get_config(arch: str) -> ModelConfig:
    key = _ALIASES.get(arch, arch)
    if key not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCH_MODULES)}")
    return importlib.import_module(ARCH_MODULES[key]).CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {name: get_config(name) for name in ARCH_MODULES}


def reduced_config(cfg: ModelConfig, periods: int = 2) -> ModelConfig:
    """Smoke-test variant of the same family: tiny width, few experts, small
    vocab, short frontends — but the SAME block pattern and code paths."""
    pat = cfg.block_pattern
    n_heads = 4
    head_dim = 16
    ratio = max(1, cfg.num_heads // cfg.num_kv_heads)
    kv = max(1, n_heads // ratio)
    d_model = n_heads * head_dim  # 64
    return cfg.replace(
        name=cfg.name + "_smoke",
        num_layers=periods * len(pat),
        d_model=d_model,
        num_heads=n_heads,
        num_kv_heads=kv,
        head_dim=head_dim,
        d_ff=4 * d_model,
        vocab_size=256,
        local_window=min(cfg.local_window, 8) if cfg.local_window else None,
        num_experts=min(cfg.num_experts, 4),
        experts_per_token=min(cfg.experts_per_token, 2),
        # drop-free routing so decode == teacher-forced forward in tests
        # (capacity depends on token count, which differs between the two)
        capacity_factor=8.0,
        moe_d_ff=4 * d_model if cfg.moe_d_ff else None,
        mamba_d_state=8,
        rwkv_head_dim=16,
        encoder_layers=min(cfg.encoder_layers, 2),
        encoder_seq=min(cfg.encoder_seq, 16) if cfg.encoder_seq else 0,
        frontend_tokens=min(cfg.frontend_tokens, 8) if cfg.frontend_tokens else 0,
        opt_state_dtype="float32",
    )
