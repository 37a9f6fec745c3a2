"""Model-level accounting (``repro/models/registry.py``): parameter counts
and analytical MODEL_FLOPS.

The count walks the port's own parameter tree built on the meta device
(shapes only, nothing allocated), with the reference's key rules over
paths written as ``jax.tree_util.keystr`` writes them (``['embed']``,
``['blocks'][0]['b0']['attn']['wq']``), for all ten architectures.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig


def leaves_with_path(tree, prefix: str = ""):
    """(path, leaf) for every tensor of a parameter tree, the path as
    ``jax.tree_util.keystr`` writes it."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves_with_path(v, f"{prefix}['{k}']")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _leaf_sizes(cfg: ModelConfig):
    from repro_torch.models.transformer import init_params
    tree = init_params(cfg, device=torch.device("meta"))
    for path, leaf in leaves_with_path(tree):
        yield path, math.prod(leaf.shape)


def param_count(cfg: ModelConfig, active_only: bool = False,
                include_embed: bool = True) -> int:
    """Exact parameter count from the parameter tree's shapes.

    ``active_only``: MoE expert tensors are scaled by k/E (top-k routing).
    """
    total = 0.0
    frac = ((cfg.experts_per_token / cfg.num_experts) if cfg.num_experts
            else 1.0)
    for key, n in _leaf_sizes(cfg):
        if not include_embed and ("'embed'" in key or "'unembed'" in key):
            continue
        if active_only and "'moe'" in key and any(
                w in key for w in ("w_gate", "w_up", "w_down")) \
                and "'shared'" not in key:
            n = n * frac
        total += n
    return int(total)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Analytical 'useful' FLOPs for one step of the given shape.

    Dense/MoE LM convention: 6·N_active·tokens for training (fwd+bwd),
    2·N_active·tokens for inference, plus the attention score/AV term
    (12·S·q_dim per token per attention layer for causal training).
    N excludes the embedding *lookup* but includes the unembed matmul.
    """
    n_active = param_count(cfg, active_only=True, include_embed=False)
    # unembed/tied-head matmul counts as compute
    n_active += cfg.vocab_size * cfg.d_model
    tokens = shape.tokens if shape.kind != "decode" else shape.global_batch
    mult = 6.0 if shape.kind == "train" else 2.0
    flops = mult * n_active * tokens

    # attention quadratic term
    n_attn = sum(1 for k in cfg.block_pattern if k.startswith("attn"))
    n_attn_layers = n_attn * cfg.num_periods
    if cfg.family == "encdec":
        n_attn_layers += cfg.encoder_layers
    qk_dim = cfg.num_heads * cfg.head_dim
    if shape.kind == "train":
        # causal: ~S/2 context per token, fwd+bwd(2x) for QK^T and AV
        flops += (6.0 * 2 * qk_dim * (shape.seq_len / 2) * tokens
                  * n_attn_layers / 1)
    elif shape.kind == "prefill":
        flops += (2.0 * 2 * qk_dim * (shape.seq_len / 2) * tokens
                  * n_attn_layers)
    else:  # decode: each new token attends to full cache
        flops += 2.0 * 2 * qk_dim * shape.seq_len * tokens * n_attn_layers
    return flops
