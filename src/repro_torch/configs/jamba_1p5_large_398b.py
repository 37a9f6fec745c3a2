"""jamba-1.5-large-398b [arXiv:2403.19887] — hybrid Mamba+attention (1:7
attn:mamba interleave), MoE every other layer, 16 experts top-2.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536.
Super-block (period 8): attention on layer 3 of each period (as in Jamba),
MoE FFN on every odd layer within the period.  Hybrid -> long_500k RUNS
(only 9/72 layers hold a KV cache; mamba state is O(1) in sequence).
Optimizer state kept in bf16 (DESIGN.md §5).
"""
from repro_torch.configs.base import ATTN_MOE, MAMBA, MAMBA_MOE, ModelConfig

# period of 8: [mamba, mamba_moe, mamba, attn_moe, mamba, mamba_moe, mamba, mamba_moe]
_PERIOD = (MAMBA, MAMBA_MOE, MAMBA, "attn_moe", MAMBA, MAMBA_MOE, MAMBA, MAMBA_MOE)

CONFIG = ModelConfig(
    name="jamba_1p5_large_398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    block_pattern=_PERIOD,
    norm="rmsnorm",
    act="silu",
    num_experts=16,
    experts_per_token=2,
    moe_d_ff=24576,
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    opt_state_dtype="bfloat16",
    sub_quadratic=True,
)
