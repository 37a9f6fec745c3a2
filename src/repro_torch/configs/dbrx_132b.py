"""dbrx-132b [hf:databricks/dbrx-base] — fine-grained MoE, every layer MoE.

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352, 16 experts top-4.
~132B total / ~36B active.
"""
from repro_torch.configs.base import ATTN_MOE, ModelConfig

CONFIG = ModelConfig(
    name="dbrx_132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    block_pattern=(ATTN_MOE,),
    rope_theta=500_000.0,
    norm="layernorm",
    act="silu",
    num_experts=16,
    experts_per_token=4,
    sub_quadratic=False,
)
