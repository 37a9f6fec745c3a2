"""qwen2-7b [arXiv:2407.10671] — dense GQA decoder with QKV bias.

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.
Note 28 heads is NOT divisible by the 16-way model axis: GSPMD pads the head
dim (verified); the roofline table quantifies the padding waste.
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="qwen2_7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    block_pattern=(ATTN,),
    rope_theta=1_000_000.0,
    qkv_bias=True,
    norm="rmsnorm",
    act="silu",
    sub_quadratic=False,
)
