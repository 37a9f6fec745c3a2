"""phi3-mini-3.8b [arXiv:2404.14219] — dense decoder, RoPE + SwiGLU + MHA.

32L d_model=3072 32H (kv=32 i.e. MHA) d_ff=8192 vocab=32064.
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="phi3_mini_3p8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    block_pattern=(ATTN,),
    rope_theta=10_000.0,
    norm="rmsnorm",
    act="silu",
    sub_quadratic=False,
)
