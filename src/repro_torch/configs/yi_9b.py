"""yi-9b [arXiv:2403.04652] — llama-architecture dense GQA decoder.

48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="yi_9b",
    family="dense",
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    block_pattern=(ATTN,),
    rope_theta=10_000.0,
    norm="rmsnorm",
    act="silu",
    sub_quadratic=False,
)
