"""rwkv6-7b "Finch" [arXiv:2404.05892] — attention-free RNN with
data-dependent decay (time mix) + channel mix.

32L d_model=4096 d_ff=14336 vocab=65536, rwkv head_dim=64 (64 heads).
SSM family -> long_500k RUNS (state is O(1) in sequence length).
The attention-layout machinery is inapplicable (no KV cache); noted in
DESIGN.md §Arch-applicability.
"""
from repro_torch.configs.base import RWKV, ModelConfig

CONFIG = ModelConfig(
    name="rwkv6_7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,            # d_model / rwkv_head_dim
    num_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    block_pattern=(RWKV,),
    norm="layernorm",
    act="silu",
    rwkv_head_dim=64,
    sub_quadratic=True,
)
