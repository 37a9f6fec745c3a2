"""phi-3-vision-4.2b — phi3-mini text backbone + CLIP vision frontend (stub).

[hf:microsoft/Phi-3-vision-128k-instruct]  32L d_model=3072 32H (MHA kv=32)
d_ff=8192 vocab=32064.  The vision tower is a STUB: ``input_specs`` provides
precomputed patch embeddings that are concatenated in front of the token
embeddings (early fusion).  Pure full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="phi3_vision_4p2b",
    family="vlm",
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
    frontend="clip_stub",
    frontend_tokens=576,          # 24x24 CLIP-L patch grid per image
    sub_quadratic=False,
)
