"""gemma2-27b [arXiv:2408.00118] — local/global alternating attention,
attention- and final-logit softcapping, pre+post block norms.

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000, head_dim=128
(heads*head_dim != d_model, as in the released model).  local_window=4096.
The alternating pattern is a scanned super-block of (local, global).
Global layers are full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ATTN, ATTN_LOCAL, ModelConfig

CONFIG = ModelConfig(
    name="gemma2_27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    block_pattern=(ATTN_LOCAL, ATTN),
    rope_theta=10_000.0,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    local_window=4096,
    norm="rmsnorm",
    post_norm=True,
    act="gelu",
    tie_embeddings=True,
    sub_quadratic=False,
)
