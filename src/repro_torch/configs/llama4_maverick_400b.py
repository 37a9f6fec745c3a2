"""llama4-maverick-400b-a17b [hf:meta-llama/Llama-4 family] — interleaved
dense/MoE decoder, 128 routed experts top-1 + 1 shared expert, early-fusion
multimodal (text backbone here; vision frontend is out of assigned scope).

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1.
MoE on every other layer (super-block = [dense, moe]).  ~400B total / ~17B
active.  Optimizer state kept in bf16 (see DESIGN.md §5 memory budget).
"""
from repro_torch.configs.base import ATTN, ATTN_MOE, ModelConfig

CONFIG = ModelConfig(
    name="llama4_maverick_400b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    block_pattern=(ATTN, ATTN_MOE),
    rope_theta=500_000.0,
    norm="rmsnorm",
    act="silu",
    num_experts=128,
    experts_per_token=1,
    moe_d_ff=8192,
    num_shared_experts=1,
    opt_state_dtype="bfloat16",
    sub_quadratic=False,
)
