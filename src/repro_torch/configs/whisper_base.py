"""whisper-base [arXiv:2212.04356] — encoder-decoder; conv audio frontend is a
STUB (``input_specs`` provides precomputed mel-frame embeddings).

6L encoder + 6L decoder, d_model=512 8H (kv=8) d_ff=2048 vocab=51865.
The released model caps at 1500 encoder / 448 decoder positions; the assigned
32k shapes exercise the backbone mechanically (documented).  Full attention
-> long_500k skipped.  Decoder caches self-attention KV per step and
cross-attention KV once at prefill.
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="whisper_base",
    family="encdec",
    num_layers=6,                 # decoder layers
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    block_pattern=(ATTN,),
    norm="layernorm",
    act="gelu",
    encoder_layers=6,
    encoder_seq=1500,
    frontend="audio_stub",
    sub_quadratic=False,
)
