"""The LM stack (``repro/models``): layers, the transformer, accounting,
and the carrier of the reference's weights."""
from repro_torch.models.transformer import (  # noqa: F401
    CLIP_DIM, decode_step, forward, init_cache, init_params, logits_fwd,
    prefill)
