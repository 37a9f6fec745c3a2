"""The paper's CNN layer and network descriptors, and the LM-family
architecture and input-shape descriptors.

``ConvSpec`` and ``CNNConfig`` mirror ``repro/configs/base.py`` field for
field, and keep the same class names: ``serve.plan_cache.network_id``
hashes ``repr(cfg.layers)``, so a plan file written by either package
resolves in the other only while the two reprs agree letter for letter.
``ModelConfig``, ``ShapeConfig`` and ``ParallelConfig`` are copies of the
reference's too (each ``repr`` agrees letter for letter, a test holds it).
``param_count``/``active_param_count`` count the port's own parameter tree
(``models.registry``, built on the meta device); an architecture whose
blocks are not ported yet raises there.  ``TrainConfig`` waits for the
LM training slice.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Block kinds of the LM-family stack
# ---------------------------------------------------------------------------
ATTN = "attn"              # global self attention + dense MLP
ATTN_LOCAL = "attn_local"  # sliding-window self attention + dense MLP
ATTN_MOE = "attn_moe"      # global self attention + MoE FFN
MAMBA = "mamba"            # Mamba SSM mixer + dense MLP
MAMBA_MOE = "mamba_moe"    # Mamba SSM mixer + MoE FFN
RWKV = "rwkv"              # RWKV-6 time mix + channel mix
MOE_ONLY = "moe"           # (unused standalone)


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description for the LM-family stack."""

    name: str
    family: str                    # dense | moe | hybrid | ssm | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    # Super-block pattern: the stack is ``num_layers // len(block_pattern)``
    # repetitions of ``block_pattern``.  Entries are block kinds.
    block_pattern: Tuple[str, ...] = (ATTN,)

    # Attention details ------------------------------------------------------
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    attn_logit_softcap: Optional[float] = None   # gemma2: 50.0
    final_logit_softcap: Optional[float] = None  # gemma2: 30.0
    local_window: Optional[int] = None           # sliding-window size
    norm: str = "rmsnorm"                        # rmsnorm | layernorm
    norm_eps: float = 1e-5
    post_norm: bool = False                      # gemma2 uses pre+post norms
    act: str = "silu"                            # silu | gelu
    tie_embeddings: bool = False

    # MoE --------------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: Optional[int] = None               # expert hidden size (defaults d_ff)
    num_shared_experts: int = 0                  # llama4-style shared expert
    router_jitter: float = 0.0
    capacity_factor: float = 1.25

    # Mamba (jamba) -----------------------------------------------------------
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2

    # RWKV-6 ------------------------------------------------------------------
    rwkv_head_dim: int = 64
    rwkv_chunked: bool = False     # chunk-parallel WKV

    # Encoder-decoder (whisper) ----------------------------------------------
    encoder_layers: int = 0
    encoder_seq: int = 0                         # encoder positions (frames)

    # Modality frontend stub --------------------------------------------------
    frontend: Optional[str] = None               # clip_stub | audio_stub | None
    frontend_tokens: int = 0                     # prefix embedding positions

    # Numerics ----------------------------------------------------------------
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"             # bf16 for the >=300B configs

    # Sub-quadratic support: True when long-context decode is admissible.
    sub_quadratic: bool = False

    def __post_init__(self):
        if self.num_layers % len(self.block_pattern) != 0:
            raise ValueError(
                f"{self.name}: num_layers={self.num_layers} not divisible by "
                f"block_pattern of length {len(self.block_pattern)}")

    # -- derived -------------------------------------------------------------
    @property
    def num_periods(self) -> int:
        return self.num_layers // len(self.block_pattern)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff if self.moe_d_ff is not None else self.d_ff

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    def param_count(self) -> int:
        """Analytical parameter count (embedding + blocks + head)."""
        from repro_torch.models import registry as _r  # lazy, avoids cycle
        return _r.param_count(self)

    def active_param_count(self) -> int:
        from repro_torch.models import registry as _r
        return _r.param_count(self, active_only=True)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) column of the assignment grid."""

    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeConfig("train_4k", "train", 4_096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32_768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524_288, 1)

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def shapes_for(cfg: ModelConfig) -> Tuple[ShapeConfig, ...]:
    """The shape set an architecture runs (long_500k only when
    sub-quadratic)."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.sub_quadratic:
        out.append(LONG_500K)
    return tuple(out)


# ---------------------------------------------------------------------------
# Mesh / parallelism
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ParallelConfig:
    """How a model is laid out on the mesh.  On one card only
    ``window_kv_cache`` changes what runs (the step factories read it);
    the server takes its KV layout from ``Server(kv_layout=)``.  The other
    fields are kept so that the two packages' reprs agree."""

    fsdp: bool = True               # shard params/opt over the data axis
    fsdp_pod: bool = False          # additionally shard over the pod axis
    seq_shard_saved: bool = True    # SP: shard saved residuals over model axis
    remat: str = "block"            # none | block | full
    remat_policy: str = "none"      # none | save_moe (keep MoE outs in bwd)
    microbatches: int = 1           # gradient accumulation steps
    accum_dtype: str = "float32"    # grad-accum dtype (bf16 for >=300B cfgs)
    window_kv_cache: bool = False   # local-attn layers cache only the window
    pipeline_stages: int = 1        # >1: GPipe over the pod axis
    grad_compression: str = "none"  # none | bf16 | int8
    scan_layers: bool = True
    # Decode cache layout: auto = let the layout selector pick.
    kv_cache_layout: str = "auto"   # auto | bksd | sbkd


# ---------------------------------------------------------------------------
# The paper's CNNs
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ConvSpec:
    name: str
    kind: str                      # conv | pool | fc | softmax | relu | lrn |
                                   # flatten | add | concat | upsample
    out_channels: int = 0
    kernel: int = 0                # also: upsample factor for kind="upsample"
    stride: int = 1
    pad: int = 0
    pool_op: str = "max"           # max | avg
    fc_out: int = 0
    # Graph edges: names of the producer layers this layer consumes.  Empty
    # means "the previous layer".  ``repr=False`` keeps the linear
    # ``network_id`` fingerprints independent of it; the edge structure is
    # fingerprinted separately (only when present).
    inputs: Tuple[str, ...] = field(default=(), repr=False)


@dataclass(frozen=True)
class CNNConfig:
    name: str
    batch: int
    in_channels: int
    image_hw: int
    num_classes: int
    layers: Tuple[ConvSpec, ...]

    def replace(self, **kw) -> "CNNConfig":
        return dataclasses.replace(self, **kw)
