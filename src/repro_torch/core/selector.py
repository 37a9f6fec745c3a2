"""Layout assignment records and the plan data model
(``repro/core/selector.py``).

``LayerDesc`` is one network layer as the selector sees it; ``Assignment``
is an unfused per-layer layout plan; ``paper_heuristic_layouts`` is the
paper's §IV.D single-scan assignment.  ``FusedOp`` (one kernel launch of
the fused engine) and ``FusedPlan`` (the ops in order plus the planner's
accounting) are the fused plan's records.  Fields, names and defaults match
the reference field for field, because the port runs the reference
planner's plans, loaded from the plan-cache JSON (``serve.plan_cache``).
The planners themselves (the layout DP ``assign_layouts``, ``plan_fused``
and their cost model) are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from repro_torch.configs.paper_table1 import ConvLayer, PoolLayer
from repro_torch.perfmodel import (Thresholds, select_conv_layout,
                                   select_pool_layout)

# the reference traffic model's default element size
# (``repro/perfmodel/traffic.py``), which a bare LayerDesc carries
DEFAULT_DTYPE_BYTES = 2


@dataclass
class LayerDesc:
    """One network layer as seen by the selector."""
    name: str
    kind: str                       # conv | pool | act | fc | softmax |
                                    # flatten | add | concat | upsample
    conv: Optional[ConvLayer] = None
    pool: Optional[PoolLayer] = None
    out_shape: Tuple[int, ...] = ()   # logical NCHW shape of the output
    dtype_bytes: int = DEFAULT_DTYPE_BYTES   # storage element size
    trainable: bool = True          # False: frozen params, wgrad skipped
    # producer layer indices (-1 is the network input); empty = "the
    # previous layer", the linear default
    inputs: Tuple[int, ...] = ()


@dataclass
class Assignment:
    layouts: List[str]
    transforms: List[int]           # indices i where a transform happens before layer i
    total_s: float
    dtypes: List[str] = field(default_factory=list)  # per-layer storage dtype


def paper_heuristic_layouts(layers: Sequence[LayerDesc],
                            th: Thresholds) -> List[str]:
    """The paper's §IV.D single-scan field assignment (no DP)."""
    out = []
    cur = "NCHW"
    for l in layers:
        if l.kind == "conv" and l.conv is not None:
            cur = select_conv_layout(l.conv, th)
        elif l.kind == "pool":
            cur = select_pool_layout(l.pool)
        out.append(cur)    # act/fc/softmax inherit the incoming layout
    return out


@dataclass(frozen=True)
class FusedOp:
    """One node of the fused execution plan.

    ``layout`` is the layout the kernel computes in; ``src_layout`` /
    ``dst_layout`` are the layouts it consumes/produces (folded re-layouts
    when they differ from ``layout``).  For conv nodes, ``relu`` and
    ``pool_index`` mark the folded epilogue layers.  ``src_dtype`` /
    ``dst_dtype`` are the storage dtypes of the tensors the node reads /
    writes; empty means "the run's dtype".  ``inputs``/``out_index`` carry
    graph edges, ``add_index``/``res_index``/``res_layout`` a residual add
    folded into a conv epilogue, and ``stack_index``/``stack_relu`` a second
    conv fused into the same kernel (conv->conv stack).
    """
    kind: str                       # conv | pool | act | fc | softmax |
                                    # flatten | add | concat | upsample
    index: int                      # primary layer index in the config
    name: str
    layout: str
    src_layout: str
    dst_layout: str
    relu: bool = False
    pool_index: Optional[int] = None
    src_dtype: str = ""
    dst_dtype: str = ""
    inputs: Tuple[int, ...] = ()    # producer layer indices (main input first)
    out_index: int = -1             # layer index whose output this op stores
    add_index: Optional[int] = None   # residual-add layer folded into this op
    res_index: Optional[int] = None   # producer layer of the folded skip tensor
    res_layout: str = ""            # stored layout of the folded skip tensor
    stack_index: Optional[int] = None
    stack_relu: bool = False

    def __post_init__(self):
        # JSON roundtrips tuples as lists; normalize so loaded plans compare
        # equal to freshly made ones
        if not isinstance(self.inputs, tuple):
            object.__setattr__(self, "inputs", tuple(self.inputs))

    @property
    def is_fused(self) -> bool:
        return (self.relu or self.pool_index is not None or
                self.res_index is not None or
                self.stack_index is not None or
                self.src_layout != self.layout or
                self.dst_layout != self.layout)


# one-letter storage-dtype codes for plan signatures (reports)
DTYPE_CODES = {"float32": "f", "bfloat16": "b", "float16": "h", "int8": "8",
               "": "?"}


@dataclass
class FusedPlan:
    layouts: List[str]              # per-layer layout (DP assignment)
    ops: List[FusedOp]              # execution nodes, in order
    transforms: List[int]           # layer indices needing a STANDALONE pass
    total_s: float                  # the planner's modeled seconds
    fused_bytes: int                # modeled HBM bytes, fused engine
    unfused_bytes: int              # same layouts executed unfused
    dtypes: List[str] = field(default_factory=list)  # per-layer storage dtype
    base_dtype: str = ""            # the float dtype non-int8 layers run in
    intermediate_roundtrip_bytes: int = 0

    @property
    def conv_signature(self) -> str:
        """One letter per conv LAYER ('C'HWN / 'N'CHW); a stack op covers
        two conv layers and contributes two letters."""
        return "".join(op.layout[0] * (2 if op.stack_index is not None else 1)
                       for op in self.ops if op.kind == "conv")

    @property
    def dtype_signature(self) -> str:
        """One letter per conv LAYER's output storage dtype (f/b/h/8)."""
        return "".join(DTYPE_CODES.get(op.dst_dtype, "?")
                       * (2 if op.stack_index is not None else 1)
                       for op in self.ops if op.kind == "conv")

    @property
    def stacked_convs(self) -> int:
        return sum(1 for op in self.ops
                   if op.kind == "conv" and op.stack_index is not None)
