"""The paper's (Ct, Nt) layout thresholds and its per-layer rule (§IV.A-B),
as ``repro/perfmodel/calibration.py`` states them."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.configs.paper_table1 import ConvLayer, PoolLayer


@dataclass(frozen=True)
class Thresholds:
    Ct: int
    Nt: int


def select_conv_layout(l: ConvLayer, th: Thresholds) -> str:
    """Verbatim paper heuristic (§IV.A): CHWN for few input channels or a
    large batch, NCHW otherwise."""
    if l.Ci < th.Ct:
        return "CHWN"
    if l.N >= th.Nt:
        return "CHWN"
    return "NCHW"


def select_pool_layout(l: Optional[PoolLayer] = None) -> str:
    """Paper §IV.B: pooling always prefers CHWN (its windows slide along
    the contiguous W in NCHW, which the GPU reads uncoalesced)."""
    return "CHWN"
