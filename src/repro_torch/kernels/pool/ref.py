"""Plain PyTorch version of the pool kernels K3a/K3b."""
from __future__ import annotations

from typing import Optional

import torch
from torch.nn import functional as nnf

from repro_torch.core.transform import apply_transform


def pool_ref(x: torch.Tensor, F: int, S: int, op: str = "max",
             layout: str = "CHWN",
             dst_layout: Optional[str] = None) -> torch.Tensor:
    """Max/avg pool of ``x`` (in ``layout``) over its H, W dims, F x F
    windows at stride S, unpadded; the result in ``dst_layout`` (default:
    ``layout``).  Max propagates NaN, as the kernels do."""
    xn = apply_transform(x, layout, "NCHW")
    y = nnf.max_pool2d(xn, F, S) if op == "max" else nnf.avg_pool2d(xn, F, S)
    return apply_transform(y, "NCHW", dst_layout or layout)
