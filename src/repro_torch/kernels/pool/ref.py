"""Plain PyTorch versions of the pool kernels: the forward K3a/K3b
(``pool_ref``) and the backward K7a/K7b (``pool_backward_ref``)."""
from __future__ import annotations

import math
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


def pool_backward_ref(x: torch.Tensor, g: torch.Tensor, F: int, S: int,
                      op: str = "max", layout: str = "CHWN",
                      g_layout: Optional[str] = None,
                      relu_mask: bool = False) -> torch.Tensor:
    """dx of pool(x, F, S, op): x the pool input in ``layout``, g the pooled
    output's gradient in ``g_layout``; dx in ``layout``.  A line-for-line
    copy of the reference's ``_route`` (``repro/kernels/pool/backward.py``):
    max recomputes each window's NaN-propagating maximum and routes the
    window's gradient to its FIRST maximal element in row-major tap order
    (a window holding a NaN routes nothing); avg adds g/F^2 over the
    window; ``relu_mask`` multiplies by (x > 0) afterwards.  Elements under
    no window get 0."""
    ha, wa = (1, 2) if layout == "CHWN" else (2, 3)
    g = apply_transform(g, g_layout or layout, layout).float()
    Ho, Wo = g.shape[ha], g.shape[wa]

    def at(dy: int, dx: int):
        idx = [slice(None)] * x.dim()
        idx[ha] = slice(dy, dy + (Ho - 1) * S + 1, S)
        idx[wa] = slice(dx, dx + (Wo - 1) * S + 1, S)
        return tuple(idx)

    xf = x.float()
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    if op == "avg":
        gavg = g / (F * F)
        for dy in range(F):
            for dx in range(F):
                acc[at(dy, dx)] += gavg
    else:
        mx = torch.full(g.shape, -math.inf, dtype=torch.float32,
                        device=x.device)
        for dy in range(F):
            for dx in range(F):
                mx = torch.maximum(mx, xf[at(dy, dx)])
        claimed = torch.zeros(g.shape, dtype=torch.bool, device=x.device)
        for dy in range(F):
            for dx in range(F):
                take = (xf[at(dy, dx)] == mx) & ~claimed
                claimed = claimed | take
                acc[at(dy, dx)] += torch.where(take, g, 0.0)
    if relu_mask:
        acc = acc * (xf > 0.0)
    return acc.to(x.dtype)
