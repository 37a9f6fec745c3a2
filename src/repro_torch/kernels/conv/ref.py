"""Plain PyTorch version of the fused conv block both conv kernels compute.

permute to NCHW -> conv2d (+bias) -> +residual -> ReLU -> max/avg pool ->
permute to the destination layout.  The wrappers in ``ops.py`` run it for
tensors on the CPU, and the tests and ``chip_smoke.py`` hold the kernels
against it.  On the card, compare it with TF32 off
(``torch.backends.cudnn.allow_tf32 = False``): cuDNN's default keeps only
about three digits of an fp32 conv.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.layout import perm_between


def conv_ref(x: torch.Tensor, w_oihw: torch.Tensor, stride: int = 1,
             pad: int = 0, *, bias: Optional[torch.Tensor] = None,
             relu: bool = False, pool: Optional[Tuple[int, int, str]] = None,
             res: Optional[torch.Tensor] = None, res_layout: str = "NCHW",
             src_layout: str = "NCHW", dst_layout: str = "NCHW"
             ) -> torch.Tensor:
    """x in ``src_layout``; w canonical [Co, Ci, F, F]; ``res`` (the skip
    tensor of a folded residual add, conv-output shape) in ``res_layout``.
    Returns the result in ``dst_layout``, pooled when ``pool`` is
    ``(F, S, "max" | "avg")``."""
    y = F.conv2d(x.permute(perm_between(src_layout, "NCHW")), w_oihw,
                 bias, stride=stride, padding=pad)
    if res is not None:
        y = y + res.permute(perm_between(res_layout, "NCHW"))
    if relu:
        y = torch.relu(y)
    if pool is not None:
        pF, pS, op = pool
        y = (F.max_pool2d(y, pF, pS) if op == "max"
             else F.avg_pool2d(y, pF, pS))
    return y.permute(perm_between("NCHW", dst_layout)).contiguous()
