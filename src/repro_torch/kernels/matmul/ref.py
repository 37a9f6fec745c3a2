"""Plain PyTorch version of the tiled matmul K10
(``repro/kernels/matmul/ref.py``)."""
from __future__ import annotations

from typing import Optional

import torch


def matmul_ref(x: torch.Tensor, y: torch.Tensor,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x [M, K] @ y [K, N] computed in float32, returned in ``out_dtype``
    (default x's dtype).  On the card, compare with TF32 off
    (``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default)."""
    return (x.float() @ y.float()).to(out_dtype or x.dtype)
