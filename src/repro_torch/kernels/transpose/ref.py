"""Plain PyTorch versions of the transpose kernels K9a/K9b."""
from __future__ import annotations

import torch


def transpose2d_ref(x: torch.Tensor) -> torch.Tensor:
    """[M, N] -> [N, M], contiguous."""
    return x.t().contiguous()


def transpose2d_batched_ref(x: torch.Tensor) -> torch.Tensor:
    """[B, M, N] -> [B, N, M], contiguous."""
    return x.transpose(1, 2).contiguous()
