"""Plain PyTorch version of the row softmax kernel (f32 math)."""
from __future__ import annotations

import torch


def softmax_ref(x: torch.Tensor) -> torch.Tensor:
    """Row softmax of [N, C], computed in float32, returned in x's dtype."""
    return torch.softmax(x.float(), dim=-1).to(x.dtype)
