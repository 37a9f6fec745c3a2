"""Plain PyTorch versions of the softmax kernels (f32 math): the row
softmax K4 and the row cross entropy K8 (``repro/kernels/softmax/ref.py``)."""
from __future__ import annotations

import torch


def softmax_ref(x: torch.Tensor) -> torch.Tensor:
    """Row softmax of [N, C], computed in float32, returned in x's dtype."""
    return torch.softmax(x.float(), dim=-1).to(x.dtype)


def softmax_xent_ref(x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Row cross entropy of [N, C] logits against [N] labels, in float32:
    logsumexp(x) - x[label]."""
    xf = x.float()
    gold = torch.gather(xf, 1, labels[:, None])[:, 0]
    return torch.logsumexp(xf, dim=-1) - gold
