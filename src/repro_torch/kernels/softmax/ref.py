"""Plain PyTorch versions of the softmax kernels (f32 math): the row
softmax K4, the paper's five-step baseline, and the row cross entropy K8
(``repro/kernels/softmax/ref.py``)."""
from __future__ import annotations

import torch


def softmax_ref(x: torch.Tensor) -> torch.Tensor:
    """Row softmax of [N, C], computed in float32, returned in x's dtype."""
    return torch.softmax(x.float(), dim=-1).to(x.dtype)


def softmax_5step_ref(x: torch.Tensor) -> torch.Tensor:
    """The paper's literal 5 steps as 5 materialized passes."""
    xf = x.float()
    maxv = torch.amax(xf, dim=-1, keepdim=True)         # kernel 1
    midv1 = xf - maxv                                   # kernel 2
    midv2 = torch.exp(midv1)                            # kernel 3
    sumv = torch.sum(midv2, dim=-1, keepdim=True)       # kernel 4
    return (midv2 / sumv).to(x.dtype)                   # kernel 5


def softmax_xent_ref(x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Row cross entropy of [N, C] logits against [N] labels, in float32,
    as the reference's kernel computes it: log(sum(exp(x - max))) + max -
    x[label].  A label outside [0, C) picks no column and its loss is the
    bare logsumexp (the kernel's gold logit is a one-hot sum); a row that
    holds a NaN or +inf, or is all -inf, gives NaN (x - max is NaN there)."""
    xf = x.float()
    C = xf.shape[-1]
    m = torch.amax(xf, dim=-1, keepdim=True)
    lse = torch.log(torch.exp(xf - m).sum(-1)) + m[:, 0]
    inside = (labels >= 0) & (labels < C)
    gold = torch.gather(xf, 1, labels.clamp(0, max(C - 1, 0))[:, None])[:, 0]
    return lse - torch.where(inside, gold, 0.0)
