"""Plain PyTorch version of the fused unembed + cross entropy K12
(``repro/kernels/crossentropy/ref.py``): materialized-logits cross
entropy, in float32."""
from __future__ import annotations

from typing import Optional

import torch


def xent_ref(h: torch.Tensor, table: torch.Tensor, labels: torch.Tensor,
             softcap: Optional[float] = None) -> torch.Tensor:
    """h [T, D], table [V, D], labels [T] -> per-token loss [T] float32:
    logsumexp of the (softcapped) logits h @ tableᵀ minus the gold logit.
    A label outside [0, V) hits no column and its loss is the bare
    logsumexp, as the kernel gives it (the reference's ``xent_ref`` wraps
    a negative label onto the last columns instead; labels in range agree
    with it)."""
    logits = h.float() @ table.float().T
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    V = logits.shape[1]
    labels = labels.long()
    hit = (labels >= 0) & (labels < V)
    gold = torch.gather(logits, 1, labels.clamp(0, V - 1)[:, None])[:, 0]
    return torch.logsumexp(logits, dim=-1) - torch.where(hit, gold, 0.0)
