"""Plain PyTorch versions of attention (f32 math).

``flash_attention_ref`` is the plain version of K11 (``ops.flash_attention``
runs it for CPU tensors, and the card tests hold the kernel against it):
the TPU kernel's own causal mask, top-left (key kpos kept where kpos <=
qpos, both counted from 0), and its scale-after-product order.
``attention_ref`` is a copy of the reference's oracle
(``repro/kernels/flash_attention/ref.py``), which aligns a causal mask
bottom-right (``tril(k=Sk-Sq)``); the two agree where Sq == Sk and differ
elsewhere, and the tests show both.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _attend(q, k, v, s, mask):
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """q [BH, Sq, D], k and v [BH, Sk, D] -> [BH, Sq, D] in q's dtype, the
    function K11 computes."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * (
        1.0 / math.sqrt(q.shape[-1]))
    mask = None
    if causal:
        Sq, Sk = s.shape[-2:]
        mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device).tril()
    return _attend(q, k, v, s, mask)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """The reference's oracle: q, k, v [BH, S, D]; a causal mask aligned
    bottom-right."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / math.sqrt(
        q.shape[-1])
    mask = None
    if causal:
        Sq, Sk = s.shape[-2:]
        mask = torch.ones(Sq, Sk, dtype=torch.bool,
                          device=q.device).tril(diagonal=Sk - Sq)
    return _attend(q, k, v, s, mask)
