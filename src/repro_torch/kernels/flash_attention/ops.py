"""Wrapper of the flash-attention kernel K11 (``csrc/flash_attention.cu``).

``flash_attention(q, k, v, causal=True)`` is the reference's
``repro.kernels.flash_attention.ops.flash_attention`` without the TPU
tiling knobs: q, k, v [B, H, S, D] or [BH, S, D], scale 1/sqrt(D), the
result in q's dtype (float32 or bfloat16), computed in fp32.  The causal
mask is the kernel's own, top-left (key kpos kept where kpos <= qpos), as
``F.scaled_dot_product_attention(is_causal=True)`` aligns it; the
reference's ``attention_ref`` aligns bottom-right, which differs where
Sq != Sk.  There is no GQA: a caller repeats its KV heads.  Head dims up
to 256 run; a larger one raises.  The reference wrapper's halving of its
block until it divides S is not carried over: the kernel masks the tail.

For a CPU tensor it returns the plain version
(``ref.flash_attention_ref``); for a CUDA tensor it launches the kernel or
raises.  Launches are counted in ``flash_attention.launches``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

MAX_HEAD_DIM = 256
_MAX_GRID_Y = 65535


def _as_3d(name: str, t: torch.Tensor) -> torch.Tensor:
    if t.dim() == 4:
        return t.reshape(t.shape[0] * t.shape[1], t.shape[2], t.shape[3])
    if t.dim() == 3:
        return t
    raise ValueError(f"flash_attention: {name} must be [B, H, S, D] or "
                     f"[BH, S, D], got {tuple(t.shape)}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """K11: softmax(q kᵀ / sqrt(D)) v with an online softmax; q [.., Sq, D],
    k and v [.., Sk, D] with the same leading dims -> q's shape and
    dtype."""
    if q.dim() != k.dim() or k.shape != v.shape or \
            q.shape[:-2] != k.shape[:-2] or q.shape[-1] != k.shape[-1]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    q3, k3, v3 = _as_3d("q", q), _as_3d("k", k), _as_3d("v", v)
    BH, Sq, D = q3.shape
    Sk = k3.shape[1]
    if D > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {D} > {MAX_HEAD_DIM}")
    if _build.on_cpu("flash_attention", q):
        return flash_attention_ref(q3, k3, v3, causal).reshape(q.shape)
    dtype = _build.require_cuda_float("flash_attention", q.device, q=q3,
                                      k=k3, v=v3)
    if Sk < 1 or BH > _MAX_GRID_Y:
        raise ValueError(f"flash_attention: BH={BH}, Sq={Sq}, Sk={Sk} not "
                         "supported in one launch")
    out = torch.empty_like(q3)
    err = _build.library().flash_attention_forward(
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), out.data_ptr(), BH, Sq,
        Sk, D, int(causal), 1.0 / math.sqrt(D), int(dtype == torch.bfloat16),
        _build.stream_of(q.get_device()))
    _build.check("flash_attention", err)
    flash_attention.launches += 1
    return out.reshape(q.shape)


flash_attention.launches = 0
