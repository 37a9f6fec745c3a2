"""Per-channel symmetric int8 quantization for activation storage
(``repro/quant.py``, in PyTorch).

The mixed-dtype planner stores precision-tolerant interior activations as
int8: the producing conv's output is quantized per channel on its way
out, and the consuming conv reads the raw int8 values, widens them to
float32 and accumulates in float32.  Because the scale is per channel and
a convolution contracts over the input channels, the dequant folds
exactly into the weights:

    conv(q * s[ci], w)[co] = sum_ci s[ci] * q[ci] * w[ci, co]
                           = conv(q, s[ci] * w[ci, co])

so the conv kernels (K1, K2) take int8 x with the scaled float weights,
and the scale costs no extra pass over the activation.

Training keeps the carrier in the float dtype and uses the
straight-through estimator (``fake_quant``): the forward value is the
dequantized quantization of x, the gradient passes through unchanged.

These are plain tensor ops on whatever device x is on, as the reference
runs them as plain jnp outside its kernels.  The arithmetic is the
reference's step for step (float32 divide, round half to even, clip), so
the same float32 input gives the same q and scale bit for bit.
"""
from __future__ import annotations

from typing import Tuple

import torch

QMAX = 127.0

# Acceptance tolerance of an int8-storage forward against its float
# reference, on the softmax outputs (so dimensionless): per-channel
# symmetric quantization bounds each stored activation's error by
# scale / 2 = max|a| / 254, and one int8 boundary per interior chain keeps
# the end-to-end drift far below this (the reference's bound, kept).
INT8_FORWARD_ATOL = 2e-2


def _reduce_dims(ndim: int, channel_axis: int) -> Tuple[int, ...]:
    return tuple(a for a in range(ndim) if a != channel_axis % ndim)


def _broadcast(scale: torch.Tensor, ndim: int,
               channel_axis: int) -> torch.Tensor:
    shape = [1] * ndim
    shape[channel_axis % ndim] = -1
    return scale.reshape(shape)


def channel_scale(x: torch.Tensor, channel_axis: int) -> torch.Tensor:
    """Per-channel symmetric scale: max|x| over all non-channel dims / 127,
    a float32 vector of length ``x.shape[channel_axis]`` (never zero: an
    all-zero channel gets scale 1, so dequantize(quantize(0)) == 0)."""
    # |x| and its max are exact in x's own dtype: no float32 copy of x
    amax = torch.amax(torch.abs(x),
                      dim=_reduce_dims(x.dim(), channel_axis)).float()
    return torch.where(amax > 0, amax / QMAX, torch.ones_like(amax))


def quantize(x: torch.Tensor,
             channel_axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (float) -> (int8 values, float32 per-channel scale): the storage
    cast at an int8 boundary."""
    scale = channel_scale(x, channel_axis)
    # a bf16 x divides by the float32 scale in float32 (type promotion),
    # with no float32 copy of x beside the quotient
    q = torch.div(x, _broadcast(scale, x.dim(), channel_axis))
    return q.round_().clamp_(-QMAX, QMAX).to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, channel_axis: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """int8 values + per-channel scale -> a float tensor of ``dtype`` (the
    generic dequant; a conv consumer folds ``scale`` into its weights
    instead)."""
    y = q.float() * _broadcast(scale, q.dim(), channel_axis)
    return y.to(dtype)


def fold_scale_into_weights(w_oihw: torch.Tensor,
                            scale: torch.Tensor) -> torch.Tensor:
    """Fold a per-input-channel activation scale into canonical
    [Co, Ci, F, F] weights: computed in float32, returned in w's dtype
    (for bf16 weights that rounding is part of the result)."""
    return (w_oihw.float() * scale.reshape(1, -1, 1, 1)).to(w_oihw.dtype)


def fake_quant(x: torch.Tensor, channel_axis: int) -> torch.Tensor:
    """Straight-through quantize -> dequantize: the forward value is the
    int8 round trip (what the server stores), the gradient the identity."""
    q, scale = quantize(x, channel_axis)
    xq = dequantize(q, scale, channel_axis, x.dtype)
    return x + (xq - x).detach()
