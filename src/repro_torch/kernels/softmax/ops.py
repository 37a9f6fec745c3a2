"""Wrappers of the softmax kernels (``csrc/softmax.cu``): the row softmax
K4 (``softmax``) and the row cross entropy K8 (``softmax_xent``).

For a CPU tensor each returns the plain version (``ref.softmax_ref``,
``ref.softmax_xent_ref``); for a CUDA tensor it launches its kernel or
raises.  Launches are counted in ``softmax.launches`` and
``softmax_xent.launches`` (a bf16 launch also in the wrapper's
``variant_launches["bf16"]``).  K4 takes float32 or bf16 (computed in
float32, rounded once to x's dtype); K8 takes float32 or bf16 logits and
gives a float32 loss.  ``softmax`` is differentiable: the gradient is
the reference's closed form on the saved output, in plain tensor ops.

Nothing in either wrapper reads device memory on the host, so a launch
never waits for the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.softmax.ref import softmax_ref, softmax_xent_ref


def _softmax(x: torch.Tensor) -> torch.Tensor:
    if x.dim() != 2:
        raise ValueError(f"softmax takes [N, C], got {tuple(x.shape)}")
    if _build.on_cpu("softmax", x):
        return softmax_ref(x)
    dev, variant = _build.require_cuda_storage("softmax", x)
    rows, cols = x.shape
    y = torch.empty_like(x)
    _build.check("softmax", _build.entry("softmax_forward", variant)(
        x.data_ptr(), y.data_ptr(), rows, cols, _build.stream_of(dev)))
    softmax.launches += 1
    if variant:
        softmax.variant_launches[variant] += 1
    return y


class _SoftmaxFn(torch.autograd.Function):
    """K4 with the closed-form softmax gradient on its saved output (the
    reference's ``_softmax_bwd``): dx = (g - sum(g * y)) * y."""

    @staticmethod
    def forward(ctx, x):
        y = _softmax(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        yf, gf = y.float(), g.float()
        return ((gf - (gf * yf).sum(-1, keepdim=True)) * yf).to(y.dtype)


def softmax(x: torch.Tensor) -> torch.Tensor:
    """Fused row softmax of a float32 or bf16 [N, C] matrix (paper §V.B:
    max, shift, exp, sum and normalize in one kernel); differentiable."""
    if x.requires_grad and torch.is_grad_enabled():
        return _SoftmaxFn.apply(x)
    return _softmax(x)


def softmax_xent(x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """K8: row-wise cross entropy of float32 or bf16 logits x [N, C]
    against int64 ``labels`` [N]: ``lse(x) - x[label]`` -> [N] float32,
    computed in float32 (bf16 widened, as the reference's kernel does).  A label outside
    [0, C) picks no column and its loss is the bare logsumexp, as the
    reference's kernel gives it (its gold logit is a one-hot sum); a row
    that holds a NaN or +inf, or is all -inf, gives NaN, as there."""
    if x.dim() != 2 or labels.shape != (x.shape[0],):
        raise ValueError(f"softmax_xent takes x [N, C] and labels [N], got "
                         f"{tuple(x.shape)} and {tuple(labels.shape)}")
    if labels.dtype is not torch.int64:
        raise TypeError(f"softmax_xent: labels are {labels.dtype}, not int64")
    if labels.get_device() != x.get_device():
        raise ValueError(f"softmax_xent: labels on {labels.device}, x on "
                         f"{x.device}")
    if _build.on_cpu("softmax_xent", x):
        return softmax_xent_ref(x, labels)
    dev, variant = _build.require_cuda_storage("softmax_xent", x)
    if not labels.is_contiguous():
        raise ValueError("softmax_xent: labels must be contiguous")
    rows, cols = x.shape
    loss = torch.empty(rows, device=x.device, dtype=torch.float32)
    _build.check("softmax_xent", _build.entry("softmax_xent_forward", variant)(
        x.data_ptr(), labels.data_ptr(), loss.data_ptr(), rows, cols,
        _build.stream_of(dev)))
    softmax_xent.launches += 1
    if variant:
        softmax_xent.variant_launches[variant] += 1
    return loss


softmax.launches = 0
softmax.variant_launches = {"bf16": 0}
softmax_xent.launches = 0
softmax_xent.variant_launches = {"bf16": 0}
