"""Standalone layout transform (paper §IV.C).

``apply_transform`` collapses common dim groups (``layout.plan_transform``)
and runs the minimal transpose.  With ``use_kernel=True`` a collapsed 2-D
transpose goes to the tiled transpose kernel K9a and a batched one (a
3-axis permutation that keeps its leading group, e.g. NCHW -> NHWC) to
K9b (``repro_torch.kernels.transpose``), as ``use_pallas`` does in
``repro/core/transform.py``; on a CUDA tensor that launches the kernel or
raises, and a permutation neither kernel covers raises too.  The executors
set ``use_kernel`` from their engine: "cuda" takes the kernels, "torch"
takes ``use_kernel=False``, which is ``permute().contiguous()``, the
counterpart of the reference's XLA transpose.  Both are differentiable:
the gradient of a re-layout is the inverse re-layout, on the same kernels
when ``use_kernel`` (``_TransformFn``).
"""
from __future__ import annotations

import torch

from repro_torch.core.layout import perm_between, plan_transform


class _TransformFn(torch.autograd.Function):
    """A re-layout on the transpose kernels, whose gradient is the inverse
    re-layout on them."""

    @staticmethod
    def forward(ctx, x, src, dst):
        ctx.conf = (src, dst)
        return _relayout(x, src, dst, True)

    @staticmethod
    def backward(ctx, g):
        src, dst = ctx.conf
        return _relayout(g.contiguous(), dst, src, True), None, None


def apply_transform(x: torch.Tensor, src: str, dst: str, *,
                    use_kernel: bool = False) -> torch.Tensor:
    """Re-layout ``x`` from layout ``src`` to ``dst`` (a contiguous copy)."""
    if src == dst or plan_transform(src, dst).is_identity:
        return x
    if use_kernel and torch.is_grad_enabled() and x.requires_grad:
        return _TransformFn.apply(x, src, dst)
    return _relayout(x, src, dst, use_kernel)


def _relayout(x: torch.Tensor, src: str, dst: str,
              use_kernel: bool) -> torch.Tensor:
    plan = plan_transform(src, dst)
    if use_kernel and x.device.type != "cpu" and not x.is_contiguous():
        # a reshape would copy it: the permute the kernel stands for
        raise ValueError(f"{src} -> {dst}: the transpose kernel takes a "
                         "contiguous x")
    xc = x.reshape(plan.collapsed_shape(x.shape))
    if use_kernel and plan.is_2d_transpose:
        # imported here: the kernels package imports this module
        from repro_torch.kernels.transpose.ops import transpose2d
        yc = transpose2d(xc)
    elif use_kernel and len(plan.perm) == 3 and plan.perm[0] == 0:
        from repro_torch.kernels.transpose.ops import transpose2d_batched
        yc = transpose2d_batched(xc)
    elif use_kernel and x.device.type != "cpu":
        raise NotImplementedError(
            f"{src} -> {dst} collapses to the permutation {plan.perm}, "
            "which no transpose kernel covers")
    else:
        yc = xc.permute(plan.perm).contiguous()
    dims = dict(zip(src, x.shape))
    return yc.reshape(tuple(dims[d] for d in dst))


def naive_transform(x: torch.Tensor, src: str, dst: str) -> torch.Tensor:
    """The paper's Fig. 7a baseline: direct 4-D permute, no collapsing."""
    return x.permute(perm_between(src, dst)).contiguous()
