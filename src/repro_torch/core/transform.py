"""Standalone layout transform (paper §IV.C), as plain tensor code.

``apply_transform`` collapses common dim groups (``layout.plan_transform``)
and runs the minimal permute.  The fused executor only reaches it for a
re-layout that no kernel absorbed; no stock plan has one.  The tiled
transpose kernel that ``repro/core/transform.py`` can dispatch to is not on
the executor's path and is not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.core.layout import plan_transform


def apply_transform(x: torch.Tensor, src: str, dst: str) -> torch.Tensor:
    """Re-layout ``x`` from layout ``src`` to ``dst`` (a contiguous copy)."""
    if src == dst:
        return x
    plan = plan_transform(src, dst)
    if plan.is_identity:
        return x
    xc = x.reshape(plan.collapsed_shape(x.shape))
    yc = xc.permute(plan.perm).contiguous()
    dims = dict(zip(src, x.shape))
    return yc.reshape(tuple(dims[d] for d in dst))
