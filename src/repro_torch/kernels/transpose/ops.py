"""Wrappers of the tiled transpose kernel (K9a/K9b, ``csrc/transpose.cu``).

For a CPU tensor each wrapper returns the plain version (``ref.py``); for a
CUDA tensor it launches the kernel or raises.  Launches are counted in
``transpose2d.launches`` and ``transpose2d_batched.launches``; a bf16
launch (the same kernel over 2-byte elements) also in
``variant_launches["bf16"]``.  The reference wrappers' padding to a block
multiple is not carried over: the kernel checks the ragged edges itself.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.transpose.ref import (transpose2d_batched_ref,
                                               transpose2d_ref)


def _launch(wrapper, x: torch.Tensor, B: int, M: int, N: int,
            out_shape) -> torch.Tensor:
    name = wrapper.__name__
    dev, variant = _build.require_cuda_storage(name, x)
    y = torch.empty(out_shape, device=x.device, dtype=x.dtype)
    err = _build.entry("transpose_forward", variant)(
        x.data_ptr(), y.data_ptr(), B, M, N, _build.stream_of(dev))
    _build.check(name, err)
    wrapper.launches += 1
    if variant:
        wrapper.variant_launches[variant] += 1
    return y


def transpose2d(x: torch.Tensor) -> torch.Tensor:
    """K9a: [M, N] -> [N, M] through 32 x 32 shared-memory tiles."""
    if x.dim() != 2:
        raise ValueError(f"transpose2d takes [M, N], got {tuple(x.shape)}")
    if _build.on_cpu("transpose2d", x):
        return transpose2d_ref(x)
    M, N = x.shape
    return _launch(transpose2d, x, 1, M, N, (N, M))


def transpose2d_batched(x: torch.Tensor) -> torch.Tensor:
    """K9b: [B, M, N] -> [B, N, M], the same kernel over a batch of tiles."""
    if x.dim() != 3:
        raise ValueError("transpose2d_batched takes [B, M, N], got "
                         f"{tuple(x.shape)}")
    if _build.on_cpu("transpose2d_batched", x):
        return transpose2d_batched_ref(x)
    B, M, N = x.shape
    return _launch(transpose2d_batched, x, B, M, N, (B, N, M))


transpose2d.launches = 0
transpose2d_batched.launches = 0
transpose2d.variant_launches = {"bf16": 0}
transpose2d_batched.variant_launches = {"bf16": 0}
