"""Wrappers of the tiled transpose kernel (K9a/K9b, ``csrc/transpose.cu``).

For a CPU tensor each wrapper returns the plain version (``ref.py``); for a
CUDA tensor it launches the kernel or raises.  Launches are counted in
``transpose2d.launches`` and ``transpose2d_batched.launches``.  The
reference wrappers' padding to a block multiple is not carried over: the
kernel checks the ragged edges itself.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.transpose.ref import (transpose2d_batched_ref,
                                               transpose2d_ref)


def _launch(name: str, x: torch.Tensor, B: int, M: int, N: int,
            out_shape) -> torch.Tensor:
    dev = _build.require_cuda_f32(name, x)
    y = torch.empty(out_shape, device=x.device, dtype=x.dtype)
    err = _build.library().transpose_forward(
        x.data_ptr(), y.data_ptr(), B, M, N, _build.stream_of(dev))
    _build.check(name, err)
    return y


def transpose2d(x: torch.Tensor) -> torch.Tensor:
    """K9a: [M, N] -> [N, M] through 32 x 32 shared-memory tiles."""
    if x.dim() != 2:
        raise ValueError(f"transpose2d takes [M, N], got {tuple(x.shape)}")
    if _build.on_cpu("transpose2d", x):
        return transpose2d_ref(x)
    M, N = x.shape
    y = _launch("transpose2d", x, 1, M, N, (N, M))
    transpose2d.launches += 1
    return y


def transpose2d_batched(x: torch.Tensor) -> torch.Tensor:
    """K9b: [B, M, N] -> [B, N, M], the same kernel over a batch of tiles."""
    if x.dim() != 3:
        raise ValueError("transpose2d_batched takes [B, M, N], got "
                         f"{tuple(x.shape)}")
    if _build.on_cpu("transpose2d_batched", x):
        return transpose2d_batched_ref(x)
    B, M, N = x.shape
    y = _launch("transpose2d_batched", x, B, M, N, (B, N, M))
    transpose2d_batched.launches += 1
    return y


transpose2d.launches = 0
transpose2d_batched.launches = 0
