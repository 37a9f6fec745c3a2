"""Wrapper of the tiled matmul K10 (``csrc/matmul.cu``).

``matmul(x, y)`` is the reference's ``repro.kernels.matmul.ops.matmul``
without the TPU tiling knobs: x [M, K] @ y [K, N] with an fp32
accumulator, the result in x's dtype (float32 or bfloat16).  The
reference's padding of both operands to 128-multiples is not carried over:
the kernel masks the ragged edges, and it reads each operand through its
two strides, so a transposed view goes in without a copy.

For a CPU tensor it returns the plain version (``ref.matmul_ref``); for a
CUDA tensor it launches the kernel or raises.  Launches are counted in
``matmul.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.matmul.ref import matmul_ref

_BN = 128          # output columns per block (csrc/gemm_tile.cuh)
_MAX_GRID_Y = 65535


def matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """K10: x [M, K] @ y [K, N] -> [M, N] in x's dtype, fp32 accumulation;
    x and y of one dtype, any strides."""
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"matmul takes x [M, K] and y [K, N], got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if _build.on_cpu("matmul", x):
        return matmul_ref(x, y)
    dtype = _build.require_cuda_float("matmul", x.device, contiguous=False,
                                      x=x, y=y)
    (M, K), N = x.shape, y.shape[1]
    if max(M, N, K) >= 2 ** 31 or -(-N // _BN) > _MAX_GRID_Y:
        raise ValueError(f"matmul: [{M}, {K}] @ [{K}, {N}] is too large "
                         "for one launch")
    out = torch.empty(M, N, device=x.device, dtype=dtype)
    err = _build.library().matmul_forward(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), M, N, K, *x.stride(),
        *y.stride(), int(dtype == torch.bfloat16),
        _build.stream_of(x.device))
    _build.check("matmul", err)
    matmul.launches += 1
    return out


matmul.launches = 0
