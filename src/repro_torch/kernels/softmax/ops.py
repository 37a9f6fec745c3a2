"""Wrapper of the row softmax kernel (K4, ``csrc/softmax.cu``).

For a CPU tensor it returns the plain version (``ref.softmax_ref``); for a
CUDA tensor it launches the kernel or raises.  Launches are counted in
``softmax.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.softmax.ref import softmax_ref


def softmax(x: torch.Tensor) -> torch.Tensor:
    """Fused row softmax of a float32 [N, C] matrix (paper §V.B: max,
    shift, exp, sum and normalize in one kernel)."""
    if x.dim() != 2:
        raise ValueError(f"softmax takes [N, C], got {tuple(x.shape)}")
    if _build.on_cpu("softmax", x):
        return softmax_ref(x)
    _build.require_cuda_f32("softmax", x.device, x=x)
    y = torch.empty_like(x)
    rows, cols = x.shape
    err = _build.library().softmax_forward(x.data_ptr(), y.data_ptr(), rows,
                                           cols, _build.stream_of(x.device))
    _build.check("softmax", err)
    softmax.launches += 1
    return y


softmax.launches = 0
