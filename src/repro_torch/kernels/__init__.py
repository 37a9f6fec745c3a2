"""The port's hand-written CUDA kernels and their wrappers.

K1 (``conv.ops.conv_direct_chwn``), K2 (``conv.ops.conv_im2col_nchw_fused``),
K4 (``softmax.ops.softmax``) and the conv->conv stacks K5a
(``conv.ops.conv_stack_chwn``) and K5b (``conv.ops.conv_stack_nchw``).
Each wrapper counts the kernels it launches; ``launch_counts``/
``reset_launch_counts`` read and zero them.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels.conv.ops import (conv_direct_chwn,
                                          conv_im2col_nchw_fused,
                                          conv_stack_chwn, conv_stack_nchw)
from repro_torch.kernels.softmax.ops import softmax

WRAPPERS = {
    "conv_chwn": conv_direct_chwn,
    "conv_nchw": conv_im2col_nchw_fused,
    "softmax": softmax,
    "conv_stack_chwn": conv_stack_chwn,
    "conv_stack_nchw": conv_stack_nchw,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
