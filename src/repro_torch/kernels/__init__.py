"""The port's hand-written CUDA kernels and their wrappers.

K1 (``conv.ops.conv_direct_chwn``), K2 (``conv.ops.conv_im2col_nchw_fused``)
and K4 (``softmax.ops.softmax``).  Each wrapper counts the kernels it
launches; ``launch_counts``/``reset_launch_counts`` read and zero them.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels.conv.ops import (conv_direct_chwn,
                                          conv_im2col_nchw_fused)
from repro_torch.kernels.softmax.ops import softmax

WRAPPERS = {
    "conv_chwn": conv_direct_chwn,
    "conv_nchw": conv_im2col_nchw_fused,
    "softmax": softmax,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
