"""The port's hand-written CUDA kernels and their wrappers.

K1 (``conv.ops.conv_direct_chwn``), K2 (``conv.ops.conv_im2col_nchw_fused``),
the standalone pools K3a (``pool.ops.pool_chwn``) and K3b
(``pool.ops.pool_nchw``), K4 (``softmax.ops.softmax``), the conv->conv
stacks K5a (``conv.ops.conv_stack_chwn``) and K5b
(``conv.ops.conv_stack_nchw``), the weight gradient K6
(``conv.backward.conv_wgrad``), the pool backwards K7a
(``pool.backward.pool_backward_chwn``) and K7b
(``pool.backward.pool_backward_nchw``), the row cross entropy K8
(``softmax.ops.softmax_xent``), the tiled transposes K9a
(``transpose.ops.transpose2d``) and K9b (``transpose.ops.transpose2d_batched``),
the tiled matmul K10 (``matmul.ops.matmul``, under the matrix-expansion
conv ``conv.ops.conv_im2col_nchw``), the flash attention K11
(``flash_attention.ops.flash_attention``) and the fused unembed + cross
entropy K12 (``crossentropy.ops.fused_xent``).
dgrad has no kernel of its own: it runs on K1/K2.  Each wrapper counts the
kernels it launches; ``launch_counts``/``reset_launch_counts`` read and
zero them.  K1-K7 and K9 also take narrow storage dtypes (bf16; int8 x
into K1 and K2), each a build of its own, and count those launches by
variant as well: ``variant_launch_counts`` reads them as
"<wrapper>.<variant>".  (K10-K12 take bf16 in their one build.)
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels.conv.backward import conv_wgrad
from repro_torch.kernels.conv.ops import (conv_direct_chwn,
                                          conv_im2col_nchw_fused,
                                          conv_stack_chwn, conv_stack_nchw)
from repro_torch.kernels.crossentropy.ops import fused_xent
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.matmul.ops import matmul
from repro_torch.kernels.pool.backward import (pool_backward_chwn,
                                               pool_backward_nchw)
from repro_torch.kernels.pool.ops import pool_chwn, pool_nchw
from repro_torch.kernels.softmax.ops import softmax, softmax_xent
from repro_torch.kernels.transpose.ops import (transpose2d,
                                               transpose2d_batched)

WRAPPERS = {
    "conv_chwn": conv_direct_chwn,
    "conv_nchw": conv_im2col_nchw_fused,
    "softmax": softmax,
    "conv_stack_chwn": conv_stack_chwn,
    "conv_stack_nchw": conv_stack_nchw,
    "pool_chwn": pool_chwn,
    "pool_nchw": pool_nchw,
    "transpose2d": transpose2d,
    "transpose2d_batched": transpose2d_batched,
    "wgrad": conv_wgrad,
    "pool_backward_chwn": pool_backward_chwn,
    "pool_backward_nchw": pool_backward_nchw,
    "softmax_xent": softmax_xent,
    "matmul": matmul,
    "flash_attention": flash_attention,
    "fused_xent": fused_xent,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def variant_launch_counts() -> Dict[str, int]:
    """Launches of each narrow storage variant, as "<wrapper>.<variant>"
    (e.g. "conv_chwn.bf16", "conv_nchw.i8bf16"); each also counts in its
    wrapper's ``launch_counts``."""
    return {f"{name}.{v}": n for name, fn in WRAPPERS.items()
            for v, n in getattr(fn, "variant_launches", {}).items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
        for v in getattr(fn, "variant_launches", {}):
            fn.variant_launches[v] = 0
