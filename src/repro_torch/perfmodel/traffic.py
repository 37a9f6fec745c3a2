"""Device-memory bytes of the conv backward pass (training), as
``repro/perfmodel/traffic.py`` prices them.

A partial copy: only the backward-direction byte entries (``dilated_hw``,
``dgrad_bytes``, ``wgrad_bytes``, ``conv_backward_bytes``), which are pure
shape arithmetic with no lane tiling and no TPU rates.  The executors'
``RunStats.bwd_hbm_bytes`` is built from them, so both packages report the
same backward bytes for the same plan.
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.configs.paper_table1 import ConvLayer
from repro_torch.shapes import pool_out_hw

# the reference's default element size (bf16); the executors always pass
# the element size of the tensors they run
DEFAULT_DTYPE_BYTES = 2


def dilated_hw(l: ConvLayer) -> int:
    """Rows of the dilated+padded output gradient the transposed-conv dgrad
    consumes: stride-S dilation re-inflates Ho to the input scale, and the
    F-1 border re-centres the rotated filter."""
    return (l.out_hw - 1) * l.S + 1 + 2 * (l.F - 1)


def dgrad_bytes(l: ConvLayer, layout: str = "CHWN",
                dtype_bytes: int = DEFAULT_DTYPE_BYTES) -> int:
    """Bytes of the input-gradient conv.  For S > 1 the dilated gradient
    is materialized (one write) and re-read by the conv engine on top of the
    original gradient read; S == 1 streams the gradient directly."""
    ho = l.out_hw
    out_b = l.N * l.Co * ho * ho * dtype_bytes
    in_b = l.N * l.Ci * l.HW * l.HW * dtype_bytes
    w_b = l.Co * l.Ci * l.F * l.F * dtype_bytes
    if l.S > 1:
        hd = dilated_hw(l)
        g_b = out_b + 2 * l.N * l.Co * hd * hd * dtype_bytes
    else:
        g_b = out_b
    return g_b + w_b + in_b


def wgrad_bytes(l: ConvLayer, layout: str = "CHWN",
                dtype_bytes: int = DEFAULT_DTYPE_BYTES,
                native: bool = True) -> int:
    """Bytes of the weight-gradient contraction.  The native kernel keeps
    the im2col patch matrix virtual for either layout; the decomposed NCHW
    path (Caffe-style) re-materializes it."""
    ho = l.out_hw
    base = (l.N * l.Ci * l.HW * l.HW + l.N * l.Co * ho * ho +
            l.Co * l.Ci * l.F * l.F) * dtype_bytes
    if not native and layout == "NCHW":
        base += 2 * l.N * ho * ho * l.Ci * l.F * l.F * dtype_bytes
    return base


def conv_backward_bytes(l: ConvLayer, layout: str = "CHWN",
                        dtype_bytes: int = DEFAULT_DTYPE_BYTES, *,
                        relu: bool = False,
                        pool: Optional[Tuple[int, int]] = None,
                        bias: bool = False, fused: bool = True,
                        trainable: bool = True,
                        residual: bool = False) -> int:
    """Bytes of the backward pass of a conv[->add][->relu][->pool] chain.

    Fused (the kernels' autograd Functions): the forward kernel stashed the
    pre-pool activation (one extra write + one read), the pool backward and
    the ReLU mask run as ONE kernel, and the reversed re-layout chain folds
    into the dgrad/wgrad I/O maps.  A folded residual add fans the masked
    gradient out to the skip branch: one extra dres write fused, a
    read+write pair for the standalone fan-out unfused.  Unfused (plain
    autograd): every backward stage makes its own round trips, and NCHW
    wgrad re-materializes the patch matrix.  ``trainable=False`` drops the
    wgrad contraction (frozen weights)."""
    ho = l.out_hw
    out_b = l.N * l.Co * ho * ho * dtype_bytes
    fin_b = out_b
    if pool is not None:
        pho = pool_out_hw(ho, pool[0], pool[1])
        fin_b = l.N * l.Co * pho * pho * dtype_bytes
    total = dgrad_bytes(l, layout, dtype_bytes)
    if trainable:
        total += wgrad_bytes(l, layout, dtype_bytes, native=fused)
    if fused:
        if pool is not None:
            total += 2 * out_b            # activation stash: write + read
            total += fin_b + out_b        # pool(+mask) bwd: read g, write dz
        elif relu:
            total += 2 * out_b            # mask from saved y: read + write
        if residual:
            total += out_b                # dres: the masked g written once
    else:
        if pool is not None:
            total += fin_b + 2 * out_b    # read g, read stored act, write dz
        if relu:
            total += 3 * out_b            # read dz, read mask source, write
        if residual:
            total += 2 * out_b            # standalone fan-out: read g, write
    if bias:
        total += out_b
    return total
