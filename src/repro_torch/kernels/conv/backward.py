"""Layout-aware conv backward (``repro/kernels/conv/backward.py``): dgrad on
the forward engines, wgrad on its own kernel K6 (``csrc/wgrad.cu``).

dgrad (the input gradient) is the transposed conv: the output gradient,
spatially dilated by the forward stride, convolved at stride 1 with the
filter rotated by 180 degrees and its channel roles swapped.  It runs on
the layout-bound forward kernels (K1 in CHWN, K2 in NCHW), so it reads g
in the downstream layout (``g_layout``) and writes dx straight in the
upstream one (``dst_layout``).  The reference pads the dilated gradient by
F-1, convolves, and cuts the ``[pad, pad+H)`` window out of the result
(zero-filling the rows past the last window).  The port asks the conv
kernel for that window directly: padding F-1-pad on each side, and the
dilated gradient grown by the r = (H + 2*pad - F) % S rows (and columns)
that no window consumed, as zeros.  The conv then writes exactly the H x W
gradient, with no padded copy and no slice.  For S == 1 nothing is
materialized at all.

wgrad (the weight gradient) is K6, a GEMM over the virtual im2col matrix
on the tensor cores in fp32 accuracy (3xTF32; bf16 x and g: one bf16
product a term, a kernel of its own), with split-K over the output
positions; ``conv_wgrad`` is its wrapper and ``wgrad_tiling`` picks its
block tile and splits, for both builds (the bf16 kernel reduces the same
32-position slices).  ``bias_grad`` is a plain
reduction, as in the reference.  For a CPU tensor ``conv_wgrad`` returns the
plain version (``ref.wgrad_ref``); for a CUDA tensor it launches K6 or
raises, and counts its launches in ``conv_wgrad.launches``.  x and g are
float32 or bf16, one dtype; dw is float32 either way (the reference's
``wgrad_pallas`` emits float32 whatever its inputs), and ``conv_backward``
rounds it to w's dtype, as the reference's ``_conv_bwd`` does.  A bf16
launch also counts in ``conv_wgrad.variant_launches["bf16"]``.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.conv.ref import wgrad_ref
from repro_torch.shapes import conv_out_hw

_SMS = 132                # H100 SXM streaming multiprocessors
_HBM_BYTES_S = 3.35e12    # H100 SXM device memory, bytes/s
_WG_BP = 32               # positions per slice of csrc/wgrad.cu
_WG_BF16_STAGES = 4       # ring depth of its bf16 kernel (32-deep slices)
_WG_MAX_SPLITS = 65535    # gridDim.z
# the splits' cost model: the rate a block's tensor-core work is assumed
# to run at (3xTF32, fp32-equivalent FLOP/s over the card), and the
# pipeline fill and tile write of a block, in slices
_WG_RATE = 50e12
_WG_BLOCK_OVERHEAD = 2


def _spatial_axes(layout: str) -> Tuple[int, int]:
    return (2, 3) if layout == "NCHW" else (1, 2)


def dilate_grad(g: torch.Tensor, S: int, layout: str,
                tail: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Spatially dilate ``g`` (in ``layout``) by the forward stride S: S-1
    zeros between neighbouring rows and columns, plus ``tail`` zero rows and
    columns at the end.  ``g`` itself when there is nothing to add."""
    if S == 1 and tail == (0, 0):
        return g
    ha, wa = _spatial_axes(layout)
    shape = list(g.shape)
    shape[ha] = (shape[ha] - 1) * S + 1 + tail[0]
    shape[wa] = (shape[wa] - 1) * S + 1 + tail[1]
    gd = g.new_zeros(shape)
    idx = [slice(None)] * g.dim()
    idx[ha] = slice(0, (g.shape[ha] - 1) * S + 1, S)
    idx[wa] = slice(0, (g.shape[wa] - 1) * S + 1, S)
    gd[tuple(idx)] = g
    return gd


def dgrad_shape(N: int, Ci: int, H: int, W: int, Co: int, F: int,
                stride: int, pad: int) -> Tuple[int, ...]:
    """(N, Ci, H, W, Co, F, S, pad) of the stride-1 conv that
    ``dgrad_problem`` poses for dx of a conv of an [N, Ci, H, W] input by
    Co F x F filters: the dilated gradient's Co channels and size, the
    rotated filter's Ci outputs, its padding."""
    Hd, Wd = ((conv_out_hw(n, F, stride, pad) - 1) * stride + 1
              + (n + 2 * pad - F) % stride for n in (H, W))
    return N, Co, Hd, Wd, Ci, F, 1, F - 1 - pad


def dgrad_problem(g: torch.Tensor, w: torch.Tensor, x_hw: Tuple[int, int],
                  stride: int, pad: int, g_layout: str):
    """The stride-1 conv whose output is dx: (dilated gradient, rotated
    canonical filter [Ci, Co, F, F], padding)."""
    F = w.shape[2]
    H, W = x_hw
    if pad > F - 1:
        raise ValueError(f"conv_dgrad: padding {pad} > F-1 = {F - 1} is not "
                         "supported (every layer of the networks pads less)")
    ha, wa = _spatial_axes(g_layout)
    Ho, Wo = conv_out_hw(H, F, stride, pad), conv_out_hw(W, F, stride, pad)
    if (g.shape[ha], g.shape[wa]) != (Ho, Wo):
        raise ValueError(f"conv_dgrad: g is {g.shape[ha]}x{g.shape[wa]}, the "
                         f"conv of a {H}x{W} input makes {Ho}x{Wo}")
    tail = ((H + 2 * pad - F) % stride, (W + 2 * pad - F) % stride)
    gd = dilate_grad(g, stride, g_layout, tail)
    wt = torch.flip(w, (2, 3)).transpose(0, 1).contiguous()
    return gd, wt, F - 1 - pad


def conv_dgrad(g: torch.Tensor, w: torch.Tensor, x_hw: Tuple[int, int],
               stride: int = 1, pad: int = 0, *, layout: str = "CHWN",
               g_layout: Optional[str] = None,
               dst_layout: Optional[str] = None) -> torch.Tensor:
    """Input gradient of conv(x, w, stride, pad).

    g: conv-output gradient in ``g_layout`` (NCHW [N,Co,Ho,Wo] or CHWN
    [Co,Ho,Wo,N]); w: canonical [Co,Ci,F,F]; x_hw: (H, W) of the forward
    input.  Computes on ``layout``'s conv kernel (K1 for CHWN, K2 for
    NCHW), returns dx in ``dst_layout``.  Rows/cols of x beyond the last
    consumed window get zero gradient."""
    # imported here: ops imports this module for the conv backward
    from repro_torch.kernels.conv.ops import _conv
    g_layout = g_layout or layout
    dst_layout = dst_layout or layout
    gd, wt, p = dgrad_problem(g, w, x_hw, stride, pad, g_layout)
    if layout == "CHWN":
        wt = wt.permute(1, 2, 3, 0).contiguous()   # [Co, F, F, Ci]
    return _conv(layout, gd, wt, 1, p, src_layout=g_layout,
                 dst_layout=dst_layout)


def bias_grad(g: torch.Tensor, layout: str = "CHWN") -> torch.Tensor:
    """d(bias): reduce the conv-output gradient over all non-Co dims."""
    axes = (0, 2, 3) if layout == "NCHW" else (1, 2, 3)
    return g.float().sum(axes)


class WgradTiling(NamedTuple):
    """K6's launch: a ``bm`` (co) x ``bn`` (k) block tile, ``splits``
    ranges of ``per`` output positions each (a multiple of 32)."""
    bm: int
    bn: int
    per: int
    splits: int
    tiles: int           # block tiles over [Co, K]
    ws_elems: int        # split workspace [splits, Co, K], 0 for one split


def wgrad_bf16_smem(bm: int, bn: int) -> int:
    """Shared memory of one block of K6's bf16 kernel (``wgrad_bf16_kernel``
    in csrc/wgrad.cu): a ring of 4 stages of (bm + bn) bf16 rows of 32
    positions, and the block's table of k offsets and taps."""
    return _WG_BF16_STAGES * (bm + bn) * _WG_BP * 2 + 3 * 4 * bn


@functools.lru_cache(maxsize=None)
def wgrad_tiling(Co: int, K: int, P: int) -> WgradTiling:
    """K6's tile and split of the reduction over ``P`` output positions for
    a [Co, K] weight gradient.  The tile is 128 x 128, 64 rows where Co <=
    64 and 32 or 64 columns where K <= 32 or 64, so thin layers do not
    multiply padding.  The splits minimise a modeled time: the waves of
    resident blocks (one an SM) times a block's slices plus its fill,
    each slice at ``_WG_RATE``, plus the workspace each split writes and
    the sum reads back; among splits that give at least one block an SM
    where the positions allow it."""
    bm = 64 if Co <= 64 else 128
    bn = 32 if K <= 32 else 64 if K <= 64 else 128
    tiles = -(-Co // bm) * -(-K // bn)
    slices = -(-P // _WG_BP)
    t_slice = 2.0 * bm * bn * _WG_BP * _SMS / _WG_RATE
    best = None
    for s in range(1, min(slices, _WG_MAX_SPLITS) + 1):
        per = -(-slices // s)
        if -(-slices // per) != s:     # the same ranges as fewer splits
            continue
        blocks = tiles * s
        t = -(-blocks // _SMS) * (per + _WG_BLOCK_OVERHEAD) * t_slice
        if s > 1:
            t += (2 * s + 1) * Co * K * 4 / _HBM_BYTES_S
        key = (blocks < _SMS, t, s)
        if best is None or key < best[0]:
            best = (key, s, per)
    _, s, per = best
    return WgradTiling(bm, bn, per * _WG_BP, s, tiles,
                       s * Co * K if s > 1 else 0)


def conv_wgrad(x: torch.Tensor, g: torch.Tensor, F: int, S: int = 1,
               pad: int = 0, *, x_layout: str = "CHWN",
               g_layout: Optional[str] = None) -> torch.Tensor:
    """K6: weight gradient of conv(x, w, S, pad) -> canonical [Co, Ci, F,
    F], accumulated and returned in float32.  x: the forward input
    (unpadded) in ``x_layout``; g: the conv-output gradient in
    ``g_layout``, of x's dtype (float32 or bf16).  Two launches (the split
    partials, then their fixed-order sum) count as one call."""
    g_layout = g_layout or x_layout
    for lay in (x_layout, g_layout):
        if lay not in ("CHWN", "NCHW"):
            raise ValueError(f"conv_wgrad: layout {lay!r}")
    if x.dim() != 4 or g.dim() != 4:
        raise ValueError("conv_wgrad: x and g must be 4-D")
    N, Ci, H, W = (x.shape[x_layout.index(d)] for d in "NCHW")
    gN, Co, Ho, Wo = (g.shape[g_layout.index(d)] for d in "NCHW")
    if (gN, Ho, Wo) != (N, conv_out_hw(H, F, S, pad),
                        conv_out_hw(W, F, S, pad)):
        raise ValueError(f"conv_wgrad: g {tuple(g.shape)} ({g_layout}) is "
                         f"not the output of a {F}x{F}/{S} conv of x "
                         f"{tuple(x.shape)} ({x_layout}) with pad {pad}")
    if _build.on_cpu("conv_wgrad", x):
        return wgrad_ref(x, g, F, S, pad, x_layout=x_layout,
                         g_layout=g_layout)
    dev, variant = _build.require_cuda_storage("conv_wgrad", x, g=g)
    t = wgrad_tiling(Co, Ci * F * F, N * Ho * Wo)
    if t.ws_elems >= 2 ** 31:
        raise ValueError("conv_wgrad: the split workspace needs 2^31 or "
                         "more elements")
    dw = torch.empty((Co, Ci, F, F), device=x.device, dtype=torch.float32)
    ws = (torch.empty((t.splits, Co, Ci * F * F), device=x.device,
                      dtype=torch.float32) if t.splits > 1 else None)
    err = _build.entry("wgrad_forward", variant)(
        x.data_ptr(), g.data_ptr(), ws.data_ptr() if ws is not None else None,
        dw.data_ptr(), N, Ci, H, W, Co, F, S, pad, int(x_layout == "NCHW"),
        int(g_layout == "NCHW"), t.bm, t.bn, t.per, t.splits,
        _build.stream_of(dev))
    _build.check("conv_wgrad", err)
    conv_wgrad.launches += 1
    if variant:
        conv_wgrad.variant_launches[variant] += 1
    return dw


conv_wgrad.launches = 0
conv_wgrad.variant_launches = {"bf16": 0}
