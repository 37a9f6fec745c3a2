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

wgrad (the weight gradient) is K6, an implicit GEMM with split-K over the
output positions; ``conv_wgrad`` is its wrapper.  ``bias_grad`` is a plain
reduction, as in the reference.  For a CPU tensor ``conv_wgrad`` returns the
plain version (``ref.wgrad_ref``); for a CUDA tensor it launches K6 or
raises, and counts its launches in ``conv_wgrad.launches``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.conv.ref import wgrad_ref
from repro_torch.shapes import conv_out_hw

_SMS = 132                # H100 SXM streaming multiprocessors
# the design constants of csrc/wgrad.cu
_WG_BM, _WG_BN, _WG_BP = 64, 128, 32
_WG_BLOCKS = 8 * _SMS     # blocks to aim for: a few resident per SM, twice
_WG_MIN_SLICES = 16       # reduction slices a split takes at least


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


def wgrad_splits(Co: int, K: int, P: int) -> Tuple[int, int]:
    """K6's split of the reduction over ``P`` output positions for a
    [Co, K] weight gradient: (positions per split, splits).  Enough splits
    that the smallest layer still fills the card (about ``_WG_BLOCKS``
    blocks of 64 x 128 outputs), but each split at least
    ``_WG_MIN_SLICES`` slices of 32 positions."""
    tiles = -(-Co // _WG_BM) * -(-K // _WG_BN)
    slices = -(-P // _WG_BP)
    want = max(1, min(-(-_WG_BLOCKS // tiles), slices // _WG_MIN_SLICES))
    per = -(-slices // want) * _WG_BP
    return per, -(-P // per)


def conv_wgrad(x: torch.Tensor, g: torch.Tensor, F: int, S: int = 1,
               pad: int = 0, *, x_layout: str = "CHWN",
               g_layout: Optional[str] = None) -> torch.Tensor:
    """K6: weight gradient of conv(x, w, S, pad) -> canonical [Co, Ci, F,
    F], accumulated in fp32.  x: the forward input (unpadded) in
    ``x_layout``; g: the conv-output gradient in ``g_layout``.  Two
    launches (the split partials, then their fixed-order sum) count as one
    call."""
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
    _build.require_cuda_f32("conv_wgrad", x.device, x=x, g=g)
    K = Ci * F * F
    per, splits = wgrad_splits(Co, K, N * Ho * Wo)
    dw = torch.empty((Co, Ci, F, F), device=x.device, dtype=torch.float32)
    ws = (torch.empty((splits, Co, K), device=x.device, dtype=torch.float32)
          if splits > 1 else None)
    if ws is not None and ws.numel() >= 2 ** 31:
        raise ValueError("conv_wgrad: the split workspace needs 2^31 or "
                         "more elements")
    err = _build.library().wgrad_forward(
        x.data_ptr(), g.data_ptr(), ws.data_ptr() if ws is not None else None,
        dw.data_ptr(), N, Ci, H, W, Co, F, S, pad, int(x_layout == "NCHW"),
        int(g_layout == "NCHW"), per, splits, _build.stream_of(x.device))
    _build.check("conv_wgrad", err)
    conv_wgrad.launches += 1
    return dw


conv_wgrad.launches = 0
