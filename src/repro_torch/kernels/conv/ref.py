"""Plain PyTorch versions of what the conv kernels compute.

``conv_ref`` (K1, K2): permute to NCHW -> conv2d (+bias) -> +residual ->
ReLU -> max/avg pool -> permute to the destination layout; with
``save_act`` also the pre-pool activation (the kernels' ``z`` output).
``conv_stack_ref`` (K5a, K5b): two ``conv_ref`` calls, conv1 (+bias1,
+ReLU) into the float32 mid tensor and conv2 with the full epilogue.
Both compute in float32 whatever the storage dtypes (bf16, int8 x) and
round once, to the output's dtype, at the end, as the kernels do.
``wgrad_ref`` (K6): the conv weight gradient as one contraction per filter
tap, in float32 for float32 or bf16 inputs (float64 is the card's
oracle).
``im2col_nchw``: the matrix expansion of the baseline
``ops.conv_im2col_nchw``, whose matmul runs on K10.  The wrappers
in ``ops.py`` run them for tensors on the CPU, and the tests and
``chip_smoke.py`` hold the kernels against them.  On the card, compare
them with TF32 off (``torch.backends.cudnn.allow_tf32 = False``): cuDNN's
default keeps only about three digits of an fp32 conv.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.layout import perm_between
from repro_torch.shapes import pool_out_hw


def conv_ref(x: torch.Tensor, w_oihw: torch.Tensor, stride: int = 1,
             pad: int = 0, *, bias: Optional[torch.Tensor] = None,
             relu: bool = False, pool: Optional[Tuple[int, int, str]] = None,
             res: Optional[torch.Tensor] = None, res_layout: str = "NCHW",
             src_layout: str = "NCHW", dst_layout: str = "NCHW",
             save_act: bool = False, act_layout: str = "NCHW",
             out_dtype: Optional[torch.dtype] = None):
    """x in ``src_layout``; w canonical [Co, Ci, F, F]; ``res`` (the skip
    tensor of a folded residual add, conv-output shape) in ``res_layout``.
    Returns the result in ``dst_layout``, pooled when ``pool`` is
    ``(F, S, "max" | "avg")``.  With ``save_act`` returns ``(y, z)``: z is
    the conv output after bias, residual and ReLU, before the pool, in
    ``act_layout``, and 0 at the conv outputs under no pool window (the
    kernels never compute those).  A narrow operand (bf16; int8 x, whose
    per-channel scale is folded into w) is widened to float32, the whole
    epilogue runs in float32 (float64 where w is: the card's oracle), and
    the results are rounded once to ``out_dtype`` (default: w's dtype)."""
    acc = _acc_dtype(w_oihw)
    y = F.conv2d(x.permute(perm_between(src_layout, "NCHW")).to(acc),
                 w_oihw.to(acc), None if bias is None else bias.to(acc),
                 stride=stride, padding=pad)
    if res is not None:
        y = y + res.permute(perm_between(res_layout, "NCHW")).to(acc)
    if relu:
        y = torch.relu(y)
    z = y
    if pool is not None:
        pF, pS, op = pool
        y = (F.max_pool2d(y, pF, pS) if op == "max"
             else F.avg_pool2d(y, pF, pS))
        if save_act:
            z = torch.where(_in_windows(z.shape[2], pF, pS, z.device)[:, None]
                            & _in_windows(z.shape[3], pF, pS, z.device),
                            z, 0.0)
    dt = out_dtype or w_oihw.dtype
    y = y.permute(perm_between("NCHW", dst_layout)).contiguous().to(dt)
    if save_act:
        return y, z.permute(perm_between("NCHW", act_layout)).contiguous(
            ).to(dt)
    return y


def _acc_dtype(w: torch.Tensor) -> torch.dtype:
    """What the plain versions compute in: float64 for a float64 w (the
    oracle of the card's tests), float32 for every storage dtype."""
    return torch.float64 if w.dtype == torch.float64 else torch.float32


def _in_windows(n: int, pF: int, pS: int, device) -> torch.Tensor:
    """Which of ``n`` rows some pool window (F = pF, stride pS) reads."""
    r = torch.arange(n, device=device)
    return (r % pS < pF) & (r < (pool_out_hw(n, pF, pS) - 1) * pS + pF)


def conv_stack_ref(x: torch.Tensor, w1_oihw: torch.Tensor,
                   w2_oihw: torch.Tensor, stride1: int = 1, pad1: int = 0,
                   stride2: int = 1, pad2: int = 0, *,
                   bias1: Optional[torch.Tensor] = None,
                   bias2: Optional[torch.Tensor] = None, relu1: bool = True,
                   relu2: bool = False,
                   pool: Optional[Tuple[int, int, str]] = None,
                   res: Optional[torch.Tensor] = None,
                   res_layout: str = "NCHW", src_layout: str = "NCHW",
                   dst_layout: str = "NCHW") -> torch.Tensor:
    """conv1 [+bias1] [+ReLU] -> conv2 [+bias2] [+residual] [+ReLU]
    [+pool], with canonical weights [Cm, Ci, F1, F1] and [Co, Cm, F2, F2].
    The mid tensor is NCHW and float32 here, whatever the storage dtype:
    the stack kernels never store it, so it is never rounded to bf16."""
    mid = conv_ref(x, w1_oihw, stride1, pad1, bias=bias1, relu=relu1,
                   src_layout=src_layout, dst_layout="NCHW",
                   out_dtype=_acc_dtype(w1_oihw))
    return conv_ref(mid, w2_oihw, stride2, pad2, bias=bias2, relu=relu2,
                    pool=pool, res=res, res_layout=res_layout,
                    src_layout="NCHW", dst_layout=dst_layout)


def wgrad_ref(x: torch.Tensor, g: torch.Tensor, F: int, S: int = 1,
              pad: int = 0, *, x_layout: str = "NCHW",
              g_layout: str = "NCHW",
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Weight gradient of conv(x, w, S, pad) -> canonical [Co, Ci, F, F]:
    for each filter tap (dy, dx), the contraction of g [N, Co, Ho, Wo]
    with the tap's strided window of the padded x over (n, oh, ow), as
    the reference's ``_wgrad_kernel`` sums its taps.  ``x`` in
    ``x_layout``, ``g`` in ``g_layout``; computed and returned in
    ``dtype``: by default float32 for a float32 or bf16 x (bf16 inputs are
    widened, summed in float32 and returned unrounded, as K6 and the
    reference's kernel, whose ``preferred_element_type`` is float32, do),
    else x's."""
    dtype = dtype or _acc_dtype(x)
    xn = x.permute(perm_between(x_layout, "NCHW")).to(dtype)
    gn = g.permute(perm_between(g_layout, "NCHW")).to(dtype)
    if pad:
        xn = torch.nn.functional.pad(xn, (pad, pad, pad, pad))
    Ho, Wo = gn.shape[2], gn.shape[3]
    taps = [torch.einsum("nohw,nchw->oc", gn,
                         xn[:, :, dy:dy + (Ho - 1) * S + 1:S,
                            dx:dx + (Wo - 1) * S + 1:S])
            for dy in range(F) for dx in range(F)]
    Co, Ci = taps[0].shape
    return torch.stack(taps, -1).reshape(Co, Ci, F, F)


def im2col_nchw(x: torch.Tensor, F: int, stride: int = 1, pad: int = 0
                ) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    """x [N, Ci, H, W] -> (patches [N*Ho*Wo, Ci*F*F], (N, Ho, Wo)): the
    paper's matrix expansion (``repro/kernels/conv/ref.py::im2col_nchw``),
    one row per output position (n, oh, ow), columns in (ci, dy, dx)
    order.  The patch matrix is materialized: its traffic is the point of
    the baseline."""
    N, Ci = x.shape[:2]
    if pad:
        x = torch.nn.functional.pad(x, (pad, pad, pad, pad))
    win = x.unfold(2, F, stride).unfold(3, F, stride)  # [N,Ci,Ho,Wo,F,F]
    Ho, Wo = win.shape[2], win.shape[3]
    patches = win.permute(0, 2, 3, 1, 4, 5).reshape(N * Ho * Wo, Ci * F * F)
    return patches, (N, Ho, Wo)
