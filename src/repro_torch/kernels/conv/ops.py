"""Wrappers of the two fused conv kernels (K1 ``csrc/conv_chwn.cu``, K2
``csrc/conv_nchw.cu``).

Both speak the reference's fused-epilogue protocol
(``repro/kernels/conv/ops.py``): ``bias``/``res``/``relu``/``pool`` fold
into the conv's output write in that order (bias, residual add, ReLU,
pool), and ``src_layout``/``dst_layout`` let the kernel read its input in
the producer's layout and write its output in the consumer's.  The
arguments are the reference wrappers' own, without the TPU tiling knobs
(``nt``, ``interpret``).

For a CPU tensor a wrapper returns the plain version (``ref.conv_ref``).
For a CUDA tensor it launches its kernel or raises; it never falls back.
Each wrapper counts its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.conv.ref import conv_ref
from repro_torch.shapes import conv_out_hw, pool_out_hw

_LAYOUTS = ("NCHW", "CHWN")
# a block holds every tap of a pool window among its 128 GEMM columns
# (BN in csrc/conv_common.cuh)
_MAX_POOL_TAPS = 128


def _dims(x: torch.Tensor, layout: str) -> Tuple[int, int, int, int]:
    """(N, C, H, W) of a 4-D tensor stored in ``layout``."""
    if x.dim() != 4:
        raise ValueError(f"expected a 4-D tensor, got shape {tuple(x.shape)}")
    return tuple(x.shape[layout.index(d)] for d in "NCHW")


def _shape(layout: str, N: int, C: int, H: int, W: int) -> Tuple[int, ...]:
    dims = {"N": N, "C": C, "H": H, "W": W}
    return tuple(dims[d] for d in layout)


def _launch(entry: str, wrapper, x, w, Ci: int, Co: int, F: int, stride: int,
            pad: int, bias, relu: bool, pool, res, res_layout: str,
            src_layout: str, dst_layout: str) -> torch.Tensor:
    name = wrapper.__name__
    for arg, lay in (("src_layout", src_layout), ("dst_layout", dst_layout),
                     ("res_layout", res_layout)):
        if lay not in _LAYOUTS:
            raise ValueError(f"{name}: {arg}={lay!r} not in {_LAYOUTS}")
    N, xc, H, W = _dims(x, src_layout)
    if xc != Ci:
        raise ValueError(f"{name}: x has {xc} channels, w expects {Ci}")
    if stride < 1 or pad < 0:
        raise ValueError(f"{name}: stride={stride}, pad={pad}")
    Ho, Wo = conv_out_hw(H, F, stride, pad), conv_out_hw(W, F, stride, pad)
    if Ho < 1 or Wo < 1:
        raise ValueError(f"{name}: {F}x{F} window does not fit {H}x{W} "
                         f"with pad {pad}")
    if bias is not None and tuple(bias.shape) != (Co,):
        raise ValueError(f"{name}: bias shape {tuple(bias.shape)} != {(Co,)}")
    if res is not None:
        want = _shape(res_layout, N, Co, Ho, Wo)
        if tuple(res.shape) != want:
            raise ValueError(f"{name}: res shape {tuple(res.shape)} != "
                             f"{want} ({res_layout})")
    pF = pS = avg = 0
    OH, OW = Ho, Wo
    if pool is not None:
        pF, pS, op = pool
        if op not in ("max", "avg") or pF < 1 or pS < 1:
            raise ValueError(f"{name}: unsupported pool {pool!r}")
        if pF * pF > _MAX_POOL_TAPS:
            raise ValueError(f"{name}: a {pF}x{pF} pool window has more "
                             f"than {_MAX_POOL_TAPS} taps")
        avg = int(op == "avg")
        OH, OW = pool_out_hw(Ho, pF, pS), pool_out_hw(Wo, pF, pS)
        if OH < 1 or OW < 1:
            raise ValueError(f"{name}: pool {pool!r} does not fit the "
                             f"{Ho}x{Wo} conv output")
    _build.require_cuda_f32(name, x.device, x=x, w=w, bias=bias, res=res)
    y = torch.empty(_shape(dst_layout, N, Co, OH, OW), device=x.device,
                    dtype=torch.float32)
    if y.numel() >= 2 ** 31:
        raise ValueError(f"{name}: output has {y.numel()} elements; the "
                         "kernel indexes with 32-bit ints")
    err = getattr(_build.library(), entry)(
        x.data_ptr(), w.data_ptr(),
        bias.data_ptr() if bias is not None else None,
        res.data_ptr() if res is not None else None, y.data_ptr(),
        N, Ci, H, W, Co, F, stride, pad, pF, pS, avg, int(relu),
        int(src_layout == "NCHW"), int(dst_layout == "NCHW"),
        int(res_layout == "NCHW"), _build.stream_of(x.device))
    _build.check(name, err)
    wrapper.launches += 1
    return y


def conv_direct_chwn(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                     pad: int = 0, *, bias: Optional[torch.Tensor] = None,
                     relu: bool = False,
                     pool: Optional[Tuple[int, int, str]] = None,
                     res: Optional[torch.Tensor] = None,
                     res_layout: str = "CHWN", src_layout: str = "CHWN",
                     dst_layout: str = "CHWN") -> torch.Tensor:
    """K1, the direct CHWN engine: x [Ci,H,W,N] (or [N,Ci,H,W] for src
    NCHW), w [Ci,F,F,Co] -> [Co,Ho',Wo',N] (or NCHW for dst NCHW), with the
    optional fused bias/residual-add/ReLU/pool epilogue (``res`` is the
    skip tensor, conv-output shape, stored in ``res_layout``)."""
    if w.dim() != 4:
        raise ValueError(f"w must be [Ci,F,F,Co], got {tuple(w.shape)}")
    if _build.on_cpu("conv_direct_chwn", x):
        return conv_ref(x, w.permute(3, 0, 1, 2), stride, pad, bias=bias,
                        relu=relu, pool=pool, res=res, res_layout=res_layout,
                        src_layout=src_layout, dst_layout=dst_layout)
    Ci, F, _, Co = w.shape
    return _launch("conv_chwn_forward", conv_direct_chwn, x, w, Ci, Co, F,
                   stride, pad, bias, relu, pool, res, res_layout,
                   src_layout, dst_layout)


def conv_im2col_nchw_fused(x: torch.Tensor, w: torch.Tensor,
                           stride: int = 1, pad: int = 0, *,
                           bias: Optional[torch.Tensor] = None,
                           relu: bool = False,
                           pool: Optional[Tuple[int, int, str]] = None,
                           res: Optional[torch.Tensor] = None,
                           res_layout: str = "NCHW",
                           src_layout: str = "NCHW",
                           dst_layout: str = "NCHW") -> torch.Tensor:
    """K2, the virtual-im2col NCHW engine: x [N,Ci,H,W] (or [Ci,H,W,N] for
    src CHWN), w canonical [Co,Ci,F,F] -> [N,Co,Ho',Wo'] (or CHWN for dst
    CHWN), with the same optional fused epilogue as K1."""
    if w.dim() != 4:
        raise ValueError(f"w must be [Co,Ci,F,F], got {tuple(w.shape)}")
    if _build.on_cpu("conv_im2col_nchw_fused", x):
        return conv_ref(x, w, stride, pad, bias=bias, relu=relu, pool=pool,
                        res=res, res_layout=res_layout,
                        src_layout=src_layout, dst_layout=dst_layout)
    Co, Ci, F, _ = w.shape
    return _launch("conv_nchw_forward", conv_im2col_nchw_fused, x, w, Ci, Co,
                   F, stride, pad, bias, relu, pool, res, res_layout,
                   src_layout, dst_layout)


conv_direct_chwn.launches = 0
conv_im2col_nchw_fused.launches = 0
