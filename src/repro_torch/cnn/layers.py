"""Layout-polymorphic CNN layers (``repro/cnn/layers.py``).

Every op executes natively in its assigned layout.  ``impl`` selects the
engine:
  * "cuda"  — the hand-written kernels (direct-CHWN conv K1, virtual-im2col
              NCHW conv K2, standalone pools K3a/K3b, fused softmax K4,
              conv->conv stacks K5a/K5b), the counterpart of the
              reference's "pallas" engine.  A CPU tensor runs each kernel's
              plain version instead; a CUDA tensor runs the kernel.
  * "torch" — the decomposed plain PyTorch engine (the counterpart of the
              reference's "xla"): the oracle the kernels are held against.
  * "fft"   — ``conv_forward`` only: the frequency-domain conv (NCHW; the
              cuDNN-FFT analogue), in ``torch.fft``.
Both engines are differentiable: "torch" by plain autograd, "cuda" through
the kernels' autograd Functions (the conv, stack, pool and softmax
wrappers; dgrad on K1/K2, the weight gradient K6, the pool backward K7),
the counterparts of the reference's custom VJPs.
Weights are canonical [Co, Ci, F, F] for conv and [in, out] for fc, as
``init_cnn`` makes them in both packages.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import CNNConfig
from repro_torch.dtypes import DEFAULT_DTYPE, torch_dtype
from repro_torch.kernels.conv.ops import (conv_direct_chwn,
                                          conv_fft_nchw,
                                          conv_im2col_nchw_fused,
                                          conv_stack_chwn, conv_stack_nchw)
from repro_torch.kernels.conv.ref import conv_ref, conv_stack_ref
from repro_torch.kernels.pool.ops import pool_chwn, pool_nchw
from repro_torch.kernels.pool.ref import pool_ref
from repro_torch.kernels.softmax.ops import softmax as softmax_kernel
from repro_torch.kernels.softmax.ref import softmax_ref
from repro_torch.shapes import conv_out_hw, pool_out_hw

IMPLS = ("cuda", "torch")


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; known: {IMPLS}")


def fused_conv_block(x: torch.Tensor, w: torch.Tensor, layout: str,
                     stride: int = 1, pad: int = 0, *,
                     bias: Optional[torch.Tensor] = None, relu: bool = False,
                     pool: Optional[Tuple[int, int, str]] = None,
                     res: Optional[torch.Tensor] = None,
                     res_layout: Optional[str] = None,
                     src_layout: Optional[str] = None,
                     dst_layout: Optional[str] = None,
                     impl: str = "cuda") -> torch.Tensor:
    """One fused-engine node: conv[+bias][+residual add][+relu][+pool]
    executed natively in ``layout``, consuming ``src_layout`` input and
    producing ``dst_layout`` output.  ``res`` (stored in ``res_layout``) is
    added before the ReLU, the ResNet epilogue order.  ``impl="cuda"`` runs
    it as ONE kernel of the ``layout``'s engine."""
    _check_impl(impl)
    src = src_layout or layout
    dst = dst_layout or layout
    rlay = res_layout or layout
    if impl == "torch":
        return conv_ref(x, w, stride, pad, bias=bias, relu=relu, pool=pool,
                        res=res, res_layout=rlay, src_layout=src,
                        dst_layout=dst)
    kw = dict(bias=bias, relu=relu, pool=pool, res=res, res_layout=rlay,
              src_layout=src, dst_layout=dst)
    if layout == "CHWN":
        return conv_direct_chwn(x, w.permute(1, 2, 3, 0).contiguous(),
                                stride, pad, **kw)
    if layout == "NCHW":
        return conv_im2col_nchw_fused(x, w, stride, pad, **kw)
    raise ValueError(f"no conv engine computes in layout {layout!r}")


def fused_conv_stack(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                     layout: str, stride1: int = 1, pad1: int = 0,
                     stride2: int = 1, pad2: int = 0, *, relu1: bool = False,
                     relu2: bool = False,
                     pool: Optional[Tuple[int, int, str]] = None,
                     res: Optional[torch.Tensor] = None,
                     res_layout: Optional[str] = None,
                     src_layout: Optional[str] = None,
                     dst_layout: Optional[str] = None,
                     impl: str = "cuda") -> torch.Tensor:
    """Cross-layer stack node: conv1[+relu] -> conv2[+residual add][+relu]
    [+pool] executed natively in ``layout``.  ``w1``/``w2`` are canonical
    [Co, Ci, F, F].  ``impl="cuda"`` runs it as ONE kernel (K5a for CHWN,
    K5b for NCHW) whose mid activation never reaches device memory;
    ``impl="torch"`` runs its plain version ``conv_stack_ref`` (the
    oracle: two convs, the mid kept float32 as the kernels keep it)."""
    _check_impl(impl)
    src = src_layout or layout
    dst = dst_layout or layout
    rlay = res_layout or layout
    if impl == "torch":                   # the mid stays float32
        return conv_stack_ref(x, w1, w2, stride1, pad1, stride2, pad2,
                              relu1=relu1, relu2=relu2, pool=pool, res=res,
                              res_layout=rlay, src_layout=src,
                              dst_layout=dst)
    kw = dict(relu1=relu1, relu2=relu2, pool=pool, res=res, res_layout=rlay,
              src_layout=src, dst_layout=dst)
    if layout == "CHWN":
        return conv_stack_chwn(x, w1.permute(1, 2, 3, 0).contiguous(),
                               w2.permute(1, 2, 3, 0).contiguous(), stride1,
                               pad1, stride2, pad2, **kw)
    if layout == "NCHW":
        return conv_stack_nchw(x, w1, w2, stride1, pad1, stride2, pad2, **kw)
    raise ValueError(f"no conv engine computes in layout {layout!r}")


def conv_forward(x: torch.Tensor, w: torch.Tensor, layout: str,
                 stride: int = 1, pad: int = 0,
                 impl: str = "cuda") -> torch.Tensor:
    """Bare conv in ``layout`` (x and the result both in it).  Besides the
    two engines, ``impl="fft"`` runs the frequency-domain conv
    (``conv_fft_nchw``, the paper's cuDNN-FFT mode), bound to NCHW as the
    reference's is."""
    if impl == "fft":
        if layout != "NCHW":
            raise ValueError("FFT conv is bound to NCHW (paper §IV.A), got "
                             f"layout {layout!r}")
        return conv_fft_nchw(x, w, stride, pad)
    return fused_conv_block(x, w, layout, stride, pad, impl=impl)


def pool_forward(x: torch.Tensor, layout: str, F: int, S: int,
                 op: str = "max", impl: str = "cuda",
                 dst_layout: Optional[str] = None) -> torch.Tensor:
    """Standalone max/avg pool over the H, W dims of ``x`` (in ``layout``),
    written in ``dst_layout``.  ``impl="cuda"`` runs the pool kernel of the
    source layout (K3a for CHWN, K3b for NCHW; on a CPU tensor its plain
    version)."""
    _check_impl(impl)
    dst = dst_layout or layout
    if impl == "torch":
        return pool_ref(x, F, S, op, layout, dst)
    if layout == "CHWN":
        return pool_chwn(x, F, S, op, dst_layout=dst)
    if layout == "NCHW":
        return pool_nchw(x, F, S, op, dst_layout=dst)
    raise ValueError(f"no pool kernel reads layout {layout!r}")


def flatten_forward(x: torch.Tensor, layout: str) -> torch.Tensor:
    """-> [N, features] regardless of layout."""
    if layout == "CHWN":
        C, H, W, N = x.shape
        return x.reshape(C * H * W, N).t()
    return x.reshape(x.shape[0], -1)


def fc_forward(x2d: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """y = xW + b, accumulated in float32 and rounded once to x's dtype
    (``torch.matmul``; TF32 must be off for fp32 exactness:
    ``torch.backends.cuda.matmul.allow_tf32``).  A bf16 product on the card
    asks cuBLAS for its float32 sums (``out_dtype``) rather than copy W to
    float32: VGG16's fc6 alone would be a 411 MB copy a forward.  Under
    autograd (training) it takes the float32 copies, whose gradient is the
    reference's (dx = g W^T in float32, rounded once to x's dtype): the
    ``out_dtype`` product has no such derivative."""
    if (x2d.dtype is torch.bfloat16 and x2d.is_cuda
            and not (torch.is_grad_enabled()
                     and (x2d.requires_grad or w.requires_grad))):
        y = torch.mm(x2d, w, out_dtype=torch.float32)
    else:
        y = torch.matmul(x2d.float(), w.float())
    return (y + b.float()).to(x2d.dtype)


def softmax_forward(x2d: torch.Tensor, impl: str = "cuda") -> torch.Tensor:
    _check_impl(impl)
    if impl == "cuda":
        if not x2d.is_contiguous():
            x2d = x2d.contiguous()
        return softmax_kernel(x2d)
    return softmax_ref(x2d)


def relu_forward(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def concat_forward(xs: Sequence[torch.Tensor], layout: str) -> torch.Tensor:
    """Channel concat of the merge inputs (U-Net skip join)."""
    return torch.cat(list(xs), dim=0 if layout == "CHWN" else 1)


def upsample_forward(x: torch.Tensor, layout: str,
                     factor: int) -> torch.Tensor:
    """Nearest-neighbour spatial x``factor`` (the U-Net decoder expand)."""
    ha, wa = (1, 2) if layout == "CHWN" else (2, 3)
    return x.repeat_interleave(factor, dim=ha).repeat_interleave(factor,
                                                                 dim=wa)


# ---------------------------------------------------------------------------
# parameter init + shape propagation
# ---------------------------------------------------------------------------

def resolved_cfg_inputs(cfg: CNNConfig) -> List[Tuple[int, ...]]:
    """Per-layer producer INDICES from the config's name-based ``inputs``
    edges (-1 is the network input; empty means "the previous layer")."""
    idx = {spec.name: i for i, spec in enumerate(cfg.layers)}
    rins: List[Tuple[int, ...]] = []
    for i, spec in enumerate(cfg.layers):
        if spec.inputs:
            try:
                ins = tuple(idx[nm] for nm in spec.inputs)
            except KeyError as e:
                raise ValueError(
                    f"layer {spec.name!r}: unknown input layer {e.args[0]!r}")
            for p in ins:
                if p >= i:
                    raise ValueError(
                        f"layer {spec.name!r}: input {cfg.layers[p].name!r} "
                        "is not an earlier layer (layers must be "
                        "topologically ordered)")
        else:
            ins = (i - 1,) if i else (-1,)
        rins.append(ins)
    return rins


def layer_shapes(cfg: CNNConfig) -> List[Tuple[int, ...]]:
    """Logical NCHW output shape after each layer, propagated along the
    graph edges; merge nodes validate that their branches meet."""
    rins = resolved_cfg_inputs(cfg)
    in_shape = (cfg.batch, cfg.in_channels, cfg.image_hw, cfg.image_hw)
    out: List[Tuple[int, ...]] = []

    def shp(p: int) -> Tuple[int, ...]:
        return in_shape if p < 0 else out[p]

    for i, spec in enumerate(cfg.layers):
        s0 = shp(rins[i][0])
        if spec.kind == "conv":
            hw = conv_out_hw(s0[2], spec.kernel, spec.stride, spec.pad)
            out.append((cfg.batch, spec.out_channels, hw, hw))
        elif spec.kind == "pool":
            hw = pool_out_hw(s0[2], spec.kernel, spec.stride)
            out.append((s0[0], s0[1], hw, hw))
        elif spec.kind == "flatten":
            out.append((s0[0], math.prod(s0[1:])))
        elif spec.kind == "fc":
            out.append((cfg.batch, spec.fc_out))
        elif spec.kind == "add":
            shs = [shp(p) for p in rins[i]]
            if any(s != shs[0] for s in shs):
                raise ValueError(f"{spec.name}: add operands disagree "
                                 f"({shs})")
            out.append(shs[0])
        elif spec.kind == "concat":
            shs = [shp(p) for p in rins[i]]
            if any(s[0] != shs[0][0] or s[2:] != shs[0][2:] for s in shs):
                raise ValueError(f"{spec.name}: concat operands disagree "
                                 f"on batch/spatial dims ({shs})")
            out.append((shs[0][0], sum(s[1] for s in shs)) + shs[0][2:])
        elif spec.kind == "upsample":
            f = spec.kernel
            out.append((s0[0], s0[1], s0[2] * f, s0[3] * f))
        else:                            # act/softmax inherit their input
            out.append(s0)
    return out


def init_cnn(cfg: CNNConfig, seed: int = 0,
             dtype: str = DEFAULT_DTYPE) -> Dict[str, Dict[str, np.ndarray]]:
    """Random weights as a numpy tree {layer: {"w": ..., "b": ...}}: conv
    w [Co, Ci, F, F] ~ N(0, 1/(Ci*F*F)), fc w [in, out] ~ N(0, 1/in) and
    b = 0, the reference ``init_cnn``'s distribution.  The numbers come
    from ``numpy.random.default_rng(seed)`` in float32, so both packages
    can be handed the same tree (``params_from_numpy`` here, ``jnp.asarray``
    there).  A narrower float ``dtype`` (bf16) rounds each weight once, to
    nearest even; the tree still holds float32 arrays, whose values
    ``params_from_numpy(..., dtype)`` then casts exactly."""
    rng = np.random.default_rng(seed)
    tdt = torch_dtype(dtype)
    params: Dict[str, Dict[str, np.ndarray]] = {}
    rins = resolved_cfg_inputs(cfg)
    shapes = layer_shapes(cfg)

    def in_dim(i: int) -> int:           # channels (4-D) or features (2-D)
        p = rins[i][0]
        return cfg.in_channels if p < 0 else shapes[p][1]

    def normal(shape, std) -> np.ndarray:
        v = rng.standard_normal(shape, dtype=np.float32) * np.float32(std)
        if tdt is torch.float32:
            return v
        return torch.from_numpy(v).to(tdt).float().numpy()

    for i, spec in enumerate(cfg.layers):
        if spec.kind == "conv":
            ci = in_dim(i)
            params[spec.name] = {"w": normal(
                (spec.out_channels, ci, spec.kernel, spec.kernel),
                1.0 / math.sqrt(ci * spec.kernel * spec.kernel))}
        elif spec.kind == "fc":
            feat = in_dim(i)
            params[spec.name] = {
                "w": normal((feat, spec.fc_out), 1.0 / math.sqrt(feat)),
                "b": np.zeros((spec.fc_out,), np.float32),
            }
    return params


def params_from_numpy(tree: Dict[str, Dict[str, np.ndarray]], device,
                      dtype: str = DEFAULT_DTYPE
                      ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The same tree as tensors of the storage ``dtype`` on ``device``.
    The arrays pass through float32 (exact for a bf16 array of the JAX
    package), then are cast once, to nearest even."""
    tdt = torch_dtype(dtype)
    return {layer: {k: torch.as_tensor(np.asarray(v, np.float32)).to(
                        device=device, dtype=tdt)
                    for k, v in p.items()}
            for layer, p in tree.items()}
