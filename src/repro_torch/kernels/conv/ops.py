"""Wrappers of the fused conv kernels: K1 ``csrc/conv_chwn.cu``, K2
``csrc/conv_nchw.cu``, and the conv->conv stacks K5a
``csrc/conv_stack_chwn.cu`` and K5b ``csrc/conv_stack_nchw.cu``.

All speak the reference's fused-epilogue protocol
(``repro/kernels/conv/ops.py``): ``bias``/``res``/``relu``/``pool`` fold
into the (last) conv's output write in that order (bias, residual add,
ReLU, pool), and ``src_layout``/``dst_layout`` let the kernel read its
input in the producer's layout and write its output in the consumer's.  A
stack's conv1 carries a bias[+ReLU] epilogue only.  The arguments are the
reference wrappers' own, without the TPU tiling knobs (``nt``,
``interpret``).

For a CPU tensor a wrapper returns the plain version (``ref.conv_ref``,
``ref.conv_stack_ref``).  For a CUDA tensor it launches its kernel or
raises; it never falls back, and a stack never splits into two convs.
Each wrapper counts its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.conv.ref import conv_ref, conv_stack_ref
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


def _check_layouts(name: str, **layouts: str) -> None:
    for arg, lay in layouts.items():
        if lay not in _LAYOUTS:
            raise ValueError(f"{name}: {arg}={lay!r} not in {_LAYOUTS}")


def _conv_hw(name: str, H: int, W: int, F: int, stride: int,
             pad: int) -> Tuple[int, int]:
    if stride < 1 or pad < 0:
        raise ValueError(f"{name}: stride={stride}, pad={pad}")
    Ho, Wo = conv_out_hw(H, F, stride, pad), conv_out_hw(W, F, stride, pad)
    if Ho < 1 or Wo < 1:
        raise ValueError(f"{name}: {F}x{F} window does not fit {H}x{W} "
                         f"with pad {pad}")
    return Ho, Wo


def _check_epilogue(name: str, N: int, Co: int, Ho: int, Wo: int, bias,
                    pool, res, res_layout: str) -> Tuple[int, int, int,
                                                         int, int]:
    """Check the epilogue operands of a conv with a [N, Co, Ho, Wo]
    output; returns (pool_F, pool_S, pool_avg, out_H, out_W)."""
    if bias is not None and tuple(bias.shape) != (Co,):
        raise ValueError(f"{name}: bias shape {tuple(bias.shape)} != {(Co,)}")
    if res is not None:
        want = _shape(res_layout, N, Co, Ho, Wo)
        if tuple(res.shape) != want:
            raise ValueError(f"{name}: res shape {tuple(res.shape)} != "
                             f"{want} ({res_layout})")
    if pool is None:
        return 0, 0, 0, Ho, Wo
    pF, pS, op = pool
    if op not in ("max", "avg") or pF < 1 or pS < 1:
        raise ValueError(f"{name}: unsupported pool {pool!r}")
    if pF * pF > _MAX_POOL_TAPS:
        raise ValueError(f"{name}: a {pF}x{pF} pool window has more "
                         f"than {_MAX_POOL_TAPS} taps")
    OH, OW = pool_out_hw(Ho, pF, pS), pool_out_hw(Wo, pF, pS)
    if OH < 1 or OW < 1:
        raise ValueError(f"{name}: pool {pool!r} does not fit the "
                         f"{Ho}x{Wo} conv output")
    return pF, pS, int(op == "avg"), OH, OW


def _output(name: str, x: torch.Tensor, dst_layout: str, N: int, Co: int,
            OH: int, OW: int) -> torch.Tensor:
    y = torch.empty(_shape(dst_layout, N, Co, OH, OW), device=x.device,
                    dtype=torch.float32)
    if y.numel() >= 2 ** 31:
        raise ValueError(f"{name}: output has {y.numel()} elements; the "
                         "kernel indexes with 32-bit ints")
    return y


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def _launch(entry: str, wrapper, x, w, Ci: int, Co: int, F: int, stride: int,
            pad: int, bias, relu: bool, pool, res, res_layout: str,
            src_layout: str, dst_layout: str) -> torch.Tensor:
    name = wrapper.__name__
    _check_layouts(name, src_layout=src_layout, dst_layout=dst_layout,
                   res_layout=res_layout)
    N, xc, H, W = _dims(x, src_layout)
    if xc != Ci:
        raise ValueError(f"{name}: x has {xc} channels, w expects {Ci}")
    Ho, Wo = _conv_hw(name, H, W, F, stride, pad)
    pF, pS, avg, OH, OW = _check_epilogue(name, N, Co, Ho, Wo, bias, pool,
                                          res, res_layout)
    _build.require_cuda_f32(name, x.device, x=x, w=w, bias=bias, res=res)
    y = _output(name, x, dst_layout, N, Co, OH, OW)
    err = getattr(_build.library(), entry)(
        x.data_ptr(), w.data_ptr(), _ptr(bias), _ptr(res), y.data_ptr(),
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


# ---------------------------------------------------------------------------
# conv -> conv stacks (K5a, K5b): the mid activation never leaves the SM
# ---------------------------------------------------------------------------

# the design constants of csrc/conv_stack_common.cuh
_STACK_THREADS = 256
_STACK_BK = 8             # reduction slice
_STACK_CM = 64            # mid channels per chunk
_STACK_RA = 128           # mid positions per conv1 pass
_STACK_TILE = 16384       # conv2 tile: bm x (16384 // bm) columns
_STACK_BMS = (64, 128, 256)
SMEM_PER_BLOCK = 232448   # 227 KB: the most shared memory an H100 block has
_SMS = 132                # H100 SXM streaming multiprocessors


@dataclass(frozen=True)
class StackTiling:
    """How the stack kernel cuts one launch: ``bm`` output channels by
    ``nb`` images x ``uth`` x ``utw`` output units per block, and what that
    costs (``blocks``, shared memory per block, and the FLOPs it executes,
    beside ``direct_flops`` of the two convs without any recompute)."""
    bm: int
    nb: int
    uth: int
    utw: int
    blocks: int
    smem_bytes: int
    executed_flops: int
    direct_flops: int


def _smem_bytes(bm: int, rstr: int, pool: bool) -> int:
    bn = _STACK_TILE // bm
    astr = max(bm, _STACK_CM) + 4
    bstr = max(bn, _STACK_RA)
    slab = max(_STACK_CM * rstr, bm * (bn + 1) if pool else 0)
    return 4 * (_STACK_BK * astr + _STACK_BK * bstr + slab)


@functools.lru_cache(maxsize=None)
def _mid_spans(U: int, UT: int, pF: int, pS: int, S2: int, F2: int, P2: int,
               M1: int) -> Tuple[Tuple[int, int], ...]:
    """(clipped mid rows a tile reads, number of such tiles) over the tiles
    of ``UT`` units along a dim of ``U`` units (``make_tile`` in the
    kernel)."""
    out = {}
    for u0 in range(0, U, UT):
        n = min(UT, U - u0)
        o0, on = (u0 * pS, (n - 1) * pS + pF) if pF else (u0, n)
        m0, m1 = o0 * S2 - P2, (o0 + on - 1) * S2 - P2 + F2
        span = max(0, min(m1, M1) - max(m0, 0))
        out[span] = out.get(span, 0) + 1
    return tuple(out.items())


@functools.lru_cache(maxsize=None)
def stack_tiling(engine: str, N: int, Ci: int, H: int, W: int, Cm: int,
                 F1: int, S1: int, P1: int, Co: int, F2: int, S2: int,
                 P2: int, pool: Optional[Tuple[int, int, str]] = None
                 ) -> StackTiling:
    """The block tile of one stack launch: among the tiles whose shared
    memory fits a block, the one with the least executed work per wave of
    132 blocks (the kernel recomputes conv1 on each tile's halo and once
    per ``bm``-wide slice of Co).  The CHWN engine keeps at least 8 images
    (or all of them) in a tile so its gathers run along n.  Raises
    ``ValueError`` when no tile fits."""
    Ho1, Wo1 = conv_out_hw(H, F1, S1, P1), conv_out_hw(W, F1, S1, P1)
    Ho2, Wo2 = conv_out_hw(Ho1, F2, S2, P2), conv_out_hw(Wo1, F2, S2, P2)
    pF, pS = (pool[0], pool[1]) if pool else (0, 0)
    T = pF * pF if pool else 1
    UH, UW = ((pool_out_hw(Ho2, pF, pS), pool_out_hw(Wo2, pF, pS)) if pool
              else (Ho2, Wo2))
    K1, K2 = Ci * F1 * F1, Cm * F2 * F2
    direct = 2 * N * (Cm * Ho1 * Wo1 * K1 + Co * Ho2 * Wo2 * K2)
    chunks = [min(_STACK_CM, Cm - c) for c in range(0, Cm, _STACK_CM)]
    k2_exec = sum(-(-c * F2 * F2 // _STACK_BK) * _STACK_BK for c in chunks)
    k1_exec = -(-K1 // _STACK_BK) * _STACK_BK
    best, best_key = None, None
    for bm in _STACK_BMS:
        bn = _STACK_TILE // bm
        units = bn // T
        if units < 1:
            continue
        co_tiles = -(-Co // bm)
        # powers of two up to the one that covers N
        nbs = [1 << i for i in range(12) if (1 << i) <= units
               and (1 << i) < 2 * N]
        if engine == "CHWN":
            nbs = [nb for nb in nbs if nb >= min(8, N)] or nbs[-1:]
        for nb in nbs:
            # (images in a tile, tiles with that many)
            n_tiles = ((nb, N // nb),) + (((N % nb, 1),) if N % nb else ())
            for th in range(1, min(UH, units // nb) + 1):
                uth = -(-UH // -(-UH // th))           # balanced tiles
                utw = min(UW, units // (nb * uth))
                utw = -(-UW // -(-UW // utw))
                oth = (uth - 1) * pS + pF if pool else uth
                otw = (utw - 1) * pS + pF if pool else utw
                rstr = nb * ((oth - 1) * S2 + F2) * ((otw - 1) * S2 + F2)
                smem = _smem_bytes(bm, rstr, pool is not None)
                if smem > SMEM_PER_BLOCK:
                    continue
                hs = _mid_spans(UH, uth, pF, pS, S2, F2, P2, Ho1)
                ws = _mid_spans(UW, utw, pF, pS, S2, F2, P2, Wo1)
                conv1 = 0
                for nbc, cn in n_tiles:
                    for sh, ch in hs:
                        for sw, cw in ws:
                            ra = nbc * sh * sw
                            conv1 += (cn * ch * cw * -(-ra // _STACK_RA)
                                      * _STACK_RA)
                tiles = -(-N // nb) * -(-UH // uth) * -(-UW // utw)
                blocks = tiles * co_tiles
                executed = 2 * co_tiles * (
                    conv1 * len(chunks) * _STACK_CM * k1_exec
                    + tiles * bm * bn * k2_exec)
                waves = -(-blocks // _SMS)
                key = (waves * executed / blocks, executed, smem)
                if best_key is None or key < best_key:
                    best_key = key
                    best = StackTiling(bm, nb, uth, utw, blocks, smem,
                                       executed, direct)
    if best is None:
        raise ValueError(
            f"conv stack: no block tile of a {Ho2}x{Wo2} conv2 output "
            f"(F2={F2}, S2={S2}, pool={pool}) fits the {SMEM_PER_BLOCK} "
            "bytes of shared memory a block can use")
    return best


def _stack_launch(entry: str, wrapper, engine: str, x, w1, w2, Ci: int,
                  Cm: int, Co: int, F1: int, F2: int, stride1: int,
                  pad1: int, stride2: int, pad2: int, bias1, bias2,
                  relu1: bool, relu2: bool, pool, res, res_layout: str,
                  src_layout: str, dst_layout: str):
    """Check a stack call; on the CPU return the plain version, on the
    card launch the kernel."""
    name = wrapper.__name__
    _check_layouts(name, src_layout=src_layout, dst_layout=dst_layout,
                   res_layout=res_layout)
    N, xc, H, W = _dims(x, src_layout)
    if xc != Ci:
        raise ValueError(f"{name}: x has {xc} channels, w1 expects {Ci}")
    Ho1, Wo1 = _conv_hw(name, H, W, F1, stride1, pad1)
    Ho2, Wo2 = _conv_hw(name, Ho1, Wo1, F2, stride2, pad2)
    if bias1 is not None and tuple(bias1.shape) != (Cm,):
        raise ValueError(f"{name}: bias1 shape {tuple(bias1.shape)} != "
                         f"{(Cm,)}")
    pF, pS, avg, OH, OW = _check_epilogue(name, N, Co, Ho2, Wo2, bias2,
                                          pool, res, res_layout)
    if _build.on_cpu(name, x):
        w1c, w2c = ((w1.permute(3, 0, 1, 2), w2.permute(3, 0, 1, 2))
                    if engine == "CHWN" else (w1, w2))
        return conv_stack_ref(x, w1c, w2c, stride1, pad1, stride2, pad2,
                              bias1=bias1, bias2=bias2, relu1=relu1,
                              relu2=relu2, pool=pool, res=res,
                              res_layout=res_layout, src_layout=src_layout,
                              dst_layout=dst_layout)
    tiling = stack_tiling(engine, N, Ci, H, W, Cm, F1, stride1, pad1, Co,
                          F2, stride2, pad2, tuple(pool) if pool else None)
    _build.require_cuda_f32(name, x.device, x=x, w1=w1, w2=w2, bias1=bias1,
                            bias2=bias2, res=res)
    y = _output(name, x, dst_layout, N, Co, OH, OW)
    err = getattr(_build.library(), entry)(
        x.data_ptr(), w1.data_ptr(), _ptr(bias1), w2.data_ptr(), _ptr(bias2),
        _ptr(res), y.data_ptr(), N, Ci, H, W, Cm, F1, stride1, pad1, Co, F2,
        stride2, pad2, pF, pS, avg, int(relu1), int(relu2),
        int(src_layout == "NCHW"), int(dst_layout == "NCHW"),
        int(res_layout == "NCHW"), tiling.bm, tiling.nb, tiling.uth,
        tiling.utw, _build.stream_of(x.device))
    _build.check(name, err)
    wrapper.launches += 1
    return y


def _stack_weights(name: str, w1, w2, shape: str):
    if w1.dim() != 4 or w2.dim() != 4:
        raise ValueError(f"{name}: w1/w2 must be 4-D {shape} weights, got "
                         f"{tuple(w1.shape)} / {tuple(w2.shape)}")


def conv_stack_chwn(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                    stride1: int = 1, pad1: int = 0, stride2: int = 1,
                    pad2: int = 0, *, bias1: Optional[torch.Tensor] = None,
                    bias2: Optional[torch.Tensor] = None, relu1: bool = True,
                    relu2: bool = False,
                    pool: Optional[Tuple[int, int, str]] = None,
                    res: Optional[torch.Tensor] = None,
                    res_layout: str = "CHWN", src_layout: str = "CHWN",
                    dst_layout: str = "CHWN") -> torch.Tensor:
    """K5a, the conv->conv stack on the CHWN engine: x [Ci,H,W,N] (or
    [N,Ci,H,W] for src NCHW), w1 [Ci,F1,F1,Cm], w2 [Cm,F2,F2,Co] ->
    [Co,Ho2',Wo2',N] (or NCHW for dst NCHW).  conv1 carries bias1[+ReLU];
    conv2 the full bias/residual-add/ReLU/pool epilogue."""
    _stack_weights("conv_stack_chwn", w1, w2, "[Ci,F,F,Co]")
    Ci, F1, _, Cm = w1.shape
    Cm2, F2, _, Co = w2.shape
    if Cm2 != Cm:
        raise ValueError(f"conv_stack_chwn: w2 takes {Cm2} channels, w1 "
                         f"makes {Cm}")
    return _stack_launch("conv_stack_chwn_forward", conv_stack_chwn, "CHWN",
                         x, w1, w2, Ci, Cm, Co, F1, F2, stride1, pad1,
                         stride2, pad2, bias1, bias2, relu1, relu2, pool,
                         res, res_layout, src_layout, dst_layout)


def conv_stack_nchw(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                    stride1: int = 1, pad1: int = 0, stride2: int = 1,
                    pad2: int = 0, *, bias1: Optional[torch.Tensor] = None,
                    bias2: Optional[torch.Tensor] = None, relu1: bool = True,
                    relu2: bool = False,
                    pool: Optional[Tuple[int, int, str]] = None,
                    res: Optional[torch.Tensor] = None,
                    res_layout: str = "NCHW", src_layout: str = "NCHW",
                    dst_layout: str = "NCHW") -> torch.Tensor:
    """K5b, the conv->conv stack on the per-sample NCHW engine: x
    [N,Ci,H,W] (or [Ci,H,W,N] for src CHWN), canonical w1 [Cm,Ci,F1,F1],
    w2 [Co,Cm,F2,F2] -> [N,Co,Ho2',Wo2'] (or CHWN for dst CHWN); otherwise
    as ``conv_stack_chwn``."""
    _stack_weights("conv_stack_nchw", w1, w2, "[Co,Ci,F,F]")
    Cm, Ci, F1, _ = w1.shape
    Co, Cm2, F2, _ = w2.shape
    if Cm2 != Cm:
        raise ValueError(f"conv_stack_nchw: w2 takes {Cm2} channels, w1 "
                         f"makes {Cm}")
    return _stack_launch("conv_stack_nchw_forward", conv_stack_nchw, "NCHW",
                         x, w1, w2, Ci, Cm, Co, F1, F2, stride1, pad1,
                         stride2, pad2, bias1, bias2, relu1, relu2, pool,
                         res, res_layout, src_layout, dst_layout)


conv_direct_chwn.launches = 0
conv_im2col_nchw_fused.launches = 0
conv_stack_chwn.launches = 0
conv_stack_nchw.launches = 0
