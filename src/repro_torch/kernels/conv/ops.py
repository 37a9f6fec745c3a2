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

Storage dtypes (``_build.CONV_VARIANTS``): K1, K2 and the stacks K5a and
K5b take float32 or bf16 x and w, or int8 x (per-channel quantized, its
scale folded into w, a stack's w1: ``repro_torch.quant``) with float32 or
bf16 w; biases, w2 and residual are w's dtype, and so is the output (the
reference's ``result_type(x, w)``).  A narrow launch also counts in
``<wrapper>.variant_launches[variant]``.  The kernels
accumulate in float32 and round once where they store; the plain versions
do the same.  ``save_act`` (training) stores z in the output's dtype, as
the reference does.

When an input requires grad, the wrappers run as ``torch.autograd
.Function``s (``_ConvFn``, ``_StackFn``), the counterparts of the
reference's custom VJPs: the forward saves the pre-pool activation
(``save_act``, the kernels' second output ``z``) where it pools, and the
backward (``conv_backward``) runs the pool backward K7, dgrad on the
engine's own conv kernel, the weight gradient K6 and, for a stack, the
recompute of its mid activation on K1/K2.

Beside them sit the paper's other two conv engines, inference only: the
matrix-expansion baseline ``conv_im2col_nchw`` (a materialized patch
matrix, its matmul on K10) and the FFT conv ``conv_fft_nchw``.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.core.transform import apply_transform
from repro_torch.kernels import _build
from repro_torch.kernels.conv.backward import (bias_grad, conv_dgrad,
                                               conv_wgrad)
from repro_torch.kernels.conv.ref import (conv_ref, conv_stack_ref,
                                          im2col_nchw)
from repro_torch.kernels.matmul.ops import matmul
from repro_torch.kernels.pool.backward import pool_backward
from repro_torch.shapes import conv_out_hw, pool_out_hw

_LAYOUTS = ("NCHW", "CHWN")
_ENTRY = {"CHWN": "conv_chwn_forward", "NCHW": "conv_nchw_forward"}
_WEIGHT_SHAPE = {"CHWN": "[Ci,F,F,Co]", "NCHW": "[Co,Ci,F,F]"}
_STACK_ENTRY = {"CHWN": "conv_stack_chwn_forward",
                "NCHW": "conv_stack_nchw_forward"}
SMEM_PER_BLOCK = 232448   # 227 KB: the most shared memory an H100 block has
_SMS = 132                # H100 SXM streaming multiprocessors
# the design constants of csrc/conv_chwn.cu (K1)
_K1_BN = 128              # GEMM columns of a pass
_K1_BK = 32               # reduction slice
_K1_NBK = 64              # reduction slice of the narrow (bf16 w) builds
_K1_STAGES = 3            # cp.async ring depth
_K1_PAD = 8               # shared row stride = width + 8 floats
_K1_BMS = (64, 128)       # output channels of a block
_K1_I8_BK = 32            # reduction slice of the int8->fp32 build
_K1_I8_STAGES = 4         # its ring depth
_K1_I8_PAD = 4            # its w row stride: bm + 4 floats
# what a slice of a 64-row tile costs beside a 128-row one's (half the
# work, but the same fragment loads feed half the mma): modeled, and set so
# that AlexNet's 3/2 layers take the 64-row rectangles that
# tools/kernel_variants.py --tiles times fastest on the card
_K1_BM64_COST = 0.55
_K1_FILL = 2              # pipeline fill and pool of a block, in slices


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
    OH, OW = pool_out_hw(Ho, pF, pS), pool_out_hw(Wo, pF, pS)
    if OH < 1 or OW < 1:
        raise ValueError(f"{name}: pool {pool!r} does not fit the "
                         f"{Ho}x{Wo} conv output")
    return pF, pS, int(op == "avg"), OH, OW


def _output(name: str, x: torch.Tensor, dst_layout: str, N: int, Co: int,
            OH: int, OW: int, dtype: torch.dtype) -> torch.Tensor:
    y = torch.empty(_shape(dst_layout, N, Co, OH, OW), device=x.device,
                    dtype=dtype)
    if y.numel() >= 2 ** 31:
        raise ValueError(f"{name}: output has {y.numel()} elements; the "
                         "kernel indexes with 32-bit ints")
    return y


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


@dataclass(frozen=True)
class ConvTiling:
    """How K1 cuts one launch: ``bm`` output channels by, without a pool
    (``nb == 0``), 128 consecutive columns (conv outputs, n fastest) a
    block, or, with a pool, the conv outputs under ``ph`` x ``pw`` pooled
    outputs of ``nb`` images (a rectangle; neighbouring rectangles share
    ``pF - pS`` rows and columns of conv outputs, computed by both).  What
    that costs: ``blocks``, the shared memory of one block, and the FLOPs
    the blocks execute (2*K for every conv output of every block, on every
    one of its channels below Co; tile padding not counted) beside
    ``direct_flops`` (every conv output once)."""
    bm: int
    nb: int
    ph: int
    pw: int
    blocks: int
    smem_bytes: int
    executed_flops: int
    direct_flops: int


def _k1_smem(bm: int, cmax: int) -> int:
    """One K1 block's shared memory (``conv_chwn_forward``): the ring, with
    a pool the [bm][cs] conv tile of ``cmax`` columns, and the static table
    of column offsets."""
    ring = _K1_STAGES * _K1_BK * (bm + _K1_PAD + _K1_BN + _K1_PAD)
    cs = -(-cmax // 32) * 32 + 8 if cmax else 0
    return 4 * (ring + bm * cs + 3 * _K1_BN)


def k1_narrow_smem(bm: int, cmax: int) -> int:
    """One block's shared memory in K1's narrow builds (bf16 w: the
    ``conv_chwn_narrow_kernel`` of csrc/conv_chwn.cu): a ring of
    ``_K1_STAGES`` bf16 stages, each a 64-deep slice of w [k][bm] and P
    [k][128], then the float32 conv tile and the column table as the float32
    kernel's.  Never more than ``_k1_smem``, which ``conv_tiling`` fits."""
    ring = _K1_STAGES * _K1_NBK * (bm + _K1_BN) * 2
    cs = -(-cmax // 32) * 32 + 8 if cmax else 0
    return ring + 4 * (bm * cs + 3 * _K1_BN)


def k1_i8f32_smem(bm: int, cmax: int) -> int:
    """One block's shared memory in K1's int8->fp32 build
    (``conv_chwn_i8f32_kernel`` of csrc/conv_chwn.cu): a ring of
    ``_K1_I8_STAGES`` stages, each a 32-deep slice of float32 w [k][bm + 4]
    and bf16 P [k][128], then the float32 conv tile and the column table as
    the float32 kernel's.  Never more than ``_k1_smem``, which
    ``conv_tiling`` fits."""
    ring = _K1_I8_STAGES * _K1_I8_BK * ((bm + _K1_I8_PAD) * 4 + _K1_BN * 2)
    cs = -(-cmax // 32) * 32 + 8 if cmax else 0
    return ring + 4 * (bm * cs + 3 * _K1_BN)


def _spans(U: int, t: int) -> Tuple[Tuple[int, int], ...]:
    """(size, count) of the tiles of ``t`` along ``U``: full ones, then the
    rest."""
    out = ((t, U // t),) if U // t else ()
    return out + (((U % t, 1),) if U % t else ())


@functools.lru_cache(maxsize=None)
def conv_tiling(N: int, Ci: int, H: int, W: int, Co: int, F: int, S: int,
                pad: int, pool: Optional[Tuple[int, int, str]] = None
                ) -> ConvTiling:
    """K1's block tile.  Without a pool: 128 consecutive columns by 128
    output channels (64 where Co <= 64).  With a pool: the rectangle of
    pooled outputs (and ``bm``) with the least modeled time among those
    whose conv tile fits a block's shared memory, ``nb`` at least 8 images
    (or all of them) where one fits, so a run of 8 columns is 32 bytes of a
    CHWN row.  The modeled time is the waves of resident blocks (one an
    SM) times the mean block's slices: the 8-column groups of each pass
    that hold a column, a 64-row slice weighed ``_K1_BM64_COST``, plus
    ``_K1_FILL``.  Raises ``ValueError`` when no rectangle fits."""
    Ho, Wo = conv_out_hw(H, F, S, pad), conv_out_hw(W, F, S, pad)
    K = Ci * F * F
    direct = 2 * K * Co * N * Ho * Wo
    if pool is None:
        bm = 64 if Co <= 64 else 128
        blocks = -(-(N * Ho * Wo) // _K1_BN) * -(-Co // bm)
        return ConvTiling(bm, 0, 0, 0, blocks, _k1_smem(bm, 0), direct,
                          direct)
    pF, pS = pool[0], pool[1]
    UH, UW = pool_out_hw(Ho, pF, pS), pool_out_hw(Wo, pF, pS)
    kslices = -(-K // _K1_BK)
    best, best_key = None, None
    for bm in _K1_BMS:
        co_tiles = -(-Co // bm)
        eff = _K1_BM64_COST if bm == 64 else 1.0
        for nb in sorted({min(N, v) for v in (1, 2, 4, 8, 16, 32)}):
            ns = _spans(N, nb)
            for ph in range(1, UH + 1):
                rh = (ph - 1) * pS + pF
                if _k1_smem(bm, nb * rh * pF) > SMEM_PER_BLOCK:
                    break
                hs = [((t - 1) * pS + pF, c) for t, c in _spans(UH, ph)]
                for pw in range(1, UW + 1):
                    rw = (pw - 1) * pS + pF
                    smem = _k1_smem(bm, nb * rh * rw)
                    if smem > SMEM_PER_BLOCK:
                        break
                    ws = [((t - 1) * pS + pF, c) for t, c in _spans(UW, pw)]
                    tiles = work = 0
                    for nbt, cn in ns:
                        for rht, ch in hs:
                            for rwt, cw in ws:
                                C, n = nbt * rht * rwt, cn * ch * cw
                                groups = sum(-(-min(_K1_BN, C - c0) // 8)
                                             for c0 in range(0, C, _K1_BN))
                                tiles += n
                                work += n * (groups * 8 / _K1_BN * kslices
                                             * eff + _K1_FILL)
                    blocks = tiles * co_tiles
                    executed = (2 * K * Co * N * sum(r * c for r, c in hs)
                                * sum(r * c for r, c in ws))
                    waves = -(-blocks // _SMS)
                    key = (nb < min(8, N), waves * work / tiles, executed,
                           smem)
                    if best_key is None or key < best_key:
                        best_key = key
                        best = ConvTiling(bm, nb, ph, pw, blocks, smem,
                                          executed, direct)
    if best is None:
        raise ValueError(
            f"conv_direct_chwn: no block tile of the {Ho}x{Wo} conv output "
            f"under pool {pool} fits the {SMEM_PER_BLOCK} bytes of shared "
            "memory a block can use")
    return best


# the design constants of csrc/conv_nchw.cu (K2)
_K2_BMS = (64, 128, 256)  # output channels of a block
_K2_TILE = 16384          # bm x the most conv outputs a block holds
_K2_PRODUCERS = 128       # the threads that issue a stage's copies
_K2_GAS = (1, 2, 4)       # 8-channel groups a 1x1 stage may hold
# the modeled costs, in mma of one warp, fitted by least squares (log
# time) by ``tools/kernel_variants.py --tiles`` to 778 tiles of the 53
# distinct main-path K2 shapes timed on an H100 (rms error 8.8 %; PERF.md,
# "Tile choices"): a stage's fixed cost beside its mma (the FULL/EMPTY
# hand-off), one copy instruction of a producer thread, a byte of the w
# slice and of the x box that a stage moves into shared memory (the box's
# short rows cost more), a block's fixed cost (launch, prologue, epilogue,
# drain), and how far a stage's mma, copies and bytes overlap (the order
# of their power mean: 1 adds them, infinity takes the longest)
_K2_STAGE_COST = 21.8
_K2_COPY_COST = 5.4
_K2_BYTE_COST = 0.0042
_K2_XBYTE_COST = 0.0091
_K2_BLOCK_COST = 1060
_K2_OVERLAP = 1.9


@dataclass(frozen=True)
class NchwTiling:
    """How K2 cuts one launch: ``bm`` output channels by the conv outputs
    under ``nb`` images x ``uth`` x ``utw`` units (pooled outputs with a
    pool, conv outputs without; neighbouring rectangles of pooled outputs
    share ``pF - pS`` rows and columns of conv outputs, computed by both),
    ``tr`` of the F tap rows and ``ga`` 8-channel groups a stage (1x1
    convs; else 1).  What that
    costs: ``blocks``, the shared memory of one block, and the FLOPs the
    blocks execute (2*K for every conv output of every block, on every one
    of its channels below Co; tile padding not counted) beside
    ``direct_flops``."""
    bm: int
    nb: int
    uth: int
    utw: int
    tr: int
    ga: int
    blocks: int
    smem_bytes: int
    executed_flops: int
    direct_flops: int


def _k2_thin(Ci: int) -> bool:
    """Fewer than 8 input channels: K2 steps its reduction along the list
    of (tap row, channel, dx) instead of 8 channels at one tap."""
    return Ci < 8


def _unit_rows(u: int, pF: int, pS: int) -> int:
    """Conv output rows (or columns) under ``u`` units: pooled outputs of
    an F x F / S pool (pF > 0), or the conv outputs themselves."""
    return (u - 1) * pS + pF if pF else u


def _k2_xw(ow: int, S: int, F: int) -> int:
    """The x box width of ``ow`` conv output columns (``make_tile``: from
    4-float alignment, its first column up to 3 in)."""
    return (3 + (ow - 1) * S + F + 3) // 4 * 4


def _k2_sa(Ci: int, F: int, tr: int, ga: int) -> Tuple[int, int]:
    """(w slice row stride, KP) of a K2 stage: 8 ga tr F + 4, or thin the
    k list of tr rows padded to 8 (KP), + 4."""
    if _k2_thin(Ci):
        kp = -(-(tr * Ci * F) // 8) * 8
        return kp + 4, kp
    return 8 * ga * tr * F + 4, 0


def k2_layout(Ci: int, F: int, S: int, pF: int, pS: int, bm: int, nb: int,
              uth: int, utw: int, tr: int, ga: int = 1) -> int:
    """One K2 block's dynamic shared memory (``layout`` in
    csrc/conv_nchw.cu): a ring of stages (3; 2 at bm 256), each the w slice
    and the x box of its taps, or the epilogue tile [bm][16384 / bm + 8]
    where that is larger.  A stage holds ``ga`` groups of 8 input channels
    at ``tr`` tap rows (ga > 1 for 1x1 convs only): w [bm][8 ga tr F +
    4], x [8 ga][nb x XH x XW]
    (channels 8 mod 32 floats apart); thin (``_k2_thin``), the list of (tap
    row, channel, dx) of ``tr`` rows padded to 8 (KP): w [bm][KP + 4], x
    [Ci + 1][nb x XH x XW], and after the ring two tables of KP ints."""
    xh = (_unit_rows(uth, pF, pS) - 1) * S + tr
    xstr = _rows8(nb * xh * _k2_xw(_unit_rows(utw, pF, pS), S, F))
    sa, kp = _k2_sa(Ci, F, tr, ga)
    stage = bm * sa + (Ci + 1 if _k2_thin(Ci) else 8 * ga) * xstr
    ring = (2 if bm == 256 else 3) * stage
    return 4 * (max(ring, bm * (_K2_TILE // bm + 8)) + 2 * kp)


def k2_bf16_xv(x_dtype: torch.dtype, src_layout: str, W: int) -> int:
    """The widest copy lane K2's bf16 builds may take for an x box row, as
    elements one copy moves (``forward`` in csrc/conv_nchw.cu picks it the
    same way, for an x as aligned as a fresh tensor): bf16 x in NCHW by
    16-byte ``cp.async`` (8) where W % 8 == 0, 8-byte (4) where W % 4 ==
    0, 4-byte (2) where W % 2 == 0; int8 x in NCHW by 8-byte loads
    widened in registers (8) where W % 8 == 0; else element by element
    (1), as every CHWN source."""
    if src_layout != "NCHW":
        return 1
    if W % 8 == 0:
        return 8
    if x_dtype == torch.int8:
        return 1
    return 4 if W % 4 == 0 else 2 if W % 2 == 0 else 1


def k2_bf16_layout(Ci: int, F: int, S: int, pF: int, pS: int, bm: int,
                   nb: int, uth: int, utw: int, tr: int, ga: int = 1,
                   xv: int = 8, int8_x: bool = False) -> Tuple[int, int]:
    """(copy lane, block bytes) of K2's bf16 builds at a tile
    (``layout_bf16`` in csrc/conv_nchw.cu).  A stage steps 16 input
    channels at one tap: ceil(ga / 2) groups of 16 at ``tr`` tap rows, w
    [bm][16 gb tr F + 8] and x [16 gb][nb x XH x XW] in halfwords (the
    bytes of the float32 stage's 8 channels); thin, the k list padded to
    16 (KP), w [bm][KP + 8], x [Ci + 1][nb x XH x XW] and two tables of KP
    ints after the ring; the epilogue tile over all.  ``xv`` is the widest
    lane the source allows (``k2_bf16_xv``); its box starts at a column
    aligned down to xv and is 8 (xv 8) or 4 columns a multiple wide, and
    where lane 8's box would take more than ``k2_layout``'s bytes the rows
    copy by lane 4 (bf16) or element by element (``int8_x``)."""
    fit = k2_layout(Ci, F, S, pF, pS, bm, nb, uth, utw, tr, ga)
    thin = _k2_thin(Ci)
    xh = (_unit_rows(uth, pF, pS) - 1) * S + tr
    span = (_unit_rows(utw, pF, pS) - 1) * S + F
    gb = -(-ga // 2)
    kp = -(-(tr * Ci * F) // 16) * 16 if thin else 0
    sa = kp + 8 if thin else 16 * gb * tr * F + 8
    cv = Ci + 1 if thin else 16 * gb

    def at(v):
        m = 8 if v == 8 else 4
        xstr = _rows8(nb * xh * (-(-(v - 1 + span) // m) * m))
        ring = (2 if bm == 256 else 3) * (bm * sa + cv * xstr)  # halfwords
        return v, max(2 * ring + 8 * kp, 4 * bm * (_K2_TILE // bm + 8))

    lane = at(xv)
    if xv == 8 and lane[1] > fit:
        lane = at(1 if int8_x else 4)
    return lane


def _k2_tap_rows(Ci: int, F: int) -> Tuple[int, ...]:
    """The tap rows a K2 stage may hold, in order of preference: all F,
    then fewer; a channel-major stage keeps a channel's ``tr * F`` taps odd
    for an odd F (the A fragment loads stay free of bank conflicts)."""
    return (F,) + tuple(t for t in range(F - 1, 0, -1)
                        if _k2_thin(Ci) or F % 2 == 0 or t % 2 == 1)


def _k2_overlap(*times: float) -> float:
    """The time of work that overlaps only in part: the power mean of
    order ``_K2_OVERLAP`` of the parts' times, between their sum (order 1)
    and the longest alone (order infinity)."""
    return sum(t ** _K2_OVERLAP for t in times) ** (1 / _K2_OVERLAP)


def _k2_copy_time(items: int, ops: int) -> float:
    """The producers' time for ``items`` row segments of ``ops`` copies
    each, 128 threads taking one at a time."""
    return -(-items // _K2_PRODUCERS) * ops * _K2_COPY_COST


def _k2_block_cost(Ci: int, W: int, F: int, S: int, bm: int, tr: int,
                   ga: int, nbc: int, oh: int, ow: int, xw: int,
                   K: int) -> float:
    """The modeled time of one K2 block over nbc images x oh x ow conv
    outputs (box xw columns wide), in mma of one warp: each stage the
    longest of its consumers' mma (6 a step for each of a warp's 8 column
    tiles), its producers' copies (``conv_nchw_kernel``'s row segments: w,
    then the x box) and the bytes it moves, and the block's fixed cost."""
    thin = _k2_thin(Ci)
    per_quad = 1 if W % 4 == 0 else 2 if W % 2 == 0 else 4
    xq = xw // 4
    NS = 2 if bm == 256 else 3
    cost, sl = 0.0, 0
    for _ in range(1 if thin else -(-(-(-Ci // 8)) // ga)):
        for dy0 in range(0, F, tr):
            trc = min(tr, F - dy0)
            sa, _ = _k2_sa(Ci, F, trc, ga)
            if thin:
                steps = (sa - 4) // 8
                segs = max(1, min(sa - 4, _K2_PRODUCERS // bm))
                w = _k2_copy_time(bm * segs, -(-(sa - 4) // segs))
            elif tr == F:
                steps, wq = ga * trc * F, 2 * ga * F * F
                segs = max(1, min(wq, _K2_PRODUCERS // bm))
                w = _k2_copy_time(bm * segs, -(-wq // segs)
                                  * (1 if K % 4 == 0 else 4))
            else:
                steps = trc * F
                w = _k2_copy_time(bm * 8, trc * F)
            rows = ((Ci + (sl < NS) if thin else 8 * ga) * nbc
                    * ((oh - 1) * S + trc))
            segs = max(1, min(xq, _K2_PRODUCERS // rows))
            x = _k2_copy_time(rows * segs, -(-xq // segs) * per_quad)
            cost += _k2_overlap(48 * steps + _K2_STAGE_COST, w + x,
                                4 * bm * (sa - 4) * _K2_BYTE_COST
                                + 4 * rows * xw * _K2_XBYTE_COST)
            sl += 1
    return cost + _K2_BLOCK_COST


@functools.lru_cache(maxsize=None)
def k2_tilings(N: int, Ci: int, H: int, W: int, Co: int, F: int, S: int,
               pad: int, pool: Optional[Tuple[int, int, str]] = None
               ) -> Tuple[Tuple[float, NchwTiling], ...]:
    """K2's candidate tiles, each with its modeled time: ``bm`` and a
    rectangle of ``nb`` images x ``uth`` x ``utw`` units whose conv outputs
    fit the block's 16384 // bm columns, with the most tap rows a stage
    (``_k2_tap_rows``) whose shared memory fits, and a 1x1 conv 1, 2 or 4
    groups of 8 channels a stage.  The modeled time is waves of one block
    an SM times the mean block's ``_k2_block_cost``."""
    Ho, Wo = conv_out_hw(H, F, S, pad), conv_out_hw(W, F, S, pad)
    pF, pS = (pool[0], pool[1]) if pool else (0, 0)
    UH, UW = ((pool_out_hw(Ho, pF, pS), pool_out_hw(Wo, pF, pS)) if pool
              else (Ho, Wo))
    K = Ci * F * F
    direct = 2 * K * Co * N * Ho * Wo
    thin = _k2_thin(Ci)

    def rows(u: int) -> int:
        return _unit_rows(u, pF, pS)

    cands = []
    for bm in _K2_BMS[:2] if thin else _K2_BMS:
        bn = _K2_TILE // bm
        co_tiles = -(-Co // bm)
        for nb in [1 << i for i in range(9) if (1 << i) < 2 * N]:
            ns = _spans(N, nb)
            for uth in _balanced(UH, bn):
                if nb * rows(uth) > bn:
                    break
                hs = [(rows(t), c) for t, c in _spans(UH, uth)]
                for utw in _balanced(UW, bn):
                    if nb * rows(uth) * rows(utw) > bn:
                        break
                    fits = [(tr, k2_layout(Ci, F, S, pF, pS, bm, nb, uth,
                                           utw, tr))
                            for tr in _k2_tap_rows(Ci, F)]
                    fits = [f for f in fits if f[1] <= SMEM_PER_BLOCK]
                    if not fits:
                        continue
                    tr, smem = fits[0]
                    gas = [(1, smem)]
                    if F == 1 and not thin:
                        gas += [(ga, k2_layout(Ci, F, S, pF, pS, bm, nb, uth,
                                               utw, tr, ga))
                                for ga in _K2_GAS[1:] if 8 * ga < Ci]
                    ws = [(rows(t), c) for t, c in _spans(UW, utw)]
                    executed = (2 * K * Co * N * sum(r * c for r, c in hs)
                                * sum(r * c for r, c in ws))
                    for ga, smem in gas:
                        if smem > SMEM_PER_BLOCK:
                            continue
                        tiles = work = 0
                        for nbc, cn in ns:
                            for rh, ch in hs:
                                for rw, cw in ws:
                                    tiles += cn * ch * cw
                                    work += cn * ch * cw * _k2_block_cost(
                                        Ci, W, F, S, bm, tr, ga, nbc, rh, rw,
                                        _k2_xw(rw, S, F), K)
                        blocks = tiles * co_tiles
                        waves = -(-blocks // _SMS)
                        cands.append((waves * work / tiles, NchwTiling(
                            bm, nb, uth, utw, tr, ga, blocks, smem,
                            executed, direct)))
    return tuple(cands)


@functools.lru_cache(maxsize=None)
def nchw_tiling(N: int, Ci: int, H: int, W: int, Co: int, F: int, S: int,
                pad: int, pool: Optional[Tuple[int, int, str]] = None
                ) -> NchwTiling:
    """K2's block tile: among ``k2_tilings``, the least modeled time, then
    the fewer executed FLOPs and shared memory.  Raises ``ValueError`` when
    no tile fits."""
    cands = k2_tilings(N, Ci, H, W, Co, F, S, pad, pool)
    if not cands:
        raise ValueError(
            f"conv_im2col_nchw_fused: no block tile of the conv output of "
            f"a {H}x{W} input (F={F}, S={S}, pad={pad}) under pool {pool} "
            f"fits the {SMEM_PER_BLOCK} bytes of shared memory a block can "
            "use")
    return min(cands, key=lambda c: (c[0], c[1].executed_flops,
                                     c[1].smem_bytes))[1]


def _launch(entry: str, wrapper, engine: str, x, w, Ci: int, Co: int,
            F: int, stride: int, pad: int, bias, relu: bool, pool, res,
            res_layout: str, src_layout: str, dst_layout: str,
            save_act: bool, stats=None):
    """Check one K1/K2 call and launch it.  ``stats`` (K2 only): int64 on
    the card that the kernel adds its executed FLOPs to."""
    name = wrapper.__name__
    _check_layouts(name, src_layout=src_layout, dst_layout=dst_layout,
                   res_layout=res_layout)
    N, xc, H, W = _dims(x, src_layout)
    if xc != Ci:
        raise ValueError(f"{name}: x has {xc} channels, w expects {Ci}")
    Ho, Wo = _conv_hw(name, H, W, F, stride, pad)
    pF, pS, avg, OH, OW = _check_epilogue(name, N, Co, Ho, Wo, bias, pool,
                                          res, res_layout)
    dev, variant = _build.require_cuda_conv(name, x, w, bias=bias, res=res)
    y = _output(name, x, dst_layout, N, Co, OH, OW, w.dtype)
    z = None
    if save_act:
        # conv outputs under no pool window are never computed: zero them
        covered = not pF or (pF >= pS and (Ho - pF) % pS == 0
                             and (Wo - pF) % pS == 0)
        z = (torch.empty if covered else torch.zeros)(
            _shape(engine, N, Co, Ho, Wo), device=x.device, dtype=w.dtype)
    pool = tuple(pool) if pool else None
    if engine == "CHWN":
        t = conv_tiling(N, Ci, H, W, Co, F, stride, pad, pool)
        tile = (t.bm, t.nb, t.ph, t.pw)
    else:
        t = nchw_tiling(N, Ci, H, W, Co, F, stride, pad, pool)
        tile = (t.bm, t.nb, t.uth, t.utw, t.tr, t.ga, _ptr(stats))
    err = _build.entry(entry, variant)(
        x.data_ptr(), w.data_ptr(), _ptr(bias), _ptr(res), y.data_ptr(),
        _ptr(z), N, Ci, H, W, Co, F, stride, pad, pF, pS, avg, int(relu),
        int(src_layout == "NCHW"), int(dst_layout == "NCHW"),
        int(res_layout == "NCHW"), *tile, _build.stream_of(dev))
    _build.check(name, err)
    wrapper.launches += 1
    if variant:
        wrapper.variant_launches[variant] += 1
    return (y, z) if save_act else y


def _conv(engine: str, x: torch.Tensor, w: torch.Tensor, stride: int = 1,
          pad: int = 0, *, bias: Optional[torch.Tensor] = None,
          relu: bool = False, pool: Optional[Tuple[int, int, str]] = None,
          res: Optional[torch.Tensor] = None, res_layout: Optional[str] = None,
          src_layout: Optional[str] = None, dst_layout: Optional[str] = None,
          save_act: bool = False):
    """One fused conv on ``engine``'s kernel (K1 for "CHWN", w
    [Ci,F,F,Co]; K2 for "NCHW", w [Co,Ci,F,F]), outside autograd: its plain
    version for a CPU tensor, the kernel for a CUDA tensor.  With
    ``save_act`` returns ``(y, z)``, z the pre-pool activation in the
    engine's layout."""
    wrapper = conv_direct_chwn if engine == "CHWN" else conv_im2col_nchw_fused
    if w.dim() != 4:
        raise ValueError(f"w must be {_WEIGHT_SHAPE[engine]}, got "
                         f"{tuple(w.shape)}")
    src, dst = src_layout or engine, dst_layout or engine
    rlay = res_layout or engine
    if _build.on_cpu(wrapper.__name__, x):
        w_oihw = w.permute(3, 0, 1, 2) if engine == "CHWN" else w
        return conv_ref(x, w_oihw, stride, pad, bias=bias, relu=relu,
                        pool=pool, res=res, res_layout=rlay, src_layout=src,
                        dst_layout=dst, save_act=save_act, act_layout=engine)
    if engine == "CHWN":
        Ci, F, _, Co = w.shape
    else:
        Co, Ci, F, _ = w.shape
    return _launch(_ENTRY[engine], wrapper, engine, x, w, Ci, Co, F, stride,
                   pad, bias, relu, pool, res, rlay, src, dst, save_act)


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def conv_backward(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                  act: Optional[torch.Tensor], *, engine: str, stride: int,
                  pad: int, relu: bool,
                  pool: Optional[Tuple[int, int, str]], res_layout: str,
                  src_layout: str, dst_layout: str,
                  needs: Tuple[bool, bool, bool, bool]):
    """Gradients (dx, dw, dbias, dres) of one fused conv, as the
    reference's ``_conv_bwd`` (``repro/kernels/conv/ops.py``) computes
    them; ``needs`` says which to compute (None for the others).

    ``g`` arrives in ``dst_layout``; ``act`` is the saved activation: the
    pre-pool ``z`` (engine layout) with a pool, else the output y (for the
    ReLU mask).  With a pool, K7 routes g through the max mask or the avg
    scatter and applies the ReLU mask in one pass; without, the mask is
    ``g * (y > 0)``.  dgrad is the engine's own conv kernel on the
    dilated, rotated problem, written straight in ``src_layout``; dw comes
    from K6 (in the engine's weight layout), in float32, and db from a
    float32 sum, each rounded once to its parameter's dtype as the
    reference rounds them; a folded residual's gradient is the masked
    gradient, re-laid-out into ``res_layout`` (K9a on the card)."""
    need_dx, need_dw, need_db, need_dres = needs
    F = w.shape[1] if engine == "CHWN" else w.shape[2]
    g = g.contiguous()
    if pool is not None:
        ga = pool_backward(act, g, pool[0], pool[1], pool[2], layout=engine,
                           g_layout=dst_layout, relu_mask=relu)
        g_lay = engine
    else:
        ga = g * (act > 0) if relu else g
        g_lay = dst_layout
    dx = dw = db = dres = None
    if need_dx:
        w_oihw = w.permute(3, 0, 1, 2) if engine == "CHWN" else w
        _, _, H, W = _dims(x, src_layout)
        dx = conv_dgrad(ga, w_oihw, (H, W), stride, pad, layout=engine,
                        g_layout=g_lay, dst_layout=src_layout)
    if need_dw:
        dw = conv_wgrad(x, ga, F, stride, pad, x_layout=src_layout,
                        g_layout=g_lay).to(w.dtype)
        if engine == "CHWN":
            dw = dw.permute(1, 2, 3, 0).contiguous()
    if need_db:
        db = bias_grad(ga, g_lay).to(w.dtype)
    if need_dres:
        dres = apply_transform(ga, g_lay, res_layout, use_kernel=True)
    return dx, dw, db, dres


class _ConvFn(torch.autograd.Function):
    """K1/K2 with their gradient: the forward saves the pre-pool activation
    (``save_act``) when it pools, the backward is ``conv_backward``."""

    @staticmethod
    def forward(ctx, x, w, bias, res, engine, stride, pad, relu, pool,
                res_layout, src_layout, dst_layout):
        kw = dict(bias=bias, relu=relu, pool=pool, res=res,
                  res_layout=res_layout, src_layout=src_layout,
                  dst_layout=dst_layout)
        if pool is not None:
            y, act = _conv(engine, x, w, stride, pad, save_act=True, **kw)
        else:
            y = _conv(engine, x, w, stride, pad, **kw)
            act = y if relu else None
        ctx.conf = dict(engine=engine, stride=stride, pad=pad, relu=relu,
                        pool=pool, res_layout=res_layout,
                        src_layout=src_layout, dst_layout=dst_layout)
        ctx.save_for_backward(x, w, act)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, act = ctx.saved_tensors
        grads = conv_backward(g, x, w, act, needs=ctx.needs_input_grad[:4],
                              **ctx.conf)
        return grads + (None,) * 8


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
    skip tensor, conv-output shape, stored in ``res_layout``).
    Differentiable (``_ConvFn``) when an input requires grad."""
    if _wants_grad(x, w, bias, res):
        return _ConvFn.apply(x, w, bias, res, "CHWN", stride, pad, relu,
                             pool, res_layout, src_layout, dst_layout)
    return _conv("CHWN", x, w, stride, pad, bias=bias, relu=relu, pool=pool,
                 res=res, res_layout=res_layout, src_layout=src_layout,
                 dst_layout=dst_layout)


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
    CHWN), with the same optional fused epilogue as K1; differentiable
    like it."""
    if _wants_grad(x, w, bias, res):
        return _ConvFn.apply(x, w, bias, res, "NCHW", stride, pad, relu,
                             pool, res_layout, src_layout, dst_layout)
    return _conv("NCHW", x, w, stride, pad, bias=bias, relu=relu, pool=pool,
                 res=res, res_layout=res_layout, src_layout=src_layout,
                 dst_layout=dst_layout)


def conv_im2col_nchw_fused_counted(x: torch.Tensor, w: torch.Tensor,
                                   stride: int = 1, pad: int = 0, **kw
                                   ) -> Tuple[torch.Tensor, int]:
    """K2 once on the card (arguments as ``conv_im2col_nchw_fused``,
    outside autograd), with the kernel counting what it runs: (y, the FLOPs
    its blocks executed).  What shows that ``nchw_tiling`` prices the
    kernel exactly."""
    if _build.on_cpu("conv_im2col_nchw_fused_counted", x):
        raise ValueError("conv_im2col_nchw_fused_counted: the count comes "
                         "from the kernel; pass CUDA tensors")
    if w.dim() != 4:
        raise ValueError(f"w must be {_WEIGHT_SHAPE['NCHW']}, got "
                         f"{tuple(w.shape)}")
    stats = torch.zeros(1, dtype=torch.int64, device=x.device)
    kw = {"bias": None, "relu": False, "pool": None, "res": None,
          "res_layout": "NCHW", "src_layout": "NCHW", "dst_layout": "NCHW",
          **kw}
    Co, Ci, F, _ = w.shape
    y = _launch(_ENTRY["NCHW"], conv_im2col_nchw_fused, "NCHW", x, w, Ci, Co,
                F, stride, pad, kw["bias"], kw["relu"], kw["pool"],
                kw["res"], kw["res_layout"], kw["src_layout"],
                kw["dst_layout"], False, stats=stats)
    return y, int(stats.item())


# ---------------------------------------------------------------------------
# conv -> conv stacks (K5a, K5b): the mid activation never leaves the SM
# ---------------------------------------------------------------------------

# the conv2 tile of both stack kernels: bm x (16384 // bm) GEMM columns
_STACK_TILE = 16384
_STACK_BMS = (64, 128, 256)
# the design constants of csrc/conv_stack_nchw.cu (K5b)
_K5B_CM = 32              # mid channels of a chunk
_K5B_PASS = 32            # 8-position tiles of a conv1 pass
# a stage's fixed cost beside its mma (the FULL/EMPTY hand-off, the weight
# fragments of each tap), in mma of one warp (modeled)
_K5B_STAGE_COST = 24
# the design constants of csrc/conv_stack_chwn.cu (K5a, the cluster kernel)
_CL_BK = 16               # reduction slice of both phases
_CL_CM = 64               # mid channels per chunk
_CL_PASS = 128            # mid positions of a conv1 pass (a 64-wide tail)
_CL_MAX = 8               # the portable cluster size
# clusters of 1..8 blocks resident at once on an H100 SXM at one block an
# SM (cudaOccupancyMaxActiveClusters of K5a, conv_stack_chwn_max_clusters;
# the SMs of a GPC that no whole cluster fills stay idle)
_H100_CLUSTERS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}
# what a conv1 FLOP of K5a costs beside a conv2 FLOP in a 64-wide pass (a
# 4 x 4 thread tile: one shared-memory load for 8 FMAs, against 10.7 in
# the 128-wide 4 x 8 passes; H100 timings of the AlexNet stack's tiles)
_CL_TAIL_COST = 1.4


@dataclass(frozen=True)
class StackTiling:
    """How a stack kernel cuts one launch: ``bm`` output channels by ``nb``
    images x ``uth`` x ``utw`` output units per block, ``cluster`` blocks
    (along Co) sharing one conv1 (K5a; 1 for K5b), and what that costs:
    ``blocks``, the shared memory of one block, and the FLOPs the kernel
    executes beside ``direct_flops`` of the two convs without any
    recompute."""
    bm: int
    nb: int
    uth: int
    utw: int
    blocks: int
    smem_bytes: int
    executed_flops: int
    direct_flops: int
    cluster: int = 1


def _cluster_ring_bytes(bm: int) -> int:
    """The ring of one K5a block (``CShape::RING`` floats in
    csrc/conv_stack_chwn.cu): two slices of either phase."""
    bn = _STACK_TILE // bm
    return 4 * max(2 * _CL_BK * (_CL_CM + 4 + _CL_PASS),
                   2 * _CL_BK * (bm + 4 + bn))


def _cluster_smem_bytes(bm: int, rstr: int, pool: bool) -> int:
    """One K5a block's dynamic shared memory (``smem_bytes`` in
    csrc/conv_stack_chwn.cu): the double-buffered ring of both phases'
    slices, then the mid slab (or the pool tile over it)."""
    bn = _STACK_TILE // bm
    slab = max(_CL_CM * rstr, bm * (bn + 1) if pool else 0)
    return _cluster_ring_bytes(bm) + 4 * slab


def k5a_bf16_ring_bytes(bm: int) -> int:
    """The rings of K5a's bf16 build (``NShape`` in
    csrc/conv_stack_chwn.cu): the larger of phase A's (four 16-deep bf16
    slices of w1 [k][64] and of x [k][128]) and phase B's (three 16-deep
    bf16 slices of w2 [k][bm], two float32 mid tiles [16][bn + 4]).  They
    lie inside the float32 build's ring (``_cluster_ring_bytes``), so the
    slab sits where it does there and a block's shared memory is the
    float32 build's, which ``stack_tiling`` fits."""
    bn = _STACK_TILE // bm
    phase_a = 4 * 16 * _CL_CM * 2 + 4 * 16 * _CL_PASS * 2
    phase_b = 3 * 16 * bm * 2 + 2 * 16 * (bn + 4) * 4
    return max(phase_a, phase_b)


# K5a's int8->bf16 kernel (``cluster_stack_i8bf16_kernel``): a stage is
# one k16 slice, phase A's w1 [16][64] and x [16][<= 128] bf16 slices and
# the x bytes [16][<= 128], or phase B's w2 [16][bm] bf16 slice
_K5A_I8_XB = 16 * _CL_CM * 2          # byte offset of the x bf16 slice
_K5A_I8_X8 = _K5A_I8_XB + 16 * _CL_PASS * 2   # ... and of the x bytes


def k5a_i8bf16_stages(bm: int) -> Tuple[int, int]:
    """(NS, slot bytes) of K5a's int8->bf16 kernel (``IShape``): as many
    stages as the twin's ring (``_cluster_ring_bytes``) holds, so its slab
    stays where the twin's is."""
    slot = max(_K5A_I8_X8 + 16 * _CL_PASS, 16 * bm * 2)
    return _cluster_ring_bytes(bm) // slot, slot


def k5a_i8bf16_smem(bm: int, rstr: int, pool: bool) -> int:
    """One K5a int8->bf16 block's dynamic shared memory: its NS stages lie
    inside the twin's ring and the slab (or the pool tile) follows it, so
    it allocates what the twin does (``_cluster_smem_bytes``).  Raises
    ``ValueError`` where the stages would outgrow the twin's ring."""
    ns, slot = k5a_i8bf16_stages(bm)
    if ns < 3 or ns * slot > _cluster_ring_bytes(bm):
        raise ValueError(f"K5a int8->bf16: {ns} stages of {slot} bytes do "
                         f"not fit the twin's {_cluster_ring_bytes(bm)}-"
                         "byte ring")
    return _cluster_smem_bytes(bm, rstr, pool)


def k5a_i8bf16_stage(sl: int, nsl1: int, nA: int, nB: int
                     ) -> Tuple[int, int, int, int]:
    """(chunk, pass, slice, q) of stage ``sl`` of a K5a int8->bf16 block,
    in closed form: per chunk ``nA`` phase-A stages (passes of ``nsl1`` k16
    slices), then ``nB`` phase-B ones (q >= 0; -1 in phase A).  The kernel
    walks it from ``IWalk::first`` by ``IWalk::step``
    (``k5a_i8bf16_step``)."""
    per = nA + nB
    chunk, r = divmod(sl, per)
    if r < nA:
        return chunk, r // nsl1, r % nsl1, -1
    return chunk, 0, 0, r - nA


def k5a_i8bf16_step(stage: Tuple[int, int, int, int], nsl1: int, nA: int,
                    nB: int) -> Tuple[int, int, int, int]:
    """The stage after ``stage`` in K5a int8->bf16's walk (``IWalk::step``,
    how its producers move on without a division)."""
    chunk, pas, s, q = stage
    if q < 0:
        s += 1
        if s == nsl1:
            s, pas = 0, pas + 1
            if pas * nsl1 == nA:
                pas, q = 0, 0
        return chunk, pas, s, q
    q += 1
    if q == nB:
        return chunk + 1, pas, s, (-1 if nA else 0)
    return chunk, pas, s, q


def k5a_i8bf16_runs(KRA: int, pt: int):
    """(k row, run) of each x run of 8 positions that producer thread
    ``pt`` copies into a phase-A stage of ``KRA`` positions, in its
    order."""
    for e in range(pt, 16 * KRA // 8, 128):
        yield divmod(e, KRA // 8)


def k5a_i8bf16_swz(KRA: int, r: int, c: int) -> int:
    """Halfword offset of 16-byte chunk ``c`` of row ``r`` of a [16][KRA]
    bf16 slice, XOR-swizzled by the row (``mma::swz``)."""
    return r * KRA + ((c ^ (r & 7)) << 3)


# K5a's int8->fp32 kernel (``cluster_stack_i8f32_kernel``): a stage is a
# phase-A k16 slice, w1 [16][64] float32 in rows of 64 + 4 floats, then x
# [16][<= 128] as bf16 and as bytes (the int8->bf16 kernel's x), or a
# phase-B stage of 4 // (bm // 64) k8 slices of w2 [8][bm] float32 in rows
# of bm + 8 floats
_K5A_F32_XB = 16 * (_CL_CM + 4) * 4     # byte offset of the x bf16 slice
_K5A_F32_X8 = _K5A_F32_XB + 16 * _CL_PASS * 2   # ... and of the x bytes


def k5a_i8f32_stages(bm: int) -> Tuple[int, int]:
    """(NS, slot bytes) of K5a's int8->fp32 kernel (``FShape``): as many
    stages as the twin's ring (``_cluster_ring_bytes``) holds, so its slab
    stays where the twin's is."""
    phase_b = (4 // (bm // 64)) * 8 * (bm + 8) * 4
    slot = max(_K5A_F32_X8 + 16 * _CL_PASS, phase_b)
    return _cluster_ring_bytes(bm) // slot, slot


def k5a_i8f32_smem(bm: int, rstr: int, pool: bool) -> int:
    """One K5a int8->fp32 block's dynamic shared memory: its NS stages lie
    inside the twin's ring and the slab (or the pool tile) follows it, so
    it allocates what the twin does (``_cluster_smem_bytes``).  Raises
    ``ValueError`` where fewer than 3 stages fit the twin's ring."""
    ns, slot = k5a_i8f32_stages(bm)
    if ns < 3 or ns * slot > _cluster_ring_bytes(bm):
        raise ValueError(f"K5a int8->fp32: {ns} stages of {slot} bytes do "
                         f"not fit the twin's {_cluster_ring_bytes(bm)}-"
                         "byte ring")
    return _cluster_smem_bytes(bm, rstr, pool)


@functools.lru_cache(maxsize=None)
def _mid_spans(U: int, UT: int, pF: int, pS: int, S2: int, F2: int, P2: int,
               M1: int) -> Tuple[Tuple[Tuple[int, int], int], ...]:
    """((conv2 outputs, clipped mid rows a tile reads), number of such
    tiles) over the tiles of ``UT`` units along a dim of ``U`` units
    (``make_tile`` in the kernels)."""
    out = {}
    for u0 in range(0, U, UT):
        n = min(UT, U - u0)
        o0, on = (u0 * pS, (n - 1) * pS + pF) if pF else (u0, n)
        m0, m1 = o0 * S2 - P2, (o0 + on - 1) * S2 - P2 + F2
        span = max(0, min(m1, M1) - max(m0, 0))
        out[(on, span)] = out.get((on, span), 0) + 1
    return tuple(out.items())


@functools.lru_cache(maxsize=None)
def _rank_passes(ra: int, cl: int) -> Tuple[int, int, float]:
    """(128-wide, 64-wide) conv1 passes that the ``cl`` ranks of a cluster
    run together over a tile of ``ra`` mid positions, and the slowest
    rank's share in positions (a 64-wide pass weighed ``_CL_TAIL_COST``):
    each rank takes a range of ``ceil(ra / cl)`` positions rounded up to
    whole 64-position passes (the last rank the rest), in passes of 128
    and one of 64 where no more than 64 remain (as
    ``cluster_stack_kernel`` does)."""
    rr = -(-(-(-ra // cl)) // 64) * 64
    wide = tail = 0
    slowest = 0.0
    for q in range(cl):
        n = max(0, min(rr, ra - q * rr))
        w, t = n // _CL_PASS + (n % _CL_PASS > 64), 0 < n % _CL_PASS <= 64
        wide, tail = wide + w, tail + t
        slowest = max(slowest, w * _CL_PASS + t * 64 * _CL_TAIL_COST)
    return wide, tail, slowest


def _cluster_tiling(N, Ci, Cm, Co, F1, F2, S2, P2, Ho1, Wo1, UH, UW, T, pF,
                    pS, pool, direct) -> Optional[StackTiling]:
    """K5a's tile: ``bm`` and the cluster that covers Co (CL = ceil(Co /
    bm) blocks when that is at most 8, else Co in several clusters) and the
    spatial tile (``nb`` >= min(8, N) images, multiples of 4 so the x
    gather copies 16 bytes); the one with the least work per wave of
    resident clusters."""
    K1, chunks = Ci * F1 * F1, -(-Cm // _CL_CM)
    k1_exec = -(-K1 // _CL_BK) * _CL_BK
    k2_exec = sum(-(-min(_CL_CM, Cm - c) * F2 * F2 // _CL_BK) * _CL_BK
                  for c in range(0, Cm, _CL_CM))
    best, best_key = None, None
    for bm in _STACK_BMS:
        bn = _STACK_TILE // bm
        units = bn // T
        if units < 1:
            continue
        co_tiles = -(-Co // bm)
        groups = -(-co_tiles // _CL_MAX)
        cl = -(-co_tiles // groups)
        if N <= 8:
            nbs = [N] if N <= units else []
        else:
            nbs = list(range(8, min(N + 3, units) + 1, 4))
        nbs = nbs or [min(N, units)]  # a pool window wider than 8 images
        for nb in nbs:
            n_tiles = ((nb, N // nb),) + (((N % nb, 1),) if N % nb else ())
            nbmax = min(nb, N)
            for uth in range(1, UH + 1):
                if nb * uth > units:
                    break
                hs = _mid_spans(UH, uth, pF, pS, S2, F2, P2, Ho1)
                for utw in range(1, UW + 1):
                    if nb * uth * utw > units:
                        break
                    ws = _mid_spans(UW, utw, pF, pS, S2, F2, P2, Wo1)
                    rstr = nbmax * max(h for (_, h), _ in hs) * max(
                        w for (_, w), _ in ws)
                    rstr = -(-rstr // 4) * 4
                    tiles = -(-N // nb) * -(-UH // uth) * -(-UW // utw)
                    clusters = tiles * groups
                    waves = -(-clusters // _H100_CLUSTERS[cl])
                    conv2 = 2 * clusters * cl * bm * bn * k2_exec
                    smem = _cluster_smem_bytes(bm, rstr, pool is not None)
                    if smem > SMEM_PER_BLOCK:
                        continue
                    wide = tail = 0
                    slowest = 0.0    # summed over the tiles
                    for nbc, cn in n_tiles:
                        for (_, sh), ch in hs:
                            for (_, sw), cw in ws:
                                w_, t_, s_ = _rank_passes(nbc * sh * sw, cl)
                                n = cn * ch * cw
                                wide, tail = wide + n * w_, tail + n * t_
                                slowest += n * s_
                    per_pos = 2 * groups * chunks * _CL_CM * k1_exec
                    conv1 = per_pos * (wide * _CL_PASS + tail * 64)
                    executed = conv1 + conv2
                    # a cluster waits for its slowest rank's conv1
                    cost = conv2 / cl + per_pos * slowest
                    key = (waves * cost / clusters, executed, smem)
                    if best_key is None or key < best_key:
                        best_key = key
                        best = StackTiling(bm, nb, uth, utw, clusters * cl,
                                           smem, executed, direct,
                                           cluster=cl)
    return best


def _stack_dims(N, Ci, H, W, Cm, F1, S1, P1, Co, F2, S2, P2, pool):
    """(Ho1, Wo1, Ho2, Wo2, UH, UW, pF, pS, direct FLOPs) of a stack: the
    mid and conv2 extents, the unit grid (the pooled output, or conv2's)
    and the pool's window and stride (0 without one)."""
    Ho1, Wo1 = conv_out_hw(H, F1, S1, P1), conv_out_hw(W, F1, S1, P1)
    Ho2, Wo2 = conv_out_hw(Ho1, F2, S2, P2), conv_out_hw(Wo1, F2, S2, P2)
    pF, pS = (pool[0], pool[1]) if pool else (0, 0)
    UH, UW = ((pool_out_hw(Ho2, pF, pS), pool_out_hw(Wo2, pF, pS)) if pool
              else (Ho2, Wo2))
    direct = 2 * N * (Cm * Ho1 * Wo1 * Ci * F1 * F1
                      + Co * Ho2 * Wo2 * Cm * F2 * F2)
    return Ho1, Wo1, Ho2, Wo2, UH, UW, pF, pS, direct


@functools.lru_cache(maxsize=None)
def stack_tiling(engine: str, N: int, Ci: int, H: int, W: int, Cm: int,
                 F1: int, S1: int, P1: int, Co: int, F2: int, S2: int,
                 P2: int, pool: Optional[Tuple[int, int, str]] = None
                 ) -> StackTiling:
    """The block tile of one stack launch, among the tiles whose shared
    memory fits a block, with the least modeled time.  K5b ("NCHW")
    recomputes conv1 on each tile's halo and once per ``bm``-wide slice of
    Co; K5a ("CHWN") shares one conv1 over a cluster of blocks that covers
    Co, and keeps at least 8 images (or all of them) in a tile so its
    gathers run along n.  ``executed_flops`` is what the kernel executes.
    Raises ``ValueError`` when no tile fits."""
    Ho1, Wo1, Ho2, Wo2, UH, UW, pF, pS, direct = _stack_dims(
        N, Ci, H, W, Cm, F1, S1, P1, Co, F2, S2, P2, pool)
    if engine == "CHWN":
        best = _cluster_tiling(N, Ci, Cm, Co, F1, F2, S2, P2, Ho1, Wo1, UH,
                               UW, pF * pF if pool else 1, pF, pS, pool,
                               direct)
    else:
        cands = k5b_tilings(N, Ci, H, W, Cm, F1, S1, P1, Co, F2, S2, P2,
                            pool)
        # the least modeled time, then the fewer FLOPs and shared memory
        best = min(cands, key=lambda c: (c[0], c[1].executed_flops,
                                         c[1].smem_bytes))[1] if cands \
            else None
    if best is None:
        raise ValueError(
            f"conv stack: no block tile of a {Ho2}x{Wo2} conv2 output "
            f"(F2={F2}, S2={S2}, pool={pool}) fits the {SMEM_PER_BLOCK} "
            "bytes of shared memory a block can use")
    return best


def _rows8(n: int) -> int:
    """The smallest v >= n with v % 32 == 8 (``rows8`` in the kernel)."""
    return n + (8 - n % 32) % 32


def _k5b_box(F1: int, S1: int, F2: int, S2: int, pF: int, pS: int,
             uth: int, utw: int) -> Tuple[int, int, int, int]:
    """(rh, rw, xh, span) of a K5b tile of uth x utw units: its unclipped
    mid box and the rows and columns of the x box under it."""
    oth = (uth - 1) * pS + pF if pF else uth
    otw = (utw - 1) * pS + pF if pF else utw
    rh, rw = (oth - 1) * S2 + F2, (otw - 1) * S2 + F2
    return rh, rw, (rh - 1) * S1 + F1, (rw - 1) * S1 + F1


def k5b_layout(Ci: int, F1: int, S1: int, F2: int, S2: int, pF: int,
               pS: int, bm: int, nb: int, uth: int, utw: int
               ) -> Tuple[int, int]:
    """(ga, bytes): one K5b block's 8-channel groups of Ci a phase-A stage
    holds and its dynamic shared memory (``layout`` in
    csrc/conv_stack_nchw.cu).  A ring slot holds a phase-B stage (the w2
    slice of 8 mid channels) or a phase-A stage (the w1 slice and the x
    box of ga x 8 input channels, ga the largest divisor of Ci/8 that fits
    the slot); 3 slots, 2 at bm 256, or the epilogue tile over them where
    that is larger; then the mid slab of 32 channels."""
    rh, rw, xh, span = _k5b_box(F1, S1, F2, S2, pF, pS, uth, utw)
    xw = (3 + span + 3) // 4 * 4
    ff1, ci_oct = F1 * F1, -(-Ci // 8)
    xstr = _rows8(nb * xh * xw)

    def stage_a(ga):
        return _K5B_CM * (8 * ga * ff1 + 4) + 8 * ga * xstr

    slot = max(stage_a(1), bm * (8 * F2 * F2 + 4))
    ga = max(g for g in range(1, ci_oct + 1)
             if ci_oct % g == 0 and (g == 1 or stage_a(g) <= slot))
    ring = (2 if bm == 256 else 3) * slot
    tile = bm * (_STACK_TILE // bm + 8)
    return ga, 4 * (max(ring, tile) + _K5B_CM * _rows8(nb * rh * rw))


def _k5b_narrow_layout(Ci: int, F1: int, S1: int, F2: int, S2: int,
                       pF: int, pS: int, bm: int, nb: int, uth: int,
                       utw: int, want8: bool, want4: bool
                       ) -> Tuple[int, int, int, int, int, int]:
    """(gb, phase-A stage bytes, phase-B stage bytes, slot bytes, box
    mode, x box channel stride in elements) of K5b's bf16 builds at a tile (``layout_bf16`` in
    csrc/conv_stack_nchw.cu).  A stage steps 16 channels at one tap: a
    phase-B stage holds bm w2 rows of 16 F2^2 + 8 halfwords (the float32
    stage's bytes), a phase-A stage gb 16-channel groups of Ci (the largest
    divisor of ceil(Ci / 16) that fits) of w1 rows (16 gb F1^2 + 8
    halfwords) and of the x box.  Both lie inside ``k5b_layout``'s slot, so
    the slab and the block's shared memory are the float32 build's.  The
    box mode: 2, an origin aligned down to 8 and a width rounded up to 8,
    where ``want8`` (the rows may copy by 8 or 16 bytes: an NCHW source, W
    % 8 == 0) and that box fits the slot; 1, aligned to 4 (``want4``: W % 4
    == 0, the int8->bf16 build's 4-byte copies), the float32 box's
    columns, which always fit; else 0, the box from its first column."""
    _, _, xh, span = _k5b_box(F1, S1, F2, S2, pF, pS, uth, utw)
    xw = (3 + span + 3) // 4 * 4
    ff1, ci16 = F1 * F1, -(-Ci // 16)
    slot = 2 * max(_K5B_CM * (8 * ff1 + 4) + 8 * _rows8(nb * xh * xw),
                   bm * (8 * F2 * F2 + 4))          # halfwords

    def stage_a(gb, xstr):
        return _K5B_CM * (16 * gb * ff1 + 8) + 16 * gb * xstr

    x8, x4 = _rows8(nb * xh * ((7 + span + 7) // 8 * 8)), _rows8(nb * xh * xw)
    mode = (2 if want8 and stage_a(1, x8) <= slot else
            1 if want4 and stage_a(1, x4) <= slot else 0)
    xstr = (x8, x4, _rows8(nb * xh * ((span + 3) // 4 * 4)))[2 - mode]
    gb = max(g for g in range(1, ci16 + 1)
             if ci16 % g == 0 and (g == 1 or stage_a(g, xstr) <= slot))
    return (gb, 2 * stage_a(gb, xstr), 2 * bm * (16 * F2 * F2 + 8),
            2 * slot, mode, xstr)


def k5b_bf16_layout(Ci: int, F1: int, S1: int, F2: int, S2: int, pF: int,
                    pS: int, bm: int, nb: int, uth: int, utw: int,
                    want8: bool = True) -> Tuple[int, int, int, int, bool]:
    """(gb, phase-A stage bytes, phase-B stage bytes, slot bytes, box8) of
    K5b's bf16 build at a tile (``_k5b_narrow_layout``): ``want8``, the x
    rows may copy by 16 bytes (an NCHW source, W % 8 == 0); ``box8``, they
    do, the box of an origin aligned down to 8 and a width rounded up to 8
    fitting the slot."""
    gb, stage_a, stage_b, slot, mode, _ = _k5b_narrow_layout(
        Ci, F1, S1, F2, S2, pF, pS, bm, nb, uth, utw, want8, False)
    return gb, stage_a, stage_b, slot, mode == 2


def k5b_i8bf16_layout(Ci: int, F1: int, S1: int, F2: int, S2: int,
                      pF: int, pS: int, bm: int, nb: int, uth: int,
                      utw: int, want8: bool = True, want4: bool = True
                      ) -> Tuple[int, int, int, int, int, int]:
    """(gb, phase-A stage bytes, phase-B stage bytes, slot bytes, box
    mode, x box channel stride) of K5b's int8->bf16 kernel at a tile: the bf16 build's stages in
    the same slots, its box by mode (``_k5b_narrow_layout``; the kernels'
    ``vec_x``): 2, copies of 8 or 16 bytes (``want8``: an NCHW source, W %
    8 == 0, x 8-byte aligned); 1, of 4 or 8 bytes (``want4``: W % 4 == 0, x
    4-byte aligned); 0, element loads."""
    return _k5b_narrow_layout(Ci, F1, S1, F2, S2, pF, pS, bm, nb, uth, utw,
                              want8, want4)


def k5b_i8bf16_smem(Ci: int, F1: int, S1: int, F2: int, S2: int, pF: int,
                    pS: int, bm: int, nb: int, uth: int, utw: int,
                    want8: bool = True, want4: bool = True) -> int:
    """One block's dynamic shared memory in K5b's int8->bf16 kernel: its
    stages (``k5b_i8bf16_layout``, the x bytes inside the box's own bf16
    spans) lie in the float32 layout's slots, so it allocates
    ``k5b_layout``'s bytes.  Raises ``ValueError`` where a stage would not
    fit its slot."""
    _, stage_a, stage_b, slot, _, _ = k5b_i8bf16_layout(
        Ci, F1, S1, F2, S2, pF, pS, bm, nb, uth, utw, want8, want4)
    if max(stage_a, stage_b) > slot:
        raise ValueError(f"K5b int8->bf16: a {max(stage_a, stage_b)}-byte "
                         f"stage outgrows its {slot}-byte slot")
    return k5b_layout(Ci, F1, S1, F2, S2, pF, pS, bm, nb, uth, utw)[1]


def stack_tile(N: int, H: int, W: int, F1: int, S1: int, P1: int, F2: int,
               S2: int, P2: int, pool, nb: int, uth: int, utw: int,
               ng: int, th: int, tw: int) -> dict:
    """One block's tile of a stack launch (``make_tile`` in
    csrc/conv_stack_common.cuh): images [n0, n0 + NBc), its conv2 output
    rectangle (oh0, ow0, OH x OW; the outputs under its units where it
    pools) and the clipped mid box it reads (rows [mh_lo, mh_lo + MHc),
    columns [mw_lo, mw_lo + MWc)), with the unclipped box's origin (mh_u,
    mw_u) and extent (RH x RW), for the block of image group ``ng`` and
    unit tile (``th``, ``tw``)."""
    Ho1, Wo1, Ho2, Wo2, UH, UW, pF, pS, _ = _stack_dims(
        N, 1, H, W, 1, F1, S1, P1, 1, F2, S2, P2, pool)
    n0, uh0, uw0 = ng * nb, th * uth, tw * utw
    UTHc, UTWc = min(uth, UH - uh0), min(utw, UW - uw0)
    oh0, ow0 = (uh0 * pS, uw0 * pS) if pF else (uh0, uw0)
    OH = (UTHc - 1) * pS + pF if pF else UTHc
    OW = (UTWc - 1) * pS + pF if pF else UTWc

    def span(o0, on, M1):
        m0, m1 = o0 * S2 - P2, (o0 + on - 1) * S2 - P2 + F2
        lo = max(m0, 0)
        return lo, max(0, min(m1, M1) - lo)

    mh_lo, MHc = span(oh0, OH, Ho1)
    mw_lo, MWc = span(ow0, OW, Wo1)
    return dict(n0=n0, NBc=min(nb, N - n0), UTHc=UTHc, UTWc=UTWc, oh0=oh0,
                ow0=ow0, OH=OH, OW=OW, mh_lo=mh_lo, MHc=MHc, mw_lo=mw_lo,
                MWc=MWc, mh_u=oh0 * S2 - P2, mw_u=ow0 * S2 - P2,
                RH=(OH - 1) * S2 + F2, RW=(OW - 1) * S2 + F2)


def k5b_i8bf16_box(tile: dict, F1: int, S1: int, P1: int,
                   mode: int) -> Tuple[int, int, int, int]:
    """(ih0, XH, iw0, XW) of a block's x box in K5b's int8->bf16 kernel
    (``make_box_i8``): the rows under the unclipped mid box; its columns
    from an origin aligned down to Q (8 at mode 2, 4 at mode 1) and a width
    rounded up to Q, or (mode 0) from the first column, width rounded up
    to 4.  The consumers read column (mw + dw) S1 + sh + dx of it."""
    ih0 = tile["mh_u"] * S1 - P1
    XH = (tile["RH"] - 1) * S1 + F1
    iws = tile["mw_u"] * S1 - P1
    span = (tile["RW"] - 1) * S1 + F1
    if mode:
        q = 8 if mode == 2 else 4
        iw0 = iws // q * q
        return ih0, XH, iw0, (iws - iw0 + span + q - 1) // q * q
    return ih0, XH, iws, (span + 3) // 4 * 4


def k5b_i8bf16_walk(XU: int, XH: int, NBc: int, channels: int, pt: int):
    """The units of a phase-A stage's box that producer thread ``pt``
    owns, in its order, as (c16, nl, xh, xu): from its first (``box_walk``)
    stepped on by 128 units without a division (``i8_units``)."""
    xu, drow, dq = pt % XU, 128 // XU, 128 % XU
    c16, nl, xh = 0, 0, pt // XU
    while xh >= XH:
        xh -= XH
        nl += 1
        if nl == NBc:
            nl, c16 = 0, c16 + 1
    while c16 < channels:
        yield c16, nl, xh, xu
        xu += dq
        rows = drow
        if xu >= XU:
            xu, rows = xu - XU, rows + 1
        xh += rows
        while xh >= XH:
            xh -= XH
            nl += 1
            if nl == NBc:
                nl, c16 = 0, c16 + 1


def k5b_i8bf16_unit(q: int, XW: int, xu: int, iw0: int, W: int,
                    row_ok: bool, src_addr: int):
    """One copy unit of K5b's int8->bf16 box (``I8Unit``): 2Q columns of a
    box row from column 2Q xu (Q where the row ends).  Returns (copies,
    widen): each copy (byte offset in the unit's bf16 span, bytes, global
    byte address of its source or None for a zero fill), and the widening
    (byte offset of the bytes in the span, how many; they become bf16 at
    the span's start).  ``src_addr``: x's address of the unit's first
    column; ``row_ok``: its row and channel lie in x."""
    c0 = 2 * q * xu
    iw = iw0 + c0
    half = c0 + q == XW
    ok0 = row_ok and iw >= 0 and iw + q <= W
    ok1 = not half and row_ok and iw + q >= 0 and iw + 2 * q <= W
    if half:
        return [(q, q, src_addr if ok0 else None)], (q, q)
    if ok0 and ok1 and src_addr % (2 * q) == 0:
        return [(2 * q, 2 * q, src_addr)], (2 * q, 2 * q)
    return [(2 * q, q, src_addr if ok0 else None),
            (3 * q, q, src_addr + q if ok1 else None)], (2 * q, 2 * q)


def k5b_i8f32_mode(W: int, x_addr: int, src_layout: str = "NCHW") -> int:
    """The x copies of K5b's int8->fp32 kernel (its ``vec_x``): C = 16, 8
    or 4, the largest with W % C == 0 and x C-byte aligned (so every row of
    an NCHW x starts on a C-byte boundary), copies of C-byte chunks; 0
    (a CHWN source, W % 4 != 0, x misaligned) element loads."""
    if src_layout != "NCHW":
        return 0
    return next((c for c in (16, 8, 4) if W % c == 0 and x_addr % c == 0),
                0)


def k5b_i8f32_box(tile: dict, F1: int, S1: int, P1: int
                  ) -> Tuple[int, int, int, int]:
    """(ih0, XH, iw0, XW) of a block's x box in K5b's int8->fp32 kernel:
    the float32 twin's (``make_box``): the rows under the unclipped mid
    box, its columns from an origin aligned down to 4, the width rounded
    up to 4."""
    ih0 = tile["mh_u"] * S1 - P1
    XH = (tile["RH"] - 1) * S1 + F1
    iws = tile["mw_u"] * S1 - P1
    iw0 = iws // 4 * 4
    return ih0, XH, iw0, (iws - iw0 + (tile["RW"] - 1) * S1 + F1 + 3) // 4 * 4


def k5b_i8f32_units(C: int, iw0: int, XW: int) -> Tuple[int, int]:
    """(XU, phi): the copy units of a box row in K5b's int8->fp32 kernel
    (its C-byte chunks of x that hold box columns) and the quad of the box
    origin in its chunk."""
    cq = C // 4
    phi = (iw0 % C) // 4
    return -(-(XW // 4 + phi) // cq), phi


def k5b_i8f32_unit(C: int, xu: int, phi: int, XW: int, iw0: int, W: int,
                   row_ok: bool, chunk_addr: int):
    """One copy unit of K5b's int8->fp32 box (``F32Unit``): chunk quads
    [j0, j1) of the C-byte chunk ``xu`` of a row (its first column iw0 - 4
    phi + C xu; ``chunk_addr`` its address in x).  Returns (q0, j0, j1,
    copies, bytes_at): q0 the box quad of chunk quad 0; each copy
    (byte offset from chunk quad 0's float32 span, bytes, source address or
    None for a zero fill); ``bytes_at`` where the bytes lie (chunk quad j
    at bytes_at + 4 j, the last C bytes of the unit's span).  The thread
    widens them into the floats of box quads q0 + j0 .. q0 + j1 - 1."""
    cq = C // 4
    q0 = cq * xu - phi
    j0, j1 = max(0, -q0), min(cq, XW // 4 - q0)
    cw = iw0 - 4 * phi + C * xu
    ok = row_ok and cw >= 0 and cw + C <= W
    at = 16 * j1 - C
    src = chunk_addr if ok else None

    def off(j):
        return None if src is None else src + 4 * j

    if j0 == 0 and j1 == cq:
        return q0, j0, j1, [(at, C, src)], at
    copies, j = [], j0
    while j < j1:
        if C >= 8 and j % 2 == 0 and j + 1 < j1:
            copies.append((at + 4 * j, 8, off(j)))
            j += 2
        else:
            copies.append((at + 4 * j, 4, off(j)))
            j += 1
    return q0, j0, j1, copies, at


def k5b_i8f32_smem(Ci: int, F1: int, S1: int, F2: int, S2: int, pF: int,
                   pS: int, bm: int, nb: int, uth: int, utw: int) -> int:
    """One block's dynamic shared memory in K5b's int8->fp32 kernel: its
    stages are the float32 twin's (the x box at the twin's columns, each
    unit's bytes inside its own float32 span), so it allocates
    ``k5b_layout``'s bytes."""
    return k5b_layout(Ci, F1, S1, F2, S2, pF, pS, bm, nb, uth, utw)[1]


def _balanced(U: int, cap: int):
    """The tile sizes along a dim of ``U`` units that split it into equal
    tiles (the last one no larger), up to ``cap``."""
    return sorted({-(-U // -(-U // t)) for t in range(1, min(U, cap) + 1)})


@functools.lru_cache(maxsize=None)
def k5b_tilings(N: int, Ci: int, H: int, W: int, Cm: int, F1: int, S1: int,
                P1: int, Co: int, F2: int, S2: int, P2: int,
                pool: Optional[Tuple[int, int, str]] = None
                ) -> Tuple[Tuple[float, StackTiling], ...]:
    """K5b's candidate tiles, each with its modeled time: ``bm`` and a
    rectangle of ``nb`` images x ``uth`` x ``utw`` units whose conv2
    outputs fit the block's 16384 // bm columns and whose shared memory
    fits.  The modeled time is waves of one block an SM times the mean
    block's mma of one warp (phase A: 6 a tap for each of the warp's
    8-position tiles of a pass, 8 warps along the box; phase B: 6 a tap for
    each of its column tiles), plus ``_K5B_STAGE_COST`` a stage.
    ``executed_flops`` is what the blocks execute
    (``conv_stack_nchw_counted`` reads the kernel's own count)."""
    Ho1, Wo1, _, _, UH, UW, pF, pS, direct = _stack_dims(
        N, Ci, H, W, Cm, F1, S1, P1, Co, F2, S2, P2, pool)
    ci_oct, chunks = -(-Ci // 8), -(-Cm // _K5B_CM)
    FF1, FF2 = F1 * F1, F2 * F2
    b_stages = sum(-(-min(_K5B_CM, Cm - c) // 8)
                   for c in range(0, Cm, _K5B_CM))
    cands = []
    for bm in _STACK_BMS:
        bn, wn = _STACK_TILE // bm, 256 // bm
        co_tiles = -(-Co // bm)
        for nb in [1 << i for i in range(9) if (1 << i) < 2 * N]:
            ns = ((nb, N // nb),) + (((N % nb, 1),) if N % nb else ())
            for uth in _balanced(UH, bn):
                oth = (uth - 1) * pS + pF if pF else uth
                if nb * oth > bn:
                    break
                hs = _mid_spans(UH, uth, pF, pS, S2, F2, P2, Ho1)
                for utw in _balanced(UW, bn):
                    otw = (utw - 1) * pS + pF if pF else utw
                    if nb * oth * otw > bn:
                        break
                    ga, smem = k5b_layout(Ci, F1, S1, F2, S2, pF, pS, bm,
                                          nb, uth, utw)
                    if smem > SMEM_PER_BLOCK:
                        continue
                    ws = _mid_spans(UW, utw, pF, pS, S2, F2, P2, Wo1)
                    tiles = executed = work = 0
                    for nbc, cn in ns:
                        for (oh, mh), ch in hs:
                            for (ow, mw), cw in ws:
                                n = cn * ch * cw
                                nta = -(-(nbc * mh * mw) // 8)
                                ntb = -(-(nbc * oh * ow) // 8)
                                tiles += n
                                executed += n * (
                                    2 * _K5B_CM * 64 * ci_oct * FF1 * chunks
                                    * nta + 2 * bm * 64 * FF2 * b_stages * ntb)
                                passes = -(-nta // _K5B_PASS)
                                wa = sum(-(-min(_K5B_PASS,
                                                nta - p * _K5B_PASS) // 8)
                                         for p in range(passes))
                                work += n * (
                                    6 * chunks * ci_oct * FF1 * wa
                                    + 6 * b_stages * FF2 * -(-ntb // wn)
                                    + _K5B_STAGE_COST
                                    * (chunks * passes * ci_oct // ga
                                       + b_stages))
                    blocks = tiles * co_tiles
                    waves = -(-blocks // _SMS)
                    cands.append((waves * work / tiles, StackTiling(
                        bm, nb, uth, utw, blocks, smem, executed * co_tiles,
                        direct)))
    return tuple(cands)


def _stack_launch(entry: str, wrapper, engine: str, x, w1, w2, Ci: int,
                  Cm: int, Co: int, F1: int, F2: int, stride1: int,
                  pad1: int, stride2: int, pad2: int, bias1, bias2,
                  relu1: bool, relu2: bool, pool, res, res_layout: str,
                  src_layout: str, dst_layout: str, stats=None):
    """Check a stack call; on the CPU return the plain version, on the
    card launch the kernel.  ``stats``: int64 on the card that the kernel
    adds its executed FLOPs to (K5a also its cluster size, a second
    one)."""
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
    dev, variant = _build.require_cuda_conv(
        name, x, w1, w2=w2, bias1=bias1, bias2=bias2, res=res)
    y = _output(name, x, dst_layout, N, Co, OH, OW, w1.dtype)
    cluster = (tiling.cluster,) if engine == "CHWN" else ()
    err = _build.entry(entry, variant)(
        x.data_ptr(), w1.data_ptr(), _ptr(bias1), w2.data_ptr(), _ptr(bias2),
        _ptr(res), y.data_ptr(), N, Ci, H, W, Cm, F1, stride1, pad1, Co, F2,
        stride2, pad2, pF, pS, avg, int(relu1), int(relu2),
        int(src_layout == "NCHW"), int(dst_layout == "NCHW"),
        int(res_layout == "NCHW"), tiling.bm, tiling.nb, tiling.uth,
        tiling.utw, *cluster, _ptr(stats), _build.stream_of(dev))
    _build.check(name, err)
    wrapper.launches += 1
    if variant:
        wrapper.variant_launches[variant] += 1
    return y


def _stack(engine: str, x, w1, w2, stride1: int, pad1: int, stride2: int,
           pad2: int, bias1, bias2, relu1: bool, relu2: bool, pool, res,
           res_layout: str, src_layout: str, dst_layout: str, stats=None):
    """One conv->conv stack on ``engine``'s kernel (K5a for "CHWN", K5b for
    "NCHW"), outside autograd."""
    wrapper = conv_stack_chwn if engine == "CHWN" else conv_stack_nchw
    name = wrapper.__name__
    if w1.dim() != 4 or w2.dim() != 4:
        raise ValueError(f"{name}: w1/w2 must be 4-D {_WEIGHT_SHAPE[engine]} "
                         f"weights, got {tuple(w1.shape)} / "
                         f"{tuple(w2.shape)}")
    if engine == "CHWN":
        (Ci, F1, _, Cm), (Cm2, F2, _, Co) = w1.shape, w2.shape
    else:
        (Cm, Ci, F1, _), (Co, Cm2, F2, _) = w1.shape, w2.shape
    if Cm2 != Cm:
        raise ValueError(f"{name}: w2 takes {Cm2} channels, w1 makes {Cm}")
    return _stack_launch(_STACK_ENTRY[engine], wrapper, engine, x, w1, w2,
                         Ci, Cm, Co, F1, F2, stride1, pad1, stride2, pad2,
                         bias1, bias2, relu1, relu2, pool, res, res_layout,
                         src_layout, dst_layout, stats)


class _StackFn(torch.autograd.Function):
    """K5a/K5b with their gradient, as the reference's
    ``_stack_bwd_unfused``: the backward recomputes the mid activation y1
    with one conv1 launch (K1/K2), then runs the two convs' backwards
    (``conv_backward``).  conv2's ReLU mask comes from the saved stack
    output; where the stack pools, conv2 is recomputed once more with
    ``save_act`` for the pre-pool activation that the pool backward
    routes through.  An int8 x (quantized, its scale folded into w1) has
    no gradient, as the reference trains on a float carrier; w1's gradient
    then reads x widened to w1's dtype, exactly."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, res, engine, stride1, pad1, stride2,
                pad2, relu1, relu2, pool, res_layout, src_layout,
                dst_layout):
        y = _stack(engine, x, w1, w2, stride1, pad1, stride2, pad2, b1, b2,
                   relu1, relu2, pool, res, res_layout, src_layout,
                   dst_layout)
        ctx.conf = (engine, stride1, pad1, stride2, pad2, relu1, relu2,
                    pool, res_layout, src_layout, dst_layout)
        ctx.save_for_backward(x, w1, b1, w2, b2, res, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, w2, b2, res, y = ctx.saved_tensors
        (engine, stride1, pad1, stride2, pad2, relu1, relu2, pool,
         res_layout, src_layout, dst_layout) = ctx.conf
        need_x, need_w1, need_b1, need_w2, need_b2, need_res = \
            ctx.needs_input_grad[:6]
        y1 = _conv(engine, x, w1, stride1, pad1, bias=b1, relu=relu1,
                   src_layout=src_layout, dst_layout=engine)
        if pool is not None:
            _, act2 = _conv(engine, y1, w2, stride2, pad2, bias=b2,
                            relu=relu2, pool=pool, res=res,
                            res_layout=res_layout, src_layout=engine,
                            dst_layout=dst_layout, save_act=True)
        else:
            act2 = y
        dy1, dw2, db2, dres = conv_backward(
            g, y1, w2, act2, engine=engine, stride=stride2, pad=pad2,
            relu=relu2, pool=pool, res_layout=res_layout, src_layout=engine,
            dst_layout=dst_layout, needs=(True, need_w2, need_b2, need_res))
        if x.dtype == torch.int8:      # K6 takes float x: widen, exactly
            x = x.to(w1.dtype)
        dx, dw1, db1, _ = conv_backward(
            dy1, x, w1, y1, engine=engine, stride=stride1, pad=pad1,
            relu=relu1, pool=None, res_layout=engine, src_layout=src_layout,
            dst_layout=engine, needs=(need_x, need_w1, need_b1, False))
        return (dx, dw1, db1, dw2, db2, dres) + (None,) * 11


def _stack_public(engine, x, w1, w2, stride1, pad1, stride2, pad2, bias1,
                  bias2, relu1, relu2, pool, res, res_layout, src_layout,
                  dst_layout):
    args = (stride1, pad1, stride2, pad2)
    if _wants_grad(x, w1, w2, bias1, bias2, res):
        return _StackFn.apply(x, w1, bias1, w2, bias2, res, engine, *args,
                              relu1, relu2, pool, res_layout, src_layout,
                              dst_layout)
    return _stack(engine, x, w1, w2, *args, bias1, bias2, relu1, relu2, pool,
                  res, res_layout, src_layout, dst_layout)


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
    conv2 the full bias/residual-add/ReLU/pool epilogue.  Differentiable
    (``_StackFn``) when an input requires grad."""
    return _stack_public("CHWN", x, w1, w2, stride1, pad1, stride2, pad2,
                         bias1, bias2, relu1, relu2, pool, res, res_layout,
                         src_layout, dst_layout)


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
    return _stack_public("NCHW", x, w1, w2, stride1, pad1, stride2, pad2,
                         bias1, bias2, relu1, relu2, pool, res, res_layout,
                         src_layout, dst_layout)


def conv_stack_chwn_counted(x: torch.Tensor, w1: torch.Tensor,
                            w2: torch.Tensor, stride1: int = 1,
                            pad1: int = 0, stride2: int = 1, pad2: int = 0,
                            **kw) -> Tuple[torch.Tensor, int, int]:
    """K5a once on the card (arguments as ``conv_stack_chwn``, outside
    autograd), with the kernel counting what it runs: (y, the FLOPs its
    blocks executed, the cluster size they ran in).  What shows that
    ``stack_tiling`` prices the kernel exactly and that it launches as a
    cluster."""
    if _build.on_cpu("conv_stack_chwn_counted", x):
        raise ValueError("conv_stack_chwn_counted: the count comes from the "
                         "kernel; pass CUDA tensors")
    stats = torch.zeros(2, dtype=torch.int64, device=x.device)
    kw = {"bias1": None, "bias2": None, "relu1": True, "relu2": False,
          "pool": None, "res": None, "res_layout": "CHWN",
          "src_layout": "CHWN", "dst_layout": "CHWN", **kw}
    y = _stack("CHWN", x, w1, w2, stride1, pad1, stride2, pad2,
               kw["bias1"], kw["bias2"], kw["relu1"], kw["relu2"],
               kw["pool"], kw["res"], kw["res_layout"], kw["src_layout"],
               kw["dst_layout"], stats=stats)
    flops, cluster = stats.tolist()
    return y, flops, cluster


def conv_stack_nchw_counted(x: torch.Tensor, w1: torch.Tensor,
                            w2: torch.Tensor, stride1: int = 1,
                            pad1: int = 0, stride2: int = 1, pad2: int = 0,
                            **kw) -> Tuple[torch.Tensor, int]:
    """K5b once on the card (arguments as ``conv_stack_nchw``, outside
    autograd), with the kernel counting what it runs: (y, the FLOPs its
    blocks executed).  What shows that ``stack_tiling`` prices the kernel
    exactly."""
    if _build.on_cpu("conv_stack_nchw_counted", x):
        raise ValueError("conv_stack_nchw_counted: the count comes from the "
                         "kernel; pass CUDA tensors")
    stats = torch.zeros(1, dtype=torch.int64, device=x.device)
    kw = {"bias1": None, "bias2": None, "relu1": True, "relu2": False,
          "pool": None, "res": None, "res_layout": "NCHW",
          "src_layout": "NCHW", "dst_layout": "NCHW", **kw}
    y = _stack("NCHW", x, w1, w2, stride1, pad1, stride2, pad2,
               kw["bias1"], kw["bias2"], kw["relu1"], kw["relu2"],
               kw["pool"], kw["res"], kw["res_layout"], kw["src_layout"],
               kw["dst_layout"], stats=stats)
    return y, int(stats.item())


def stack_max_clusters(N: int, Ci: int, H: int, W: int, Cm: int, F1: int,
                       S1: int, P1: int, Co: int, F2: int, S2: int, P2: int,
                       pool: Optional[Tuple[int, int, str]],
                       tiling: StackTiling,
                       dtype: torch.dtype = torch.float32,
                       w_dtype: Optional[torch.dtype] = None) -> int:
    """How many of K5a's clusters at ``tiling`` the card holds at once
    (``cudaOccupancyMaxActiveClusters``), for the build of x's ``dtype``
    and w's ``w_dtype`` (default: x's), the pair's variant in
    ``_build.CONV_VARIANTS`` (the builds' kernels differ in registers)."""
    n = ctypes.c_int(0)
    pF, pS = (pool[0], pool[1]) if pool else (0, 0)
    variant = _build.CONV_VARIANTS[(dtype, w_dtype or dtype)]
    _build.check("stack_max_clusters",
                 _build.entry("conv_stack_chwn_max_clusters", variant)(
                     N, Ci, H, W, Cm, F1, S1, P1, Co, F2, S2, P2, pF, pS,
                     tiling.bm, tiling.nb, tiling.uth, tiling.utw,
                     tiling.cluster, ctypes.byref(n)))
    return n.value


# ---------------------------------------------------------------------------
# the paper's other conv engines: matrix expansion (on K10) and FFT
# ---------------------------------------------------------------------------

def conv_im2col_nchw(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                     pad: int = 0, use_kernel_mm: bool = True
                     ) -> torch.Tensor:
    """im2col + matmul, NCHW: x [N,Ci,H,W], w [Co,Ci,F,F] -> [N,Co,Ho,Wo].
    The seed baseline (``repro/kernels/conv/ops.py::conv_im2col_nchw``):
    the patch matrix [N*Ho*Wo, Ci*F*F] is materialized (the paper's
    'matrix expansion' traffic) and only its product with the weights runs
    on a kernel, K10 (``use_kernel_mm=False``: ``patches @ wmat``, the
    reference's ``use_pallas_mm=False``).  The weight matrix is
    ``w.reshape(Co, -1).T``, a strided view K10 reads without a copy."""
    N = x.shape[0]
    Co, Ci, F, _ = w.shape
    patches, (_, Ho, Wo) = im2col_nchw(x, F, stride, pad)
    wmat = w.reshape(Co, Ci * F * F).T             # [Ci*F*F, Co]
    out = matmul(patches, wmat) if use_kernel_mm else patches @ wmat
    return out.reshape(N, Ho, Wo, Co).permute(0, 3, 1, 2).contiguous()


def conv_fft_nchw(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                  pad: int = 0) -> torch.Tensor:
    """FFT conv (NCHW; ``repro/kernels/conv/ops.py::conv_fft_nchw``): pads
    the filter to the image size and multiplies in the frequency domain
    (the paper's cuDNN-FFT mode, memory overhead included).  No kernel of
    the port's own: ``torch.fft`` (cuFFT on the card), as the reference
    leaves it to XLA.  Only exact for stride 1; a strided layer subsamples
    the full conv."""
    F = w.shape[2]
    if pad:
        x = torch.nn.functional.pad(x, (pad, pad, pad, pad))
    H, W = x.shape[2], x.shape[3]
    Hf, Wf = H + F - 1, W + F - 1
    xf = torch.fft.rfft2(x.float(), s=(Hf, Wf))            # [N,Ci,Hf,Wf']
    wf = torch.fft.rfft2(w.flip(2, 3).float(), s=(Hf, Wf))
    yf = torch.einsum("nchw,ochw->nohw", xf, wf)
    y = torch.fft.irfft2(yf, s=(Hf, Wf))
    y = y[:, :, F - 1:H, F - 1:W]                          # valid region
    if stride > 1:
        y = y[:, :, ::stride, ::stride]
    return y.to(x.dtype).contiguous()


conv_direct_chwn.launches = 0
conv_im2col_nchw_fused.launches = 0
conv_stack_chwn.launches = 0
conv_stack_nchw.launches = 0
conv_direct_chwn.variant_launches = {"bf16": 0, "i8f32": 0, "i8bf16": 0}
conv_im2col_nchw_fused.variant_launches = {"bf16": 0, "i8f32": 0,
                                           "i8bf16": 0}
conv_stack_chwn.variant_launches = {"bf16": 0, "i8f32": 0, "i8bf16": 0}
conv_stack_nchw.variant_launches = {"bf16": 0, "i8f32": 0, "i8bf16": 0}
