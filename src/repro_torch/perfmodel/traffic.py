"""The analytic traffic model (``repro/perfmodel/traffic.py``), over a
``Hardware`` profile.

Predicted device-memory bytes AND roofline seconds per (fused op, layout,
dtype): conv chains, cross-layer stacks, the backward direction and
standalone cast edges.  Each byte model counts the streams a kernel moves
(DeLTA's per-layer traffic discipline, Lym et al. 2019); each seconds model
is the roofline max(compute, memory) with tile-utilization de-rating.

Every expression is the reference's, in the reference's operation order,
with its device constants taken from ``hw`` (``perfmodel.hardware``): the
peak rate per element size, the memory bandwidth, the minor and
second-minor granules, the coalescing span and the stack gate.  Under a
profile built from the reference's own constants the two packages price
every plan identically; the port's default profile is the H100's.  The
byte models are device-free.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from repro_torch.configs.paper_table1 import ConvLayer
from repro_torch.perfmodel.hardware import Hardware, default_hardware
from repro_torch.shapes import pool_out_hw

# One shared default element size for every cost/byte model (the
# reference's, bf16); callers modelling a specific storage dtype pass
# ``dtype_bytes`` explicitly (4 for fp32 serving).
DEFAULT_DTYPE_BYTES = 2


def _hw(hw: Optional[Hardware]) -> Hardware:
    return default_hardware() if hw is None else hw


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def tile_utilization(shape: Tuple[int, ...],
                     dtype_bytes: int = DEFAULT_DTYPE_BYTES,
                     hw: Optional[Hardware] = None) -> float:
    """Fraction of each (second-minor x minor) granule tile holding real
    data for the two minormost dims of ``shape``; an element size the
    profile has no granule for raises."""
    if not shape:
        return 1.0
    hw = _hw(hw)
    lane = shape[-1]
    sub = shape[-2] if len(shape) >= 2 else 1
    sl = hw.second_minor_granule(dtype_bytes)
    return ((lane / _round_up(lane, hw.minor_granule(dtype_bytes)))
            * (sub / _round_up(sub, sl)))


# ---------------------------------------------------------------------------
# cast edges (mixed-dtype DP): converting a stored tensor between storage
# dtypes as a standalone pass reads it at the source element size and
# writes it at the destination size.  The fused engine folds both casts
# into the neighbouring kernels; only the unfused DP prices them.
# ---------------------------------------------------------------------------

def cast_bytes(shape: Tuple[int, ...], src_dtype_bytes: int,
               dst_dtype_bytes: int) -> int:
    """Bytes of a standalone dtype-cast pass (read src + write dst);
    symmetric in (src, dst)."""
    n = int(np.prod(shape)) if shape else 0
    return n * (src_dtype_bytes + dst_dtype_bytes)


def cast_cost(shape: Tuple[int, ...], src_dtype_bytes: int,
              dst_dtype_bytes: int, hw: Optional[Hardware] = None) -> float:
    """Seconds for the standalone cast pass (elementwise, ~full
    bandwidth)."""
    return (cast_bytes(shape, src_dtype_bytes, dst_dtype_bytes)
            / (_hw(hw).mem_bw * 0.9))


# ---------------------------------------------------------------------------
# conv cost model: direct (CHWN) vs im2col-MM (NCHW)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ConvCost:
    layout: str
    compute_s: float
    memory_s: float

    @property
    def total_s(self) -> float:
        return max(self.compute_s, self.memory_s)


def conv_flops(l: ConvLayer) -> float:
    ho = wo = l.out_hw
    return 2.0 * l.N * l.Co * ho * wo * l.Ci * l.F * l.F


def conv_cost(l: ConvLayer, layout: str,
              dtype_bytes: int = DEFAULT_DTYPE_BYTES,
              hw: Optional[Hardware] = None, *,
              packed_span: bool = True) -> ConvCost:
    """Roofline cost of one conv layer under a layout.

    direct/CHWN: the contraction is [Ci*F*F] x [N] per output pixel: N on
    the minor dim (the paper's coalescing dim), Ci*F*F the reduction; its
    efficiency is the tile utilization of (reduction, N), and N must also
    span ``hw.span_bytes`` to read at full rate (``packed_span=False`` is
    for engines that widen a packed operand before it is read, the fused
    int8 path).

    im2col/NCHW: materializes the [N*Ho*Wo, Ci*F*F] patch matrix (the
    paper's matrix-expansion overhead: one write and one read back), then
    an aligned matmul with Co on the minor dim.
    """
    hw = _hw(hw)
    peak, bw = hw.peak(dtype_bytes), hw.mem_bw
    ho = wo = l.out_hw
    flops = conv_flops(l)
    in_bytes = l.N * l.Ci * l.HW * l.HW * dtype_bytes
    out_bytes = l.N * l.Co * ho * wo * dtype_bytes
    w_bytes = l.Co * l.Ci * l.F * l.F * dtype_bytes

    if layout == "CHWN":
        red = l.Ci * l.F * l.F
        eff = tile_utilization((red, l.N), dtype_bytes, hw)
        if packed_span:
            eff = min(eff, l.N * dtype_bytes / hw.span_bytes)
        mem = in_bytes + out_bytes + w_bytes
        return ConvCost("CHWN", flops / (peak * max(eff, 1e-3)), mem / bw)

    if layout == "NCHW":
        red = l.Ci * l.F * l.F
        eff = tile_utilization((red, _round_up(l.Co, hw.co_block)),
                               dtype_bytes, hw)
        im2col = l.N * ho * wo * red * dtype_bytes
        mem = in_bytes + 2 * im2col + out_bytes + w_bytes
        return ConvCost("NCHW", flops / (peak * max(eff, 1e-3)), mem / bw)

    raise ValueError(layout)


def select_conv_layout_cost(l: ConvLayer,
                            dtype_bytes: int = DEFAULT_DTYPE_BYTES,
                            hw: Optional[Hardware] = None) -> str:
    """Cost-model arbitration (used for calibration)."""
    c = {lay: conv_cost(l, lay, dtype_bytes, hw).total_s
         for lay in ("CHWN", "NCHW")}
    return min(c, key=c.get)


# ---------------------------------------------------------------------------
# fusion cost model: conv -> relu -> pool chains executed as one kernel
# keep the intermediate on chip, so its round trips vanish
# ---------------------------------------------------------------------------

def chain_bytes(l: ConvLayer, dtype_bytes: int = DEFAULT_DTYPE_BYTES, *,
                relu: bool = False,
                pool: Optional[Tuple[int, int]] = None,
                fused: bool = True,
                in_dtype_bytes: Optional[int] = None,
                out_dtype_bytes: Optional[int] = None,
                residual: bool = False) -> int:
    """Bytes moved by a conv[->add][->relu][->pool] chain.

    Unfused, every intermediate makes a full round trip.  Fused, only the
    conv input, the weights, the skip tensor (``residual``) and the final
    (post-pool) output touch device memory.  ``pool`` is ``(F, S)`` of the
    folded pool; ``in_dtype_bytes``/``out_dtype_bytes`` (mixed-dtype plans)
    override the element size of the stored input/output, while weights
    and the unfused intermediates stay at ``dtype_bytes``.
    """
    in_db = dtype_bytes if in_dtype_bytes is None else in_dtype_bytes
    out_db = dtype_bytes if out_dtype_bytes is None else out_dtype_bytes
    ho = l.out_hw
    in_b = l.N * l.Ci * l.HW * l.HW * in_db
    w_b = l.Co * l.Ci * l.F * l.F * dtype_bytes
    out_b = l.N * l.Co * ho * ho * dtype_bytes
    final_n = l.N * l.Co * ho * ho
    if pool is not None:
        pho = pool_out_hw(ho, pool[0], pool[1])
        final_n = l.N * l.Co * pho * pho
    final_b = final_n * out_db
    if fused:
        return in_b + w_b + final_b + (out_b if residual else 0)
    total = in_b + w_b + out_b
    if residual:
        total += 3 * out_b       # standalone add: read a, read skip, write
    if relu:
        total += 2 * out_b
    if pool is not None:
        total += out_b + final_b
    return total


def fusion_saved_bytes(l: ConvLayer, dtype_bytes: int = DEFAULT_DTYPE_BYTES,
                       *, relu: bool = False,
                       pool: Optional[Tuple[int, int]] = None) -> int:
    """Intermediate read+write traffic a fused chain removes."""
    return (chain_bytes(l, dtype_bytes, relu=relu, pool=pool, fused=False) -
            chain_bytes(l, dtype_bytes, relu=relu, pool=pool, fused=True))


def fused_chain_cost(l: ConvLayer, layout: str,
                     dtype_bytes: int = DEFAULT_DTYPE_BYTES, *,
                     relu: bool = False,
                     pool: Optional[Tuple[int, int]] = None,
                     in_dtype_bytes: Optional[int] = None,
                     out_dtype_bytes: Optional[int] = None,
                     residual: bool = False,
                     hw: Optional[Hardware] = None) -> ConvCost:
    """Cost of the fused conv[->relu][->pool] node: the compute side of
    ``conv_cost`` (at the input's storage element size), the memory side
    exactly the fused kernel's traffic (``chain_bytes``): the NCHW patch
    matrix stays virtual, so no expansion bytes are charged."""
    hw = _hw(hw)
    in_db = dtype_bytes if in_dtype_bytes is None else in_dtype_bytes
    base = conv_cost(l, layout, in_db, hw, packed_span=False)
    mem_bytes = chain_bytes(l, dtype_bytes, relu=relu, pool=pool, fused=True,
                            in_dtype_bytes=in_dtype_bytes,
                            out_dtype_bytes=out_dtype_bytes,
                            residual=residual)
    return ConvCost(layout, base.compute_s, mem_bytes / hw.mem_bw)


# ---------------------------------------------------------------------------
# cross-layer stack model: two stacked convs in one kernel trade
# recomputed halo rows for the mid activation's round trip
# ---------------------------------------------------------------------------

# N-tile candidates of the "budget" gate's CHWN stack, largest first
STACK_NT_CANDIDATES = (8, 4, 2, 1)


def pool_tiles_block(bho: int, n_ho: int, pF: int, pS: int) -> bool:
    """True when every pool window lies inside one conv-output row block:
    one block covers the whole height, or the block height is a multiple
    of the pool stride and windows don't overlap block seams."""
    if pF > bho:
        return False
    return n_ho == 1 or (bho % pS == 0 and pF <= pS)


def pick_bho(Ho: int, F: int, S: int,
             pool: Optional[Tuple[int, int, str]] = None) -> int:
    """Smallest output-row block: the halo trick needs 2*bho*S to cover
    one window span, and a fused pool needs its windows to tile the block
    (else one whole-height block)."""
    min_bho = max(1, -(-(F - S) // S))
    cands = [d for d in range(1, Ho + 1) if Ho % d == 0 and d >= min_bho]
    if pool is not None:
        pF, pS, _ = pool
        cands = [d for d in cands if pool_tiles_block(d, Ho // d, pF, pS)]
        if not cands:
            return Ho
    return min(cands) if cands else Ho


def conv_blocking(Ho: int, F: int, S: int,
                  pool: Optional[Tuple[int, int, str]] = None):
    """(output row block, input row block, row-block count): the two
    stitched input blocks must cover one window span, so a whole-height
    block below that bound widens its input block."""
    bho = pick_bho(Ho, F, S, pool)
    IBH = max(bho * S, -(-((bho - 1) * S + F) // 2))
    return bho, IBH, Ho // bho


def stack_blocking(Ho2: int, F1: int, S1: int, F2: int, S2: int,
                   pool: Optional[Tuple[int, int, str]] = None):
    """Row blocking of a conv->conv stack as ONE virtual conv with the
    composite receptive field S_eff = S1*S2, F_eff = (F2-1)*S1 + F1 over
    the second conv's output rows; ``mho = (bho-1)*S2 + F2`` mid rows are
    staged a block.  Returns (bho, IBH, n_ho, mho).  The reference's
    geometry (``repro/kernels/conv/ops.py::stack_blocking``), kept for the
    footprint and recompute arithmetic."""
    S_eff, F_eff = S1 * S2, (F2 - 1) * S1 + F1
    bho, IBH, n_ho = conv_blocking(Ho2, F_eff, S_eff, pool)
    mho = (bho - 1) * S2 + F2
    assert 2 * IBH >= (mho - 1) * S1 + F1, (IBH, mho, S1, F1)
    return bho, IBH, n_ho, mho


def _pool3(pool) -> Optional[Tuple[int, int, str]]:
    if pool is not None and len(pool) == 2:
        return (pool[0], pool[1], "max")   # cost-model pools carry no op
    return pool


def _stack_geom(l1: ConvLayer, l2: ConvLayer,
                pool: Optional[Tuple[int, int, str]] = None,
                hw: Optional[Hardware] = None):
    """Composite blocking + staged-tile widths for a conv->conv stack."""
    hw = _hw(hw)
    blocking = hw.stack_blocking or stack_blocking
    bho, IBH, n_ho, mho = blocking(l2.out_hw, l1.F, l1.S, l2.F, l2.S,
                                   _pool3(pool))
    w_pad = l1.HW + 2 * (l1.pad + l1.S * l2.pad)
    wm = l1.out_hw + 2 * l2.pad
    return bho, IBH, n_ho, mho, w_pad, wm


def stack_vmem_bytes(l1: ConvLayer, l2: ConvLayer, layout: str,
                     dtype_bytes: int = DEFAULT_DTYPE_BYTES, *,
                     pool: Optional[Tuple[int, int, str]] = None,
                     residual: bool = False, nt: int = 8,
                     in_dtype_bytes: Optional[int] = None,
                     hw: Optional[Hardware] = None) -> int:
    """On-chip footprint of one stack step of the "budget" gate: the
    stitched input block, both full weight slabs, the f32 staged mid tile,
    the f32 output accumulator, and the residual block."""
    in_db = dtype_bytes if in_dtype_bytes is None else in_dtype_bytes
    bho, IBH, _, mho, w_pad, wm = _stack_geom(l1, l2, pool, hw)
    ntv = min(nt, max(l1.N, 1)) if layout == "CHWN" else 1
    x_b = l1.Ci * 2 * IBH * w_pad * ntv * in_db
    w_b = (l1.Co * l1.Ci * l1.F * l1.F +
           l2.Co * l2.Ci * l2.F * l2.F) * dtype_bytes
    mid_b = l1.Co * mho * wm * ntv * 4
    out_b = l2.Co * bho * l2.out_hw * ntv * 4
    res_b = l2.Co * bho * l2.out_hw * ntv * dtype_bytes if residual else 0
    return x_b + w_b + mid_b + out_b + res_b


def stack_nt(l1: ConvLayer, l2: ConvLayer, layout: str,
             dtype_bytes: int = DEFAULT_DTYPE_BYTES, *,
             pool: Optional[Tuple[int, int, str]] = None,
             residual: bool = False,
             in_dtype_bytes: Optional[int] = None,
             hw: Optional[Hardware] = None) -> int:
    """The stack's N tile, or 0 when the pair cannot run as one stack
    kernel (the planner's fuse/don't gate).

    ``"smem"`` gate: the images a block tile of the stack kernel holds
    (``kernels.conv.ops.stack_tiling``), 0 when no tile fits one block's
    shared memory.  ``"budget"`` gate: the largest candidate N tile whose
    ``stack_vmem_bytes`` fits ``hw.stack_budget``."""
    hw = _hw(hw)
    if hw.stack_gate == "smem":
        from repro_torch.kernels.conv.ops import stack_tiling
        try:
            t = stack_tiling(layout, l1.N, l1.Ci, l1.HW, l1.HW, l1.Co, l1.F,
                             l1.S, l1.pad, l2.Co, l2.F, l2.S, l2.pad,
                             _pool3(pool))
        except ValueError:
            return 0
        return t.nb
    cands = STACK_NT_CANDIDATES if layout == "CHWN" else (1,)
    for nt in cands:
        if stack_vmem_bytes(l1, l2, layout, dtype_bytes, pool=pool,
                            residual=residual, nt=nt,
                            in_dtype_bytes=in_dtype_bytes,
                            hw=hw) <= hw.stack_budget:
            return nt
    return 0


def chain_fits(l: ConvLayer, layout: str,
               pool: Optional[Tuple[int, int]] = None,
               hw: Optional[Hardware] = None) -> bool:
    """Whether the conv engine of ``layout`` can run the conv[->pool]
    chain ``l`` as one launch.  ``"smem"`` gate: the engine's tile model
    (K1: ``kernels.conv.ops.conv_tiling``, K2: ``nchw_tiling``) has a block
    tile that fits one block's shared memory; a pool window too wide for
    any tile must run on its own.  ``"budget"`` gate: always (the
    reference's engines tile every chain)."""
    hw = _hw(hw)
    if hw.stack_gate != "smem":
        return True
    from repro_torch.kernels.conv.ops import conv_tiling, nchw_tiling
    tiling = conv_tiling if layout == "CHWN" else nchw_tiling
    try:
        tiling(l.N, l.Ci, l.HW, l.HW, l.Co, l.F, l.S, l.pad, _pool3(pool))
    except ValueError:
        return False
    return True


def stack_bytes(l1: ConvLayer, l2: ConvLayer,
                dtype_bytes: int = DEFAULT_DTYPE_BYTES, *,
                pool: Optional[Tuple[int, int, str]] = None,
                residual: bool = False,
                in_dtype_bytes: Optional[int] = None,
                out_dtype_bytes: Optional[int] = None) -> int:
    """Bytes of the fused stack: conv1's input, both weight tensors, the
    final (post-pool) output, and the skip tensor when conv2 folds a
    residual.  The mid activation contributes nothing."""
    in_db = dtype_bytes if in_dtype_bytes is None else in_dtype_bytes
    out_db = dtype_bytes if out_dtype_bytes is None else out_dtype_bytes
    in_b = l1.N * l1.Ci * l1.HW * l1.HW * in_db
    w_b = (l1.Co * l1.Ci * l1.F * l1.F +
           l2.Co * l2.Ci * l2.F * l2.F) * dtype_bytes
    ho2 = l2.out_hw
    final_n = l2.N * l2.Co * ho2 * ho2
    if pool is not None:
        pho = pool_out_hw(ho2, pool[0], pool[1])
        final_n = l2.N * l2.Co * pho * pho
    out_b = l2.N * l2.Co * ho2 * ho2 * dtype_bytes
    return in_b + w_b + final_n * out_db + (out_b if residual else 0)


def stack_fused_cost(l1: ConvLayer, l2: ConvLayer, layout: str,
                     dtype_bytes: int = DEFAULT_DTYPE_BYTES, *,
                     pool: Optional[Tuple[int, int, str]] = None,
                     residual: bool = False,
                     in_dtype_bytes: Optional[int] = None,
                     out_dtype_bytes: Optional[int] = None,
                     hw: Optional[Hardware] = None) -> ConvCost:
    """Roofline cost of the fused conv->conv stack node: conv2 runs once,
    conv1 recomputes its halo (each of the ``n_ho`` row blocks stages
    ``mho`` mid rows and ``wm`` mid columns), so conv1's compute scales by
    (n_ho*mho/Ho1) * (wm/Wo1); memory is ``stack_bytes``."""
    hw = _hw(hw)
    in_db = dtype_bytes if in_dtype_bytes is None else in_dtype_bytes
    _, _, n_ho, mho, _, wm = _stack_geom(l1, l2, pool, hw)
    c1 = conv_cost(l1, layout, in_db, hw, packed_span=False).compute_s
    c2 = conv_cost(l2, layout, dtype_bytes, hw,
                   packed_span=False).compute_s
    recompute = ((n_ho * mho) / max(l1.out_hw, 1)) * (wm / max(l1.out_hw, 1))
    mem = stack_bytes(l1, l2, dtype_bytes, pool=pool, residual=residual,
                      in_dtype_bytes=in_dtype_bytes,
                      out_dtype_bytes=out_dtype_bytes)
    return ConvCost(layout, c1 * recompute + c2, mem / hw.mem_bw)


# ---------------------------------------------------------------------------
# backward direction: dgrad / wgrad (training)
# ---------------------------------------------------------------------------

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


def train_chain_bytes(l: ConvLayer, layout: str = "CHWN",
                      dtype_bytes: int = DEFAULT_DTYPE_BYTES, *,
                      relu: bool = False,
                      pool: Optional[Tuple[int, int]] = None,
                      bias: bool = False, fused: bool = True,
                      trainable: bool = True) -> int:
    """Forward + backward bytes of one chain (one training step's view)."""
    return (chain_bytes(l, dtype_bytes, relu=relu, pool=pool, fused=fused) +
            conv_backward_bytes(l, layout, dtype_bytes, relu=relu, pool=pool,
                                bias=bias, fused=fused, trainable=trainable))


def conv_backward_cost(l: ConvLayer, layout: str,
                       dtype_bytes: int = DEFAULT_DTYPE_BYTES, *,
                       relu: bool = False,
                       pool: Optional[Tuple[int, int]] = None,
                       fused: bool = True, residual: bool = False,
                       hw: Optional[Hardware] = None) -> ConvCost:
    """Roofline cost of the backward chain: dgrad + wgrad each move the
    forward FLOPs (2x total) at the layout's tile efficiency; the memory
    side is ``conv_backward_bytes``."""
    hw = _hw(hw)
    fwd = conv_cost(l, layout, dtype_bytes, hw)
    mem_bytes = conv_backward_bytes(l, layout, dtype_bytes, relu=relu,
                                    pool=pool, fused=fused,
                                    residual=residual)
    return ConvCost(layout, 2 * fwd.compute_s, mem_bytes / hw.mem_bw)


# ---------------------------------------------------------------------------
# LM-side layout scoring (the KV cache) — the paper's principle carried to
# the LM architectures
# ---------------------------------------------------------------------------

def select_kv_layout(batch: int, kv_heads: int, seq: int, head_dim: int,
                     steps_per_read: float = 1.0,
                     dtype_bytes: int = 2,
                     hw: Optional[Hardware] = None) -> str:
    """Choose the decode KV-cache layout (the reference's DESIGN.md §4.1b).

    ``bksd`` reads contiguously but each decode step UPDATES a size-1 slice
    of the S dim (the second-minor dim) -> update writes pad to a full
    (second-minor x minor granule) tile per (b,k):
    waste = B*K*(granule-1)*head_dim.  ``sbkd`` updates one full row
    [1,B,K,Dh] but attention reads stride across S-major tiles; read cost
    is identical at the memory level (the whole cache is streamed) as long
    as B*K*Dh fills tiles.  Prefer ``sbkd`` when the padded-update waste
    exceeds the read-side tile waste.

    The reference's arithmetic, with its TPU constants taken from ``hw``:
    the sublane count is ``hw.second_minor_granule``, the 128 lanes
    ``hw.minor_granule``.  Under ``reference_hardware()`` it picks what
    the reference picks; under the H100 profile (the default) the card's
    pick, with the granules of the port's kernels (their cost terms are
    not yet refit for the card).
    """
    hw = _hw(hw)
    sl = hw.second_minor_granule(dtype_bytes)
    lanes = hw.minor_granule(dtype_bytes)
    # bksd: update touches B*K tiles of (sl x lanes) to write 1 x Dh each
    upd_bksd = batch * kv_heads * sl * max(head_dim, lanes) * dtype_bytes
    # sbkd: update writes ceil(B*K*Dh / lanes) contiguous tiles exactly once
    row = batch * kv_heads * head_dim
    upd_sbkd = _round_up(row, sl * lanes) * dtype_bytes
    # read: both stream B*K*S*Dh; sbkd wastes if row < tile
    read_eff_sbkd = row / _round_up(row, sl * lanes)
    read_eff_bksd = min(1.0, (seq * head_dim) /
                        (_round_up(seq, sl) * _round_up(head_dim, lanes)))
    read_bytes = batch * kv_heads * seq * head_dim * dtype_bytes
    cost_bksd = upd_bksd + steps_per_read * read_bytes / max(read_eff_bksd, 1e-3)
    cost_sbkd = upd_sbkd + steps_per_read * read_bytes / max(read_eff_sbkd, 1e-3)
    return "bksd" if cost_bksd <= cost_sbkd else "sbkd"
