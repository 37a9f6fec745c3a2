"""Wrapper of the tiled matmul K10 (``csrc/matmul.cu``).

``matmul(x, y)`` is the reference's ``repro.kernels.matmul.ops.matmul``
without the TPU tiling knobs: x [M, K] @ y [K, N] with an fp32
accumulator, the result in x's dtype (float32 or bfloat16).  The
reference's padding of both operands to 128-multiples is not carried over:
the kernel masks the ragged edges, and it reads each operand through its
two strides, so a transposed view goes in without a copy.

``matmul_tiling`` picks the block tile and the split of K for a launch
(pure Python, so the CPU tests reach it).  For a CPU tensor ``matmul``
returns the plain version (``ref.matmul_ref``); for a CUDA tensor it
launches the kernel or raises.  Launches are counted in
``matmul.launches``, one a call (the split-K combine included).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.matmul.ref import matmul_ref

_MAX_GRID_Y = 65535
_SMS = 132                     # H100 SXM streaming multiprocessors
# the block tiles of csrc/matmul.cu, and what a reduction slice of each
# costs beside a 128 x 128 one's
TILES = ((128, 128), (128, 64), (64, 64))
_DEPTH = {torch.float32: 32, torch.bfloat16: 64}   # k of a slice
# The fp32 costs are a least-squares fit to 177 timed launches on an H100
# SXM (the 12 Table-1 matmuls under every tile and 1-16 splits of K,
# ``tools/kernel_variants.py --tiles``): a 128 x 128 slice's seconds on one
# SM, the narrower tiles' slices beside it, a block's fill and stores in
# slices, and the bytes/s the split partials move at.  bf16's slice time
# is modeled (one mma a 16-deep step; bf16 is off the main path).
_TILE_COST = {(128, 128): 1.0, (128, 64): 0.584, (64, 64): 0.332}
_SLICE_S = {torch.float32: 2.74e-6, torch.bfloat16: 0.9e-6}
_BLOCK_FILL = 0.678
_HBM_BYTES = 2.21e12
_MAX_SPLITS = 32


@dataclass(frozen=True)
class MatmulTiling:
    """How K10 cuts one launch: ``bm`` x ``bn`` output tiles, K in
    ``splits`` contiguous ranges of ``k_per_split`` (the last one shorter),
    each (tile, split) one block; ``waves`` of one block an SM."""
    bm: int
    bn: int
    splits: int
    k_per_split: int
    blocks: int
    waves: int
    seconds: float       # the modeled time the choice minimised


@functools.lru_cache(maxsize=None)
def matmul_tilings(M: int, N: int, K: int,
                   dtype: torch.dtype = torch.float32
                   ) -> Tuple[MatmulTiling, ...]:
    """Every tile and split-K of an [M, K] @ [K, N] launch, each with its
    modeled time: waves of one block an SM, each block its slices (a
    narrower tile's slice weighed ``_TILE_COST``) plus ``_BLOCK_FILL``,
    and with splits the partials written and read once more by the
    combine.  Splits are balanced (no empty split)."""
    depth = _DEPTH[dtype]
    slices = -(-K // depth)
    cands = []
    for bm, bn in TILES:
        if -(-N // bn) > _MAX_GRID_Y:
            continue
        tiles = -(-M // bm) * -(-N // bn)
        for want in range(1, min(_MAX_SPLITS, max(slices, 1)) + 1):
            per = max(1, -(-slices // want))
            splits = max(1, -(-slices // per))
            if splits != want:
                continue            # the same split as a smaller count
            blocks = tiles * splits
            waves = -(-blocks // _SMS)
            t = waves * (per * _TILE_COST[(bm, bn)] + _BLOCK_FILL) \
                * _SLICE_S[dtype]
            if splits > 1:
                t += (splits + 1) * 4.0 * M * N / _HBM_BYTES
            cands.append(MatmulTiling(bm, bn, splits, per * depth, blocks,
                                      waves, t))
    return tuple(cands)


@functools.lru_cache(maxsize=None)
def matmul_tiling(M: int, N: int, K: int,
                  dtype: torch.dtype = torch.float32) -> MatmulTiling:
    """The tile and split-K of ``matmul_tilings`` with the least modeled
    time (the wider tile, then fewer splits, on a tie)."""
    cands = matmul_tilings(M, N, K, dtype)
    if not cands:
        raise ValueError(f"matmul: [{M}, {K}] @ [{K}, {N}] has too many "
                         "column tiles for one launch")
    return min(cands, key=lambda c: (c.seconds, -c.bm * c.bn, c.splits))


def matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """K10: x [M, K] @ y [K, N] -> [M, N] in x's dtype, fp32 accumulation;
    x and y of one dtype, any strides."""
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"matmul takes x [M, K] and y [K, N], got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if _build.on_cpu("matmul", x):
        return matmul_ref(x, y)
    dtype = _build.require_cuda_float("matmul", x.device, contiguous=False,
                                      x=x, y=y)
    (M, K), N = x.shape, y.shape[1]
    if max(M, N, K) >= 2 ** 31:
        raise ValueError(f"matmul: [{M}, {K}] @ [{K}, {N}] is too large "
                         "for one launch")
    t = matmul_tiling(M, N, K, dtype)
    out = torch.empty(M, N, device=x.device, dtype=dtype)
    ws = (torch.empty(t.splits, M, N, device=x.device, dtype=torch.float32)
          if t.splits > 1 else None)
    err = _build.library().matmul_forward(
        x.data_ptr(), y.data_ptr(), out.data_ptr(),
        ws.data_ptr() if ws is not None else None, M, N, K, *x.stride(),
        *y.stride(), int(dtype == torch.bfloat16), t.bm, t.bn,
        t.k_per_split, t.splits, _build.stream_of(x.get_device()))
    _build.check("matmul", err)
    matmul.launches += 1
    return out


matmul.launches = 0
