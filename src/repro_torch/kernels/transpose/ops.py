"""Wrappers of the tiled transpose kernel (K9a/K9b, ``csrc/transpose.cu``).

For a CPU tensor each wrapper returns the plain version (``ref.py``); for a
CUDA tensor it launches the kernel or raises.  Launches are counted in
``transpose2d.launches`` and ``transpose2d_batched.launches``; a bf16
launch (the bf16 build's own kernel, ``transpose_bf16_kernel``) also in
``variant_launches["bf16"]``.  The reference wrappers' padding to a block
multiple is not carried over: the kernel checks the ragged edges itself.

The ``k9_bf16_*`` functions mirror the bf16 kernel's tile, access widths
and thread maps in plain Python, for the tests.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.transpose.ref import (transpose2d_batched_ref,
                                               transpose2d_ref)


K9_BF16_THREADS = 256   # a block of the bf16 kernel
K9_BF16_UNITS = 2       # (row pair, 8 columns) units a thread loads


def k9_bf16_tile(M: int) -> Tuple[int, int]:
    """(TM, TN) of the bf16 kernel's tile: all of M where M <= 32, else
    64 of it, by 256 or 128 columns: 16 KB."""
    TM = 32 if M <= 32 else 64
    return TM, 64 * (K9_BF16_THREADS // (4 * TM)) * K9_BF16_UNITS


def k9_bf16_widths(M: int, N: int, x_addr: int, y_addr: int
                   ) -> Tuple[int, int]:
    """Bytes a load of x and a store of y move in the bf16 kernel: 16
    where a row's length (N; M for y) is a multiple of 8 and the base is
    16-byte aligned, else 4 where it is even and the base 4-byte aligned,
    else 2."""
    def width(n: int, addr: int) -> int:
        if n % 8 == 0 and addr % 16 == 0:
            return 16
        return 4 if n % 2 == 0 and addr % 4 == 0 else 2
    return width(N, x_addr), width(M, y_addr)


def k9_bf16_word(r: int, p: int, TM: int) -> int:
    """The shared-memory word (32 bits) holding pair ``p`` (M elements 2p,
    2p + 1 of the tile) of tile row ``r`` (its N element ``r``): rows of
    TM / 2 words, 16-byte chunks XOR-swizzled by the row."""
    s = (r >> 3) & 7 if TM == 64 else (r >> 4) & 3
    return r * (TM // 2) + 4 * ((p >> 2) ^ s) + (p & 3)


def k9_bf16_units(TM: int, tid: int) -> List[Tuple[int, int]]:
    """(pair p, chunk nc) of each load unit of thread ``tid``: x rows m0 +
    2p and m0 + 2p + 1 at the tile's columns 8 nc .. 8 nc + 7."""
    pairs = TM // 2
    groups = K9_BF16_THREADS // (8 * pairs)
    lane8, p, grp = tid & 7, (tid >> 3) % pairs, (tid >> 3) // pairs
    return [(p, lane8 + 8 * (grp + groups * u))
            for u in range(K9_BF16_UNITS)]


def k9_bf16_unit_rows(TM: int, nc: int) -> List[int]:
    """The tile rows a unit of chunk ``nc`` stores its 8 words to, in
    store order (where TM = 32, odd chunks alternate the rows' parity)."""
    swap = TM == 32 and nc & 1
    return [8 * nc + (j ^ 1 if swap else j) for j in range(8)]


def k9_bf16_reads(TM: int, TN: int, tid: int) -> List[Tuple[int, int]]:
    """(tile row r, chunk c) of each 16-byte read of thread ``tid``: y
    row n0 + r at M elements m0 + 8c .. m0 + 8c + 7."""
    chunks = TM // 8
    return [divmod(tid + K9_BF16_THREADS * i, chunks)
            for i in range(TN * chunks // K9_BF16_THREADS)]


def _launch(wrapper, x: torch.Tensor, B: int, M: int, N: int,
            out_shape) -> torch.Tensor:
    name = wrapper.__name__
    dev, variant = _build.require_cuda_storage(name, x)
    y = torch.empty(out_shape, device=x.device, dtype=x.dtype)
    err = _build.entry("transpose_forward", variant)(
        x.data_ptr(), y.data_ptr(), B, M, N, _build.stream_of(dev))
    _build.check(name, err)
    wrapper.launches += 1
    if variant:
        wrapper.variant_launches[variant] += 1
    return y


def transpose2d(x: torch.Tensor) -> torch.Tensor:
    """K9a: [M, N] -> [N, M] through shared-memory tiles (32 x 32 in
    float32; bf16: ``k9_bf16_tile``)."""
    if x.dim() != 2:
        raise ValueError(f"transpose2d takes [M, N], got {tuple(x.shape)}")
    if _build.on_cpu("transpose2d", x):
        return transpose2d_ref(x)
    M, N = x.shape
    return _launch(transpose2d, x, 1, M, N, (N, M))


def transpose2d_batched(x: torch.Tensor) -> torch.Tensor:
    """K9b: [B, M, N] -> [B, N, M], the same kernel over a batch of tiles."""
    if x.dim() != 3:
        raise ValueError("transpose2d_batched takes [B, M, N], got "
                         f"{tuple(x.shape)}")
    if _build.on_cpu("transpose2d_batched", x):
        return transpose2d_batched_ref(x)
    B, M, N = x.shape
    return _launch(transpose2d_batched, x, B, M, N, (B, N, M))


transpose2d.launches = 0
transpose2d_batched.launches = 0
transpose2d.variant_launches = {"bf16": 0}
transpose2d_batched.variant_launches = {"bf16": 0}
