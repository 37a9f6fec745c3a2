"""Wrappers of the pool backward kernels K7a/K7b (``csrc/pool_backward.cu``),
the counterpart of ``repro/kernels/pool/backward.py``.

``pool_backward`` routes a pooled gradient back onto the pool's input:
max to each window's first maximal element in row-major tap order, avg as
g/F^2 over the window, with the ReLU mask optionally folded into the same
pass.  It reads g in the downstream layout (``g_layout``) and writes dx in
the pool input's layout.  A CHWN input runs K7a (``pool_backward_chwn``),
an NCHW one K7b (``pool_backward_nchw``); the identity pool (F = S = 1) is
a re-layout of g and runs no K7.  For a CPU tensor a wrapper returns the
plain version (``ref.pool_backward_ref``); for a CUDA tensor it launches
its kernel or raises.  Launches are counted in
``pool_backward_chwn.launches`` and ``pool_backward_nchw.launches``; a
bf16 launch (x, g and dx bf16: the windows' shares summed in float32 and
rounded once) also in ``variant_launches["bf16"]``.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.core.transform import apply_transform
from repro_torch.kernels import _build
from repro_torch.kernels.pool.ref import pool_backward_ref
from repro_torch.shapes import pool_out_hw

_LAYOUTS = ("CHWN", "NCHW")
# K7a's block: the shared memory it aims at (several blocks an SM), the
# most dx rows it takes, and what a block may use at all on an H100
_K7A_SMEM_AIM = 32 * 1024
_K7A_MAX_BAND = 16
_SMEM_PER_BLOCK = 232448
# K7b's block: the dx elements it aims at (fewer where the launch would
# not give every SM 4 blocks, down to _K7B_MIN_ELEMS) and the shared memory
# it may take (4 blocks an SM)
_K7B_ELEMS = 8192
_K7B_MIN_ELEMS = 1024
_K7B_SMEM_AIM = 48 * 1024
_SMS = 132                # H100 SXM streaming multiprocessors


class PoolBand(NamedTuple):
    """K7a's split of the H rows: blocks of ``band`` dx rows (the last one
    shorter), each touching at most ``win_rows`` window rows."""
    band: int
    bands: int
    win_rows: int
    smem_bytes: int


def band_windows(h0: int, h1: int, H: int, F: int, S: int):
    """The window rows [lo, hi] that touch dx rows [h0, h1) of an F x F /
    S pool over H rows (hi < lo: none), as K7a's block computes them."""
    Ho = pool_out_hw(H, F, S)
    lo = (h0 - F + S) // S if h0 >= F else 0
    return lo, min(Ho - 1, (h1 - 1) // S)


def k7a_bf16_smem_bytes(win: int) -> int:
    """One banded K7a bf16 block's shared memory (``chwn_bf16_smem_bytes``
    in csrc/pool_backward.cu): for each of ``win`` windows and each of the
    chunk's 32 units, its g word and its first-max taps word."""
    return win * 32 * 8


@functools.lru_cache(maxsize=None)
def pool_backward_band(H: int, W: int, F: int, S: int,
                       itemsize: int = 4) -> PoolBand:
    """K7a's band: the most rows (up to ``_K7A_MAX_BAND``) whose block
    fits ``_K7A_SMEM_AIM`` bytes of shared memory, or one row where none
    does; raises where even one row exceeds a block's 227 KB.  A float32
    block (``itemsize`` 4) holds window g values [win][33] floats, taps
    [win][32] shorts and ReLU words [band * W]; a banded bf16 block
    (``itemsize`` 2) ``k7a_bf16_smem_bytes``."""
    Wo = pool_out_hw(W, F, S)

    def tiling(b: int) -> PoolBand:
        rows = 0
        for h0 in range(0, H, b):
            lo, hi = band_windows(h0, min(H, h0 + b), H, F, S)
            rows = max(rows, hi - lo + 1)
        rows = max(rows, 1)
        smem = (k7a_bf16_smem_bytes(rows * Wo) if itemsize == 2
                else rows * Wo * (33 * 4 + 32 * 2) + b * W * 4)
        return PoolBand(b, -(-H // b), rows, smem)

    fits = [t for t in map(tiling, range(1, min(H, _K7A_MAX_BAND) + 1))
            if t.smem_bytes <= _K7A_SMEM_AIM]
    best = fits[-1] if fits else tiling(1)
    if best.smem_bytes > _SMEM_PER_BLOCK:
        raise ValueError(f"pool_backward_chwn: one row of a {W}-wide pool "
                         f"needs {best.smem_bytes} bytes of shared memory")
    return best


def k7a_bf16_direct(op: str, F: int, S: int) -> bool:
    """Whether a K7a bf16 launch runs the direct kernel (max windows that
    share no element), else the banded one."""
    return op == "max" and F <= S


def _units(N: int, pair: bool):
    """(units a position, images of unit q) of the bf16 pool kernels: two
    neighbouring images a unit where ``pair``, else one."""
    if pair:
        return N // 2, lambda q: (2 * q, 2 * q + 1)
    return N, lambda q: (q,)


def k7a_bf16_direct_unit(u: int, N: int, C: int, H: int, W: int, F: int,
                         S: int, pair: bool):
    """What thread ``u`` of the direct K7a bf16 kernel
    (``pool_backward_direct_bf16``) writes: (c, its window (oh, ow), its
    images, the (h, w) of dx it owns: the window's taps and the rows and
    columns up to the next window or the edge).  Units run n fastest, then
    ow, oh, c."""
    Ho, Wo = pool_out_hw(H, F, S), pool_out_hw(W, F, S)
    U, images = _units(N, pair)
    r, q = divmod(u, U)
    r, ow = divmod(r, Wo)
    c, oh = divmod(r, Ho)
    h1 = H if oh == Ho - 1 else (oh + 1) * S
    w1 = W if ow == Wo - 1 else (ow + 1) * S
    owned = [(h, w) for h in range(oh * S, h1) for w in range(ow * S, w1)]
    return c, (oh, ow), images(q), owned


def k7a_bf16_banded_grid(N: int, C: int, H: int, W: int, F: int, S: int,
                         pair: bool):
    """The banded K7a bf16 kernel's grid (bands, C, chunks of 32 units)."""
    U = _units(N, pair)[0]
    return (pool_backward_band(H, W, F, S, 2).bands, C, -(-U // 32))


def k7a_bf16_banded_unit(block, e: int, N: int, H: int, W: int, F: int,
                         S: int, pair: bool):
    """What iteration ``e`` (thread ``e % 256``'s ``e // 256``-th) of block
    ``(bx, c, z)`` of the banded K7a bf16 kernel
    (``pool_backward_banded_bf16``) writes in phase 2: (c, h, w, images),
    or None past the block's units.  Its dx units run n fastest, then w,
    h; the block's windows are ``band_windows`` of its rows."""
    bx, c, z = block
    band = pool_backward_band(H, W, F, S, 2).band
    U, images = _units(N, pair)
    nu = min(32, U - 32 * z)
    h0, h1 = bx * band, min(H, bx * band + band)
    if e >= (h1 - h0) * W * nu:
        return None
    rw, j = divmod(e, nu)
    hh, w = divmod(rw, W)
    return c, h0 + hh, w, images(32 * z + j)


class PoolPlanes(NamedTuple):
    """K7b's split of the launch: blocks of ``planes`` consecutive (n, c)
    planes by ``band`` dx rows (the last ones fewer), each touching at most
    ``win_rows`` window rows."""
    planes: int
    band: int
    groups: int
    bands: int
    win_rows: int
    smem_bytes: int


def _k7b_smem(planes: int, win_rows: int, F: int, S: int, W: int,
              Wo: int) -> int:
    """One K7b block's shared memory (``nchw_smem_bytes`` in
    csrc/pool_backward.cu): per plane the x rows its windows cover and
    their g (float) and first-max tap (uint16)."""
    return planes * (4 * ((win_rows - 1) * S + F) * W + 6 * win_rows * Wo)


@functools.lru_cache(maxsize=None)
def pool_backward_planes(N: int, C: int, H: int, W: int, F: int,
                         S: int) -> PoolPlanes:
    """K7b's split: a block aims at ``_K7B_ELEMS`` dx elements (fewer where
    the launch would give the card fewer than 4 blocks an SM).  A plane
    larger than half that is cut into bands of rows, the most whose block
    fits ``_K7B_SMEM_AIM``; smaller planes go whole, as many to a block as
    the aim and the shared memory allow.  Raises where even one row
    exceeds a block's 227 KB."""
    Wo = pool_out_hw(W, F, S)
    planes = N * C
    aim = min(_K7B_ELEMS, max(_K7B_MIN_ELEMS,
                              planes * H * W // (4 * _SMS)))

    def tiling(p: int, b: int) -> PoolPlanes:
        rows = 1
        for h0 in range(0, H, b):
            lo, hi = band_windows(h0, min(H, h0 + b), H, F, S)
            rows = max(rows, hi - lo + 1)
        return PoolPlanes(p, b, -(-planes // p), -(-H // b), rows,
                          _k7b_smem(p, rows, F, S, W, Wo))

    if 2 * H * W > aim:
        best = tiling(1, 1)
        for b in range(2, min(H, max(1, aim // W)) + 1):
            t = tiling(1, b)
            if t.smem_bytes > _K7B_SMEM_AIM:
                break
            best = t
    else:
        best = tiling(1, H)
        for p in range(2, min(planes, aim // (H * W)) + 1):
            t = tiling(p, H)
            if t.smem_bytes > _K7B_SMEM_AIM:
                break
            best = t
    if best.bands > 1:  # bands of equal height (the last no taller)
        best = tiling(1, -(-H // best.bands))
    if best.smem_bytes > _SMEM_PER_BLOCK:
        raise ValueError(f"pool_backward_nchw: one row of a {W}-wide pool "
                         f"needs {best.smem_bytes} bytes of shared memory")
    return best


def _pool_backward(wrapper, entry: str, layout: str, x: torch.Tensor,
                   g: torch.Tensor, F: int, S: int, op: str,
                   g_layout: Optional[str], relu_mask: bool) -> torch.Tensor:
    name = wrapper.__name__
    g_layout = g_layout or layout
    if op not in ("max", "avg"):
        raise ValueError(f"{name}: unknown pool op {op!r}")
    if g_layout not in _LAYOUTS:
        raise ValueError(f"{name}: g_layout={g_layout!r} not in {_LAYOUTS}")
    if x.dim() != 4 or g.dim() != 4:
        raise ValueError(f"{name}: x and g must be 4-D")
    N, C, H, W = (x.shape[layout.index(d)] for d in "NCHW")
    Ho, Wo = pool_out_hw(H, F, S), pool_out_hw(W, F, S)
    if F < 1 or S < 1 or Ho < 1 or Wo < 1:
        raise ValueError(f"{name}: a {F}x{F} window at stride {S} does not "
                         f"fit {H}x{W}")
    want = tuple({"N": N, "C": C, "H": Ho, "W": Wo}[d] for d in g_layout)
    if tuple(g.shape) != want:
        raise ValueError(f"{name}: g shape {tuple(g.shape)} != {want} "
                         f"({g_layout})")
    if _build.on_cpu(name, x):
        return pool_backward_ref(x, g, F, S, op, layout, g_layout, relu_mask)
    dev, variant = _build.require_cuda_storage(name, x, g=g)
    dx = torch.empty_like(x)
    args = [x.data_ptr(), g.data_ptr(), dx.data_ptr(), N, C, H, W, F, S,
            int(op == "avg"), int(relu_mask), int(g_layout == "NCHW")]
    if layout == "CHWN":
        band = pool_backward_band(H, W, F, S, x.element_size())
        args += [band.band, band.win_rows]
    else:
        t = pool_backward_planes(N, C, H, W, F, S)
        args += [t.planes, t.band, t.win_rows]
    err = _build.entry(entry, variant)(*args, _build.stream_of(dev))
    _build.check(name, err)
    wrapper.launches += 1
    if variant:
        wrapper.variant_launches[variant] += 1
    return dx


def pool_backward_chwn(x: torch.Tensor, g: torch.Tensor, F: int, S: int,
                       op: str = "max", g_layout: Optional[str] = None,
                       relu_mask: bool = False) -> torch.Tensor:
    """K7a: x [C, H, W, N], g [C, Ho, Wo, N] (or NCHW for ``g_layout``)
    -> dx [C, H, W, N].  float32: a block takes one channel, a band of
    rows (``pool_backward_band``) and 32 images on the lanes; it finds each
    window's first maximum once, then forms dx from shared memory.  bf16:
    lanes over (w, image pairs); max pools whose windows share no element
    run a thread a window (``k7a_bf16_direct_unit``), the others the two
    phases in bf16 bytes (``k7a_bf16_banded_unit``)."""
    return _pool_backward(pool_backward_chwn, "pool_backward_chwn", "CHWN",
                          x, g, F, S, op, g_layout, relu_mask)


def pool_backward_nchw(x: torch.Tensor, g: torch.Tensor, F: int, S: int,
                       op: str = "max", g_layout: Optional[str] = None,
                       relu_mask: bool = False) -> torch.Tensor:
    """K7b: x [N, C, H, W], g [N, C, Ho, Wo] (or CHWN for ``g_layout``)
    -> dx [N, C, H, W].  A block takes a band of rows of one plane, or
    several small planes whole (``pool_backward_planes``); it finds each
    window's first maximum once, then forms dx from shared memory."""
    return _pool_backward(pool_backward_nchw, "pool_backward_nchw", "NCHW",
                          x, g, F, S, op, g_layout, relu_mask)


def pool_backward(x: torch.Tensor, g: torch.Tensor, F: int, S: int,
                  op: str = "max", *, layout: str = "CHWN",
                  g_layout: Optional[str] = None,
                  relu_mask: bool = False) -> torch.Tensor:
    """dx of pool(x, F, S, op): x the pool input in ``layout``, g the pooled
    output's gradient in ``g_layout``.  Returns dx in ``layout``; rows/cols
    beyond the last window get zero gradient.  ``relu_mask`` multiplies dx
    by (x > 0) in the same pass."""
    g_layout = g_layout or layout
    if F == 1 and S == 1:
        # identity pool: dx is g re-laid-out (K9a on the card), masked
        ga = apply_transform(g, g_layout, layout, use_kernel=True).float()
        if relu_mask:
            ga = ga * (x > 0.0)
        return ga.to(x.dtype)
    if layout == "CHWN":
        return pool_backward_chwn(x, g, F, S, op, g_layout, relu_mask)
    if layout == "NCHW":
        return pool_backward_nchw(x, g, F, S, op, g_layout, relu_mask)
    raise ValueError(f"no pool backward kernel reads layout {layout!r}")


pool_backward_chwn.launches = 0
pool_backward_nchw.launches = 0
pool_backward_chwn.variant_launches = {"bf16": 0}
pool_backward_nchw.variant_launches = {"bf16": 0}
