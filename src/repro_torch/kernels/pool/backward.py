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


def k7b_bf16_xw(W: int) -> int:
    """Elements of a staged x row of K7b bf16's banded kernel (``k7b_xw``):
    W rounded up to 8 (16-byte rows)."""
    return -(-W // 8) * 8


def k7b_bf16_smem_bytes(planes: int, win_rows: int, F: int, S: int, W: int,
                        Wo: int) -> int:
    """One banded K7b bf16 block's shared memory (``nchw_bf16_smem_bytes``
    in csrc/pool_backward.cu): per plane the x rows its windows cover in
    bf16 and a 4-byte word a window (its g and first-max tap)."""
    return planes * (2 * ((win_rows - 1) * S + F) * k7b_bf16_xw(W)
                     + 4 * win_rows * Wo)


@functools.lru_cache(maxsize=None)
def pool_backward_planes(N: int, C: int, H: int, W: int, F: int,
                         S: int, itemsize: int = 4) -> PoolPlanes:
    """K7b's split: a block aims at ``_K7B_ELEMS`` dx elements (fewer where
    the launch would give the card fewer than 4 blocks an SM).  A plane
    larger than half that is cut into bands of rows, the most whose block
    fits ``_K7B_SMEM_AIM``; smaller planes go whole, as many to a block as
    the aim and the shared memory allow.  Raises where even one row
    exceeds a block's 227 KB.  A float32 block (``itemsize`` 4) holds
    ``_k7b_smem``, a bf16 one (``itemsize`` 2) ``k7b_bf16_smem_bytes``."""
    Wo = pool_out_hw(W, F, S)
    planes = N * C
    aim = min(_K7B_ELEMS, max(_K7B_MIN_ELEMS,
                              planes * H * W // (4 * _SMS)))
    smem = k7b_bf16_smem_bytes if itemsize == 2 else _k7b_smem

    def tiling(p: int, b: int) -> PoolPlanes:
        rows = 1
        for h0 in range(0, H, b):
            lo, hi = band_windows(h0, min(H, h0 + b), H, F, S)
            rows = max(rows, hi - lo + 1)
        return PoolPlanes(p, b, -(-planes // p), -(-H // b), rows,
                          smem(p, rows, F, S, W, Wo))

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


def _k7b_block(block, N: int, C: int, H: int, W: int, F: int, S: int):
    """(first plane, planes, h0, h1, oh_lo, window rows) of the banded K7b
    bf16 kernel's block ``(bx, by)``."""
    t = pool_backward_planes(N, C, H, W, F, S, 2)
    bx, by = block
    p0 = bx * t.planes
    h0 = by * t.band
    h1 = min(H, h0 + t.band)
    lo, hi = band_windows(h0, h1, H, F, S)
    return p0, min(t.planes, N * C - p0), h0, h1, lo, max(0, hi - lo + 1)


def k7b_bf16_phase1_item(block, e: int, N: int, C: int, H: int, W: int,
                         F: int, S: int):
    """What iteration ``e`` (thread ``e % 256``'s ``e // 256``-th) of the
    banded K7b bf16 kernel's block ``block`` writes in phase 1: (plane, oh,
    ow) of one window's word, or None past the block's items."""
    p0, pc, _, _, lo, wr = _k7b_block(block, N, C, H, W, F, S)
    Wo = pool_out_hw(W, F, S)
    if e >= pc * wr * Wo:
        return None
    pl, r = divmod(e, wr * Wo)
    rw, ow = divmod(r, Wo)
    return p0 + pl, lo + rw, ow


def k7b_bf16_phase2_item(block, e: int, N: int, C: int, H: int, W: int,
                         F: int, S: int):
    """What iteration ``e`` of the banded K7b bf16 kernel's block ``block``
    forms in phase 2: (plane, h, the columns w0 .. w0 + 7 inside W, the
    windows (oh, ow) it visits in its order: oh, then ow, descending), or
    None past the block's items."""
    p0, pc, h0, h1, _, _ = _k7b_block(block, N, C, H, W, F, S)
    Ho, Wo = pool_out_hw(H, F, S), pool_out_hw(W, F, S)
    WQ = -(-W // 8)
    if e >= pc * (h1 - h0) * WQ:
        return None
    pl, r = divmod(e, (h1 - h0) * WQ)
    hh, i = divmod(r, WQ)
    h, w0 = h0 + hh, 8 * i
    oh_a = min(h // S, Ho - 1)
    oh_b = max((h - F + S) // S if h >= F else 0, oh_a - (-(-F // S)) + 1)
    ow_a = min((w0 + 7) // S, Wo - 1)
    ow_b = (w0 - F + S) // S if w0 >= F else 0
    wins = [(oh, ow) for oh in range(oh_a, oh_b - 1, -1)
            for ow in range(ow_a, ow_b - 1, -1)]
    return p0 + pl, h, list(range(w0, min(W, w0 + 8))), wins


def k7b_bf16_mask_row(block, h: int, N: int, C: int, H: int, W: int, F: int,
                      S: int):
    """(staged row, staged rows) of the banded K7b bf16 kernel's block
    ``block``: the x row in shared memory whose elements mask dx row ``h``
    of a max pool (the nearest where no window covers ``h``), and how many
    rows the block staged."""
    _, _, _, _, lo, wr = _k7b_block(block, N, C, H, W, F, S)
    xr = min(H, (lo + wr - 1) * S + F) - lo * S if wr else 0
    return max(0, min(h - lo * S, xr - 1)), xr


def k7b_bf16_pairs(H: int, W: int, F: int, S: int) -> int:
    """The window rows a block of K7b bf16's pair kernel takes
    (``pair_rows`` in csrc/pool_backward.cu), or 0 where the launch runs
    the banded kernel.  The pair kernel takes S = 2 and F = 2 or 3 where W
    % 8 == 0 (and x and dx are 16-byte aligned): a thread a window row and
    8 columns, the block the most rows whose threads (with the row above
    for F = 3) fit 256, evened out over the bands the plane's ceil(H / 2)
    row pairs need."""
    if not (S == 2 and F in (2, 3) and W % 8 == 0):
        return 0
    most = 256 // (W // 8) - (F == 3)
    if most < 1:
        return 0
    K = -(-H // 2)
    bands = -(-K // most)
    return -(-K // bands)


def k7b_bf16_pair_item(block, t: int, N: int, C: int, H: int, W: int,
                       F: int):
    """What thread ``t`` of block ``(p, b)`` of K7b bf16's pair kernel
    does: (plane, window row k, the windows (k, ow) whose words it makes,
    and [(h, columns, the windows it visits in its order)] of the dx rows
    it forms), or None for a thread past the block's items.  Thread t = r
    WQ + i takes window row k = b KB - (F == 3) + r and columns 8 i .. 8 i +
    7; dx row 2k visits row k's windows 4 i + 3 down to 4 i - (F - 2), then
    row k - 1's (F = 3); dx row 2k + 1 row k's."""
    Ho, Wo = pool_out_hw(H, F, 2), pool_out_hw(W, F, 2)
    WQ, KB, halo = W // 8, k7b_bf16_pairs(H, W, F, 2), int(F == 3)
    p, b = block
    r, i = divmod(t, WQ)
    if r >= KB + halo:
        return None
    k = b * KB - halo + r
    made = [(k, ow) for ow in range(4 * i, 4 * i + 4)
            if 0 <= k < Ho and ow < Wo]
    if r < halo or 2 * k >= H:
        return p, k, made, []
    ows = list(range(4 * i + 3, 4 * i - (F - 1), -1))
    top = [(k, ow) for ow in ows] + [(k - 1, ow) for ow in ows if F == 3]
    cols = list(range(8 * i, 8 * i + 8))
    rows = [(2 * k, cols, top)]
    if 2 * k + 1 < H:
        rows.append((2 * k + 1, cols, [(k, ow) for ow in ows]))
    return p, k, made, rows


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
        t = pool_backward_planes(N, C, H, W, F, S, x.element_size())
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
    window's first maximum once, then forms dx from shared memory.  bf16,
    S = 2 and F = 2 or 3 on 16-byte rows: a thread a window row and 8
    columns, x and g in registers, dx 8 along w of two rows
    (``k7b_bf16_pair_item``); else the bands with x and a word a window in
    shared memory at their storage width (``k7b_bf16_phase1_item``,
    ``k7b_bf16_phase2_item``)."""
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
