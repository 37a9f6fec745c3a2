"""K2 (the virtual-im2col NCHW conv) on the tensor cores and K7b (the NCHW
pool backward) as a two-phase block kernel, checked on the CPU.

- K2's fp32 arithmetic, 3xTF32 with a flush every 32 reduction terms
  (``repro_torch.kernels.tf32``), in the order the kernel reduces: (8 input
  channels) x (one tap), a chain of at most 4 taps, the tap rows of a
  channel group split over stages where the ring holds fewer than F; a
  thin input (fewer than 8 channels) 8 consecutive (tap row, channel, dx)
  a step, AlexNet's 11 x 11 first layer three tap rows a stage.  Over
  VGG16 conv4_2's 4608-term reduction, AlexNet conv1's and conv2's,
  within 1e-5 scale-relative to float64 (the kernel's accuracy gate),
  where one TF32 product a term misses it.
- K2's block tile ``nchw_tiling``, on every K2 launch of ``chip_smoke.py``'s
  main path (the packaged VGG16, AlexNet and ResNet-18 plans at every
  bucket and both stack policies, the unfused modes, the training steps'
  forwards, save_act forwards and dgrad problems) and the 12 Table-1
  layers, and on the card tests' cases: every output unit (pooled output,
  or conv output) owned by one block per slice of Co, every conv output
  under a pool window written to z by one block and none under no window
  (the kernel's writer rule), the FLOPs recounted block by block as the
  kernel counts them, the tile's conv outputs within its 16384 // bm
  columns and its shared memory within a block's, the tile of least
  modeled time picked; executed over direct FLOPs 1 wherever the conv is
  unpooled or its pool windows tile the output, under 2 under the
  overlapping 3/2 pools and at most 1.3 on ResNet-18's conv1 at the main
  path's batches.
- K7b's split ``pool_backward_planes``: the blocks cover every dx row of
  every plane once, every window that touches a block's band is among the
  rows it stages, and its shared memory fits.
"""
from __future__ import annotations

import pytest
import torch

import chip_smoke as cs
from repro_torch.configs.paper_table1 import CONV_LAYERS
from repro_torch.kernels.conv.backward import dgrad_problem, dgrad_shape
from repro_torch.kernels.conv import ops as conv_ops
from repro_torch.kernels.pool.backward import (band_windows,
                                               pool_backward_planes)
from repro_torch.kernels.tf32 import gemm_emulated
from repro_torch.serve.plan_cache import PlanCache, packaged_plans
from repro_torch.shapes import conv_out_hw, pool_out_hw
from tests.test_torch_kernels_card import CONV_CASES

TC_TOL = 1e-5        # scale-relative to float64


def _scaled_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.double() - want).abs().max()
            / max(1.0, want.abs().max().item())).item()


# -- the arithmetic ---------------------------------------------------------

def _k2_order(C: int, F: int, tr: int):
    """The reduction index k = (c, dy, dx) over C x F x F in the order K2
    reduces it, -1 for a zero term, each chain padded to 32 terms so that
    a 32-term slice of the emulation is one chain of the kernel.  Per
    8-channel group and per stage of ``tr`` tap rows, chains of 4 taps (an
    mma k is a channel, its tap fixed for the step); thin (C < 8), per
    stage the list of (tap row, channel, dx) padded to 8, chains of 4
    8-deep steps."""
    FF, order = F * F, []
    if C < 8:
        for dy0 in range(0, F, tr):
            ks = [c * FF + dy * F + dx for dy in range(dy0, min(F, dy0 + tr))
                  for c in range(C) for dx in range(F)]
            ks += [-1] * (-len(ks) % 8)
            for k0 in range(0, len(ks), 32):
                chain = ks[k0:k0 + 32]
                order += chain + [-1] * (32 - len(chain))
        return torch.tensor(order)
    for o in range(-(-C // 8)):
        for dy0 in range(0, F, tr):
            taps = [dy * F + dx for dy in range(dy0, min(F, dy0 + tr))
                    for dx in range(F)]
            for r0 in range(0, len(taps), 4):
                chain = [(o * 8 + c) * FF + r if o * 8 + c < C else -1
                         for r in taps[r0:r0 + 4] for c in range(8)]
                order += chain + [-1] * (32 - len(chain))
    return torch.tensor(order)


def _k2_gemm(w, p, C: int, F: int, tr: int, split: bool):
    """w [M, C*F*F] @ p [C*F*F, P] as K2 forms it."""
    idx = _k2_order(C, F, tr)
    keep = (idx >= 0).float()
    wk = w[:, idx.clamp(min=0)] * keep
    pk = p[idx.clamp(min=0), :] * keep[:, None]
    return gemm_emulated(wk, pk, split=split)


def test_k2_reduction_order_holds_every_term_once():
    for C, F, tr in [(3, 3, 3), (512, 3, 3), (3, 11, 1), (3, 11, 3),
                     (96, 5, 3), (13, 7, 3), (256, 1, 1), (7, 7, 7),
                     (1, 5, 2)]:
        idx = _k2_order(C, F, tr)
        assert sorted(idx[idx >= 0].tolist()) == list(range(C * F * F))


@pytest.mark.parametrize("what,C,F,tr,Co",
                         [("vgg16-conv4_2", 512, 3, 3, 64),
                          ("alexnet-conv1", 3, 11, 3, 96),
                          ("alexnet-conv2", 96, 5, 5, 256)],
                         ids=["vgg16-conv4_2", "alexnet-conv1",
                              "alexnet-conv2"])
def test_k2_3xtf32_holds_1e5_and_one_pass_tf32_does_not(what, C, F, tr, Co):
    """Activation-like patches (ReLU outputs, some large) against weights
    of a He-scaled layer: 3xTF32 within 1e-5 of float64, one TF32 product a
    term far outside it."""
    gen = torch.Generator().manual_seed(C + F)
    K = C * F * F
    w = torch.randn(Co, K, generator=gen) / K ** 0.5
    p = torch.relu(torch.randn(K, 256, generator=gen)) * 4.0
    want = w.double() @ p.double()
    assert _scaled_err(_k2_gemm(w, p, C, F, tr, True), want) <= TC_TOL
    assert _scaled_err(_k2_gemm(w, p, C, F, tr, False), want) > 10 * TC_TOL


# -- K2's block tile ----------------------------------------------------------

def _shape_of(case):
    """(N, Ci, H, W, Co, F, S, pad, pool) of a K2 launch of chip_smoke.py:
    a forward or save_act case, or a dgrad case as the stride-1 conv of
    the dilated gradient that ``backward.dgrad_problem`` poses."""
    if case[0] == "dgrad":
        N, Ci, H, Co, F, S, pad = case[1:8]
        return (*dgrad_shape(N, Ci, H, H, Co, F, S, pad), None)
    if case[0] == "save_act":
        case = case[1:]
    N, Ci, H, Co, F, S, pad, pool = case[:8]
    return (N, Ci, H, H, Co, F, S, pad, tuple(pool) if pool else None)


def _main_path_shapes():
    """Every distinct K2 launch of the main path, and of the packaged
    plans at every bucket and both stack policies, and the Table-1
    layers."""
    out = set()

    def add(keys):
        out.update(_shape_of(c) for k, c in keys if k == "conv_nchw")

    for network in ("vgg16", "alexnet", "resnet18"):
        cache = PlanCache(str(packaged_plans(network)))
        b = cache.min_bucket
        while b <= cache.max_bucket:
            for stack in ("off", "auto"):
                try:
                    add(cs.plan_launches(network, b, stack))
                except LookupError:
                    pass
            b *= 2
    for network, batch in cs.UNFUSED:
        for mode in cs.MODES:
            add(cs.unfused_launches(network, batch, mode)[1])
    for network, batch in cs.TRAINED:
        add(cs.train_launches(network, batch))
    out.update((c.N, c.Ci, c.HW, c.HW, c.Co, c.F, c.S, c.pad, None)
               for c in CONV_LAYERS)
    return sorted(out, key=str)


def _card_shapes():
    return sorted({(c[1], c[2], c[3], c[3], c[4], c[5], c[6], c[7],
                    tuple(c[8]) if c[8] else None)
                   for c in CONV_CASES if c[0] == "NCHW"}, key=str)


def _dim_tiles(U: int, ut: int, pF: int, pS: int):
    """The tiles along one dim of ``U`` units, as the kernel's make_tile
    cuts it: (first unit, units, first conv output, conv outputs, last)."""
    out = []
    for u0 in range(0, U, ut):
        n = min(ut, U - u0)
        o0, on = (u0 * pS, (n - 1) * pS + pF) if pF else (u0, n)
        out.append((u0, n, o0, on, u0 + n == U))
    return out


def _writers(O: int, U: int, tiles, pF: int, pS: int):
    """How many tiles write each conv output (row or column) of the O along
    a dim to z, by the kernel's rule: local row r of a tile of n units is
    written where r < n * pS (or the tile is the last) and r % pS < pF."""
    count = [0] * O
    for _, n, o0, on, last in tiles:
        for r in range(on):
            if (not pF) or ((r < n * pS or last) and r % pS < pF):
                count[o0 + r] += 1
    return count


def _under_a_window(O: int, U: int, pF: int, pS: int):
    if not pF:
        return [1] * O
    return [int(any(u * pS <= o < u * pS + pF for u in range(U)))
            for o in range(O)]


def _k2_recount(shape, t):
    """(FLOPs, blocks) of K2 at tile ``t``, block by block as the kernel
    counts them (2 K for every conv output of the block's rectangle on
    each of its channels below Co).  Asserts one owner per output unit and
    Co slice, one z writer per conv output under a window and none under
    no window, and the rectangle within the tile's columns."""
    N, Ci, H, W, Co, F, S, pad, pool = shape
    Ho, Wo = conv_out_hw(H, F, S, pad), conv_out_hw(W, F, S, pad)
    pF, pS = (pool[0], pool[1]) if pool else (0, 0)
    UH, UW = ((pool_out_hw(Ho, pF, pS), pool_out_hw(Wo, pF, pS)) if pool
              else (Ho, Wo))
    hs, ws = _dim_tiles(UH, t.uth, pF, pS), _dim_tiles(UW, t.utw, pF, pS)
    ns = [(n0, min(t.nb, N - n0)) for n0 in range(0, N, t.nb)]
    for tiles, U in ((hs, UH), (ws, UW)):   # one owner per unit
        owned = [0] * U
        for u0, n, *_ in tiles:
            for u in range(u0, u0 + n):
                owned[u] += 1
        assert owned == [1] * U
    assert sum(n for _, n in ns) == N
    assert _writers(Ho, UH, hs, pF, pS) == _under_a_window(Ho, UH, pF, pS)
    assert _writers(Wo, UW, ws, pF, pS) == _under_a_window(Wo, UW, pF, pS)
    K, flops, blocks = Ci * F * F, 0, 0
    for co0 in range(0, Co, t.bm):
        rows = min(t.bm, Co - co0)
        for _, nbc in ns:
            for _, _, _, oh, _ in hs:
                for _, _, _, ow, _ in ws:
                    assert nbc * oh * ow <= 16384 // t.bm
                    flops += 2 * K * rows * nbc * oh * ow
                    blocks += 1
    return flops, blocks


def _check_k2_tiling(shape):
    t = conv_ops.nchw_tiling(*shape)
    N, Ci, H, W, Co, F, S, pad, pool = shape
    pF, pS = (pool[0], pool[1]) if pool else (0, 0)
    assert t.bm in (64, 128, 256) and 1 <= t.tr <= F and t.ga in (1, 2, 4)
    assert t.ga == 1 or (F == 1 and Ci > 8 * t.ga)
    assert t.smem_bytes <= conv_ops.SMEM_PER_BLOCK
    assert t.smem_bytes == conv_ops.k2_layout(Ci, F, S, pF, pS, t.bm, t.nb,
                                              t.uth, t.utw, t.tr, t.ga)
    assert (t.executed_flops, t.blocks) == _k2_recount(shape, t)
    return t


MAIN = _main_path_shapes()


def _id(s):
    N, Ci, H, _, Co, F, S, pad, pool = s
    tag = "" if pool is None else f"-{pool[2]}{pool[0]}s{pool[1]}"
    return f"N{N}-C{Ci}-H{H}-K{Co}-F{F}-S{S}-P{pad}{tag}"


def test_the_main_path_has_every_kind_of_k2_launch():
    """The list the tests below walk holds the forwards, the pooled
    forwards (2/2, ResNet-18's 3/2 and 7 x 7 avg), the 11 x 11, 7 x 7, 5 x 5
    and 1 x 1 filters, stride 1, 2 and 4, and the dgrad problems."""
    pools = {s[8] for s in MAIN}
    assert {None, (2, 2, "max"), (3, 2, "max"), (7, 7, "avg")} <= pools
    assert {1, 3, 5, 7, 11} <= {s[5] for s in MAIN}
    assert {1, 2, 4} <= {s[6] for s in MAIN}
    assert len(MAIN) > 60


def _dgrad_geometries():
    """(H, F, S, pad) of every dgrad of the training steps (on K1 and K2),
    and odd sizes where a stride leaves a tail of rows unread."""
    out = {(7, 3, 2, 1), (8, 1, 2, 0), (9, 7, 2, 3), (10, 3, 2, 0),
           (12, 5, 3, 1)}
    for network, batch in cs.TRAINED:
        out.update(tuple(c[3:4] + c[5:8]) for _, c in
                   cs.train_launches(network, batch) if c[0] == "dgrad")
    return sorted(out)


DGRADS = _dgrad_geometries()


@pytest.mark.parametrize("layout", ["NCHW", "CHWN"])
@pytest.mark.parametrize("geom", DGRADS, ids=str)
def test_dgrad_shape_is_the_problem_dgrad_problem_poses(geom, layout):
    """The shape the tile tests and the tile sweep price a dgrad at is the
    conv ``dgrad_problem`` builds: the dilated gradient, the rotated
    filter and the padding."""
    H, F, S, pad = geom
    N, Ci, Co = 2, 3, 5
    Ho = conv_out_hw(H, F, S, pad)
    g = torch.zeros(N, Co, Ho, Ho)
    if layout == "CHWN":
        g = g.permute(1, 2, 3, 0).contiguous()
    gd, wt, p = dgrad_problem(g, torch.zeros(Co, Ci, F, F), (H, H), S, pad,
                              layout)
    dims = {d: gd.shape[layout.index(d)] for d in "NCHW"}
    posed = (dims["N"], dims["C"], dims["H"], dims["W"], wt.shape[0],
             wt.shape[2], 1, p)
    assert wt.shape == (Ci, Co, F, F)
    assert dgrad_shape(N, Ci, H, H, Co, F, S, pad) == posed


@pytest.mark.parametrize("shape", MAIN, ids=[_id(s) for s in MAIN])
def test_k2_tiling_of_every_main_path_launch(shape):
    t = _check_k2_tiling(shape)
    pool = shape[8]
    Ho = conv_out_hw(shape[2], shape[5], shape[6], shape[7])
    if pool is None or (pool[0] == pool[1] and Ho % pool[1] == 0):
        assert t.executed_flops == t.direct_flops
    else:
        # overlapping 3/2 windows: only the rows and columns neighbouring
        # rectangles share are computed twice; the modeled time may take
        # more of them for a faster tile (AlexNet conv5 at batch 1: 1.6x
        # in 72 blocks), never every window's taps anew (2.25x)
        assert t.executed_flops < 2 * t.direct_flops


@pytest.mark.parametrize("N", [8, 32])
def test_k2_resnet18_conv1_recomputes_little_halo(N):
    """ResNet-18's conv1 (7 x 7 / 2) with its 3/2 max pool, as the main
    path's plans run it at batch 8 and 32: at most 1.3x the direct FLOPs."""
    shape = (N, 3, 224, 224, 64, 7, 2, 3, (3, 2, "max"))
    assert shape in MAIN
    t = conv_ops.nchw_tiling(*shape)
    assert t.executed_flops <= 1.3 * t.direct_flops


@pytest.mark.parametrize("shape", MAIN, ids=[_id(s) for s in MAIN])
def test_k2_picks_the_tile_of_least_modeled_time(shape):
    cands = conv_ops.k2_tilings(*shape)
    t = conv_ops.nchw_tiling(*shape)
    modeled = dict((c, m) for m, c in cands)
    assert modeled[t] == min(m for m, _ in cands)
    assert len({c for _, c in cands}) == len(cands)


CARD = _card_shapes()


@pytest.mark.parametrize("shape", CARD, ids=[_id(s) for s in CARD])
def test_k2_tiling_prices_the_card_cases_exactly(shape):
    _check_k2_tiling(shape)


def test_k2_splits_the_taps_only_of_the_wide_filters():
    """A stage holds every tap row of the 3 x 3 and 5 x 5 filters of 8 or
    more channels, and of the 1 x 1 projections; a channel-major split
    keeps a channel's taps odd.  The 3-channel first layers run thin: a
    stage's reduction is its list of (tap row, channel, dx), and AlexNet's
    11 x 11 / 4 splits its rows over stages."""
    assert conv_ops.nchw_tiling(32, 256, 56, 56, 256, 3, 1, 1).tr == 3
    assert conv_ops.nchw_tiling(128, 96, 27, 27, 256, 5, 1, 2).tr in (3, 5)
    assert conv_ops.nchw_tiling(8, 128, 28, 28, 256, 1, 2, 0).tr == 1
    for Ci, F in [(16, 7), (9, 11), (8, 5)]:
        assert all(t % 2 == 1 for t in conv_ops._k2_tap_rows(Ci, F))
    assert conv_ops._k2_thin(3) and not conv_ops._k2_thin(8)
    t = conv_ops.nchw_tiling(128, 3, 227, 227, 96, 11, 4, 0)
    assert t.tr < 11 and t.bm in (64, 128)


def test_k2_rejects_a_pool_no_tile_holds():
    """A pool window is bounded by the tile, not by a tap count: a 16 x 16
    window fits the 256 columns of a 64-row tile, a 17 x 17 one no tile."""
    conv_ops.nchw_tiling(1, 3, 18, 18, 4, 3, 1, 0, (16, 1, "max"))
    with pytest.raises(ValueError, match="no block tile"):
        conv_ops.nchw_tiling(1, 3, 19, 19, 4, 3, 1, 0, (17, 1, "max"))


# -- K7b's split --------------------------------------------------------------

def _k7b_main_path():
    """(N, C, H, W, F, S) of every K7b launch of the training steps."""
    return sorted({(c[0], c[1], c[2], c[2], c[3], c[4])
                   for network, batch in cs.TRAINED
                   for k, c in cs.train_launches(network, batch)
                   if k == "pool_backward_nchw"})


def _k7b_shapes():
    out = set(_k7b_main_path())
    out |= {(3, 5, 9, 9, 3, 2), (2, 3, 16, 16, 2, 2), (1, 2, 300, 300, 3, 2),
            (2, 3, 10, 10, 1, 2), (2, 7, 7, 7, 7, 7), (33, 4, 17, 17, 3, 2),
            (2, 2, 230, 230, 2, 2), (1, 1, 5, 5, 5, 1)}
    return sorted(out)


K7B = _k7b_shapes()


@pytest.mark.parametrize("shape", K7B, ids=str)
def test_k7b_blocks_cover_every_row_and_window_once(shape):
    N, C, H, W, F, S = shape
    t = pool_backward_planes(*shape)
    Ho, Wo = pool_out_hw(H, F, S), pool_out_hw(W, F, S)
    assert t.groups * t.planes >= N * C > (t.groups - 1) * t.planes
    assert t.bands * t.band >= H > (t.bands - 1) * t.band
    assert t.planes == 1 or t.band == H
    covered = [0] * H
    for h0 in range(0, H, t.band):
        h1 = min(H, h0 + t.band)
        for h in range(h0, h1):
            covered[h] += 1
        lo, hi = band_windows(h0, h1, H, F, S)
        # every window touching the band is staged, and its x rows too
        touching = [o for o in range(Ho)
                    if o * S < h1 and o * S + F > h0]
        assert touching == list(range(lo, hi + 1))
        assert hi - lo + 1 <= t.win_rows
    assert covered == [1] * H
    assert t.smem_bytes == t.planes * (
        4 * ((t.win_rows - 1) * S + F) * W + 6 * t.win_rows * Wo)
    assert t.smem_bytes <= 48 * 1024


def test_k7b_gives_every_sm_blocks_on_the_main_path():
    """VGG16's five 2/2 pools, ResNet-18's 3/2 and 7 x 7 avg at batch 32:
    at least 4 blocks an SM, pool1's planes in bands of equal height."""
    main = _k7b_main_path()
    assert {(32, 64, 224, 224, 2, 2), (32, 64, 112, 112, 3, 2),
            (32, 512, 7, 7, 7, 7)} <= set(main)
    for shape in main:
        t = pool_backward_planes(*shape)
        assert t.groups * t.bands >= 4 * 132, (shape, t)
    t = pool_backward_planes(32, 64, 224, 224, 2, 2)
    assert t.planes == 1 and t.band * t.bands == 224
