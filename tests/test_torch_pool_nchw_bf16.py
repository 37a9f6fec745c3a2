"""The bf16 builds of K3b (``pool_nchw_bf16_kernel`` in
``kernels/pool/csrc/pool.cu``) and K7b (``pool_backward_nchw_bf16`` in
``pool_backward.cu``), checked on the CPU through their maps in Python.

- K3b bf16's unit map (``pool.ops.k3b_bf16_unit``: two neighbouring
  outputs of a row a thread) at 2/2, 3/2, 3/1 and 7/7, Wo odd and even:
  every output written by exactly one thread.  Then the kernel's
  arithmetic over that map on bf16 inputs with ties, NaN and all -inf
  windows: each window row's span loaded as the kernel loads it (8-byte,
  4-byte or halfword loads, a load past the row clamped to its last),
  widened, the max or the float32 sum in row-major order, divided,
  rounded once: the max bit for bit equal to the plain version, the avg
  within one bf16 step.
- K7b bf16's blocks (``pool_backward_planes(..., itemsize=2)``,
  ``k7b_bf16_phase1_item``, ``k7b_bf16_phase2_item``) on every K7b shape
  of the fp32 and bf16 training steps and ``test_torch_k2_k7b.py``'s extra
  shapes: every dx element formed once, every window that holds an
  element visited by it in the reference's order (oh, then ow,
  descending), every window a block visits written by that block's phase
  1 (pad slots where there is none), and the shared memory within a
  block's 227 KB.  Then the kernel's arithmetic over those maps on bf16
  inputs with ties, NaN and all -inf windows, the ReLU mask on and off:
  max bit for bit, avg within one bf16 step.

``test_torch_pool_nchw_bf16_card.py`` holds the CUDA kernels against the
plain versions on the card.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import chip_smoke as cs
from repro_torch.kernels.pool import backward as bwd
from repro_torch.kernels.pool.ops import k3b_bf16_unit
from repro_torch.kernels.pool.ref import pool_backward_ref, pool_ref
from repro_torch.shapes import pool_out_hw
from tests.test_torch_k2_k7b import K7B

BF16_STEP = 2.0 ** -7
SMEM_PER_BLOCK = 232448
WINDOWS = ((2, 2), (3, 2), (3, 1), (7, 7))
F32 = np.float32


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16)


def _within_one_step(got, want):
    got, want = got.double(), want.double()
    nan = want.isnan()
    assert torch.equal(got.isnan(), nan)
    inf = want.isinf()
    assert torch.equal(got[inf], want[inf])
    got, want = got[~nan & ~inf], want[~nan & ~inf]
    bound = BF16_STEP * want.abs() + 1e-5 * want.abs().max()
    assert bool(((got - want).abs() <= bound).all())


def _check(got, want, op):
    if op == "max":
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    else:
        _within_one_step(got, want)


# --------------------------------------------------------------------------
# K3b bf16: two neighbouring outputs of a row a thread
# --------------------------------------------------------------------------
def _k3b_units(N, C, Ho, Wo):
    return [k3b_bf16_unit(u, C, Ho, Wo)
            for u in range(N * C * Ho * -(-Wo // 2))]


@pytest.mark.parametrize("FS", WINDOWS)
@pytest.mark.parametrize("W", [14, 15, 16, 17, 23])
def test_k3b_bf16_units_write_every_output_once(FS, W):
    F, S = FS
    N, C, H = 3, 2, 9
    Ho, Wo = pool_out_hw(H, F, S), pool_out_hw(W, F, S)
    units = _k3b_units(N, C, Ho, Wo)
    written = [(n, c, ho, wo) for n, c, ho, wos in units for wo in wos]
    assert len(written) == len(set(written)) == N * C * Ho * Wo
    assert all(0 <= n < N and 0 <= c < C and 0 <= ho < Ho and 0 <= wo < Wo
               for n, c, ho, wo in written)
    # neighbouring threads take neighbouring pairs of a row: a warp's
    # 8-byte loads (2/2) are one contiguous line
    for a, b in zip(units, units[1:]):
        if a[:3] == b[:3]:
            assert b[3][0] == a[3][0] + 2
    assert {len(wos) for *_, wos in units} == ({2} if Wo % 2 == 0
                                                else {1, 2} if Wo > 1
                                                else {1})


def _k3b_loads(F, S, W):
    """The load widths (elements) K3b bf16 may take for F/S at width W:
    2/2 and 3/2 by 8-byte loads where W % 4 == 0, 4-byte where W is even,
    halfwords always (x at an odd halfword); other windows halfwords."""
    if (F, S) not in ((2, 2), (3, 2)):
        return [0]
    return [v for v in (4, 2, 1) if W % v == 0]


def _emulate_k3b(x, F, S, op, xv):
    """y of K3b bf16 over its map, each window row's span [w0, w0 + S + F)
    as the kernel loads it (``xv`` elements a load, 0: the generic kernel's
    halfwords), the two outputs combined from it in row-major order."""
    N, C, H, W = x.shape
    Ho, Wo = pool_out_hw(H, F, S), pool_out_hw(W, F, S)
    xf = x.float().numpy()
    y = torch.empty(N, C, Ho, Wo, dtype=torch.bfloat16)
    L = S + F
    for n, c, ho, wos in _k3b_units(N, C, Ho, Wo):
        w0 = wos[0] * S
        acc = [F32(0.0) if op == "avg" else F32(-math.inf)] * 2
        for dy in range(F):
            row = xf[n, c, ho * S + dy]
            if xv > 1:
                last = W // xv - 1
                span = [row[min(w0 // xv + k // xv, last) * xv + k % xv]
                        for k in range(L)]
            else:
                span = [row[min(w0 + k, W - 1)] for k in range(L)]
            for j in range(2):
                for dx in range(F):
                    v = F32(span[j * S + dx])
                    if op == "avg":
                        acc[j] = F32(acc[j] + v)
                    elif v > acc[j] or v != v:
                        acc[j] = v
        for j, wo in enumerate(wos):
            a = F32(acc[j] / F32(F * F)) if op == "avg" else acc[j]
            y[n, c, ho, wo] = torch.tensor(a).to(torch.bfloat16)
    return y


@pytest.mark.parametrize("FS,W,op", [
    ((2, 2), 16, "max"), ((2, 2), 14, "avg"), ((2, 2), 15, "max"),
    ((3, 2), 16, "avg"), ((3, 2), 14, "max"), ((3, 2), 17, "max"),
    ((3, 2), 13, "avg"), ((3, 1), 11, "max"), ((7, 7), 16, "avg"),
    ((7, 7), 15, "max")])
def test_k3b_bf16_emulated_equals_the_plain_version(FS, W, op):
    F, S = FS
    rng = np.random.default_rng(F * 100 + W)
    x = _bf16(np.round(rng.standard_normal((2, 3, 9, W)) * 4) / 4)
    x[0, 1, 2, 3] = float("nan")
    x[1, 0, :F, :F] = -float("inf")
    want = pool_ref(x, F, S, op, "NCHW")
    for xv in _k3b_loads(F, S, W):
        _check(_emulate_k3b(x, F, S, op, xv), want, op)


# --------------------------------------------------------------------------
# K7b bf16: the pair kernel (S = 2, F = 2 or 3 on 16-byte rows) and the
# banded one (every other case)
# --------------------------------------------------------------------------
def _bf16_main_path():
    """(N, C, H, W, F, S) of every K7b launch of the bf16 training steps."""
    out = set()
    for network, batch, profile in cs.BF16_TRAINED:
        if network != "resnet18":
            continue
        cfg, plan = cs.bf16_train_plan(network, batch, profile)
        out |= {(c[0], c[1], c[2], c[2], c[3], c[4])
                for k, c in cs.plan_train_launches(cfg, plan)
                if k == "pool_backward_nchw.bf16"}
    return out


K7B_BF16 = sorted(set(K7B) | _bf16_main_path())


def _blocks(groups, bands, full: bool):
    """The blocks to check: all of them, or the first and last group of
    planes over every band (every other group has the first's rows)."""
    gs = range(groups) if full else sorted({0, groups - 1})
    return [(bx, by) for bx in gs for by in range(bands)]


def _items(fn, block, shape):
    out, e = [], 0
    while (item := fn(block, e, *shape)) is not None:
        out.append(item)
        e += 1
    return out


def _holding(h, w, F, S, Ho, Wo):
    """The windows (oh, ow) that hold element (h, w)."""
    return {(oh, ow) for oh in range(max(0, (h - F) // S), h // S + 1)
            for ow in range(max(0, (w - F) // S), w // S + 1)
            if oh < Ho and ow < Wo and oh * S <= h < oh * S + F
            and ow * S <= w < ow * S + F}


def _pair_items(N, C, H, W, F, full):
    """[(block, t, item)] of the pair kernel over the blocks checked."""
    KB = bwd.k7b_bf16_pairs(H, W, F, 2)
    WQ, halo = W // 8, int(F == 3)
    bands = -(-(-(-H // 2)) // KB)
    out = []
    for block in _blocks(N * C, bands, full):
        for t in range((KB + halo) * WQ):
            out.append((block, t, bwd.k7b_bf16_pair_item(block, t, N, C, H,
                                                          W, F)))
    return out


@pytest.mark.parametrize("shape", K7B_BF16, ids=str)
def test_k7b_bf16_blocks_cover_every_element_and_window(shape):
    """The banded kernel's blocks on every shape; the pair kernel's where
    it runs.  Every dx element formed once; every window that holds an
    element visited by it, in the reference's order, after the block made
    its word; the banded block's shared memory within 227 KB."""
    N, C, H, W, F, S = shape
    t = bwd.pool_backward_planes(N, C, H, W, F, S, itemsize=2)
    Ho, Wo = pool_out_hw(H, F, S), pool_out_hw(W, F, S)
    assert t.smem_bytes == bwd.k7b_bf16_smem_bytes(t.planes, t.win_rows, F,
                                                   S, W, Wo)
    assert t.smem_bytes <= SMEM_PER_BLOCK
    assert t.groups * t.planes >= N * C > (t.groups - 1) * t.planes
    full = N * C * H * W <= 40000
    formed = []
    for block in _blocks(t.groups, t.bands, full):
        made = set(_items(bwd.k7b_bf16_phase1_item, block, shape))
        assert all(0 <= oh < Ho and 0 <= ow < Wo for _, oh, ow in made)
        for plane, h, cols, wins in _items(bwd.k7b_bf16_phase2_item, block,
                                           shape):
            formed += [(plane, h, w) for w in cols]
            assert all((plane, oh, ow) in made for oh, ow in wins)
            assert wins == sorted(wins, reverse=True)
            for w in cols:
                assert _holding(h, w, F, S, Ho, Wo) <= set(wins)
    assert len(formed) == len(set(formed))
    if full:
        assert len(formed) == N * C * H * W
    if not bwd.k7b_bf16_pairs(H, W, F, S):
        return
    formed = []
    KB = bwd.k7b_bf16_pairs(H, W, F, S)
    assert (KB + (F == 3)) * (W // 8) <= 256
    made = {}
    for block, _, item in _pair_items(N, C, H, W, F, full):
        if item is None:
            continue
        plane, k, wins, rows = item
        made.setdefault(block, set()).update((plane, oh, ow)
                                             for oh, ow in wins)
    for block, _, item in _pair_items(N, C, H, W, F, full):
        if item is None:
            continue
        plane, k, wins, rows = item
        for h, cols, visits in rows:
            formed += [(plane, h, w) for w in cols]
            real = [v for v in visits if (plane, *v) in made[block]]
            assert real == sorted(real, reverse=True)
            for w in cols:
                assert _holding(h, w, F, S, Ho, Wo) <= set(real)
    assert len(formed) == len(set(formed))
    if full:
        assert len(formed) == N * C * H * W


@pytest.mark.parametrize("shape", K7B_BF16 + [(2, 3, 64, 64, 2, 3)],
                         ids=str)
def test_k7b_bf16_mask_reads_a_staged_row(shape):
    """Phase 2 of the banded kernel masks dx row h of a max pool by a row
    it staged: the row h itself wherever a window covers h, and a row in
    range where none does (a band starting in a row that no 2/3 window
    covers, as at H = 64, reads the first staged row)."""
    N, C, H, W, F, S = shape
    t = bwd.pool_backward_planes(N, C, H, W, F, S, itemsize=2)
    Ho, Wo = pool_out_hw(H, F, S), pool_out_hw(W, F, S)
    for block in _blocks(t.groups, t.bands, False):
        for _, h, cols, _ in _items(bwd.k7b_bf16_phase2_item, block, shape):
            row, xr = bwd.k7b_bf16_mask_row(block, h, *shape)
            if xr == 0:
                continue
            assert 0 <= row < xr
            lo = bwd.band_windows(block[1] * t.band, min(H, (block[1] + 1)
                                  * t.band), H, F, S)[0]
            if any(_holding(h, w, F, S, Ho, Wo) for w in cols):
                assert row == h - lo * S


def _first_max(xf, n, c, oh, ow, F, S):
    """(ty, tx) of the window's first maximal tap in row-major order, None
    for a window holding a NaN."""
    taps = [xf[n, c, oh * S + dy, ow * S + dxx]
            for dy in range(F) for dxx in range(F)]
    if any(v != v for v in taps):
        return None
    m, first = -math.inf, 0
    for t, v in enumerate(taps):
        if v > m:
            m, first = v, t
    return divmod(first, F)


def _share(op, F, gv, tap, dy, dxx):
    """The share a window adds to element (dy, dxx) of its taps."""
    if op == "avg":
        return F32(gv / F32(F * F)) if 0 <= dxx < F else F32(0.0)
    return gv if tap == (dy, dxx) else F32(0.0)


def _emulate_k7b(x, g, F, S, op, relu, pair):
    """dx of K7b bf16 over the pair kernel's map (``pair``) or the banded
    kernel's: each window's word (g, and its first maximal tap among the
    widened values; a NaN window or a slot with no window matches
    nothing, g 0 for the latter), each visited window's share added in the
    item's order in float32, the mask multiplied, rounded once."""
    N, C, H, W = x.shape
    Ho, Wo = pool_out_hw(H, F, S), pool_out_hw(W, F, S)
    xf, gf = x.float().numpy(), g.float().numpy()
    dx = torch.full(x.shape, float("nan"), dtype=torch.bfloat16)

    def word(plane, oh, ow):
        if not (0 <= oh < Ho and 0 <= ow < Wo):
            return F32(0.0), None
        n, c = divmod(plane, C)
        return F32(gf[n, c, oh, ow]), _first_max(xf, n, c, oh, ow, F, S)

    if pair:
        items = [it[2] for it in _pair_items(N, C, H, W, F, True)
                 if it[2] is not None]
        rows = [(plane, h, cols, visits)
                for plane, _, _, rs in items for h, cols, visits in rs]
    else:
        t = bwd.pool_backward_planes(N, C, H, W, F, S, itemsize=2)
        rows = [it for block in _blocks(t.groups, t.bands, True)
                for it in _items(bwd.k7b_bf16_phase2_item, block,
                                 (N, C, H, W, F, S))]
    for plane, h, cols, visits in rows:
        n, c = divmod(plane, C)
        for w in cols:
            acc = F32(0.0)
            for oh, ow in visits:
                gv, tap = word(plane, oh, ow)
                acc = F32(acc + _share(op, F, gv, tap, h - oh * S,
                                       w - ow * S))
            if relu:
                acc = F32(acc * F32(1.0 if xf[n, c, h, w] > 0 else 0.0))
            dx[n, c, h, w] = torch.tensor(acc).to(torch.bfloat16)
    return dx


@pytest.mark.parametrize("shape,op,relu", [
    ((2, 3, 17, 17, 3, 2), "max", True), ((2, 3, 16, 16, 3, 2), "max", False),
    ((1, 2, 40, 40, 3, 2), "max", True), ((2, 3, 16, 16, 2, 2), "max", True),
    ((3, 2, 15, 15, 2, 2), "max", False), ((2, 2, 11, 11, 3, 1), "max", True),
    ((2, 3, 14, 14, 2, 3), "max", True), ((2, 3, 17, 17, 3, 2), "avg", True),
    ((2, 3, 16, 16, 2, 2), "avg", False), ((4, 5, 7, 7, 7, 7), "avg", True),
    ((1, 2, 24, 24, 3, 2), "avg", True), ((1, 2, 23, 24, 3, 2), "max", True),
    ((1, 1, 8, 8, 3, 2), "max", True)], ids=str)
def test_k7b_bf16_emulated_equals_the_plain_version(shape, op, relu):
    """Both kernels' arithmetic where each runs (the pair kernel where W %
    8 == 0 at S = 2 and F = 2 or 3; the banded one everywhere, as where x
    is at an odd halfword), against the plain version."""
    N, C, H, W, F, S = shape
    rng = np.random.default_rng(N * 31 + H * 7 + F)
    # few distinct values: ties in most windows
    x = _bf16(rng.integers(-2, 3, (N, C, H, W)).astype(np.float32))
    x[0, 0, 0, 0] = float("nan")
    x[-1, -1, :3, :3] = -float("inf")
    Ho, Wo = pool_out_hw(H, F, S), pool_out_hw(W, F, S)
    g = _bf16(rng.standard_normal((N, C, Ho, Wo)).astype(np.float32))
    want = pool_backward_ref(x, g, F, S, op, "NCHW", "NCHW", relu)
    for pair in {False, bool(bwd.k7b_bf16_pairs(H, W, F, S))}:
        _check(_emulate_k7b(x, g, F, S, op, relu, pair), want, op)


def test_k7b_bf16_main_path_tiling():
    """ResNet-18's 3/2 pool backward at b32 runs the pair kernel: 14 window
    rows (28 dx rows) and the row above a block, 210 threads, four bands a
    plane.  Its banded split (x at an odd halfword) is the float32 one's,
    in 18928 bytes of bf16 shared memory against the float32 block's
    34776; the 7 x 7 average pool's runs 31 planes a block."""
    assert bwd.k7b_bf16_pairs(112, 112, 3, 2) == 14
    assert (14 + 1) * (112 // 8) == 210
    t = bwd.pool_backward_planes(32, 64, 112, 112, 3, 2, itemsize=2)
    t32 = bwd.pool_backward_planes(32, 64, 112, 112, 3, 2)
    assert (t.planes, t.band, t.bands, t.win_rows) == (
        t32.planes, t32.band, t32.bands, t32.win_rows) == (1, 56, 2, 28)
    assert (t.smem_bytes, t32.smem_bytes) == (18928, 34776)
    assert not bwd.k7b_bf16_pairs(7, 7, 7, 7)
    assert bwd.pool_backward_planes(32, 512, 7, 7, 7, 7, itemsize=2).planes \
        == 31
