"""The training kernels against their plain versions, on the card: the
weight gradient K6, the pool backwards K7a/K7b, the cross entropy K8, the
``save_act`` output of K1/K2, and dgrad on K1/K2.

Every test needs a CUDA device and ``nvcc`` and skips with the reason where
either is missing.  The module imports neither ``jax`` nor the reference
package:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_backward_card.py

Tolerances: K6 against its float64 plain version at 1e-5 scale-relative
(``|got - ref| <= 1e-5 * max(1, max|ref|)``), so the error is the kernel's
own; K7 exact for max pooling where windows do not overlap and for ties,
1e-6 scale-relative otherwise (K7a's own cases: max exact everywhere,
avg 1e-6); K8 rtol 1e-5, a label outside [0, C) giving the bare
logsumexp; the ``z`` output exactly the conv output of the
same kernel launch without a pool (0 under no pool window), y and z
within the conv tolerance (rtol 1e-4 / atol 1e-3) of
``conv_ref``'s; dgrad within 1e-5 scale-relative of
``torch.nn.grad.conv2d_input`` (TF32 off).
"""
from __future__ import annotations

import itertools

import pytest
import torch

from repro_torch.cnn.layers import fused_conv_block
from repro_torch.core.layout import perm_between
from repro_torch.kernels import _build
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.conv import ops as conv_ops
from repro_torch.kernels.conv.backward import (conv_dgrad, conv_wgrad,
                                               wgrad_tiling)
from repro_torch.kernels.conv.ref import conv_ref, wgrad_ref
from repro_torch.kernels.pool import backward as pool_bwd
from repro_torch.kernels.pool.ref import pool_backward_ref
from repro_torch.kernels.softmax.ops import softmax_xent
from repro_torch.kernels.softmax.ref import softmax_xent_ref
from repro_torch.shapes import conv_out_hw, pool_out_hw

LAYOUT_PAIRS = list(itertools.product(("CHWN", "NCHW"), repeat=2))
# (N, Ci, H, Co, F, S, pad): strides 1/2/4, F 1/3/5/7/11, Ci=3, ragged Co,
# N=1, and one reduction long enough to need many splits; then the tensor-
# core design's edges: AlexNet conv1 (11x11/4, Wo 55), Co 96 and 384, the
# ragged rows Wo 55, 27, 13 and 7 and stride 2 (4-byte copies), K <= 64
# (1x1 stride 2 with Ci 64; K 27 is the first shape), one split (144 tiles
# over one 32-position slice)
WGRAD_SHAPES = [(4, 3, 19, 70, 3, 1, 1), (2, 5, 23, 65, 5, 2, 2),
                (1, 3, 35, 33, 11, 4, 0), (3, 8, 15, 129, 1, 2, 0),
                (2, 4, 17, 64, 7, 1, 3), (8, 64, 56, 64, 3, 1, 1),
                (4, 3, 227, 96, 11, 4, 0), (8, 16, 55, 96, 3, 1, 1),
                (4, 32, 27, 384, 3, 1, 1), (16, 24, 13, 40, 3, 1, 1),
                (32, 64, 14, 128, 3, 2, 1), (8, 64, 56, 128, 1, 2, 0),
                (2, 512, 4, 512, 3, 1, 1)]
POOL_CASES = list(itertools.product(("CHWN", "NCHW"), ((2, 2), (3, 2),
                                                      (3, 3), (7, 7)),
                                    ("max", "avg")))
BWD_WRAPPER = {"CHWN": pool_bwd.pool_backward_chwn,
               "NCHW": pool_bwd.pool_backward_nchw}


@pytest.fixture
def card():
    reason = _build.toolchain_missing()
    if reason:
        pytest.skip(reason)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(layout: str, shape_nchw, gen, dev) -> torch.Tensor:
    x = torch.randn(*shape_nchw, generator=gen, device=dev)
    return x.permute(perm_between("NCHW", layout)).contiguous()


def _close_scaled(got, want, tol: float) -> None:
    got, want = got.double(), want.double()
    scale = max(1.0, want.abs().max().item())
    err = (got - want).abs().max().item()
    assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("x_layout,g_layout", LAYOUT_PAIRS)
@pytest.mark.parametrize("shape", WGRAD_SHAPES,
                         ids=["x".join(map(str, s)) for s in WGRAD_SHAPES])
def test_wgrad_kernel_matches_float64(shape, x_layout, g_layout, card):
    N, Ci, H, Co, F, S, pad = shape
    gen = torch.Generator(device=card).manual_seed(sum(shape))
    Ho = conv_out_hw(H, F, S, pad)
    x = _randn(x_layout, (N, Ci, H, H), gen, card)
    g = _randn(g_layout, (N, Co, Ho, Ho), gen, card)
    before = conv_wgrad.launches
    dw = conv_wgrad(x, g, F, S, pad, x_layout=x_layout, g_layout=g_layout)
    again = conv_wgrad(x, g, F, S, pad, x_layout=x_layout,
                       g_layout=g_layout)
    torch.cuda.synchronize()
    assert conv_wgrad.launches == before + 2
    assert dw.shape == (Co, Ci, F, F) and dw.dtype == torch.float32
    assert torch.equal(dw, again)          # fixed-order split sum
    want = wgrad_ref(x, g, F, S, pad, x_layout=x_layout, g_layout=g_layout,
                     dtype=torch.float64)
    _close_scaled(dw, want, 1e-5)


def test_wgrad_shapes_take_one_split_and_many():
    """The shapes above reach both ends of K6's split-K: one split (the
    partials kernel writes dw) and many (the fixed-order sum)."""
    splits = {wgrad_tiling(Co, Ci * F * F,
                           N * conv_out_hw(H, F, S, pad) ** 2).splits
              for N, Ci, H, Co, F, S, pad in WGRAD_SHAPES}
    assert 1 in splits and max(splits) >= 100


def _pool_input(layout, N, C, H, gen, dev, ties: bool):
    if ties:  # few distinct values: many windows tie
        x = torch.randint(-2, 3, (N, C, H, H), generator=gen,
                          device=dev).float()
        return x.permute(perm_between("NCHW", layout)).contiguous()
    return _randn(layout, (N, C, H, H), gen, dev)


@pytest.mark.parametrize("layout,window,op", POOL_CASES,
                         ids=[f"{l}-{o}{f}s{s}"
                              for l, (f, s), o in POOL_CASES])
def test_pool_backward_kernel_matches_plain(layout, window, op, card):
    F, S = window
    wrapper = BWD_WRAPPER[layout]
    for i, ((N, C, H), g_layout, relu, ties) in enumerate([
            ((3, 5, 15), layout, False, False),
            ((33, 7, 16), "NCHW" if layout == "CHWN" else "CHWN", True,
             False),
            ((130, 3, 23), layout, True, True)]):
        if H < F:
            continue
        gen = torch.Generator(device=card).manual_seed(i * 97 + F * 10 + S)
        x = _pool_input(layout, N, C, H, gen, card, ties)
        Ho = pool_out_hw(H, F, S)
        g = _randn(g_layout, (N, C, Ho, Ho), gen, card)
        before = wrapper.launches
        got = wrapper(x, g, F, S, op, g_layout=g_layout, relu_mask=relu)
        want = pool_backward_ref(x, g, F, S, op, layout, g_layout, relu)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        assert got.shape == x.shape and got.is_contiguous()
        if op == "max" and (F <= S or ties):
            torch.testing.assert_close(got, want, rtol=0, atol=0)
        else:
            _close_scaled(got, want, 1e-6)


@pytest.mark.parametrize("layout", ["CHWN", "NCHW"])
def test_pool_backward_kernel_nan_window_routes_nothing(layout, card):
    gen = torch.Generator(device=card).manual_seed(5)
    xn = torch.randn(2, 3, 8, 8, generator=gen, device=card)
    xn[1, 2, 2, 3] = float("nan")
    x = xn.permute(perm_between("NCHW", layout)).contiguous()
    g = _randn(layout, (2, 3, 4, 4), gen, card)
    got = BWD_WRAPPER[layout](x, g, 2, 2, "max")
    want = pool_backward_ref(x, g, 2, 2, "max", layout)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    got_n = got.permute(perm_between(layout, "NCHW"))
    assert not got_n[1, 2, 2:4, 2:4].any()


# K7a's own cases: AlexNet's three 3/2 pools of the training path (g CHWN,
# CHWN, NCHW) at N 4 and 33 (a ragged lane chunk)
K7A_ALEXNET = [(96, 55, "CHWN"), (256, 27, "CHWN"), (256, 13, "NCHW")]


@pytest.mark.parametrize("N", [4, 33])
@pytest.mark.parametrize("C,H,g_layout", K7A_ALEXNET,
                         ids=[f"{c}x{h}-g{g}" for c, h, g in K7A_ALEXNET])
def test_k7a_alexnet_pools_match_plain(C, H, g_layout, N, card):
    gen = torch.Generator(device=card).manual_seed(C + H + N)
    x = _randn("CHWN", (N, C, H, H), gen, card)
    Ho = pool_out_hw(H, 3, 2)
    g = _randn(g_layout, (N, C, Ho, Ho), gen, card)
    for op in ("max", "avg"):
        before = pool_bwd.pool_backward_chwn.launches
        got = pool_bwd.pool_backward_chwn(x, g, 3, 2, op, g_layout=g_layout,
                                          relu_mask=True)
        want = pool_backward_ref(x, g, 3, 2, op, "CHWN", g_layout, True)
        torch.cuda.synchronize()
        assert pool_bwd.pool_backward_chwn.launches == before + 1
        if op == "max":
            torch.testing.assert_close(got, want, rtol=0, atol=0)
        else:
            _close_scaled(got, want, 1e-6)


def _special_windows(N, C, H, gen, dev):
    """NCHW input whose 3/2 windows tie (small integers), hold a NaN, are
    all -inf, or mix -inf with +inf."""
    x = torch.randint(-2, 3, (N, C, H, H), generator=gen, device=dev).float()
    x[0, 0, 0:3, 0:3] = -float("inf")            # an all -inf window
    x[0, 1, 4:7, 4:7] = -float("inf")            # -inf around one NaN
    x[0, 1, 5, 5] = float("nan")
    x[-1, 0, 2, 2] = float("inf")                 # a corner shared by 4
    x[-1, 0, 2, 4] = float("inf")                 # windows, two +inf ties
    x[1 % N, 0, 8:11, 0:3] = -float("inf")        # -inf over a band edge
    return x


@pytest.mark.parametrize("N,H", [(4, 17), (33, 23)])
@pytest.mark.parametrize("relu", [False, True])
def test_k7a_ties_nan_and_all_inf_windows_route_as_the_reference(N, H,
                                                                 relu,
                                                                 card):
    gen = torch.Generator(device=card).manual_seed(N * H)
    xn = _special_windows(N, 3, H, gen, card)
    x = xn.permute(perm_between("NCHW", "CHWN")).contiguous()
    Ho = pool_out_hw(H, 3, 2)
    for g_layout in ("CHWN", "NCHW"):
        g = _randn(g_layout, (N, 3, Ho, Ho), gen, card)
        got = pool_bwd.pool_backward_chwn(x, g, 3, 2, "max",
                                          g_layout=g_layout, relu_mask=relu)
        want = pool_backward_ref(x, g, 3, 2, "max", "CHWN", g_layout, relu)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=0, atol=0,
                                   equal_nan=True)
        gn = got.permute(perm_between("CHWN", "NCHW"))
        assert not gn[0, 1, 4:7, 4:7].any()          # the NaN window


def test_k7a_band_edge_splits_overlapping_windows(card):
    """A pool whose rows span several bands, with 3/2 windows straddling
    every band edge (the edge's window row is visited by both blocks)."""
    H = 61
    band = pool_bwd.pool_backward_band(H, H, 3, 2)
    assert band.bands > 1 and band.band % 2 == 0   # edges split a window
    gen = torch.Generator(device=card).manual_seed(7)
    x = _randn("CHWN", (40, 5, H, H), gen, card)
    Ho = pool_out_hw(H, 3, 2)
    for g_layout in ("CHWN", "NCHW"):
        g = _randn(g_layout, (40, 5, Ho, Ho), gen, card)
        got = pool_bwd.pool_backward_chwn(x, g, 3, 2, "max",
                                          g_layout=g_layout, relu_mask=True)
        want = pool_backward_ref(x, g, 3, 2, "max", "CHWN", g_layout, True)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


# K7b's own cases: VGG16's 2/2 and ResNet-18's 3/2 max pools and 7 x 7 avg
# at reduced batch, g in either layout; a plane in bands, small planes
# several to a block, W no multiple of 4 (the 4-byte path)
# (N, C, H, F, S, op)
K7B_CASES = [(2, 64, 224, 2, 2, "max"), (3, 64, 112, 3, 2, "max"),
             (5, 512, 14, 2, 2, "max"), (4, 512, 7, 7, 7, "avg"),
             (3, 6, 55, 3, 2, "max"), (2, 5, 27, 3, 2, "avg")]


@pytest.mark.parametrize("g_layout", ["NCHW", "CHWN"])
@pytest.mark.parametrize("N,C,H,F,S,op", K7B_CASES,
                         ids=[f"N{n}-C{c}-H{h}-{o}{f}s{s}"
                              for n, c, h, f, s, o in K7B_CASES])
def test_k7b_pools_match_plain(N, C, H, F, S, op, g_layout, card):
    """Max exactly, avg within 1e-6 of the plain version, with the ReLU
    mask folded in."""
    gen = torch.Generator(device=card).manual_seed(N * C + H + F)
    x = _randn("NCHW", (N, C, H, H), gen, card)
    Ho = pool_out_hw(H, F, S)
    g = _randn(g_layout, (N, C, Ho, Ho), gen, card)
    before = pool_bwd.pool_backward_nchw.launches
    got = pool_bwd.pool_backward_nchw(x, g, F, S, op, g_layout=g_layout,
                                      relu_mask=True)
    want = pool_backward_ref(x, g, F, S, op, "NCHW", g_layout, True)
    torch.cuda.synchronize()
    assert pool_bwd.pool_backward_nchw.launches == before + 1
    if op == "max":
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("N,H", [(4, 17), (33, 23)])
@pytest.mark.parametrize("relu", [False, True])
def test_k7b_ties_nan_and_all_inf_windows_route_as_the_reference(N, H,
                                                                 relu,
                                                                 card):
    gen = torch.Generator(device=card).manual_seed(N * H + 1)
    x = _special_windows(N, 3, H, gen, card)
    Ho = pool_out_hw(H, 3, 2)
    for g_layout in ("CHWN", "NCHW"):
        g = _randn(g_layout, (N, 3, Ho, Ho), gen, card)
        got = pool_bwd.pool_backward_nchw(x, g, 3, 2, "max",
                                          g_layout=g_layout, relu_mask=relu)
        want = pool_backward_ref(x, g, 3, 2, "max", "NCHW", g_layout, relu)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=0, atol=0,
                                   equal_nan=True)
        assert not got[0, 1, 4:7, 4:7].any()          # the NaN window


@pytest.mark.parametrize("W", [301, 300])
def test_k7b_band_edge_splits_overlapping_windows(W, card):
    """A plane cut into bands of an odd number of rows: 3/2 windows
    straddle the band edges (their window rows are staged by both
    blocks); W 301 loads and stores 4 bytes at a time, 300 16."""
    t = pool_bwd.pool_backward_planes(1, 2, W, W, 3, 2)
    assert t.bands > 1 and t.band % 2 == 1
    gen = torch.Generator(device=card).manual_seed(W)
    x = _pool_input("NCHW", 1, 2, W, gen, card, ties=True)
    Ho = pool_out_hw(W, 3, 2)
    for g_layout in ("CHWN", "NCHW"):
        g = _randn(g_layout, (1, 2, Ho, Ho), gen, card)
        got = pool_bwd.pool_backward_nchw(x, g, 3, 2, "max",
                                          g_layout=g_layout, relu_mask=True)
        want = pool_backward_ref(x, g, 3, 2, "max", "NCHW", g_layout, True)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("rows,cols", [(32, 1000), (128, 1000), (7, 10),
                                       (3, 1), (130, 37), (5, 1001),
                                       (9, 5000), (2, 20000)])
def test_softmax_xent_kernel_matches_plain(rows, cols, card):
    gen = torch.Generator(device=card).manual_seed(rows + cols)
    x = torch.randn(rows, cols, generator=gen, device=card) * 4
    labels = torch.randint(0, cols, (rows,), generator=gen, device=card)
    before = softmax_xent.launches
    got = softmax_xent(x, labels)
    want = softmax_xent_ref(x, labels)
    torch.cuda.synchronize()
    assert softmax_xent.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # a label outside [0, C) picks no column: the bare logsumexp
    outside = labels.clone()
    outside[::2] = torch.tensor([-1, cols, cols + 5], device=card).repeat(
        rows)[: outside[::2].numel()]
    got = softmax_xent(x, outside)
    torch.testing.assert_close(got, softmax_xent_ref(x, outside), rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(got[::2], torch.logsumexp(x, dim=-1)[::2],
                               rtol=1e-5, atol=1e-5)
    x[0, 0] = float("nan")
    assert torch.isnan(softmax_xent(x, labels)[0])
    # an all -inf row is NaN whatever its label, inside [0, C) or not
    x[1] = float("-inf")
    for label in (-1, 0, cols):
        labels[1] = label
        got = softmax_xent(x, labels)
        torch.testing.assert_close(got, softmax_xent_ref(x, labels),
                                   rtol=1e-5, atol=1e-5, equal_nan=True)
        assert torch.isnan(got[1])


def test_softmax_xent_on_misaligned_view(card):
    flat = torch.randn(4 * 1000 + 1, device=card) * 4
    x = flat[1:].view(4, 1000)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    labels = torch.tensor([3, -1, 999, 1000], device=card)
    torch.testing.assert_close(softmax_xent(x, labels),
                               softmax_xent_ref(x, labels), rtol=1e-5,
                               atol=1e-5)


def test_softmax_xent_launch_never_syncs(card):
    x = torch.randn(32, 1000, device=card)
    labels = torch.randint(-2, 1002, (32,), device=card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = softmax_xent(x, labels)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.testing.assert_close(loss, softmax_xent_ref(x, labels), rtol=1e-5,
                               atol=1e-5)


# (engine, N, Ci, H, Co, F, S, pad, pool, relu, res, src, dst)
SAVE_ACT_CASES = [
    ("CHWN", 33, 3, 19, 20, 3, 1, 1, (3, 2, "max"), True, False, "NCHW",
     "CHWN"),
    ("CHWN", 5, 6, 14, 70, 3, 1, 1, (2, 2, "max"), True, True, "CHWN",
     "NCHW"),
    ("CHWN", 8, 4, 12, 9, 5, 1, 0, (3, 3, "avg"), False, False, "CHWN",
     "CHWN"),
    ("NCHW", 2, 3, 20, 64, 3, 1, 1, (3, 2, "max"), True, True, "NCHW",
     "NCHW"),
    ("NCHW", 3, 16, 16, 33, 3, 1, 1, (2, 2, "max"), True, False, "CHWN",
     "CHWN"),
    ("NCHW", 2, 8, 7, 24, 1, 1, 0, (7, 7, "avg"), True, False, "NCHW",
     "NCHW"),
    ("NCHW", 4, 5, 13, 17, 3, 2, 1, None, True, True, "NCHW", "CHWN"),
]


@pytest.mark.parametrize("case", SAVE_ACT_CASES,
                         ids=[f"{c[0]}-{c[8]}-{c[11]}to{c[12]}"
                              for c in SAVE_ACT_CASES])
def test_save_act_output_matches_plain(case, card):
    eng, N, Ci, H, Co, F, S, pad, pool, relu, want_res, src, dst = case
    gen = torch.Generator(device=card).manual_seed(N + Ci + H)
    Ho = conv_out_hw(H, F, S, pad)
    x = _randn(src, (N, Ci, H, H), gen, card)
    w = torch.randn(Co, Ci, F, F, generator=gen, device=card) / (Ci * F * F)
    res = _randn(eng, (N, Co, Ho, Ho), gen, card) if want_res else None
    wk = w.permute(1, 2, 3, 0).contiguous() if eng == "CHWN" else w
    kw = dict(relu=relu, res=res, res_layout=eng, src_layout=src)
    wrapper = (conv_ops.conv_direct_chwn if eng == "CHWN"
               else conv_ops.conv_im2col_nchw_fused)
    before = wrapper.launches
    y, z = conv_ops._conv(eng, x, wk, S, pad, pool=pool, dst_layout=dst,
                          save_act=True, **kw)
    # the same kernel without a pool, written in the engine's layout
    z_same = conv_ops._conv(eng, x, wk, S, pad, dst_layout=eng, **kw)
    y_ref, z_ref = conv_ref(x, w, S, pad, pool=pool, dst_layout=dst,
                            save_act=True, act_layout=eng, **kw)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2
    assert z.shape == z_ref.shape
    torch.testing.assert_close(z, z_ref, rtol=1e-4, atol=1e-3)
    if pool is not None:   # outputs under no window: zero, never garbage
        pF, pS = pool[:2]
        cov = (pool_out_hw(Ho, pF, pS) - 1) * pS + pF
        zn = z.permute(perm_between(eng, "NCHW"))
        z_same_n = z_same.permute(perm_between(eng, "NCHW")).clone()
        assert not zn[:, :, cov:].any() and not zn[:, :, :, cov:].any()
        z_same_n[:, :, cov:] = 0
        z_same_n[:, :, :, cov:] = 0
        torch.testing.assert_close(zn, z_same_n, rtol=0, atol=0)
    else:
        torch.testing.assert_close(z, z_same, rtol=0, atol=0)
    torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("layout,g_layout,dst", [
    ("CHWN", "CHWN", "CHWN"), ("NCHW", "NCHW", "NCHW"),
    ("CHWN", "NCHW", "NCHW"), ("NCHW", "CHWN", "CHWN")])
@pytest.mark.parametrize("shape", [(4, 16, 14, 32, 3, 1, 1),
                                   (3, 8, 23, 16, 5, 2, 2),
                                   (2, 3, 35, 24, 11, 4, 0),
                                   (5, 32, 14, 64, 1, 2, 0)],
                         ids=lambda s: "x".join(map(str, s)))
def test_dgrad_matches_conv2d_input(shape, layout, g_layout, dst, card):
    N, Ci, H, Co, F, S, pad = shape
    gen = torch.Generator(device=card).manual_seed(N * Ci + F)
    Ho = conv_out_hw(H, F, S, pad)
    w = torch.randn(Co, Ci, F, F, generator=gen, device=card) * 0.1
    gn = torch.randn(N, Co, Ho, Ho, generator=gen, device=card)
    g = gn.permute(perm_between("NCHW", g_layout)).contiguous()
    wrapper = (conv_ops.conv_direct_chwn if layout == "CHWN"
               else conv_ops.conv_im2col_nchw_fused)
    before = wrapper.launches
    dx = conv_dgrad(g, w, (H, H), S, pad, layout=layout, g_layout=g_layout,
                    dst_layout=dst)
    want = torch.nn.grad.conv2d_input((N, Ci, H, H), w, gn, stride=S,
                                      padding=pad)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    _close_scaled(dx.permute(perm_between(dst, "NCHW")), want, 1e-5)


@pytest.mark.parametrize("layout", ["CHWN", "NCHW"])
def test_fused_block_backward_runs_the_kernels(layout, card):
    """A CUDA tensor's backward goes through K7, dgrad on K1/K2 and K6,
    once each, and agrees with plain autograd on the card."""
    gen = torch.Generator(device=card).manual_seed(11)
    N, Ci, H, Co = 8, 6, 16, 32
    x = _randn(layout, (N, Ci, H, H), gen, card).requires_grad_(True)
    w = (torch.randn(Co, Ci, 3, 3, generator=gen, device=card)
         * 0.2).requires_grad_(True)
    r = _randn(layout, (N, Co, 7, 7), gen, card)
    got = {}
    for impl in ("cuda", "torch"):
        reset_launch_counts()
        y = fused_conv_block(x, w, layout, 1, 1, relu=True,
                             pool=(3, 2, "max"), impl=impl)
        got[impl] = torch.autograd.grad((y * r).sum(), [x, w])
        torch.cuda.synchronize()
        counts = {k: v for k, v in launch_counts().items() if v}
        if impl == "cuda":
            conv = "conv_chwn" if layout == "CHWN" else "conv_nchw"
            pbwd = ("pool_backward_chwn" if layout == "CHWN"
                    else "pool_backward_nchw")
            assert counts == {conv: 2, "wgrad": 1, pbwd: 1}, counts
        else:
            assert counts == {}, counts
    for a, b in zip(got["cuda"], got["torch"]):
        _close_scaled(a, b, 1e-5)
