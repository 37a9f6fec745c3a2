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
1e-6 scale-relative otherwise; K8 rtol 1e-5; the ``z`` output exactly the
conv output of the same kernel launch without a pool (0 under no pool
window), y and z within the conv tolerance (rtol 1e-4 / atol 1e-3) of
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
from repro_torch.kernels.conv.backward import conv_dgrad, conv_wgrad
from repro_torch.kernels.conv.ref import conv_ref, wgrad_ref
from repro_torch.kernels.pool import backward as pool_bwd
from repro_torch.kernels.pool.ref import pool_backward_ref
from repro_torch.kernels.softmax.ops import softmax_xent
from repro_torch.kernels.softmax.ref import softmax_xent_ref
from repro_torch.shapes import conv_out_hw, pool_out_hw

LAYOUT_PAIRS = list(itertools.product(("CHWN", "NCHW"), repeat=2))
# (N, Ci, H, Co, F, S, pad): strides 1/2/4, F 1/3/5/7/11, Ci=3, ragged Co,
# N=1, and one reduction long enough to need many splits
WGRAD_SHAPES = [(4, 3, 19, 70, 3, 1, 1), (2, 5, 23, 65, 5, 2, 2),
                (1, 3, 35, 33, 11, 4, 0), (3, 8, 15, 129, 1, 2, 0),
                (2, 4, 17, 64, 7, 1, 3), (8, 64, 56, 64, 3, 1, 1)]
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


@pytest.mark.parametrize("rows,cols", [(32, 1000), (128, 1000), (7, 10),
                                       (3, 1)])
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
    x[0, 0] = float("nan")
    assert torch.isnan(softmax_xent(x, labels)[0])
    with pytest.raises(ValueError, match="outside"):
        softmax_xent(x, labels + cols)


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
