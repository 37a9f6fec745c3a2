"""The port's backward primitives against the reference's, on the CPU.

The same seeded numpy inputs go through the reference's backward (its
Pallas kernels in interpret mode, as ``tests/test_backward.py`` runs them)
and through the port (on CPU tensors every wrapper runs its kernel's plain
version; the autograd Functions around them are the ones the card runs):

* ``conv_dgrad``, ``conv_wgrad`` (K6) and ``bias_grad`` over the grid of
  ``tests/test_backward.py::CONV_GRID``, both layouts, and dgrad with the
  g / dst layout folds;
* fused-block gradients (bias, residual, ReLU, pools 2/2 and 3/2, avg,
  src/dst and residual layout folds) through ``fused_conv_block``;
* stack gradients through ``fused_conv_stack``;
* ``pool_backward`` (K7a/K7b) for windows (2,2), (3,2), (3,3), max and
  avg, both layouts, the ``g_layout`` fold and ``relu_mask``; ties route
  exactly as the reference's;
* the softmax gradient, and ``softmax_xent`` (K8);
* what the CPU can say about the card's kernels: K6's 3xTF32 arithmetic,
  emulated in torch, against float64 over a long reduction; K6's tile and
  split choice (``wgrad_tiling``) for every launch of the training path;
  K7a's row bands (``pool_backward_band``).

Tolerance: the reference's ``assert_grads_close`` form at 1e-5
(``|got - ref| <= 1e-5 * max(1, max|ref|)``); max-pool ties are exact.
"""
from __future__ import annotations

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cnn import layers as ref_layers
from repro.kernels.conv import backward as ref_bwd
from repro.kernels.pool.backward import pool_backward as ref_pool_backward
from repro.kernels.softmax import ops as ref_softmax

from repro_torch.cnn import layers as port_layers
from repro_torch.core.layout import perm_between
from repro_torch.kernels.conv.backward import (bias_grad, conv_dgrad,
                                               conv_wgrad, wgrad_tiling)
from repro_torch.kernels.pool.backward import (band_windows, pool_backward,
                                               pool_backward_band)
from repro_torch.kernels.softmax.ops import softmax, softmax_xent
from repro_torch.kernels.tf32 import rna_tf32 as _rna_tf32
from repro_torch.kernels.tf32 import trunc_tf32 as _trunc_tf32
from repro_torch.shapes import conv_out_hw, pool_out_hw
from tests.test_backward import CONV_GRID

TOL = 1e-5
OTHER = {"NCHW": "CHWN", "CHWN": "NCHW"}


def assert_grads_close(got, ref, tol: float = TOL) -> None:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = max(1.0, np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * scale)


def _to(layout: str, a_nchw: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a_nchw.transpose(perm_between("NCHW",
                                                              layout)))


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


# --------------------------------------------------------------------------
# dgrad / wgrad / bias-grad primitives
# --------------------------------------------------------------------------
@pytest.mark.parametrize("layout", ["CHWN", "NCHW"])
@pytest.mark.parametrize("Ci,H,N,F,Co,S,pad", CONV_GRID)
def test_conv_backward_primitives(Ci, H, N, F, Co, S, pad, layout):
    rng = np.random.default_rng(Ci * 100 + H * 10 + F + S)
    Ho = conv_out_hw(H, F, S, pad)
    x = _to(layout, rng.standard_normal((N, Ci, H, H), np.float32))
    w = rng.standard_normal((Co, Ci, F, F), np.float32) * np.float32(0.1)
    g = _to(layout, rng.standard_normal((N, Co, Ho, Ho), np.float32))
    ref_dx = ref_bwd.conv_dgrad(_j(g), _j(w), (H, H), S, pad, layout=layout)
    ref_dw = ref_bwd.conv_wgrad(_j(x), _j(g), F, S, pad, x_layout=layout,
                                g_layout=layout)
    dx = conv_dgrad(_t(g), _t(w), (H, H), S, pad, layout=layout)
    dw = conv_wgrad(_t(x), _t(g), F, S, pad, x_layout=layout,
                    g_layout=layout)
    assert tuple(dx.shape) == x.shape and tuple(dw.shape) == w.shape
    assert_grads_close(dx.numpy(), ref_dx)
    assert_grads_close(dw.numpy(), ref_dw)
    assert_grads_close(bias_grad(_t(g), layout).numpy(),
                       ref_bwd.bias_grad(_j(g), layout))


@pytest.mark.parametrize("layout,g_layout,dst", [
    ("CHWN", "NCHW", "NCHW"), ("NCHW", "CHWN", "CHWN"),
    ("CHWN", "CHWN", "NCHW"), ("NCHW", "NCHW", "CHWN")])
def test_dgrad_and_wgrad_layout_folds(layout, g_layout, dst):
    """dgrad reads g in the downstream layout and writes dx in the upstream
    one; wgrad takes any (x, g) layout pair."""
    Ci, H, N, F, Co, S, pad = 3, 10, 4, 3, 8, 2, 1
    rng = np.random.default_rng(7)
    Ho = conv_out_hw(H, F, S, pad)
    xn = rng.standard_normal((N, Ci, H, H), np.float32)
    w = rng.standard_normal((Co, Ci, F, F), np.float32) * np.float32(0.1)
    gn = rng.standard_normal((N, Co, Ho, Ho), np.float32)
    ref_dx = ref_bwd.conv_dgrad(_j(_to(g_layout, gn)), _j(w), (H, H), S, pad,
                                layout=layout, g_layout=g_layout,
                                dst_layout=dst)
    dx = conv_dgrad(_t(_to(g_layout, gn)), _t(w), (H, H), S, pad,
                    layout=layout, g_layout=g_layout, dst_layout=dst)
    assert_grads_close(dx.numpy(), ref_dx)
    ref_dw = ref_bwd.conv_wgrad(_j(_to(dst, xn)), _j(_to(g_layout, gn)), F,
                                S, pad, x_layout=dst, g_layout=g_layout)
    dw = conv_wgrad(_t(_to(dst, xn)), _t(_to(g_layout, gn)), F, S, pad,
                    x_layout=dst, g_layout=g_layout)
    assert_grads_close(dw.numpy(), ref_dw)


# --------------------------------------------------------------------------
# fused conv block: the whole epilogue's gradient through _ConvFn
# --------------------------------------------------------------------------
BLOCK_CASES = {  # name: (pool, S, pad, residual, src/dst/res other)
    "max3s2": ((3, 2, "max"), 1, 1, False, False),
    "avg2_s2": ((2, 2, "avg"), 2, 2, False, False),
    "res_max2_folds": ((2, 2, "max"), 1, 1, True, True),
    "res_nopool_folds": (None, 2, 1, True, True),
    "max3s2_folds": ((3, 2, "max"), 1, 0, False, True),
}


@pytest.mark.parametrize("name", sorted(BLOCK_CASES))
@pytest.mark.parametrize("layout", ["CHWN", "NCHW"])
def test_fused_block_grads(name, layout):
    pool, S, pad, want_res, folds = BLOCK_CASES[name]
    Ci, H, N, F, Co = 3, 10, 4, 3, 8
    rng = np.random.default_rng(len(name))
    Ho = conv_out_hw(H, F, S, pad)
    other = OTHER[layout] if folds else layout
    src, dst, rlay = other, other, other
    x = _to(src, rng.standard_normal((N, Ci, H, H), np.float32))
    w = rng.standard_normal((Co, Ci, F, F), np.float32) * np.float32(0.2)
    b = rng.standard_normal((Co,), np.float32) * np.float32(0.5)
    res = (_to(rlay, rng.standard_normal((N, Co, Ho, Ho), np.float32))
           if want_res else None)
    out_hw = Ho if pool is None else pool_out_hw(Ho, pool[0], pool[1])
    r = _to(dst, rng.standard_normal((N, Co, out_hw, out_hw), np.float32))
    kw = dict(relu=True, pool=pool, res_layout=rlay, src_layout=src,
              dst_layout=dst)
    names = ["x", "w", "b"] + (["res"] if want_res else [])

    def ref_loss(*args):
        d = dict(zip(names, args))
        y = ref_layers.fused_conv_block(
            d["x"], d["w"], layout, S, pad, bias=d["b"], res=d.get("res"),
            impl="pallas", **kw)
        return (y * _j(r)).sum()

    args = [x, w, b] + ([res] if want_res else [])
    ref_g = jax.grad(ref_loss, tuple(range(len(args))))(*map(_j, args))
    ts = [_t(a).requires_grad_(True) for a in args]
    d = dict(zip(names, ts))
    y = port_layers.fused_conv_block(d["x"], d["w"], layout, S, pad,
                                     bias=d["b"], res=d.get("res"),
                                     impl="cuda", **kw)
    got = torch.autograd.grad((y * _t(r)).sum(), ts)
    for a, c in zip(got, ref_g):
        assert_grads_close(a.numpy(), c)


# --------------------------------------------------------------------------
# stacks: the backward replays the pair (recompute on K1/K2)
# --------------------------------------------------------------------------
STACK_CASES = {  # name: (layout, H, Ci, Cm, Co, S1, P1, pool, residual,
    #                 src/dst/res in the other layout)
    "plain": ("CHWN", 8, 3, 5, 6, 1, 1, None, False, False),
    "pool_max_folds": ("NCHW", 9, 4, 6, 5, 1, 1, (2, 2, "max"), False,
                       True),
    "s1_2_res": ("CHWN", 11, 3, 5, 7, 2, 1, None, True, False),
    "res_pool_avg_folds": ("NCHW", 8, 3, 5, 7, 1, 1, (2, 2, "avg"), True,
                           True),
}


@pytest.mark.parametrize("name", sorted(STACK_CASES))
def test_stack_grads(name):
    layout, H, Ci, Cm, Co, S1, P1, pool, want_res, folds = STACK_CASES[name]
    rng = np.random.default_rng(len(name) + 11)
    N = 2
    Ho1 = conv_out_hw(H, 3, S1, P1)
    Ho2 = conv_out_hw(Ho1, 3, 1, 1)
    other = OTHER[layout] if folds else layout
    x = _to(other, rng.standard_normal((N, Ci, H, H), np.float32))
    w1 = rng.standard_normal((Cm, Ci, 3, 3), np.float32) * np.float32(0.2)
    w2 = rng.standard_normal((Co, Cm, 3, 3), np.float32) * np.float32(0.2)
    res = (_to(other, rng.standard_normal((N, Co, Ho2, Ho2), np.float32))
           if want_res else None)
    out_hw = Ho2 if pool is None else pool_out_hw(Ho2, pool[0], pool[1])
    r = _to(other, rng.standard_normal((N, Co, out_hw, out_hw), np.float32))
    kw = dict(relu1=True, relu2=True, pool=pool, res_layout=other,
              src_layout=other, dst_layout=other)
    args = [x, w1, w2] + ([res] if want_res else [])

    def ref_loss(x, w1, w2, res=None):
        y = ref_layers.fused_conv_stack(x, w1, w2, layout, S1, P1, 1, 1,
                                        res=res, nt=2, impl="pallas", **kw)
        return (y * _j(r)).sum()

    ref_g = jax.grad(ref_loss, tuple(range(len(args))))(*map(_j, args))
    ts = [_t(a).requires_grad_(True) for a in args]
    y = port_layers.fused_conv_stack(*ts[:3], layout, S1, P1, 1, 1,
                                     res=ts[3] if want_res else None,
                                     impl="cuda", **kw)
    got = torch.autograd.grad((y * _t(r)).sum(), ts)
    for a, c in zip(got, ref_g):
        assert_grads_close(a.numpy(), c)


# --------------------------------------------------------------------------
# pool backward (K7a / K7b)
# --------------------------------------------------------------------------
POOL_CASES = list(itertools.product(
    ("CHWN", "NCHW"), ((2, 2), (3, 2), (3, 3)), ("max", "avg")))


@pytest.mark.parametrize("layout,window,op", POOL_CASES,
                         ids=[f"{l}-{o}{f}s{s}"
                              for l, (f, s), o in POOL_CASES])
def test_pool_backward_matches_reference(layout, window, op):
    F, S = window
    rng = np.random.default_rng(F * 10 + S)
    N, C, H = 5, 4, 13
    Ho = pool_out_hw(H, F, S)
    x = _to(layout, rng.standard_normal((N, C, H, H), np.float32))
    gn = rng.standard_normal((N, C, Ho, Ho), np.float32)
    # the g_layout fold everywhere, the ReLU mask on every other case
    g_layout, relu_mask = OTHER[layout], F == 3
    g = _to(g_layout, gn)
    want = ref_pool_backward(_j(x), _j(g), F, S, op, layout=layout,
                             g_layout=g_layout, relu_mask=relu_mask)
    got = pool_backward(_t(x), _t(g), F, S, op, layout=layout,
                        g_layout=g_layout, relu_mask=relu_mask)
    assert got.shape == x.shape
    if op == "max" and F == S:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        assert_grads_close(got.numpy(), want)


@pytest.mark.parametrize("layout", ["CHWN", "NCHW"])
@pytest.mark.parametrize("window", [(2, 2), (3, 2)])
def test_max_pool_backward_ties_route_exactly(layout, window):
    """Constant and quantized inputs tie inside windows: the gradient goes
    to the FIRST maximal element, exactly as the reference routes it."""
    F, S = window
    rng = np.random.default_rng(3)
    for xn in (np.ones((2, 3, 9, 9), np.float32),
               rng.integers(-1, 2, (2, 3, 9, 9)).astype(np.float32)):
        Ho = pool_out_hw(9, F, S)
        x = _to(layout, xn)
        g = _to(layout, rng.standard_normal((2, 3, Ho, Ho), np.float32))
        want = ref_pool_backward(_j(x), _j(g), F, S, "max", layout=layout)
        got = pool_backward(_t(x), _t(g), F, S, "max", layout=layout)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pool_backward_nan_window_routes_nothing():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 2, 6, 6), np.float32)
    x[0, 1, 2, 3] = np.nan
    g = rng.standard_normal((1, 2, 3, 3), np.float32)
    want = np.asarray(ref_pool_backward(_j(x), _j(g), 2, 2, "max",
                                        layout="NCHW"))
    got = pool_backward(_t(x), _t(g), 2, 2, "max", layout="NCHW").numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[0, 1, 2:4, 2:4].any()


def test_identity_pool_backward_is_the_masked_relayout():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 4, 4), np.float32)
    g = _to("CHWN", rng.standard_normal((2, 3, 4, 4), np.float32))
    want = ref_pool_backward(_j(x), _j(g), 1, 1, "avg", layout="NCHW",
                             g_layout="CHWN", relu_mask=True)
    got = pool_backward(_t(x), _t(g), 1, 1, "avg", layout="NCHW",
                        g_layout="CHWN", relu_mask=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("layout", ["CHWN", "NCHW"])
def test_standalone_pool_gradient_matches_reference(layout):
    """``pool_chwn``/``pool_nchw`` are differentiable over K7, reading the
    gradient in their ``dst_layout``."""
    from repro.kernels.pool import ops as ref_pool_ops
    from repro_torch.kernels.pool import ops as pool_ops
    rng = np.random.default_rng(6)
    x = _to(layout, rng.standard_normal((4, 6, 13, 13), np.float32))
    r = _to(OTHER[layout], rng.standard_normal((4, 6, 6, 6), np.float32))
    ref_fn = (ref_pool_ops.pool_chwn if layout == "CHWN"
              else ref_pool_ops.pool_nchw)
    fn = pool_ops.pool_chwn if layout == "CHWN" else pool_ops.pool_nchw
    want = jax.grad(lambda a: (ref_fn(a, 3, 2, "max",
                                      dst_layout=OTHER[layout])
                               * _j(r)).sum())(_j(x))
    xt = _t(x).requires_grad_(True)
    (got,) = torch.autograd.grad(
        (fn(xt, 3, 2, "max", dst_layout=OTHER[layout]) * _t(r)).sum(), [xt])
    assert_grads_close(got.numpy(), want)


# --------------------------------------------------------------------------
# softmax gradient and cross entropy (K8)
# --------------------------------------------------------------------------
def test_softmax_gradient_matches_reference():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((32, 50), np.float32) * np.float32(3)
    r = rng.standard_normal((32, 50), np.float32)
    want = jax.grad(lambda a: (ref_softmax.softmax(a) * _j(r)).sum())(_j(x))
    xt = _t(x).requires_grad_(True)
    (got,) = torch.autograd.grad((softmax(xt) * _t(r)).sum(), [xt])
    assert_grads_close(got.numpy(), want)


@pytest.mark.parametrize("rows,cols", [(32, 1000), (5, 10), (1, 3)])
def test_softmax_xent_matches_reference(rows, cols):
    rng = np.random.default_rng(rows + cols)
    x = rng.standard_normal((rows, cols), np.float32) * np.float32(4)
    labels = rng.integers(0, cols, rows)
    want = ref_softmax.softmax_xent(_j(x), jnp.asarray(labels, jnp.int32))
    got = softmax_xent(_t(x), torch.from_numpy(labels).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("rows,cols", [(4, 10), (32, 1000), (6, 3)])
def test_softmax_xent_out_of_range_labels_match_reference(rows, cols):
    """A label outside [0, C) (here -1, C and beyond) picks no column: the
    reference's kernel (interpret mode) gives the bare logsumexp, and so
    does the port."""
    rng = np.random.default_rng(11 * rows + cols)
    x = rng.standard_normal((rows, cols), np.float32) * np.float32(4)
    labels = rng.integers(0, cols, rows)
    labels[::2] = np.array([-1, cols, cols + 7, -5])[
        np.arange(len(labels[::2])) % 4]
    want = ref_softmax.softmax_xent(_j(x), jnp.asarray(labels, jnp.int32))
    got = softmax_xent(_t(x), torch.from_numpy(labels).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    lse = torch.logsumexp(_t(x), dim=-1).numpy()
    np.testing.assert_allclose(got.numpy()[::2], lse[::2], rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("label", [-1, 0, 5])
def test_softmax_xent_nonfinite_rows_match_reference(label):
    """An all -inf row, and a row with +inf, give NaN whatever the label,
    inside [0, C) or not, as the reference's kernel (interpret mode) gives
    it: x - max is NaN there."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 5), np.float32)
    x[1, :] = -np.inf
    x[2, 3] = np.inf
    labels = np.array([label, label, label, 2])
    want = np.asarray(ref_softmax.softmax_xent(
        _j(x), jnp.asarray(labels, jnp.int32)))
    got = softmax_xent(_t(x), torch.from_numpy(labels).long()).numpy()
    assert np.isnan(want[1:3]).all() and np.isnan(got[1:3]).all()
    np.testing.assert_allclose(got[[0, 3]], want[[0, 3]], rtol=TOL, atol=TOL)


def test_softmax_xent_rejects_bad_labels():
    x = torch.zeros(3, 4)
    # a label outside [0, C) is no error: it gives the bare logsumexp, as
    # the reference's kernel does
    want = ref_softmax.softmax_xent(jnp.zeros((3, 4), jnp.float32),
                                    jnp.asarray([0, 4, 1], jnp.int32))
    np.testing.assert_allclose(
        softmax_xent(x, torch.tensor([0, 4, 1])).numpy(), np.asarray(want),
        rtol=TOL, atol=TOL)
    with pytest.raises(TypeError, match="int64"):
        softmax_xent(x, torch.tensor([0, 1, 1], dtype=torch.int32))
    with pytest.raises(ValueError, match=r"\[N\]"):
        softmax_xent(x, torch.tensor([0, 1]))


# --------------------------------------------------------------------------
# K6 on the card: its arithmetic and its tiling
# --------------------------------------------------------------------------
SMS = 132                      # H100 SXM streaming multiprocessors
SMEM_PER_BLOCK = 232448        # what one H100 block may use


def _wgrad_emulated(g: torch.Tensor, x: torch.Tensor, split: bool):
    """K6's sum dw = g @ x over P positions as the kernel forms it: each
    32-position slice's products summed in fp32 from zero, then added to an
    fp32 total in slice order.  ``split``: the 3xTF32 products
    (g_small x_big + g_big x_small + g_big x_big, big rounded to TF32 and
    small = v - big as the tensor core reads it); else one TF32 product."""
    gb, xb = _rna_tf32(g), _rna_tf32(x)
    gs, xs = _trunc_tf32(g - gb), _trunc_tf32(x - xb)
    co, P = g.shape

    def slices(a_, b_):    # [slices, Co, K], each slice's sum in fp32
        return torch.bmm(a_.reshape(co, -1, 32).transpose(0, 1),
                         b_.reshape(-1, 32, b_.shape[1]))

    part = slices(gb, xb)
    if split:
        part = (slices(gs, xb) + slices(gb, xs)) + part
    total = torch.zeros(co, x.shape[1], dtype=torch.float32)
    for s in part:
        total = total + s
    return total


def test_3xtf32_holds_the_wgrad_tolerance_and_one_pass_tf32_does_not():
    """Over 128K positions of narrow channels, the 3xTF32 split product
    summed in fp32 stays within K6's 1e-5 (scale-relative to float64);
    one TF32 product a term keeps ~11 bits and misses it."""
    rng = np.random.default_rng(17)
    P = 1 << 17
    g = torch.from_numpy(rng.standard_normal((4, P), np.float32))
    x = torch.from_numpy(rng.standard_normal((P, 8), np.float32))
    want = g.double() @ x.double()
    scale = max(1.0, want.abs().max().item())

    def err(split):
        return ((_wgrad_emulated(g, x, split).double() - want).abs().max()
                .item() / scale)

    assert err(True) <= TOL
    assert err(False) > TOL


def test_rna_tf32_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10                         # one TF32 ulp above 1
    v = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -12, one + 2.0 ** -11, 3.0],
                     dtype=torch.float32)
    want = torch.tensor([one, -one, 1.0, one + 2.0 ** -10, 3.0],
                        dtype=torch.float32)
    assert torch.equal(_rna_tf32(v), want)


def _main_path_wgrad_cases(network: str):
    from chip_smoke import TRAINED, train_launches
    (batch,) = [b for n, b in TRAINED if n == network]
    return [case for kern, case in train_launches(network, batch)
            if kern == "wgrad"]


def _check_wgrad_tiling(Co, K, P):
    t = wgrad_tiling(Co, K, P)
    assert t.bm in (64, 128) and t.bn in (32, 64, 128)
    assert t.bm == (64 if Co <= 64 else 128)
    assert t.bn == (32 if K <= 32 else 64 if K <= 64 else 128)
    assert t.tiles == -(-Co // t.bm) * -(-K // t.bn)    # tiles cover Co x K
    assert t.per % 32 == 0 and t.per > 0
    assert t.splits * t.per >= P > (t.splits - 1) * t.per  # none is empty
    assert 1 <= t.splits <= 65535
    assert t.ws_elems == (t.splits * Co * K if t.splits > 1 else 0)
    assert t.ws_elems < 2 ** 31
    return t


@pytest.mark.parametrize("network,launches", [("vgg16", 13),
                                              ("alexnet", 5),
                                              ("resnet18", 20)])
def test_wgrad_tiling_of_every_training_launch(network, launches):
    """Every K6 launch of the training path: tiles cover [Co, K], the
    splits cover the positions, the workspace stays under 2^31 elements,
    and the grid has at least one block an SM."""
    cases = _main_path_wgrad_cases(network)
    assert len(cases) == launches
    for N, Ci, H, Co, F, S, pad, _, _ in cases:
        Ho = conv_out_hw(H, F, S, pad)
        t = _check_wgrad_tiling(Co, Ci * F * F, N * Ho * Ho)
        assert t.tiles * t.splits >= SMS


@pytest.mark.parametrize("Co,K,P", [(70, 27, 4 * 19 * 19), (33, 27, 8),
                                    (384, 64, 40), (96, 363, 387200),
                                    (1, 1, 1), (512, 4608, 1568)])
def test_wgrad_tiling_edges(Co, K, P):
    t = _check_wgrad_tiling(Co, K, P)
    # fewer positions than one block an SM needs: one slice a split
    if t.tiles * -(-P // 32) < SMS:
        assert t.per == 32


# --------------------------------------------------------------------------
# K7a on the card: its row bands
# --------------------------------------------------------------------------
@pytest.mark.parametrize("H,F,S", [(55, 3, 2), (27, 3, 2), (13, 3, 2),
                                   (224, 2, 2), (15, 7, 7), (23, 3, 2),
                                   (16, 2, 2), (9, 3, 1), (11, 5, 2),
                                   (7, 7, 1), (40, 3, 3)])
def test_pool_backward_bands_cover_every_row_and_window(H, F, S):
    """The bands cover H once; the windows a band's block visits are all
    the windows of every element of the band, within ``win_rows`` of them
    (the shared memory it was given); each window row is visited once by
    each band that owns one of its rows, and by no other."""
    b = pool_backward_band(H, H, F, S)
    assert b.bands == -(-H // b.band) and b.smem_bytes <= SMEM_PER_BLOCK
    Ho = pool_out_hw(H, F, S)
    visits = [0] * Ho
    for h0 in range(0, H, b.band):
        h1 = min(H, h0 + b.band)
        lo, hi = band_windows(h0, h1, H, F, S)
        assert hi - lo + 1 <= b.win_rows
        for oh in range(max(lo, 0), hi + 1):
            visits[oh] += 1
        for h in range(h0, h1):
            for oh in range(Ho):
                if oh * S <= h < oh * S + F:
                    assert lo <= oh <= hi, (h, oh, lo, hi)
    for oh in range(Ho):
        owners = {r // b.band for r in range(oh * S, oh * S + F)}
        assert visits[oh] == len(owners)


def test_pool_backward_band_of_the_training_path():
    """AlexNet's three 3/2 pools fit the block's shared-memory aim."""
    for H in (55, 27, 13):
        b = pool_backward_band(H, H, 3, 2)
        assert b.smem_bytes <= 32 * 1024 and b.band >= 8
