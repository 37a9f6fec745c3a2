"""The training path's kernels in bf16, on the card.

Each bf16 build (``_build.VARIANTS["bf16"]``) against its plain version on
the same card inputs: the pools K3a/K3b, the pool backwards K7a/K7b (ties,
overlapping windows, NaN, g in the other layout, the ReLU mask), the
transposes K9a/K9b, the weight gradient K6 (bf16 x and g, float32 dw), the
NCHW stack K5b and the ``save_act`` output z of K1/K2; then one bf16
training step of each conv engine (an all-CHWN plan on K1 and an all-NCHW
plan on K2) against the torch engine and float64.

Every test needs a CUDA device and ``nvcc`` and skips with the reason
where either is missing.  No jax, no reference package:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_bf16_train_card.py

Tolerances, as the smoke's: max pools, max pool backwards and transposes
exactly (a bf16 max is exact, and each dx element sums its windows'
shares in float32 in the plain version's order and rounds once); avg
pools, avg backwards, K5b and z within one bf16 step of the plain
version, |got - want| <= 2^-7 |want| + 1e-5 max|want| (both sides sum in
float32 and round once); K6 within 1e-5 scale-relative of float64 (a
product of two bf16 values is exact, so only the float32 sums differ).
The training step: the loss within 8 eps(bf16) = 2^-5 of the torch
engine's at the same parameters; each parameter's step-1 gradient no
further from the float64 gradient of the same bf16 weights and input, in
the L2 norm, than twice the torch engine's bf16 gradient is, plus 2^-5 of
the float64 gradient's norm.  A bound relative to the torch engine
because bf16 itself moves a gradient far from float64: rounded
activations tie within pool windows and sit on the other side of a ReLU,
and the gradient then routes elsewhere (PERF.md §7); a kernel fault
moves it further than the torch engine's rounding does.
"""
from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.cnn.layers import init_cnn, params_from_numpy
from repro_torch.cnn.network import (init_velocity, input_shape,
                                     loss_fn_fused, make_train_step_fused,
                                     plan_network_fused, value_and_grad)
from repro_torch.configs.cnn_networks import CNN_CONFIGS
from repro_torch.core.layout import perm_between
from repro_torch.kernels import _build
from repro_torch.kernels.conv import ops as conv_ops
from repro_torch.kernels.conv.backward import conv_wgrad, dgrad_problem
from repro_torch.kernels.conv.ref import conv_ref, conv_stack_ref, wgrad_ref
from repro_torch.kernels.pool import backward as pool_bwd
from repro_torch.kernels.pool.ops import pool_chwn, pool_nchw
from repro_torch.kernels.pool.ref import pool_backward_ref, pool_ref
from repro_torch.kernels.transpose.ops import (transpose2d,
                                               transpose2d_batched)
from repro_torch.perfmodel import AnalyticCostModel, reference_hardware
from repro_torch.shapes import conv_out_hw, pool_out_hw

BF = torch.bfloat16
BF16_STEP = 2.0 ** -7
WGRAD_TOL = 1e-5
LOSS_TOL = 8 * 2.0 ** -8
GRAD_FACTOR, GRAD_SLACK = 2.0, 2.0 ** -5
OTHER = {"NCHW": "CHWN", "CHWN": "NCHW"}
POOL = {"CHWN": pool_chwn, "NCHW": pool_nchw}
POOL_BWD = {"CHWN": pool_bwd.pool_backward_chwn,
            "NCHW": pool_bwd.pool_backward_nchw}


@pytest.fixture
def card():
    reason = _build.toolchain_missing()
    if reason:
        pytest.skip(reason)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def assert_bf16_close(got, want):
    got, want = got.double(), want.double()
    nan = want.isnan()
    assert torch.equal(got.isnan(), nan)
    got, want = got[~nan], want[~nan]
    bound = BF16_STEP * want.abs() + 1e-5 * want.abs().max()
    err = (got - want).abs()
    assert bool((err <= bound).all()), float((err - bound).max())


def _randn(layout, shape_nchw, gen, dev, dtype=BF):
    x = torch.randn(*shape_nchw, generator=gen, device=dev)
    return x.permute(perm_between("NCHW", layout)).contiguous().to(dtype)


def _counted(wrapper, fn):
    before = (wrapper.launches, wrapper.variant_launches["bf16"])
    out = fn()
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.variant_launches["bf16"]) == (
        before[0] + 1, before[1] + 1)
    return out


# (N, C, H, F, S): VGG16's 2/2, AlexNet's and ResNet-18's 3/2, unet_mini's
# global window, ragged N and C
POOL_SHAPES = [(8, 64, 32, 2, 2), (33, 7, 27, 3, 2), (3, 5, 13, 3, 3),
               (8, 16, 8, 8, 8), (130, 3, 16, 2, 2)]


@pytest.mark.parametrize("layout,op", list(itertools.product(
    ("CHWN", "NCHW"), ("max", "avg"))))
def test_k3_bf16_matches_plain(layout, op, card):
    for i, (N, C, H, F, S) in enumerate(POOL_SHAPES):
        gen = torch.Generator(device=card).manual_seed(i)
        x = _randn(layout, (N, C, H, H), gen, card)
        for dst in (layout, OTHER[layout]):
            got = _counted(POOL[layout], lambda: POOL[layout](
                x, F, S, op, dst_layout=dst))
            want = pool_ref(x, F, S, op, layout, dst)
            assert got.dtype == BF and got.shape == want.shape
            if op == "max":
                torch.testing.assert_close(got, want, rtol=0, atol=0)
            else:
                assert_bf16_close(got, want)


def _tied(layout, shape, gen, dev):
    """bf16 values on a coarse grid: many windows hold equal maxima."""
    x = torch.randint(-3, 4, shape, generator=gen, device=dev).float() / 4
    return x.permute(perm_between("NCHW", layout)).contiguous().to(BF)


@pytest.mark.parametrize("layout,op", list(itertools.product(
    ("CHWN", "NCHW"), ("max", "avg"))))
def test_k7_bf16_matches_plain(layout, op, card):
    wrapper = POOL_BWD[layout]
    for i, (N, C, H, F, S) in enumerate(POOL_SHAPES):
        for ties, relu, g_layout in ((False, True, layout),
                                     (True, True, OTHER[layout]),
                                     (True, False, layout)):
            gen = torch.Generator(device=card).manual_seed(10 * i + ties)
            x = (_tied(layout, (N, C, H, H), gen, card) if ties
                 else _randn(layout, (N, C, H, H), gen, card))
            Ho = pool_out_hw(H, F, S)
            g = _randn(g_layout, (N, C, Ho, Ho), gen, card)
            got = _counted(wrapper, lambda: wrapper(
                x, g, F, S, op, g_layout=g_layout, relu_mask=relu))
            want = pool_backward_ref(x, g, F, S, op, layout, g_layout, relu)
            assert got.dtype == BF and got.shape == x.shape
            if op == "max":
                torch.testing.assert_close(got, want, rtol=0, atol=0)
            else:
                assert_bf16_close(got, want)


@pytest.mark.parametrize("layout", ["CHWN", "NCHW"])
def test_k7_bf16_nan_window_routes_nothing(layout, card):
    gen = torch.Generator(device=card).manual_seed(5)
    xn = torch.randn(2, 3, 8, 8, generator=gen, device=card)
    xn[1, 2, 2, 3] = float("nan")
    x = xn.permute(perm_between("NCHW", layout)).contiguous().to(BF)
    g = _randn(layout, (2, 3, 4, 4), gen, card)
    got = POOL_BWD[layout](x, g, 2, 2, "max")
    torch.testing.assert_close(got, pool_backward_ref(x, g, 2, 2, "max",
                                                      layout),
                               rtol=0, atol=0)
    assert not got.permute(perm_between(layout, "NCHW"))[1, 2, 2:4,
                                                        2:4].any()


@pytest.mark.parametrize("shape", [(1, 37, 45), (1, 64, 1024),
                                   (1, 3 * 224 * 224, 32), (5, 33, 70)])
def test_k9_bf16_is_exact(shape, card):
    gen = torch.Generator(device=card).manual_seed(shape[-1])
    x = torch.randn(*shape, generator=gen, device=card).to(BF)
    if shape[0] == 1:
        got = _counted(transpose2d, lambda: transpose2d(x[0]))
        assert torch.equal(got, x[0].t().contiguous())
    else:
        got = _counted(transpose2d_batched, lambda: transpose2d_batched(x))
        assert torch.equal(got, x.transpose(1, 2).contiguous())


# (N, Ci, H, Co, F, S, pad): stride 1/2/4, F 1/3/7/11, Ci 3, ragged Co,
# one split and many; the bf16 kernel's producer lanes: 16-byte runs of n
# (N 32) and of ow (W 56), halfwords at Wo 28, 14 and 7 and at stride 2,
# thin K (bn 32 at K 27, bn 64 at K 64)
WGRAD_SHAPES = [(4, 3, 19, 70, 3, 1, 1), (1, 3, 35, 33, 11, 4, 0),
                (3, 8, 15, 129, 1, 2, 0), (2, 4, 17, 64, 7, 1, 3),
                (8, 64, 56, 64, 3, 1, 1), (32, 64, 14, 128, 3, 2, 1),
                (2, 512, 4, 512, 3, 1, 1), (32, 64, 28, 64, 3, 1, 1),
                (4, 256, 14, 256, 3, 1, 1), (8, 64, 28, 128, 1, 2, 0)]


def _offset(t):
    """``t``'s values in a contiguous tensor whose data starts one element
    past an aligned allocation: no 16-byte copy can start on it."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 != 0
    return out


@pytest.mark.parametrize("x_layout,g_layout", list(itertools.product(
    ("CHWN", "NCHW"), repeat=2)))
def test_k6_bf16_matches_float64(x_layout, g_layout, card):
    for i, (N, Ci, H, Co, F, S, pad) in enumerate(WGRAD_SHAPES):
        gen = torch.Generator(device=card).manual_seed(i)
        Ho = conv_out_hw(H, F, S, pad)
        x = _randn(x_layout, (N, Ci, H, H), gen, card)
        g = _randn(g_layout, (N, Co, Ho, Ho), gen, card)
        kw = dict(x_layout=x_layout, g_layout=g_layout)
        dw = _counted(conv_wgrad, lambda: conv_wgrad(x, g, F, S, pad, **kw))
        assert dw.dtype == torch.float32
        assert torch.equal(dw, conv_wgrad(x, g, F, S, pad, **kw))
        want = wgrad_ref(x, g, F, S, pad, dtype=torch.float64, **kw)
        err = (dw.double() - want).abs().max() / max(
            1.0, want.abs().max().item())
        assert err.item() <= WGRAD_TOL, (i, err.item())
        plain = wgrad_ref(x, g, F, S, pad, **kw)
        assert plain.dtype == torch.float32


@pytest.mark.parametrize("x_layout,g_layout", list(itertools.product(
    ("CHWN", "NCHW"), repeat=2)))
def test_k6_bf16_unaligned_bases_match_float64(x_layout, g_layout, card):
    """x and g starting 2 bytes past an aligned address: every chunk goes
    element by element."""
    N, Ci, H, Co, F, S, pad = 32, 64, 14, 128, 3, 1, 1
    gen = torch.Generator(device=card).manual_seed(11)
    x = _offset(_randn(x_layout, (N, Ci, H, H), gen, card))
    g = _offset(_randn(g_layout, (N, Co, H, H), gen, card))
    kw = dict(x_layout=x_layout, g_layout=g_layout)
    dw = _counted(conv_wgrad, lambda: conv_wgrad(x, g, F, S, pad, **kw))
    assert torch.equal(dw, conv_wgrad(x, g, F, S, pad, **kw))
    want = wgrad_ref(x, g, F, S, pad, dtype=torch.float64, **kw)
    err = (dw.double() - want).abs().max() / max(1.0, want.abs().max().item())
    assert err.item() <= WGRAD_TOL, err.item()


# (N, Ci, H, Cm, Co, F1, S1, P1, F2, S2, P2, pool, res, src, dst): the
# ResNet-18 and VGG16 shapes of the training path, and edges; the bf16
# kernel's producer lanes: x box rows by 16 bytes (NCHW, W % 8 == 0) and
# by halfwords (W 55, 13, 14, 7; a CHWN source), stride 2, Ci and Cm not
# multiples of 16 (3, 7, 24; 24, 40), K1 4608 (one conv1 chain)
STACK_CASES = [
    (4, 64, 56, 64, 64, 3, 1, 1, 3, 1, 1, None, "NCHW", "NCHW", "NCHW"),
    (4, 64, 56, 128, 128, 3, 2, 1, 3, 1, 1, None, "CHWN", "NCHW", "NCHW"),
    (2, 3, 32, 64, 64, 3, 1, 1, 3, 1, 1, (2, 2, "max"), None, "NCHW",
     "CHWN"),
    (5, 7, 13, 24, 70, 3, 2, 1, 3, 1, 1, (2, 2, "avg"), "NCHW", "CHWN",
     "NCHW"),
    (4, 64, 55, 64, 64, 3, 1, 1, 3, 1, 1, None, "NCHW", "NCHW", "NCHW"),
    (4, 256, 14, 256, 256, 3, 1, 1, 3, 1, 1, None, "NCHW", "NCHW", "NCHW"),
    (2, 512, 7, 512, 512, 3, 1, 1, 3, 1, 1, None, None, "NCHW", "NCHW"),
    (3, 24, 16, 40, 48, 3, 1, 1, 3, 1, 1, (2, 2, "max"), None, "NCHW",
     "NCHW"),
    (2, 32, 32, 32, 64, 3, 1, 1, 3, 1, 1, None, "CHWN", "CHWN", "CHWN"),
]


@pytest.mark.parametrize("case", STACK_CASES)
def test_k5b_bf16_matches_plain(case, card):
    N, Ci, H, Cm, Co, F1, S1, P1, F2, S2, P2, pool, rlay, src, dst = case
    gen = torch.Generator(device=card).manual_seed(STACK_CASES.index(case))
    Ho2 = conv_out_hw(conv_out_hw(H, F1, S1, P1), F2, S2, P2)
    x = _randn(src, (N, Ci, H, H), gen, card)
    w1 = (torch.randn(Cm, Ci, F1, F1, generator=gen, device=card)
          / np.sqrt(Ci * F1 * F1)).to(BF)
    w2 = (torch.randn(Co, Cm, F2, F2, generator=gen, device=card)
          / np.sqrt(Cm * F2 * F2)).to(BF)
    b1 = (torch.randn(Cm, generator=gen, device=card) * 0.1).to(BF)
    b2 = (torch.randn(Co, generator=gen, device=card) * 0.1).to(BF)
    r = _randn(rlay, (N, Co, Ho2, Ho2), gen, card) if rlay else None
    kw = dict(bias1=b1, bias2=b2, relu1=True, relu2=True, pool=pool, res=r,
              res_layout=rlay or "NCHW", src_layout=src, dst_layout=dst)
    wrapper = conv_ops.conv_stack_nchw
    got = _counted(wrapper, lambda: wrapper(x, w1, w2, S1, P1, S2, P2,
                                            **kw))
    want = conv_stack_ref(x, w1, w2, S1, P1, S2, P2, **kw)
    assert got.dtype == BF
    assert_bf16_close(got, want)
    # a fixed summation order: repeated runs bit for bit equal
    assert torch.equal(got, wrapper(x, w1, w2, S1, P1, S2, P2, **kw))


def test_k5b_bf16_unaligned_bases_match_plain(card):
    """x, w1 and w2 starting 2 bytes past an aligned address, W % 8 == 0:
    the box rows and weight rows go by halfwords."""
    N, Ci, H, Cm, Co = 4, 64, 32, 64, 64
    gen = torch.Generator(device=card).manual_seed(9)
    x = _offset(_randn("NCHW", (N, Ci, H, H), gen, card))
    w1 = _offset((torch.randn(Cm, Ci, 3, 3, generator=gen, device=card)
                  / np.sqrt(Ci * 9)).to(BF))
    w2 = _offset((torch.randn(Co, Cm, 3, 3, generator=gen, device=card)
                  / np.sqrt(Cm * 9)).to(BF))
    kw = dict(relu1=True, relu2=True)
    wrapper = conv_ops.conv_stack_nchw
    got = _counted(wrapper, lambda: wrapper(x, w1, w2, 1, 1, 1, 1, **kw))
    assert_bf16_close(got, conv_stack_ref(x, w1, w2, 1, 1, 1, 1, **kw))
    assert torch.equal(got, wrapper(x, w1, w2, 1, 1, 1, 1, **kw))


# (engine, N, Ci, H, Co, F, S, pad, pool, relu, res, src, dst): the pooled
# convs of the bf16 training path (VGG16 conv1_2, ResNet-18 conv1) and
# edges where the pool leaves conv outputs under no window
SAVE_ACT_CASES = [
    ("CHWN", 8, 64, 32, 64, 3, 1, 1, (2, 2, "max"), True, None, "CHWN",
     "CHWN"),
    ("CHWN", 33, 3, 27, 70, 5, 2, 2, (3, 2, "max"), True, "NCHW", "NCHW",
     "NCHW"),
    ("NCHW", 4, 3, 64, 64, 7, 2, 3, (3, 2, "max"), True, None, "NCHW",
     "NCHW"),
    ("NCHW", 5, 20, 15, 33, 3, 1, 1, (2, 2, "avg"), False, "CHWN", "CHWN",
     "CHWN"),
    ("CHWN", 32, 64, 16, 64, 3, 1, 1, (2, 2, "max"), True, None, "CHWN",
     "NCHW"),
]


@pytest.mark.parametrize("case", SAVE_ACT_CASES)
def test_save_act_z_bf16_matches_plain(case, card):
    eng, N, Ci, H, Co, F, S, pad, pool, relu, rlay, src, dst = case
    gen = torch.Generator(device=card).manual_seed(SAVE_ACT_CASES.index(case))
    Ho = conv_out_hw(H, F, S, pad)
    x = _randn(src, (N, Ci, H, H), gen, card)
    w = (torch.randn(Co, Ci, F, F, generator=gen, device=card)
         / np.sqrt(Ci * F * F)).to(BF)
    r = _randn(rlay, (N, Co, Ho, Ho), gen, card) if rlay else None
    kw = dict(relu=relu, pool=pool, res=r, res_layout=rlay or eng,
              src_layout=src, dst_layout=dst)
    wk = w.permute(1, 2, 3, 0).contiguous() if eng == "CHWN" else w
    wrapper = (conv_ops.conv_direct_chwn if eng == "CHWN"
               else conv_ops.conv_im2col_nchw_fused)
    y, z = _counted(wrapper, lambda: conv_ops._conv(eng, x, wk, S, pad,
                                                    save_act=True, **kw))
    y_ref, z_ref = conv_ref(x, w, S, pad, save_act=True, act_layout=eng,
                            **kw)
    assert y.dtype == z.dtype == BF
    assert_bf16_close(y, y_ref)
    assert_bf16_close(z, z_ref)


# K1 bf16 dgrad (the stride-1 conv of the dilated gradient on the bf16
# tensor cores): (N, Ci, H, Co, F, S, pad, g layout, dx layout) of the
# forward conv: VGG16's 3x3, ResNet-18's 1x1/2 shortcut, AlexNet conv2's
# 5x5 (K = 256 x 25 = 6400: the longest flushed reduction), ragged N
DGRAD_CASES = [(8, 64, 16, 64, 3, 1, 1, "CHWN", "CHWN"),
               (8, 64, 15, 128, 1, 2, 0, "CHWN", "NCHW"),
               (8, 96, 13, 256, 5, 1, 2, "CHWN", "CHWN"),
               (13, 24, 9, 40, 3, 2, 1, "NCHW", "CHWN")]


@pytest.mark.parametrize("case", DGRAD_CASES)
def test_k1_bf16_dgrad_matches_plain(case, card):
    N, Ci, H, Co, F, S, pad, g_lay, dst = case
    gen = torch.Generator(device=card).manual_seed(DGRAD_CASES.index(case))
    Ho = conv_out_hw(H, F, S, pad)
    g = _randn(g_lay, (N, Co, Ho, Ho), gen, card)
    w = (torch.randn(Co, Ci, F, F, generator=gen, device=card)
         / np.sqrt(Ci * F * F)).to(BF)
    gd, wt, pd = dgrad_problem(g, w, (H, H), S, pad, g_lay)
    wk = wt.permute(1, 2, 3, 0).contiguous()
    got = _counted(conv_ops.conv_direct_chwn, lambda: conv_ops._conv(
        "CHWN", gd, wk, 1, pd, src_layout=g_lay, dst_layout=dst))
    assert got.dtype == BF
    assert_bf16_close(got, conv_ref(gd, wt, 1, pd, src_layout=g_lay,
                                    dst_layout=dst))


# one bf16 training step per conv engine: the H100 planner makes lenet at
# batch 64 all-CHWN (K1), the reference's profile lenet at batch 4
# all-NCHW (K2)
ENGINE_PLANS = {"CHWN": ("lenet", 64, None), "NCHW": ("lenet", 4, "ref")}


@pytest.mark.parametrize("engine", list(ENGINE_PLANS))
def test_bf16_training_step_per_engine(engine, card):
    network, batch, profile = ENGINE_PLANS[engine]
    cfg = CNN_CONFIGS[network].replace(batch=batch)
    cm = AnalyticCostModel(reference_hardware()) if profile else None
    plan = plan_network_fused(cfg, dtype="bfloat16", cost_model=cm)
    assert set(plan.conv_signature) == {engine[0]}
    params = params_from_numpy(init_cnn(cfg, 0), card, "bf16")
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal(input_shape(cfg),
                                             np.float32)).to(card, BF)
    labels = torch.from_numpy(rng.integers(0, cfg.num_classes,
                                           batch)).to(card)
    K.reset_launch_counts()
    p, v, loss = make_train_step_fused(cfg, plan)(
        params, init_velocity(params), x, labels)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    variants = K.variant_launch_counts()
    assert sum(counts.values()) == sum(variants.values()) > 0
    assert all(t.dtype == BF for q in p.values() for t in q.values())
    with torch.no_grad():
        want = loss_fn_fused(params, x, labels, cfg, plan, "torch").item()
    assert abs(loss.item() - want) <= LOSS_TOL
    grads = {}
    for run, ps, xs, impl in (
            ("cuda", params, x, "cuda"), ("torch", params, x, "torch"),
            ("f64", {l: {k: t.double() for k, t in q.items()}
                     for l, q in params.items()}, x.double(), "torch")):
        grads[run] = value_and_grad(
            lambda q, a, b, impl=impl: loss_fn_fused(q, a, b, cfg, plan,
                                                     impl),
            ps, xs, labels)[1]
    for layer, gs in grads["f64"].items():
        for k, r64 in gs.items():
            err = (grads["cuda"][layer][k].double() - r64).norm().item()
            own = (grads["torch"][layer][k].double() - r64).norm().item()
            assert err <= GRAD_FACTOR * own + GRAD_SLACK * r64.norm().item(), (
                layer, k, err, own)
