"""The serving path's kernels at narrow storage dtypes, on the card.

K1 and K2 in bf16 and with int8 input (float32 or bf16 weights), K5a and
K4 in bf16, each against its plain version on the same card inputs, at
edge shapes: N and Co not multiples of 8 or 16, odd widths, pools, the
residual in the other layout, src/dst folds.  Then what no kernel takes:
float16 or mixed dtypes reaching the kernels that take bf16 (K3, K5b, K6,
K7, K8, K9: their bf16 builds are held in
``tests/test_torch_bf16_train_card.py`` and
``tests/test_torch_pool_bf16_card.py``), a bf16 training step fed a
float32 input, and any (x, w) pair outside ``_build.CONV_VARIANTS`` raise
``TypeError`` naming the kernel; nothing falls back to a plain version.

Every test needs a CUDA device and ``nvcc`` and skips with the reason
where either is missing.  No jax, no reference package:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_dtype_card.py

Tolerances: a bf16 output |got - want| <= 2^-7 |want| + 1e-5 max|want|
(both sides accumulate in float32 and round once: one bf16 step); an
int8-input kernel with a float32 output the fp32 kernels' rtol 1e-4 /
atol 1e-3, with TF32 off for the plain conv.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.cnn.layers import init_cnn, params_from_numpy
from repro_torch.cnn.network import (init_velocity, make_train_step_fused,
                                     plan_network_fused)
from repro_torch.configs.cnn_networks import CNN_CONFIGS
from repro_torch.core.layout import perm_between
from repro_torch.kernels import _build
from repro_torch.kernels.conv import ops as conv_ops
from repro_torch.kernels.conv.backward import conv_wgrad
from repro_torch.kernels.conv.ref import conv_ref, conv_stack_ref
from repro_torch.kernels.pool.backward import (pool_backward_chwn,
                                               pool_backward_nchw)
from repro_torch.kernels.pool.ops import pool_chwn, pool_nchw
from repro_torch.kernels.softmax.ops import softmax, softmax_xent
from repro_torch.kernels.softmax.ref import softmax_ref
from repro_torch.kernels.transpose.ops import transpose2d

BF16_STEP = 2.0 ** -7
CONV_RTOL, CONV_ATOL = 1e-4, 1e-3
OTHER = {"NCHW": "CHWN", "CHWN": "NCHW"}
XW = {"bf16": (torch.bfloat16, torch.bfloat16),
      "i8f32": (torch.int8, torch.float32),
      "i8bf16": (torch.int8, torch.bfloat16)}


@pytest.fixture
def card():
    reason = _build.toolchain_missing()
    if reason:
        pytest.skip(reason)
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def assert_bf16_close(got, want):
    got, want = got.double(), want.double()
    bound = BF16_STEP * want.abs() + 1e-5 * want.abs().max()
    err = (got - want).abs()
    assert bool((err <= bound).all()), float((err - bound).max())


def _on(t, card, layout=None, dtype=None):
    if t is None:
        return None
    if layout is not None:
        t = t.permute(perm_between("NCHW", layout))
    return t.contiguous().to(card, dtype)


# (engine, N, Ci, H, Co, F, S, pad, pool, relu, bias, res, src, dst)
CONV_CASES = [
    ("CHWN", 33, 3, 27, 70, 11, 4, 0, (3, 2, "max"), True, True, False,
     "NCHW", "CHWN"),
    ("CHWN", 13, 19, 13, 17, 3, 1, 1, None, True, True, True, "CHWN",
     "NCHW"),
    ("CHWN", 130, 6, 9, 129, 5, 1, 2, (3, 2, "max"), False, False, True,
     "CHWN", "CHWN"),
    ("CHWN", 7, 8, 16, 64, 1, 1, 0, (2, 2, "avg"), True, False, False,
     "NCHW", "NCHW"),
    ("NCHW", 3, 3, 33, 64, 3, 1, 1, (2, 2, "max"), True, True, False,
     "NCHW", "NCHW"),
    ("NCHW", 5, 20, 15, 33, 3, 1, 1, None, True, True, True, "NCHW",
     "CHWN"),
    ("NCHW", 2, 9, 23, 12, 5, 2, 2, (3, 2, "max"), False, True, False,
     "CHWN", "NCHW"),
    ("NCHW", 9, 24, 7, 70, 1, 1, 0, None, True, False, True, "CHWN",
     "CHWN"),
    ("NCHW", 1, 5, 29, 130, 3, 2, 1, (2, 2, "avg"), True, True, True,
     "NCHW", "NCHW"),
]


def _case_id(c):
    eng, N, Ci, H, Co, F, S, p, pool, *_rest, src, dst = c
    ptag = "nopool" if pool is None else f"{pool[2]}{pool[0]}s{pool[1]}"
    return f"{eng}-N{N}-C{Ci}-H{H}-K{Co}-F{F}-S{S}-P{p}-{ptag}-{src}to{dst}"


@pytest.mark.parametrize("variant", list(XW))
@pytest.mark.parametrize("case", CONV_CASES,
                         ids=[_case_id(c) for c in CONV_CASES])
def test_conv_variant_matches_plain(case, variant, card):
    eng, N, Ci, H, Co, F, S, pad, pool, relu, bias, res, src, dst = case
    xdt, wdt = XW[variant]
    gen = torch.Generator().manual_seed(CONV_CASES.index(case))
    Ho = (H + 2 * pad - F) // S + 1
    if xdt == torch.int8:
        x = torch.randint(-127, 128, (N, Ci, H, H), generator=gen).float()
        scale = 1.0 / 127
    else:
        x, scale = torch.randn(N, Ci, H, H, generator=gen), 1.0
    w = torch.randn(Co, Ci, F, F, generator=gen) * scale / np.sqrt(
        Ci * F * F)
    b = torch.randn(Co, generator=gen) if bias else None
    r = torch.randn(N, Co, Ho, Ho, generator=gen) if res else None
    rlay = OTHER[eng] if CONV_CASES.index(case) % 2 else eng
    kw = dict(bias=_on(b, card, dtype=wdt), relu=relu, pool=pool,
              res=_on(r, card, rlay, wdt), res_layout=rlay, src_layout=src,
              dst_layout=dst)
    xs, wc = _on(x, card, src, xdt), _on(w, card, dtype=wdt)
    if eng == "CHWN":
        wrapper, wk = conv_ops.conv_direct_chwn, _on(wc.permute(1, 2, 3, 0),
                                                     card)
    else:
        wrapper, wk = conv_ops.conv_im2col_nchw_fused, wc
    before = (wrapper.launches, wrapper.variant_launches[variant])
    got = wrapper(xs, wk, S, pad, **kw)
    want = conv_ref(xs, wc, S, pad, **kw)
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.variant_launches[variant]) == (
        before[0] + 1, before[1] + 1)
    assert got.dtype == wdt == want.dtype
    if wdt == torch.float32:
        torch.testing.assert_close(got, want, rtol=CONV_RTOL, atol=CONV_ATOL)
    else:
        assert_bf16_close(got, want)


# (N, Ci, H, Cm, Co, F1, S1, P1, F2, S2, P2, pool, res, src, dst)
STACK_CASES = [
    (32, 3, 32, 64, 64, 3, 1, 1, 3, 1, 1, (2, 2, "max"), False, "NCHW",
     "CHWN"),
    (12, 20, 11, 33, 17, 3, 1, 1, 3, 1, 1, None, True, "CHWN", "NCHW"),
    (8, 64, 14, 64, 64, 3, 1, 1, 3, 1, 1, None, True, "CHWN", "CHWN"),
    (5, 7, 13, 24, 70, 3, 2, 1, 3, 1, 1, (2, 2, "avg"), True, "NCHW",
     "NCHW"),
]


@pytest.mark.parametrize("case", STACK_CASES)
def test_k5a_bf16_matches_plain_mid_float32(case, card):
    N, Ci, H, Cm, Co, F1, S1, P1, F2, S2, P2, pool, res, src, dst = case
    gen = torch.Generator().manual_seed(100 + STACK_CASES.index(case))
    Ho1 = (H + 2 * P1 - F1) // S1 + 1
    Ho2 = (Ho1 + 2 * P2 - F2) // S2 + 1
    bf = torch.bfloat16
    x = _on(torch.randn(N, Ci, H, H, generator=gen), card, src, bf)
    w1 = _on(torch.randn(Cm, Ci, F1, F1, generator=gen)
             / np.sqrt(Ci * F1 * F1), card, dtype=bf)
    w2 = _on(torch.randn(Co, Cm, F2, F2, generator=gen)
             / np.sqrt(Cm * F2 * F2), card, dtype=bf)
    b1 = _on(torch.randn(Cm, generator=gen) * 0.1, card, dtype=bf)
    b2 = _on(torch.randn(Co, generator=gen) * 0.1, card, dtype=bf)
    rlay = OTHER["CHWN"] if res and STACK_CASES.index(case) % 2 else "CHWN"
    r = (_on(torch.randn(N, Co, Ho2, Ho2, generator=gen), card, rlay, bf)
         if res else None)
    kw = dict(bias1=b1, bias2=b2, relu1=True, relu2=True, pool=pool, res=r,
              res_layout=rlay, src_layout=src, dst_layout=dst)
    before = conv_ops.conv_stack_chwn.variant_launches["bf16"]
    got = conv_ops.conv_stack_chwn(
        x, w1.permute(1, 2, 3, 0).contiguous(),
        w2.permute(1, 2, 3, 0).contiguous(), S1, P1, S2, P2, **kw)
    want = conv_stack_ref(x, w1, w2, S1, P1, S2, P2, **kw)
    torch.cuda.synchronize()
    assert conv_ops.conv_stack_chwn.variant_launches["bf16"] == before + 1
    assert got.dtype == bf
    assert_bf16_close(got, want)


# K1's narrow builds (bf16 and int8->bf16: the bf16 tensor cores), one
# case per producer lane: (what, N, Ci, H, Co, F, S, pad, pool, src, dst)
K1_LANE_CASES = [
    ("N8-runs", 8, 16, 12, 64, 3, 1, 1, None, "CHWN", "CHWN"),
    ("N32-runs-pool", 32, 24, 10, 96, 3, 1, 1, (2, 2, "max"), "CHWN",
     "CHWN"),
    ("N128-runs", 128, 8, 7, 128, 3, 1, 1, None, "CHWN", "NCHW"),
    ("N13-ragged", 13, 16, 9, 40, 3, 1, 1, None, "CHWN", "CHWN"),
    ("N130-ragged-pool", 130, 5, 6, 24, 3, 1, 1, (3, 2, "max"), "CHWN",
     "CHWN"),
    ("F11-S4-nchw-src-pool", 8, 3, 35, 96, 11, 4, 0, (3, 2, "max"), "NCHW",
     "CHWN"),
    ("1x1-S2", 16, 32, 15, 72, 1, 2, 0, None, "CHWN", "NCHW"),
    ("Co100", 8, 40, 9, 100, 3, 1, 1, None, "CHWN", "CHWN"),
    ("K5184-flush", 8, 576, 6, 64, 3, 1, 1, None, "CHWN", "CHWN"),
    ("K6400-flush", 8, 256, 8, 72, 5, 1, 2, None, "CHWN", "CHWN"),
]


@pytest.mark.parametrize("variant", ["bf16", "i8bf16"])
@pytest.mark.parametrize("case", K1_LANE_CASES,
                         ids=[c[0] for c in K1_LANE_CASES])
def test_k1_narrow_lanes_match_plain_and_repeat_bitwise(case, variant, card):
    _, N, Ci, H, Co, F, S, pad, pool, src, dst = case
    xdt, wdt = XW[variant]
    gen = torch.Generator().manual_seed(200 + K1_LANE_CASES.index(case))
    if xdt == torch.int8:
        x = torch.randint(-127, 128, (N, Ci, H, H), generator=gen).float()
        scale = 1.0 / 127
    else:
        x, scale = torch.randn(N, Ci, H, H, generator=gen), 1.0
    w = torch.randn(Co, Ci, F, F, generator=gen) * scale / np.sqrt(
        Ci * F * F)
    b = torch.randn(Co, generator=gen)
    kw = dict(bias=_on(b, card, dtype=wdt), relu=True, pool=pool,
              src_layout=src, dst_layout=dst)
    xs, wc = _on(x, card, src, xdt), _on(w, card, dtype=wdt)
    wk = wc.permute(1, 2, 3, 0).contiguous()
    wrapper = conv_ops.conv_direct_chwn
    before = wrapper.variant_launches[variant]
    got = wrapper(xs, wk, S, pad, **kw)
    torch.cuda.synchronize()
    assert wrapper.variant_launches[variant] == before + 1
    assert_bf16_close(got, conv_ref(xs, wc, S, pad, **kw))
    for _ in range(2):
        assert torch.equal(wrapper(xs, wk, S, pad, **kw), got)


# K5a bf16: VGG16's conv1 pair (Ci 3) at reduced maps from either source,
# Cm and Co off multiples of 16 (and of 8: element copies), clusters of 1,
# 2, 3, 4 and 6 blocks
# (N, Ci, H, Cm, Co, F1, S1, P1, F2, S2, P2, pool, src)
K5A_BF16_CASES = [
    (32, 3, 24, 64, 64, 3, 1, 1, 3, 1, 1, (2, 2, "max"), "CHWN"),
    (16, 3, 40, 64, 64, 3, 1, 1, 3, 1, 1, (2, 2, "max"), "NCHW"),
    (8, 16, 12, 36, 44, 3, 1, 1, 3, 1, 1, None, "CHWN"),
    (16, 24, 10, 64, 200, 3, 1, 1, 3, 1, 1, None, "CHWN"),
    (32, 32, 13, 96, 384, 3, 1, 1, 3, 1, 1, None, "CHWN"),
    (24, 40, 9, 72, 130, 3, 1, 1, 3, 1, 1, (3, 2, "max"), "CHWN"),
    (128, 64, 13, 64, 256, 3, 1, 1, 3, 1, 1, None, "CHWN"),
]


def _k5a_tiling(case):
    N, Ci, H, Cm, Co, F1, S1, P1, F2, S2, P2, pool, _ = case
    return conv_ops.stack_tiling("CHWN", N, Ci, H, H, Cm, F1, S1, P1, Co,
                                 F2, S2, P2, pool)


def test_k5a_bf16_cases_span_cluster_sizes():
    assert {_k5a_tiling(c).cluster for c in K5A_BF16_CASES} == {
        1, 2, 3, 4, 6}


@pytest.mark.parametrize("case", K5A_BF16_CASES)
def test_k5a_bf16_counts_its_flops_and_repeats_bitwise(case, card):
    N, Ci, H, Cm, Co, F1, S1, P1, F2, S2, P2, pool, src = case
    gen = torch.Generator().manual_seed(300 + K5A_BF16_CASES.index(case))
    bf = torch.bfloat16
    x = _on(torch.randn(N, Ci, H, H, generator=gen), card, src, bf)
    w1 = _on(torch.randn(Cm, Ci, F1, F1, generator=gen)
             / np.sqrt(Ci * F1 * F1), card, dtype=bf)
    w2 = _on(torch.randn(Co, Cm, F2, F2, generator=gen)
             / np.sqrt(Cm * F2 * F2), card, dtype=bf)
    b1 = _on(torch.randn(Cm, generator=gen) * 0.1, card, dtype=bf)
    b2 = _on(torch.randn(Co, generator=gen) * 0.1, card, dtype=bf)
    kw = dict(bias1=b1, bias2=b2, relu1=True, relu2=True, pool=pool,
              src_layout=src, dst_layout="CHWN")
    w1k = w1.permute(1, 2, 3, 0).contiguous()
    w2k = w2.permute(1, 2, 3, 0).contiguous()
    t = _k5a_tiling(case)
    got, flops, cluster = conv_ops.conv_stack_chwn_counted(
        x, w1k, w2k, S1, P1, S2, P2, **kw)
    assert (flops, cluster) == (t.executed_flops, t.cluster)
    assert got.dtype == bf
    assert_bf16_close(got, conv_stack_ref(x, w1, w2, S1, P1, S2, P2, **kw))
    for _ in range(2):
        assert torch.equal(
            conv_ops.conv_stack_chwn(x, w1k, w2k, S1, P1, S2, P2, **kw), got)


@pytest.mark.parametrize("rows,cols,offset", [
    (7, 10, 0), (32, 1000, 0), (5, 1001, 0), (3, 3, 0), (4, 5000, 0),
    (2, 20001, 0), (2, 20000, 0), (300, 1000, 0), (5, 1000, 1)])
def test_k4_bf16_matches_plain(rows, cols, offset, card):
    gen = torch.Generator().manual_seed(cols)
    base = (torch.randn(rows * cols + offset, generator=gen) * 4).to(
        card, torch.bfloat16)
    x = base[offset:].view(rows, cols)
    x[0, 0] = float("nan")
    before = softmax.variant_launches["bf16"]
    got = softmax(x)
    want = softmax_ref(x)
    torch.cuda.synchronize()
    assert softmax.variant_launches["bf16"] == before + 1
    assert got.dtype == torch.bfloat16
    assert bool(got[0].isnan().all())
    assert_bf16_close(got[1:], want[1:])


def test_kernels_without_bf16_raise(card):
    bf, hf = torch.bfloat16, torch.float16
    # the kernels that take bf16 (K8 too) take neither float16 nor mixed
    # dtypes
    with pytest.raises(TypeError, match="softmax_xent"):
        softmax_xent(torch.randn(4, 10, device=card, dtype=hf),
                     torch.zeros(4, dtype=torch.int64, device=card))
    x = torch.randn(4, 8, 8, 3, device=card, dtype=hf)    # CHWN
    xn = torch.randn(3, 4, 8, 8, device=card, dtype=hf)   # NCHW
    with pytest.raises(TypeError, match="pool_chwn"):
        pool_chwn(x, 2, 2)
    with pytest.raises(TypeError, match="pool_nchw"):
        pool_nchw(xn, 2, 2)
    with pytest.raises(TypeError, match="conv_stack_nchw"):
        conv_ops.conv_stack_nchw(xn.to(bf), torch.randn(5, 4, 3, 3,
                                                        device=card),
                                 torch.randn(6, 5, 3, 3, device=card,
                                             dtype=bf), 1, 1, 1, 1)
    with pytest.raises(TypeError, match="conv_wgrad"):
        conv_wgrad(xn.to(bf), torch.randn(3, 6, 6, 6, device=card), 3,
                   x_layout="NCHW", g_layout="NCHW")
    g = torch.randn(4, 4, 4, 3, device=card)
    with pytest.raises(TypeError, match="pool_backward_chwn"):
        pool_backward_chwn(x.to(bf), g, 2, 2)
    with pytest.raises(TypeError, match="pool_backward_nchw"):
        pool_backward_nchw(xn, torch.randn(3, 4, 4, 4, device=card,
                                           dtype=hf), 2, 2)
    with pytest.raises(TypeError, match="transpose2d"):
        transpose2d(torch.randn(8, 8, device=card, dtype=hf))


def test_conv_kernels_refuse_other_pairs(card):
    x = torch.zeros(2, 3, 8, 8, device=card)
    w = torch.zeros(4, 3, 3, 3, device=card)
    q = x.to(torch.int8)
    for wrapper in (conv_ops.conv_im2col_nchw_fused,):
        with pytest.raises(TypeError, match="conv_im2col_nchw_fused"):
            wrapper(x, w.to(torch.bfloat16))            # f32 x, bf16 w
        with pytest.raises(TypeError, match="conv_im2col_nchw_fused"):
            wrapper(x.to(torch.bfloat16), w)             # bf16 x, f32 w
        with pytest.raises(TypeError, match="conv_im2col_nchw_fused"):
            wrapper(q, w.to(torch.int8))                 # int8 w
        with pytest.raises(TypeError, match="conv_im2col_nchw_fused"):
            wrapper(x.half(), w.half())                  # float16
        with pytest.raises(TypeError, match="bias"):
            wrapper(q, w, bias=torch.zeros(4, device=card,
                                           dtype=torch.bfloat16))
    # the stacks take int8 x, but w2 must be w1's dtype
    with pytest.raises(TypeError, match="conv_stack_chwn"):
        conv_ops.conv_stack_chwn(
            torch.zeros(3, 8, 8, 2, device=card, dtype=torch.int8),
            torch.zeros(3, 3, 3, 4, device=card),
            torch.zeros(4, 3, 3, 5, device=card, dtype=torch.bfloat16),
            1, 1, 1, 1)
    with pytest.raises(TypeError, match="softmax"):
        softmax(torch.zeros(2, 10, device=card, dtype=torch.float16))


def test_bf16_training_raises(card):
    """A bf16 training step takes a bf16 input (its plan's dtype); fed a
    float32 one, the first conv refuses the (float32 x, bf16 w) pair
    rather than fall back (bf16 steps run: test_torch_bf16_train_card.py)."""
    cfg = CNN_CONFIGS["lenet"].replace(batch=4)
    plan = plan_network_fused(cfg, dtype="bf16")
    params = params_from_numpy(init_cnn(cfg, 0), card, "bf16")
    x = torch.randn(4, cfg.in_channels, cfg.image_hw, cfg.image_hw,
                    device=card)
    labels = torch.zeros(4, dtype=torch.int64, device=card)
    step = make_train_step_fused(cfg, plan)
    with pytest.raises(TypeError,
                       match="conv_direct_chwn|conv_im2col_nchw_fused|"
                             "conv_wgrad|pool_backward"):
        step(params, init_velocity(params), x, labels)
