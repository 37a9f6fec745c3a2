"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and ``nvcc`` and skips with the reason
where either is missing.  The module imports neither ``jax`` nor the
reference package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_kernels_card.py

(``--noconftest``: the repository's conftest imports jax.)  Tolerances:
conv and conv stack rtol 1e-4 / atol 1e-3, softmax atol 1e-6, with TF32
off for the plain conv (cuDNN's TF32 keeps about three digits).
"""
from __future__ import annotations

import itertools
import random

import numpy as np
import pytest
import torch

from repro_torch.core.layout import perm_between
from repro_torch.kernels import _build
from repro_torch.kernels.conv import ops as conv_ops
from repro_torch.kernels.conv.backward import conv_dgrad
from repro_torch.kernels.conv.ref import conv_ref, conv_stack_ref
from repro_torch.kernels.softmax.ops import softmax
from repro_torch.kernels.softmax.ref import softmax_ref

# (engine, N, Ci, H, Co, F, S, pad, pool, relu, bias, res, src, dst)
CONV_CASES = [
    ("CHWN", 32, 3, 20, 64, 3, 1, 1, None, True, False, False, "NCHW", "NCHW"),
    ("CHWN", 130, 3, 47, 20, 11, 4, 0, (3, 2, "max"), True, False, False,
     "NCHW", "CHWN"),
    ("CHWN", 3, 7, 13, 17, 5, 1, 2, (3, 2, "max"), True, True, True,
     "CHWN", "CHWN"),
    ("CHWN", 5, 4, 12, 9, 3, 2, 1, (2, 2, "avg"), False, False, True,
     "CHWN", "NCHW"),
    ("CHWN", 2, 3, 16, 8, 1, 1, 0, (4, 4, "avg"), True, True, False,
     "NCHW", "CHWN"),
    ("NCHW", 2, 3, 33, 64, 3, 1, 1, (2, 2, "max"), True, False, False,
     "NCHW", "NCHW"),
    ("NCHW", 3, 16, 15, 33, 3, 1, 1, None, True, True, True, "NCHW", "NCHW"),
    ("NCHW", 1, 5, 23, 12, 5, 2, 2, (3, 2, "max"), False, True, False,
     "CHWN", "NCHW"),
    ("NCHW", 4, 6, 30, 16, 11, 4, 2, None, True, False, True, "CHWN",
     "CHWN"),
    ("NCHW", 2, 8, 9, 24, 1, 2, 0, (2, 2, "avg"), True, False, False,
     "NCHW", "CHWN"),
    ("NCHW", 3, 2, 7, 3, 3, 1, 1, (5, 3, "max"), True, True, True, "NCHW",
     "NCHW"),
    ("NCHW", 2, 4, 9, 70, 3, 1, 1, (7, 1, "avg"), False, True, False,
     "CHWN", "NCHW"),
    ("CHWN", 40, 5, 11, 130, 3, 2, 0, (2, 1, "max"), True, True, True,
     "CHWN", "CHWN"),
]




def _seeded_grid(n_cases: int, seed: int = 0):
    """A seeded sample of engine x stride x pad x F x pool x relu x bias x
    residual x src/dst, with sizes drawn per case (ragged Co, odd N)."""
    axes = [("CHWN", "NCHW"), (1, 2, 4), (0, 1, 2), (1, 3, 5, 11),
            (None, (2, 2, "max"), (3, 2, "max"), (2, 2, "avg")),
            (False, True), (False, True), (False, True),
            tuple(itertools.product(("NCHW", "CHWN"), repeat=2))]
    rnd = random.Random(seed)
    cases = []
    for eng, S, pad, F, pool, relu, bias, res, (src, dst) in rnd.sample(
            list(itertools.product(*axes)), n_cases):
        Ho = rnd.randint(5, 9)
        H = max(1, (Ho - 1) * S + F - 2 * pad + rnd.randint(0, S - 1))
        cases.append((eng, rnd.choice([1, 3, 33, 130]), rnd.randint(1, 9),
                      H, rnd.choice([5, 64, 70, 129]), F, S, pad, pool, relu,
                      bias, res, src, dst))
    return cases


CONV_CASES += _seeded_grid(40)


@pytest.fixture
def card():
    reason = _build.toolchain_missing()
    if reason:
        pytest.skip(reason)
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case_id(c):
    eng, N, Ci, H, Co, F, S, p, pool, *_rest, src, dst = c
    ptag = "nopool" if pool is None else f"{pool[2]}{pool[0]}s{pool[1]}"
    return f"{eng}-N{N}-C{Ci}-H{H}-K{Co}-F{F}-S{S}-P{p}-{ptag}-{src}to{dst}"


@pytest.mark.parametrize("case", CONV_CASES,
                         ids=[_case_id(c) for c in CONV_CASES])
def test_conv_kernel_matches_plain(case, card):
    eng, N, Ci, H, Co, F, S, pad, pool, relu, bias, res, src, dst = case
    gen = torch.Generator().manual_seed(CONV_CASES.index(case))
    Ho = (H + 2 * pad - F) // S + 1
    x = torch.randn(N, Ci, H, H, generator=gen)
    w = torch.randn(Co, Ci, F, F, generator=gen) / np.sqrt(Ci * F * F)
    b = torch.randn(Co, generator=gen) if bias else None
    r = torch.randn(N, Co, Ho, Ho, generator=gen) if res else None
    rlay = "CHWN" if CONV_CASES.index(case) % 2 else "NCHW"

    def to(t, layout=None):
        if t is None:
            return None
        if layout is not None:
            t = t.permute(perm_between("NCHW", layout))
        return t.contiguous().to(card)

    kw = dict(bias=to(b), relu=relu, pool=pool, res=to(r, rlay),
              res_layout=rlay, src_layout=src, dst_layout=dst)
    if eng == "CHWN":
        wrapper, wk = conv_ops.conv_direct_chwn, to(w.permute(1, 2, 3, 0))
    else:
        wrapper, wk = conv_ops.conv_im2col_nchw_fused, to(w)
    before = wrapper.launches
    got = wrapper(to(x, src), wk, S, pad, **kw)
    want = conv_ref(to(x, src), to(w), S, pad, **kw)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)


def test_conv_kernel_rejects_what_it_does_not_take(card):
    x = torch.zeros(2, 3, 8, 8, device=card)
    w = torch.zeros(4, 3, 3, 3, device=card)
    with pytest.raises(TypeError, match="float32"):
        conv_ops.conv_im2col_nchw_fused(x.double(), w.double())
    with pytest.raises(ValueError, match="contiguous"):
        conv_ops.conv_im2col_nchw_fused(x.transpose(2, 3), w)
    with pytest.raises(ValueError, match="channels"):
        conv_ops.conv_im2col_nchw_fused(x, torch.zeros(4, 5, 3, 3,
                                                       device=card))
    with pytest.raises(ValueError, match="does not fit"):
        conv_ops.conv_im2col_nchw_fused(x, w, pool=(7, 2, "max"))
    # what bounds a pool window is the tile: 17 x 17 taps exceed the 256
    # conv outputs of K2's widest one
    with pytest.raises(ValueError, match="no block tile"):
        conv_ops.conv_im2col_nchw_fused(torch.zeros(1, 3, 19, 19,
                                                    device=card), w,
                                        pool=(17, 1, "max"))


# --------------------------------------------------------------------------
# K1 on the tensor cores (3xTF32) with its pooled tiles, at every main-path
# shape class and a reduced batch
# --------------------------------------------------------------------------
K1_TOL = 1e-5   # scale-relative to float64

# (N, Ci, H, Co, F, S, pad, src, dst): AlexNet's conv1, conv2 and conv5 with
# their 3/2 max pools, as the fused plans and the training forward run them
K1_ALEXNET = [(16, 3, 227, 96, 11, 4, 0, "NCHW", "CHWN"),
              (16, 96, 27, 256, 5, 1, 2, "CHWN", "CHWN"),
              (16, 384, 13, 256, 3, 1, 1, "CHWN", "NCHW")]


def _k1_inputs(N, Ci, H, Co, F, S, pad, src, card, seed, res_layout=None):
    gen = torch.Generator().manual_seed(seed)
    Ho = (H + 2 * pad - F) // S + 1
    x = torch.randn(N, Ci, H, H, generator=gen)
    w = torch.randn(Co, Ci, F, F, generator=gen) / np.sqrt(Ci * F * F)
    b = torch.randn(Co, generator=gen) * 0.1
    r = (torch.randn(N, Co, Ho, Ho, generator=gen) if res_layout else None)
    xs = x.permute(perm_between("NCHW", src)).contiguous().to(card)
    rr = (r.permute(perm_between("NCHW", res_layout)).contiguous().to(card)
          if res_layout else None)
    return xs, w.to(card), b.to(card), rr


def _k1_scaled_err(got, want64):
    return ((got.double() - want64).abs().max()
            / max(1.0, want64.abs().max().item())).item()


@pytest.mark.parametrize("case", K1_ALEXNET, ids=["conv1", "conv2", "conv5"])
def test_k1_alexnet_pooled_layers_and_save_act(case, card):
    """y and the save_act z (one writer per conv output, 0 under no window)
    against the plain version and float64."""
    N, Ci, H, Co, F, S, pad, src, dst = case
    x, w, b, _ = _k1_inputs(N, Ci, H, Co, F, S, pad, src, card, 5)
    kw = dict(bias=b, relu=True, pool=(3, 2, "max"), src_layout=src,
              dst_layout=dst)
    wk = w.permute(1, 2, 3, 0).contiguous()
    before = conv_ops.conv_direct_chwn.launches
    y, z = conv_ops._conv("CHWN", x, wk, S, pad, save_act=True, **kw)
    torch.cuda.synchronize()
    assert conv_ops.conv_direct_chwn.launches == before + 1
    y_ref, z_ref = conv_ref(x, w, S, pad, save_act=True, act_layout="CHWN",
                            **kw)
    torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(z, z_ref, rtol=1e-4, atol=1e-3)
    y64, z64 = conv_ref(x.double(), w.double(), S, pad, save_act=True,
                        act_layout="CHWN", **{**kw, "bias": b.double()})
    assert _k1_scaled_err(y, y64) <= K1_TOL
    assert _k1_scaled_err(z, z64) <= K1_TOL


@pytest.mark.parametrize("pool", [None, (3, 2, "max"), (2, 2, "max")],
                         ids=["nopool", "max3s2", "max2s2"])
def test_k1_nan_runs_through_relu_and_the_max_pool(pool, card):
    x, w, b, _ = _k1_inputs(9, 6, 15, 70, 3, 1, 1, "CHWN", card, 6)
    x[0, 4, 4, 2] = float("nan")     # x is [Ci, H, W, N]
    x[3, 10, 11, 7] = float("nan")
    kw = dict(bias=b, relu=True, pool=pool)
    got = conv_ops.conv_direct_chwn(x, w.permute(1, 2, 3, 0).contiguous(), 1,
                                    1, **kw)
    want = conv_ref(x, w, 1, 1, src_layout="CHWN", dst_layout="CHWN", **kw)
    assert torch.isnan(got).any()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3,
                               equal_nan=True)


@pytest.mark.parametrize("src,dst,rlay",
                         list(itertools.product(("NCHW", "CHWN"), repeat=3)))
@pytest.mark.parametrize("pool", [None, (3, 2, "max"), (2, 2, "avg")],
                         ids=["nopool", "max3s2", "avg2s2"])
def test_k1_every_layout_fold(src, dst, rlay, pool, card):
    x, w, b, r = _k1_inputs(12, 5, 13, 36, 3, 1, 1, src, card, 7,
                            res_layout=rlay)
    kw = dict(bias=b, relu=True, pool=pool, res=r, res_layout=rlay,
              src_layout=src, dst_layout=dst)
    got = conv_ops.conv_direct_chwn(x, w.permute(1, 2, 3, 0).contiguous(), 1,
                                    1, **kw)
    torch.testing.assert_close(got, conv_ref(x, w, 1, 1, **kw), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("N", [1, 3, 33, 130])
@pytest.mark.parametrize("Co", [5, 70, 129])
@pytest.mark.parametrize("pool", [None, (3, 2, "max")],
                         ids=["nopool", "max3s2"])
def test_k1_ragged_batch_and_channels(N, Co, pool, card):
    x, w, b, _ = _k1_inputs(N, 4, 11, Co, 3, 1, 0, "CHWN", card, N + Co)
    kw = dict(bias=b, relu=False, pool=pool)
    got = conv_ops.conv_direct_chwn(x, w.permute(1, 2, 3, 0).contiguous(), 1,
                                    0, **kw)
    want = conv_ref(x, w, 1, 0, src_layout="CHWN", dst_layout="CHWN", **kw)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("Ci,F", [(3, 3), (3, 5), (3, 11), (5, 1), (7, 7)],
                         ids=lambda v: str(v))
def test_k1_reductions_that_are_no_multiple_of_the_slice(Ci, F, card):
    """Ci*F*F = 27, 75, 363, 5, 343: the last 32-deep slice is ragged."""
    x, w, b, _ = _k1_inputs(8, Ci, 23, 64, F, 2, F // 2, "CHWN", card, F)
    got = conv_ops.conv_direct_chwn(x, w.permute(1, 2, 3, 0).contiguous(), 2,
                                    F // 2)
    want64 = conv_ref(x.double(), w.double(), 2, F // 2, src_layout="CHWN",
                      dst_layout="CHWN")
    assert _k1_scaled_err(got, want64) <= K1_TOL


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("g_layout,dst", [("CHWN", "CHWN"),
                                          ("CHWN", "NCHW")])
def test_k1_dgrad_at_every_stride(S, g_layout, dst, card):
    """dgrad on K1 (the stride-1 conv of the dilated gradient) against
    float64 and ``conv2d_input``."""
    N, Ci, H, Co, F, pad = 6, 16, 19, 40, (5 if S < 4 else 11), 2
    Ho = (H + 2 * pad - F) // S + 1
    gen = torch.Generator().manual_seed(S)
    g = torch.randn(N, Co, Ho, Ho, generator=gen)
    w = torch.randn(Co, Ci, F, F, generator=gen) / np.sqrt(Ci * F * F)
    gl = g.permute(perm_between("NCHW", g_layout)).contiguous().to(card)
    before = conv_ops.conv_direct_chwn.launches
    dx = conv_dgrad(gl, w.to(card), (H, H), S, pad, layout="CHWN",
                    g_layout=g_layout, dst_layout=dst)
    torch.cuda.synchronize()
    assert conv_ops.conv_direct_chwn.launches == before + 1
    want64 = torch.nn.grad.conv2d_input((N, Ci, H, H), w.double(),
                                        g.double(), stride=S, padding=pad)
    got = dx.permute(perm_between(dst, "NCHW")).cpu()
    assert _k1_scaled_err(got, want64) <= K1_TOL
    torch.testing.assert_close(
        got, torch.nn.grad.conv2d_input((N, Ci, H, H), w, g, stride=S,
                                        padding=pad),
        rtol=1e-4, atol=1e-3)


# --------------------------------------------------------------------------
# K2 on the tensor cores (3xTF32): the layout folds, the pools (2/2, 3/2,
# 7 x 7 avg), ragged N and Co, Ci F^2 no multiple of 8, strides 1, 2 and 4,
# every filter size of the networks, save_act and dgrad; the FLOPs the
# kernel counts held to ``nchw_tiling``
# --------------------------------------------------------------------------
# (N, Ci, H, Co, F, S, pad, pool, src, dst, res_layout or None)
K2_CASES = [
    (32, 3, 34, 64, 3, 1, 1, (2, 2, "max"), "NCHW", "NCHW", None),
    (3, 5, 40, 64, 7, 2, 3, (3, 2, "max"), "NCHW", "NCHW", None),
    (6, 3, 59, 96, 11, 4, 0, None, "NCHW", "NCHW", None),
    (5, 96, 13, 70, 5, 1, 2, None, "CHWN", "NCHW", "CHWN"),
    (4, 64, 15, 129, 3, 2, 1, None, "NCHW", "CHWN", "NCHW"),
    (3, 512, 7, 512, 3, 1, 1, (7, 7, "avg"), "NCHW", "NCHW", "NCHW"),
    (9, 40, 10, 256, 1, 2, 0, None, "NCHW", "NCHW", None),
    (2, 17, 21, 33, 3, 1, 1, (3, 2, "max"), "CHWN", "CHWN", "CHWN"),
    (1, 8, 9, 5, 3, 1, 0, (2, 2, "avg"), "NCHW", "NCHW", None),
    (130, 6, 6, 20, 3, 1, 1, (2, 2, "max"), "NCHW", "CHWN", "NCHW"),
]


def _k2_inputs(case, dev, seed):
    N, Ci, H, Co, F, S, pad, pool, src, dst, rlay = case
    x, w, b, r = _k1_inputs(N, Ci, H, Co, F, S, pad, src, dev, seed,
                            res_layout=rlay)
    kw = dict(bias=b, relu=True, pool=pool, res=r, res_layout=rlay or "NCHW",
              src_layout=src, dst_layout=dst)
    k64 = {**kw, "bias": b.double(), "res": r.double() if rlay else None}
    return x, w, kw, k64


def _k2_id(c):
    N, Ci, H, Co, F, S, pad, pool, src, dst, rlay = c
    ptag = "nopool" if pool is None else f"{pool[2]}{pool[0]}s{pool[1]}"
    return (f"N{N}-C{Ci}-H{H}-K{Co}-F{F}-S{S}-P{pad}-{ptag}-{src}to{dst}"
            f"-res{rlay}")


@pytest.mark.parametrize("case", K2_CASES, ids=[_k2_id(c) for c in K2_CASES])
def test_k2_matches_plain_float64_and_its_tiling(case, card):
    """y at the conv tolerance of the plain version and within 1e-5
    scale-relative of float64; with a pool, the save_act z too (one writer
    per conv output, 0 under no window); the FLOPs the blocks count equal
    to ``nchw_tiling``'s."""
    N, Ci, H, Co, F, S, pad, pool = case[:8]
    x, w, kw, k64 = _k2_inputs(case, card, K2_CASES.index(case))
    before = conv_ops.conv_im2col_nchw_fused.launches
    y, flops = conv_ops.conv_im2col_nchw_fused_counted(x, w, S, pad, **kw)
    torch.cuda.synchronize()
    assert conv_ops.conv_im2col_nchw_fused.launches == before + 1
    torch.testing.assert_close(y, conv_ref(x, w, S, pad, **kw), rtol=1e-4,
                               atol=1e-3)
    assert _k1_scaled_err(y, conv_ref(x.double(), w.double(), S, pad,
                                      **k64)) <= K1_TOL
    assert flops == conv_ops.nchw_tiling(N, Ci, H, H, Co, F, S, pad,
                                         pool).executed_flops
    if pool is not None:
        y2, z = conv_ops._conv("NCHW", x, w, S, pad, save_act=True, **kw)
        z_ref = conv_ref(x, w, S, pad, save_act=True, act_layout="NCHW",
                         **kw)[1]
        z64 = conv_ref(x.double(), w.double(), S, pad, save_act=True,
                       act_layout="NCHW", **k64)[1]
        assert torch.equal(y2, y)
        torch.testing.assert_close(z, z_ref, rtol=1e-4, atol=1e-3)
        assert _k1_scaled_err(z, z64) <= K1_TOL


def test_k2_3xtf32_holds_1e5_where_one_pass_tf32_does_not(card):
    """VGG16 conv4_2 at batch 2: K2 within 1e-5 scale-relative of float64,
    cuDNN's one-pass TF32 conv on the same inputs far outside it."""
    x, w, b, _ = _k1_inputs(2, 512, 28, 512, 3, 1, 1, "NCHW", card, 11)
    x = torch.relu(x) * 4.0
    want64 = conv_ref(x.double(), w.double(), 1, 1)
    got = conv_ops.conv_im2col_nchw_fused(x, w, 1, 1)
    assert _k1_scaled_err(got, want64) <= K1_TOL
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = torch.nn.functional.conv2d(x, w, padding=1)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    assert _k1_scaled_err(tf32, want64) > 10 * K1_TOL


@pytest.mark.parametrize("src,dst,rlay",
                         list(itertools.product(("NCHW", "CHWN"), repeat=3)))
@pytest.mark.parametrize("pool", [None, (3, 2, "max"), (2, 2, "avg")],
                         ids=["nopool", "max3s2", "avg2s2"])
def test_k2_every_layout_fold(src, dst, rlay, pool, card):
    x, w, b, r = _k1_inputs(12, 5, 13, 36, 3, 1, 1, src, card, 17,
                            res_layout=rlay)
    kw = dict(bias=b, relu=True, pool=pool, res=r, res_layout=rlay,
              src_layout=src, dst_layout=dst)
    got = conv_ops.conv_im2col_nchw_fused(x, w, 1, 1, **kw)
    torch.testing.assert_close(got, conv_ref(x, w, 1, 1, **kw), rtol=1e-4,
                               atol=1e-3)
    k64 = {**kw, "bias": b.double(), "res": r.double()}
    assert _k1_scaled_err(got, conv_ref(x.double(), w.double(), 1, 1,
                                        **k64)) <= K1_TOL


@pytest.mark.parametrize("N", [1, 3, 33, 130])
@pytest.mark.parametrize("Co", [5, 70, 129, 300])
@pytest.mark.parametrize("pool", [None, (3, 2, "max")],
                         ids=["nopool", "max3s2"])
def test_k2_ragged_batch_and_channels(N, Co, pool, card):
    x, w, b, _ = _k1_inputs(N, 4, 11, Co, 3, 1, 0, "NCHW", card, N + Co)
    kw = dict(bias=b, relu=False, pool=pool)
    got = conv_ops.conv_im2col_nchw_fused(x, w, 1, 0, **kw)
    torch.testing.assert_close(got, conv_ref(x, w, 1, 0, **kw), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("Ci,F", [(3, 3), (3, 5), (3, 11), (5, 1), (7, 7),
                                  (13, 3)], ids=lambda v: str(v))
def test_k2_reductions_that_are_no_multiple_of_8(Ci, F, card):
    """Ci*F*F = 27, 75, 363, 5, 343, 117: the last 8-channel group is
    ragged, and the wide filters split their tap rows over stages."""
    x, w, b, _ = _k1_inputs(8, Ci, 23, 64, F, 2, F // 2, "NCHW", card, F)
    got = conv_ops.conv_im2col_nchw_fused(x, w, 2, F // 2)
    want64 = conv_ref(x.double(), w.double(), 2, F // 2)
    assert _k1_scaled_err(got, want64) <= K1_TOL


@pytest.mark.parametrize("pool", [None, (3, 2, "max"), (2, 2, "max")],
                         ids=["nopool", "max3s2", "max2s2"])
def test_k2_nan_runs_through_relu_and_the_max_pool(pool, card):
    x, w, b, _ = _k1_inputs(9, 6, 15, 70, 3, 1, 1, "NCHW", card, 16)
    x[2, 4, 4, 2] = float("nan")     # x is [N, Ci, H, W]
    x[7, 3, 10, 11] = float("nan")
    kw = dict(bias=b, relu=True, pool=pool)
    got = conv_ops.conv_im2col_nchw_fused(x, w, 1, 1, **kw)
    want = conv_ref(x, w, 1, 1, **kw)
    assert torch.isnan(got).any()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3,
                               equal_nan=True)


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("g_layout,dst", [("NCHW", "NCHW"),
                                          ("CHWN", "NCHW"),
                                          ("NCHW", "CHWN")])
def test_k2_dgrad_at_every_stride(S, g_layout, dst, card):
    """dgrad on K2 (the stride-1 conv of the dilated gradient) against
    float64 and ``conv2d_input``."""
    N, Ci, H, Co, F, pad = 6, 16, 19, 40, (5 if S < 4 else 11), 2
    Ho = (H + 2 * pad - F) // S + 1
    gen = torch.Generator().manual_seed(10 + S)
    g = torch.randn(N, Co, Ho, Ho, generator=gen)
    w = torch.randn(Co, Ci, F, F, generator=gen) / np.sqrt(Ci * F * F)
    gl = g.permute(perm_between("NCHW", g_layout)).contiguous().to(card)
    before = conv_ops.conv_im2col_nchw_fused.launches
    dx = conv_dgrad(gl, w.to(card), (H, H), S, pad, layout="NCHW",
                    g_layout=g_layout, dst_layout=dst)
    torch.cuda.synchronize()
    assert conv_ops.conv_im2col_nchw_fused.launches == before + 1
    want64 = torch.nn.grad.conv2d_input((N, Ci, H, H), w.double(),
                                        g.double(), stride=S, padding=pad)
    got = dx.permute(perm_between(dst, "NCHW")).cpu()
    assert _k1_scaled_err(got, want64) <= K1_TOL
    torch.testing.assert_close(
        got, torch.nn.grad.conv2d_input((N, Ci, H, H), w, g, stride=S,
                                        padding=pad),
        rtol=1e-4, atol=1e-3)


# K4's variants (``softmax.cu``): narrow (4, 8, 16 or 32 lanes a row,
# cols <= 1024), wide (a block a row, cols <= 16384) and loop (wider), each
# with 16-byte access (cols % 4 == 0) and scalar access
SOFTMAX_COLS = [1, 3, 10, 31, 32, 100, 1000, 1001, 5000, 10000, 16388,
                20001]
SOFTMAX_ROWS = [1, 7, 128]


@pytest.mark.parametrize("shape", list(itertools.product(SOFTMAX_ROWS,
                                                         SOFTMAX_COLS)),
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_softmax_kernel_matches_plain(shape, card):
    x = (torch.randn(*shape, generator=torch.Generator().manual_seed(1))
         * 4).to(card)
    before = softmax.launches
    got = softmax(x)
    torch.cuda.synchronize()
    assert softmax.launches == before + 1
    torch.testing.assert_close(got, softmax_ref(x), rtol=0, atol=1e-6)


@pytest.mark.parametrize("cols", [12, 100, 1000, 5000, 20000])
def test_softmax_kernel_on_misaligned_view(cols, card):
    """A contiguous view whose base is 4 bytes past a 16-byte boundary:
    the kernel takes scalar access there (cols % 4 == 0 notwithstanding)."""
    flat = (torch.randn(3 * cols + 1, generator=torch.Generator()
                        .manual_seed(cols)) * 4).to(card)
    x = flat[1:].view(3, cols)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    got = softmax(x)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, softmax_ref(x), rtol=0, atol=1e-6)


@pytest.mark.parametrize("cols", [10, 100, 1000, 1001, 10000, 20000])
def test_softmax_kernel_nan_and_inf_rows(cols, card):
    """A NaN anywhere in a row, an all -inf row and a row with +inf come
    out NaN, as the plain version's; a partly -inf row is exact zeros
    there."""
    x = (torch.randn(5, cols, generator=torch.Generator().manual_seed(2))
         * 4).to(card)
    x[1, cols // 2] = float("nan")
    x[2] = float("-inf")
    x[3, : max(cols - 3, 1)] = float("-inf")
    x[4, cols - 1] = float("inf")
    got, want = softmax(x), softmax_ref(x)
    torch.cuda.synchronize()
    for r in (1, 2, 4):
        assert torch.isnan(want[r]).all() and torch.isnan(got[r]).all()
    torch.testing.assert_close(got[[0, 3]], want[[0, 3]], rtol=0, atol=1e-6)


def test_softmax_launch_never_syncs(card):
    x = torch.randn(32, 1000, device=card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = softmax(x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.testing.assert_close(y, softmax_ref(x), rtol=0, atol=1e-6)


# conv -> conv stacks (K5a, K5b):
# (engine, N, Ci, H, Cm, Co, F1, S1, P1, F2, S2, P2, pool, relu1, bias,
#  res_layout or None, src, dst)
STACK_CASES = [
    # every main-path stack shape, at a small batch
    ("NCHW", 2, 3, 224, 64, 64, 3, 1, 1, 3, 1, 1, (2, 2, "max"), True,
     False, None, "NCHW", "NCHW"),                     # VGG16 conv1_1->1_2
    ("NCHW", 2, 64, 112, 128, 128, 3, 1, 1, 3, 1, 1, (2, 2, "max"), True,
     False, None, "NCHW", "NCHW"),                     # VGG16 conv2_1->2_2
    ("NCHW", 2, 128, 56, 256, 256, 3, 1, 1, 3, 1, 1, None, True, False,
     None, "NCHW", "NCHW"),                            # VGG16 conv3_1->3_2
    ("CHWN", 16, 256, 13, 384, 384, 3, 1, 1, 3, 1, 1, None, True, False,
     None, "CHWN", "CHWN"),                            # AlexNet conv3->4
    ("NCHW", 2, 64, 55, 64, 64, 3, 1, 1, 3, 1, 1, None, True, False,
     "NCHW", "NCHW", "NCHW"),                          # ResNet-18 l1b1/l1b2
    ("NCHW", 2, 64, 55, 128, 128, 3, 2, 1, 3, 1, 1, None, True, False,
     "CHWN", "NCHW", "NCHW"),                          # ResNet-18 l2b1
    ("NCHW", 2, 128, 28, 128, 128, 3, 1, 1, 3, 1, 1, None, True, False,
     "NCHW", "NCHW", "NCHW"),                          # ResNet-18 l2b2
    ("NCHW", 2, 128, 28, 256, 256, 3, 2, 1, 3, 1, 1, None, True, False,
     "CHWN", "NCHW", "NCHW"),                          # ResNet-18 l3b1
    # edges: Ho = 1, ragged channel counts, residual in the other layout,
    # stride-2 conv1 on CHWN, folds, a 2-wide conv2 padding, avg pool
    ("NCHW", 3, 3, 5, 5, 7, 3, 1, 0, 3, 1, 0, None, True, True, None,
     "NCHW", "NCHW"),
    ("CHWN", 3, 3, 5, 5, 7, 3, 1, 0, 3, 1, 0, None, True, True, None,
     "CHWN", "CHWN"),
    ("CHWN", 5, 7, 11, 70, 130, 3, 1, 1, 3, 1, 1, None, True, True,
     "NCHW", "NCHW", "CHWN"),
    ("NCHW", 3, 9, 12, 65, 129, 3, 1, 1, 3, 1, 1, (2, 2, "max"), True,
     True, "CHWN", "CHWN", "NCHW"),
    ("CHWN", 9, 6, 17, 33, 40, 3, 2, 1, 3, 1, 1, None, True, False, "CHWN",
     "NCHW", "NCHW"),
    ("NCHW", 2, 4, 9, 6, 5, 5, 1, 2, 1, 1, 0, (3, 2, "max"), True, True,
     None, "NCHW", "CHWN"),
    ("NCHW", 2, 3, 10, 8, 9, 3, 1, 1, 3, 2, 2, (2, 2, "avg"), False, True,
     "NCHW", "NCHW", "NCHW"),
]


def _stack_id(c):
    eng, N, Ci, H, Cm, Co, F1, S1, P1, F2, S2, P2, pool, *_r, src, dst = c
    ptag = "nopool" if pool is None else f"{pool[2]}{pool[0]}s{pool[1]}"
    return (f"{eng}-N{N}-C{Ci}-H{H}-M{Cm}-K{Co}-F{F1}S{S1}P{P1}-"
            f"F{F2}S{S2}P{P2}-{ptag}-{src}to{dst}")


def _run_stack(case, dev, b1=None, seed=0):
    (eng, N, Ci, H, Cm, Co, F1, S1, P1, F2, S2, P2, pool, relu1, bias, rlay,
     src, dst) = case
    gen = torch.Generator().manual_seed(seed)
    Ho1 = (H + 2 * P1 - F1) // S1 + 1
    Ho2 = (Ho1 + 2 * P2 - F2) // S2 + 1
    x = torch.randn(N, Ci, H, H, generator=gen)
    w1 = torch.randn(Cm, Ci, F1, F1, generator=gen) / np.sqrt(Ci * F1 * F1)
    w2 = torch.randn(Co, Cm, F2, F2, generator=gen) / np.sqrt(Cm * F2 * F2)
    if b1 is None and bias:
        b1 = torch.randn(Cm, generator=gen)
    b2 = torch.randn(Co, generator=gen) if bias else None
    r = torch.randn(N, Co, Ho2, Ho2, generator=gen) if rlay else None

    def to(t, layout=None):
        if t is None:
            return None
        if layout is not None:
            t = t.permute(perm_between("NCHW", layout))
        return t.contiguous().to(dev)

    kw = dict(bias1=to(b1), bias2=to(b2), relu1=relu1, relu2=True,
              pool=pool, res=to(r, rlay), res_layout=rlay or eng,
              src_layout=src, dst_layout=dst)
    if eng == "CHWN":
        wrapper = conv_ops.conv_stack_chwn
        w1k, w2k = to(w1.permute(1, 2, 3, 0)), to(w2.permute(1, 2, 3, 0))
    else:
        wrapper, w1k, w2k = conv_ops.conv_stack_nchw, to(w1), to(w2)
    before = wrapper.launches
    got = wrapper(to(x, src), w1k, w2k, S1, P1, S2, P2, **kw)
    want = conv_stack_ref(to(x, src), to(w1), to(w2), S1, P1, S2, P2, **kw)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    return got, want


@pytest.mark.parametrize("case", STACK_CASES,
                         ids=[_stack_id(c) for c in STACK_CASES])
def test_stack_kernel_matches_plain(case, card):
    got, want = _run_stack(case, card, seed=STACK_CASES.index(case))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("engine", ["CHWN", "NCHW"])
def test_stack_kernel_reads_conv2_padding_as_zero(engine, card):
    """A large positive bias1 without ReLU makes conv1 nonzero everywhere,
    also on windows just outside the mid's edge: the kernel must read
    conv2's padding (2 wide here) as zero, not as conv1 evaluated there."""
    case = (engine, 4, 3, 9, 6, 5, 3, 1, 1, 5, 1, 2, None, False, False,
            None, engine, engine)
    got, want = _run_stack(case, card, b1=torch.full((6,), 10.0))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)


def test_stack_kernel_rejects_what_it_does_not_hold(card):
    x = torch.zeros(1, 3, 200, 200, device=card)
    w1 = torch.zeros(8, 3, 3, 3, device=card)
    w2 = torch.zeros(8, 8, 11, 11, device=card)
    before = conv_ops.conv_stack_nchw.launches
    with pytest.raises(ValueError, match="shared memory"):
        conv_ops.conv_stack_nchw(x, w1, w2, 1, 1, 4, 0,
                                 pool=(11, 1, "max"))
    with pytest.raises(TypeError, match="float32"):
        conv_ops.conv_stack_nchw(x[:, :, :8, :8].double(), w1.double(),
                                 torch.zeros(8, 8, 3, 3, device=card,
                                             dtype=torch.float64))
    assert conv_ops.conv_stack_nchw.launches == before


# K5b on the tensor cores (3xTF32): ragged N, Ci, Cm and Co, both residual
# layouts, max and avg pools (one overlapping), a CHWN source and a CHWN
# output, stride-2 conv1 (ResNet-18's), W % 4 != 0 (4-byte x copies), the
# 256-row tile, and a 5x5/1x1 pair (the kernel's generic-filter path).
# (N, Ci, H, Cm, Co, F1, S1, P1, F2, S2, P2, pool, relu1, bias,
#  res_layout or None, src, dst)
K5B_CASES = [
    (5, 16, 20, 40, 36, 3, 1, 1, 3, 1, 1, None, True, True, None, "NCHW",
     "NCHW"),
    (3, 32, 28, 64, 64, 3, 1, 1, 3, 1, 1, None, True, True, "NCHW", "NCHW",
     "NCHW"),
    (3, 32, 28, 64, 64, 3, 1, 1, 3, 1, 1, None, True, False, "CHWN", "NCHW",
     "NCHW"),
    (4, 8, 18, 24, 20, 3, 1, 1, 3, 1, 1, (2, 2, "avg"), True, True, None,
     "NCHW", "NCHW"),
    (4, 12, 17, 40, 70, 3, 1, 1, 3, 1, 1, (3, 2, "max"), True, True, "NCHW",
     "NCHW", "CHWN"),
    (6, 16, 15, 32, 48, 3, 1, 1, 3, 1, 1, None, True, True, None, "CHWN",
     "NCHW"),
    (4, 64, 29, 128, 128, 3, 2, 1, 3, 1, 1, None, True, False, "CHWN",
     "NCHW", "NCHW"),
    (2, 64, 27, 64, 64, 3, 1, 1, 3, 1, 1, None, True, False, "NCHW", "NCHW",
     "NCHW"),
    (2, 128, 28, 256, 256, 3, 1, 1, 3, 1, 1, None, True, True, None, "NCHW",
     "NCHW"),
    (3, 9, 13, 20, 33, 5, 1, 2, 1, 1, 0, (2, 2, "max"), False, True, None,
     "NCHW", "NCHW"),
]


def _scaled_err(got, want64):
    return ((got.double() - want64).abs().max()
            / max(1.0, want64.abs().max().item())).item()


def _k5b_case(case, dev, seed, nan_at=()):
    (N, Ci, H, Cm, Co, F1, S1, P1, F2, S2, P2, pool, relu1, bias, rlay, src,
     dst) = case
    gen = torch.Generator().manual_seed(seed)
    Ho1 = (H + 2 * P1 - F1) // S1 + 1
    Ho2 = (Ho1 + 2 * P2 - F2) // S2 + 1
    x = torch.randn(N, Ci, H, H, generator=gen)
    for idx in nan_at:
        x[idx] = float("nan")
    w1 = torch.randn(Cm, Ci, F1, F1, generator=gen) / np.sqrt(Ci * F1 * F1)
    w2 = torch.randn(Co, Cm, F2, F2, generator=gen) / np.sqrt(Cm * F2 * F2)
    b1 = torch.randn(Cm, generator=gen) if bias else None
    b2 = torch.randn(Co, generator=gen) if bias else None
    r = torch.randn(N, Co, Ho2, Ho2, generator=gen) if rlay else None

    def to(t, layout=None, dtype=torch.float32):
        if t is None:
            return None
        if layout is not None:
            t = t.permute(perm_between("NCHW", layout))
        return t.contiguous().to(dev, dtype)

    def kw(dtype=torch.float32):
        return dict(bias1=to(b1, dtype=dtype), bias2=to(b2, dtype=dtype),
                    relu1=relu1, relu2=True, pool=pool,
                    res=to(r, rlay, dtype), res_layout=rlay or "NCHW",
                    src_layout=src, dst_layout=dst)
    args = (to(x, src), to(w1), to(w2), S1, P1, S2, P2)
    want = conv_stack_ref(*args, **kw())
    want64 = conv_stack_ref(to(x, src, torch.float64),
                            to(w1, dtype=torch.float64),
                            to(w2, dtype=torch.float64), S1, P1, S2, P2,
                            **kw(torch.float64))
    tiling = conv_ops.stack_tiling("NCHW", N, Ci, H, H, Cm, F1, S1, P1, Co,
                                   F2, S2, P2, pool)
    return args, kw(), want, want64, tiling


def _k5b_id(c):
    return _stack_id(("NCHW",) + c)


@pytest.mark.parametrize(
    "case", K5B_CASES + [c[1:] for c in STACK_CASES if c[0] == "NCHW"],
    ids=[_k5b_id(c) for c in K5B_CASES]
    + ["main-" + _stack_id(c) for c in STACK_CASES if c[0] == "NCHW"])
def test_k5b_matches_plain_float64_and_its_tiling(case, card):
    """The plain version at the conv tolerance, float64 within 1e-5
    scale-relative (the 3xTF32 gate), and the FLOPs the blocks count equal
    to ``stack_tiling``'s."""
    args, kw, want, want64, tiling = _k5b_case(case, card, sum(case[:5]))
    before = conv_ops.conv_stack_nchw.launches
    got, flops = conv_ops.conv_stack_nchw_counted(*args, **kw)
    assert conv_ops.conv_stack_nchw.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
    assert _scaled_err(got, want64) <= K1_TOL
    assert flops == tiling.executed_flops
    torch.testing.assert_close(conv_ops.conv_stack_nchw(*args, **kw), got,
                               rtol=0, atol=0)


@pytest.mark.parametrize("pool", [None, (2, 2, "max"), (3, 2, "max")],
                         ids=["nopool", "max2s2", "max3s2"])
def test_k5b_nan_runs_through_relu_and_the_max_pool(pool, card):
    """NaN in x reaches every conv1 output whose window covers it, through
    ReLU (max(v, 0) keeps NaN), conv2 and the max pool (nan_max)."""
    case = (3, 16, 14, 32, 40, 3, 1, 1, 3, 1, 1, pool, True, True, None,
            "NCHW", "NCHW")
    args, kw, want, _, _ = _k5b_case(case, card, 9,
                                     nan_at=[(0, 3, 4, 5), (2, 11, 9, 1)])
    got = conv_ops.conv_stack_nchw(*args, **kw)
    assert torch.isnan(got).any()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3,
                               equal_nan=True)


# K5a's cluster kernel: the full AlexNet shape, Co that no C * bm matches,
# N < 8 (one tile of all images; N 5 takes the 4-byte copies), the pool and
# residual epilogues and the layout folds; the kernel counts the FLOPs it
# executes and the cluster it ran in, held to ``stack_tiling``.
# (N, Ci, H, Cm, Co, F1, S1, P1, F2, S2, P2, pool, relu1, bias,
#  res_layout or None, src, dst)
K5A_CASES = [
    (128, 256, 13, 384, 384, 3, 1, 1, 3, 1, 1, None, True, False, None,
     "CHWN", "CHWN"),                                  # AlexNet conv3->4
    (16, 8, 9, 20, 130, 3, 1, 1, 3, 1, 1, None, True, True, "CHWN", "CHWN",
     "CHWN"),
    (12, 6, 11, 24, 40, 3, 1, 1, 3, 1, 1, (2, 2, "max"), True, True, "NCHW",
     "CHWN", "NCHW"),
    (5, 7, 11, 70, 130, 3, 1, 1, 3, 1, 1, None, True, True, "NCHW", "NCHW",
     "CHWN"),
    (4, 16, 12, 24, 40, 3, 1, 1, 3, 1, 1, (3, 2, "max"), True, False, None,
     "CHWN", "CHWN"),
    (6, 9, 10, 12, 9, 3, 1, 1, 3, 2, 2, (2, 2, "avg"), False, True, "NCHW",
     "NCHW", "CHWN"),
    (20, 32, 14, 96, 200, 3, 2, 1, 3, 1, 1, None, True, True, "CHWN",
     "CHWN", "CHWN"),
]


def _k5a_inputs(case, dev, seed):
    (N, Ci, H, Cm, Co, F1, S1, P1, F2, S2, P2, pool, relu1, bias, rlay, src,
     dst) = case
    gen = torch.Generator().manual_seed(seed)
    Ho1 = (H + 2 * P1 - F1) // S1 + 1
    Ho2 = (Ho1 + 2 * P2 - F2) // S2 + 1
    x = torch.randn(N, Ci, H, H, generator=gen)
    w1 = torch.randn(Cm, Ci, F1, F1, generator=gen) / np.sqrt(Ci * F1 * F1)
    w2 = torch.randn(Co, Cm, F2, F2, generator=gen) / np.sqrt(Cm * F2 * F2)
    b1 = torch.randn(Cm, generator=gen) if bias else None
    b2 = torch.randn(Co, generator=gen) if bias else None
    r = torch.randn(N, Co, Ho2, Ho2, generator=gen) if rlay else None

    def to(t, layout=None):
        if t is None:
            return None
        if layout is not None:
            t = t.permute(perm_between("NCHW", layout))
        return t.contiguous().to(dev)

    kw = dict(bias1=to(b1), bias2=to(b2), relu1=relu1, relu2=True,
              pool=pool, res=to(r, rlay), res_layout=rlay or "CHWN",
              src_layout=src, dst_layout=dst)
    args = (to(x, src), to(w1.permute(1, 2, 3, 0)), to(w2.permute(1, 2, 3, 0)),
            S1, P1, S2, P2)
    want = conv_stack_ref(to(x, src), to(w1), to(w2), S1, P1, S2, P2, **kw)
    tiling = conv_ops.stack_tiling("CHWN", N, Ci, H, H, Cm, F1, S1, P1, Co,
                                   F2, S2, P2, pool)
    return args, kw, want, tiling


@pytest.mark.parametrize("case", K5A_CASES,
                         ids=[_stack_id(("CHWN",) + c) for c in K5A_CASES])
def test_k5a_cluster_kernel_matches_plain_and_its_tiling(case, card):
    args, kw, want, tiling = _k5a_inputs(case, card, K5A_CASES.index(case))
    before = conv_ops.conv_stack_chwn.launches
    got, flops, cluster = conv_ops.conv_stack_chwn_counted(*args, **kw)
    assert conv_ops.conv_stack_chwn.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
    assert cluster == tiling.cluster
    assert flops == tiling.executed_flops
    if case[0] == 128:                               # AlexNet at b128
        assert cluster > 1 and flops <= 2 * tiling.direct_flops
    # the wrapper's own launch gives the same result
    torch.testing.assert_close(conv_ops.conv_stack_chwn(*args, **kw), got,
                               rtol=0, atol=0)


@pytest.mark.parametrize("bm,cluster", [(64, 3), (64, 8), (128, 2)])
def test_k5a_blocks_with_an_empty_co_slice_meet_every_barrier(
        bm, cluster, card, monkeypatch):
    """Clusters wider than Co: the blocks past Co compute their share of
    conv1 and reach every cluster barrier (an early return would hang the
    cluster); the result is unchanged."""
    case = (12, 6, 11, 24, 40, 3, 1, 1, 3, 1, 1, (2, 2, "max"), True, True,
            "NCHW", "CHWN", "NCHW")
    args, kw, want, tiling = _k5a_inputs(case, card, 3)
    forced = conv_ops.StackTiling(bm, 8, 2, 2, 0, 0, 0, 0, cluster=cluster)
    monkeypatch.setattr(conv_ops, "stack_tiling", lambda *a, **k: forced)
    got, _, ran_in = conv_ops.conv_stack_chwn_counted(*args, **kw)
    assert ran_in == cluster and cluster * bm > 40 + bm
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)


def test_k5a_refused_cluster_launch_raises(card, monkeypatch):
    """A cluster of 16 blocks is past the portable 8: the launch is refused
    and the wrapper raises, with no result and no launch counted; the next
    launch is unaffected."""
    case = K5A_CASES[2]
    args, kw, want, tiling = _k5a_inputs(case, card, 2)
    forced = conv_ops.StackTiling(64, 8, 2, 2, 0, 0, 0, 0, cluster=16)
    before = conv_ops.conv_stack_chwn.launches
    with monkeypatch.context() as m:
        m.setattr(conv_ops, "stack_tiling", lambda *a, **k: forced)
        with pytest.raises(RuntimeError, match="CUDA launch failed"):
            conv_ops.conv_stack_chwn(*args, **kw)
    assert conv_ops.conv_stack_chwn.launches == before
    torch.testing.assert_close(conv_ops.conv_stack_chwn(*args, **kw), want,
                               rtol=1e-4, atol=1e-3)
