"""K2's bf16 and int8 -> bf16 builds (``conv_nchw_bf16_kernel`` in
``kernels/conv/csrc/conv_nchw.cu``: the bf16 tensor cores), on the card.

One case per path of the kernel's producers and tiles: box rows by
16-byte (W % 8 == 0), 8-byte (W % 4 == 0) and 4-byte (W % 2 == 0)
``cp.async`` and by halfwords (odd W, a CHWN source, x at an odd
halfword offset); a thin input (Ci < 8, the 7x7/2 first layer) with the
16-byte and the halfword lanes; a 1x1 conv of several 16-channel groups a
stage; a 7x7 conv whose stages split its tap rows; Ci not a multiple of
16 (and K not of 8: w element by element); stride 2; the stride-1 convs
a dgrad poses (stride 1 and 2); max and avg pools; the residual in both
layouts; N and Co off multiples of 8 and 16.  Each case in both builds:

- within one bf16 step of ``conv_ref`` (2^-7 |want| + 1e-5 max|want|:
  both sides sum in float32 and round once);
- the FLOPs the kernel counts equal to ``nchw_tiling``'s;
- three runs bitwise equal;
- ``variant_launches`` stepped by one a launch.

``tests/test_torch_tensor_cores.py`` checks on the CPU that these cases
reach every lane.  Every test needs a CUDA device and ``nvcc`` and skips
with the reason where either is missing.  No jax, no reference package:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_k2_bf16_card.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core.layout import perm_between
from repro_torch.kernels import _build
from repro_torch.kernels.conv import ops as conv_ops
from repro_torch.kernels.conv.backward import dgrad_problem
from repro_torch.kernels.conv.ref import conv_ref
from repro_torch.shapes import conv_out_hw

BF16_STEP = 2.0 ** -7
XDT = {"bf16": torch.bfloat16, "i8bf16": torch.int8}

# (what, N, Ci, H, Co, F, S, pad, pool, res_layout, src, dst, dgrad): a
# dgrad case runs the stride-1 conv ``dgrad_problem`` poses for dx of the
# conv given (Ci, Co its forward's)
K2_BF16_CASES = [
    ("xv8-W16", 4, 32, 16, 64, 3, 1, 1, None, None, "NCHW", "NCHW", False),
    ("xv4-W28-Ci20-res-chwn", 3, 20, 28, 70, 3, 1, 1, None, "CHWN", "NCHW",
     "NCHW", False),
    ("xv2-W14-max-res-nchw", 5, 16, 14, 40, 3, 1, 1, (2, 2, "max"), "NCHW",
     "NCHW", "CHWN", False),
    ("xv1-W55", 2, 64, 55, 64, 3, 1, 1, None, None, "NCHW", "NCHW",
     False),
    ("xv1-W7-avg7", 8, 48, 7, 72, 3, 1, 1, (7, 7, "avg"), None, "NCHW",
     "NCHW", False),
    ("chwn-src", 16, 40, 12, 33, 3, 1, 1, None, "NCHW", "CHWN", "CHWN",
     False),
    ("thin-7x7-s2-max", 4, 3, 40, 64, 7, 2, 3, (3, 2, "max"), None, "NCHW",
     "NCHW", False),
    ("thin-odd-chwn", 3, 5, 23, 33, 5, 2, 2, None, None, "CHWN", "NCHW",
     False),
    ("1x1-s2-4groups", 8, 256, 14, 130, 1, 2, 0, None, None, "NCHW", "NCHW",
     False),
    ("7x7-split-tap-rows", 4, 16, 40, 64, 7, 1, 3, None, None, "NCHW",
     "NCHW", False),
    ("s2-W28", 4, 32, 28, 64, 3, 2, 1, None, None, "NCHW", "NCHW", False),
    ("dgrad-s1-W14", 4, 48, 14, 64, 3, 1, 1, None, None, "NCHW", "NCHW",
     True),
    ("dgrad-s2-W28", 3, 32, 28, 48, 3, 2, 1, None, None, "NCHW", "NCHW",
     True),
]


def problem(case):
    """(N, Ci, H, W, Co, F, S, pad, pool) of the conv K2 runs for a case:
    the case's, or the stride-1 conv its dgrad poses."""
    _, N, Ci, H, Co, F, S, pad, pool, _, _, _, dgrad = case
    if not dgrad:
        return N, Ci, H, H, Co, F, S, pad, pool
    Ho = conv_out_hw(H, F, S, pad)
    Hd = (Ho - 1) * S + 1 + (H + 2 * pad - F) % S
    return N, Co, Hd, Hd, Ci, F, 1, F - 1 - pad, None


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


def _inputs(case, variant, card):
    """(x, w, stride, pad, kwargs) of the conv K2 runs, on the card."""
    what, N, Ci, H, Co, F, S, pad, pool, rlay, src, dst, dgrad = case
    rng = np.random.default_rng(K2_BF16_CASES.index(case))
    xdt = XDT[variant]
    bf = torch.bfloat16

    def normal(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)
                                * np.float32(scale))

    if dgrad:
        Ho = conv_out_hw(H, F, S, pad)
        g = normal(N, Co, Ho, Ho)
        w = normal(Co, Ci, F, F, scale=1 / np.sqrt(Co * F * F))
        gd, wt, pd = dgrad_problem(g, w, (H, H), S, pad, "NCHW")
        x, w, S, pad = gd, wt, 1, pd
        Ci = x.shape[1]
    else:
        x = normal(N, Ci, H, H)
        w = normal(Co, Ci, F, F, scale=1 / np.sqrt(Ci * F * F))
    if xdt == torch.int8:   # quantized levels; the scale rides w
        x = torch.clamp(torch.round(x * 40), -127, 127)
        w = w / 40
    Cout, _, _, _ = w.shape
    Hc = conv_out_hw(x.shape[2], F, S, pad)
    b = normal(Cout, scale=0.1)
    r = normal(N, Cout, Hc, Hc) if rlay else None
    kw = dict(bias=b.to(card, bf), relu=True, pool=pool,
              res=(r.permute(perm_between("NCHW", rlay)).contiguous()
                   .to(card, bf) if rlay else None),
              res_layout=rlay or "NCHW", src_layout=src, dst_layout=dst)
    xs = x.permute(perm_between("NCHW", src)).contiguous().to(card, xdt)
    return xs, w.to(card, bf), S, pad, kw


@pytest.mark.parametrize("variant", list(XDT))
@pytest.mark.parametrize("case", K2_BF16_CASES,
                         ids=[c[0] for c in K2_BF16_CASES])
def test_k2_bf16_matches_plain_counts_its_flops_and_repeats(case, variant,
                                                            card):
    x, w, S, pad, kw = _inputs(case, variant, card)
    wrapper = conv_ops.conv_im2col_nchw_fused
    before = wrapper.variant_launches[variant]
    got = wrapper(x, w, S, pad, **kw)
    torch.cuda.synchronize()
    assert wrapper.variant_launches[variant] == before + 1
    assert got.dtype == torch.bfloat16
    assert_bf16_close(got, conv_ref(x, w, S, pad, **kw))
    N, Ci, H, W, Co, F, S_, pad_, pool = problem(case)
    t = conv_ops.nchw_tiling(N, Ci, H, W, Co, F, S_, pad_, pool)
    y, flops = conv_ops.conv_im2col_nchw_fused_counted(x, w, S, pad, **kw)
    assert flops == t.executed_flops
    assert torch.equal(y, got)
    assert torch.equal(wrapper(x, w, S, pad, **kw), got)


@pytest.mark.parametrize("W", [16, 28, 55])
def test_k2_bf16_x_at_an_odd_halfword_matches_plain(W, card):
    """x one halfword past a 4-byte boundary: no box row may copy by
    cp.async, every one goes halfword by halfword."""
    gen = torch.Generator().manual_seed(W)
    N, Ci, Co = 3, 24, 40
    base = torch.randn(N * Ci * W * W + 1, generator=gen).to(
        card, torch.bfloat16)
    x = base[1:].view(N, Ci, W, W)
    assert x.data_ptr() % 4 == 2
    w = (torch.randn(Co, Ci, 3, 3, generator=gen) / np.sqrt(Ci * 9)).to(
        card, torch.bfloat16)
    got = conv_ops.conv_im2col_nchw_fused(x, w, 1, 1, relu=True)
    assert_bf16_close(got, conv_ref(x, w, 1, 1, relu=True))
    assert torch.equal(conv_ops.conv_im2col_nchw_fused(x, w, 1, 1, relu=True),
                       got)
