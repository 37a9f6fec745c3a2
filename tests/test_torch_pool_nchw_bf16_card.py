"""The bf16 builds of K3b (``pool_nchw_bf16_kernel`` in
``kernels/pool/csrc/pool.cu``) and K7b (``pool_backward_nchw_bf16`` in
``pool_backward.cu``), on the card.

- Every K3b bf16 launch of ``chip_smoke.py`` (unet_mini b8's first pool in
  NCHW, off every path, and the float32 K3b row's eight shapes cast to
  bf16: AlexNet b128's 3/2 and VGG16 b32's 2/2 pools) and every K7b bf16
  launch (ResNet-18 b32's 3/2 max and 7/7 average pool backwards, and the
  float32 K7b row's VGG16 2/2 shapes) against the plain version: max
  pools and pool backwards exactly, avg ones within one bf16 step (2^-7
  |want| + 1e-5 max|want|); K3b in both output layouts, K7b with g in
  both layouts and the ReLU mask on and off;
- bf16 ties (few distinct values), NaN and all -inf windows; W not a
  multiple of 8 (odd, 2 mod 4, 4 mod 8), x one halfword past a 4-byte
  boundary (the halfword loads and copies), overlapping windows (3/2,
  3/1) and windows that skip columns (2/3), several small planes a block;
- three runs bitwise equal, and ``variant_launches["bf16"]`` stepped by
  one a launch.

Every test needs a CUDA device and ``nvcc`` and skips with the reason
where either is missing.  No jax, no reference package:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_pool_nchw_bf16_card.py
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.core.layout import perm_between
from repro_torch.kernels import _build
from repro_torch.kernels.pool.backward import pool_backward_nchw
from repro_torch.kernels.pool.ops import pool_nchw
from repro_torch.kernels.pool.ref import pool_backward_ref, pool_ref
from repro_torch.shapes import pool_out_hw

BF16 = torch.bfloat16
BF16_STEP = 2.0 ** -7

# K3b bf16: ((N, C, H, W), F, S, op) -- the smoke's off-path case and the
# float32 K3b row's eight shapes first
K3B_CASES = [((8, 32, 32, 32), 2, 2, "max"),
             ((128, 96, 55, 55), 3, 2, "max"),
             ((128, 256, 27, 27), 3, 2, "max"),
             ((128, 256, 13, 13), 3, 2, "max"),
             ((32, 64, 224, 224), 2, 2, "max"),
             ((32, 128, 112, 112), 2, 2, "max"),
             ((32, 256, 56, 56), 2, 2, "max"),
             ((32, 512, 28, 28), 2, 2, "max"),
             ((32, 512, 14, 14), 2, 2, "max"),
             ((3, 5, 15, 17), 3, 2, "avg"), ((2, 4, 14, 18), 2, 2, "avg"),
             ((1, 4, 9, 9), 3, 1, "avg"), ((3, 3, 13, 11), 2, 2, "max"),
             ((6, 3, 16, 16), 7, 7, "max"), ((2, 2, 24, 20), 12, 6, "avg"),
             ((4, 3, 20, 20), 3, 2, "avg")]
# K7b bf16: (N, C, H, F, S, op, g_layout, relu_mask) -- ResNet-18 b32's two
# launches and the float32 K7b row's VGG16 shapes first
K7B_CASES = [(32, 64, 112, 3, 2, "max", "NCHW", True),
             (32, 512, 7, 7, 7, "avg", "NCHW", True),
             (32, 64, 224, 2, 2, "max", "NCHW", True),
             (32, 128, 112, 2, 2, "max", "NCHW", True),
             (32, 256, 56, 2, 2, "max", "NCHW", True),
             (32, 512, 28, 2, 2, "max", "NCHW", True),
             (32, 512, 14, 2, 2, "max", "NCHW", True),
             (3, 5, 15, 3, 2, "max", "CHWN", True),
             (2, 3, 17, 3, 2, "avg", "NCHW", False),
             (4, 6, 11, 3, 1, "max", "NCHW", False),
             (2, 3, 14, 2, 3, "max", "CHWN", True),
             (2, 3, 64, 2, 3, "max", "NCHW", True),
             (5, 4, 13, 2, 2, "max", "NCHW", True),
             (2, 3, 40, 3, 2, "max", "CHWN", False),
             (33, 3, 27, 3, 2, "avg", "CHWN", True),
             (16, 4, 20, 5, 2, "max", "NCHW", True),
             (2, 2, 300, 3, 2, "max", "NCHW", True)]


@pytest.fixture
def card():
    reason = _build.toolchain_missing()
    if reason:
        pytest.skip(reason)
    return torch.device("cuda")


def assert_bf16_close(got, want):
    """Within one bf16 step (NaN and infinities where the plain version
    has them)."""
    got, want = got.double(), want.double()
    nan, inf = want.isnan(), want.isinf()
    assert torch.equal(got.isnan(), nan)
    assert torch.equal(got[inf], want[inf])
    got, want = got[~nan & ~inf], want[~nan & ~inf]
    bound = BF16_STEP * want.abs() + 1e-5 * want.abs().max()
    assert float(((got - want).abs() - bound).max()) <= 0


def _check(got, want, op):
    if op == "max":
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    else:
        assert_bf16_close(got, want)


def _ties(shape, card, gen):
    """bf16 values from few levels (ties in most windows), a NaN and an
    all -inf corner (NCHW)."""
    x = (torch.randint(-3, 4, shape, device=card, generator=gen)
         .to(torch.float32) / 2).to(BF16)
    x[0, 0, 0, 0] = float("nan")
    x[-1, -1, :3, :3] = -float("inf")
    return x


def _odd_halfword(t):
    """A copy of ``t`` one halfword past a 4-byte boundary."""
    base = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)
    out = base[1:].view(t.shape)
    out.copy_(t)
    return out


def _runs(fn, wrapper, first):
    """Two more runs bitwise equal to ``first``, each one bf16 launch."""
    for _ in range(2):
        before = wrapper.variant_launches["bf16"]
        again = fn()
        assert wrapper.variant_launches["bf16"] == before + 1
        assert torch.equal(again.view(torch.int16), first.view(torch.int16))


@pytest.mark.parametrize("case", K3B_CASES)
@pytest.mark.parametrize("dst", ["NCHW", "CHWN"])
def test_k3b_bf16_matches_plain(case, dst, card):
    (N, C, H, W), F, S, op = case
    gen = torch.Generator(device=card).manual_seed(N + C + H + W)
    x = torch.randn(N, C, H, W, device=card, generator=gen).to(BF16)
    before = pool_nchw.variant_launches["bf16"]
    got = pool_nchw(x, F, S, op, dst_layout=dst)
    assert pool_nchw.variant_launches["bf16"] == before + 1
    assert got.dtype == BF16
    _check(got, pool_ref(x, F, S, op, "NCHW", dst), op)
    _runs(lambda: pool_nchw(x, F, S, op, dst_layout=dst), pool_nchw, got)


@pytest.mark.parametrize("case", [c for c in K3B_CASES
                                  if c[0][0] * c[0][1] <= 4096])
def test_k3b_bf16_ties_nan_and_odd_halfword(case, card):
    """Ties, a NaN, an all -inf window; then x one halfword past a 4-byte
    boundary, which loads by halfwords whatever W."""
    (N, C, H, W), F, S, op = case
    gen = torch.Generator(device=card).manual_seed(7 * N + C)
    x = _ties((N, C, H, W), card, gen)
    want = pool_ref(x, F, S, op, "NCHW")
    _check(pool_nchw(x, F, S, op), want, op)
    _check(pool_nchw(_odd_halfword(x), F, S, op), want, op)


def _k7b_inputs(case, card, seed, ties):
    N, C, H, F, S, op, g_lay, relu = case
    gen = torch.Generator(device=card).manual_seed(seed)
    Ho = pool_out_hw(H, F, S)
    z = (_ties((N, C, H, H), card, gen) if ties else
         torch.randn(N, C, H, H, device=card, generator=gen).to(BF16))
    g_nchw = torch.randn(N, C, Ho, Ho, device=card, generator=gen).to(BF16)
    g = g_nchw.permute(perm_between("NCHW", g_lay)).contiguous()
    return z, g


@pytest.mark.parametrize("case", K7B_CASES)
@pytest.mark.parametrize("relu", [True, False])
def test_k7b_bf16_matches_plain(case, relu, card):
    N, C, H, F, S, op, g_lay, _ = case
    z, g = _k7b_inputs(case, card, N + C + H, ties=False)

    def run():
        return pool_backward_nchw(z, g, F, S, op, g_layout=g_lay,
                                  relu_mask=relu)

    before = pool_backward_nchw.variant_launches["bf16"]
    got = run()
    assert pool_backward_nchw.variant_launches["bf16"] == before + 1
    assert got.dtype == BF16
    _check(got, pool_backward_ref(z, g, F, S, op, "NCHW", g_lay, relu), op)
    _runs(run, pool_backward_nchw, got)


@pytest.mark.parametrize("case", K7B_CASES[:2] + K7B_CASES[7:])
@pytest.mark.parametrize("g_layout", ["NCHW", "CHWN"])
def test_k7b_bf16_ties_nan_and_odd_halfword(case, g_layout, card):
    """Ties (the first maximal tap in row-major order), a NaN window (routes
    nothing), an all -inf window (routes to tap 0), g in either layout;
    then z one halfword past a 4-byte boundary (halfword copies)."""
    N, C, H, F, S, op, _, relu = case
    case = (N, C, H, F, S, op, g_layout, relu)
    z, g = _k7b_inputs(case, card, 3 * N + H, ties=True)
    want = pool_backward_ref(z, g, F, S, op, "NCHW", g_layout, relu)
    _check(pool_backward_nchw(z, g, F, S, op, g_layout=g_layout,
                              relu_mask=relu), want, op)
    _check(pool_backward_nchw(_odd_halfword(z), g, F, S, op,
                              g_layout=g_layout, relu_mask=relu), want, op)
