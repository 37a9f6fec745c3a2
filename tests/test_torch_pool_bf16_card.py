"""The bf16 builds of K3a (``pool_chwn_bf16_kernel`` in
``kernels/pool/csrc/pool.cu``), K7a (``pool_backward_direct_bf16`` and
``pool_backward_banded_bf16`` in ``pool_backward.cu``) and K8
(``softmax_xent_forward_bf16`` in ``softmax/csrc/softmax.cu``), on the
card.

- Every K3a bf16 and K7a bf16 launch of the smoke's bf16 plans (unet_mini
  b8's standalone pools and their gradients, VGG16 b32's bf16 training
  step) against the plain version: max pools and pool backwards exactly,
  avg ones within one bf16 step (2^-7 |want| + 1e-5 max|want|);
- bf16 ties (few distinct values), NaN and all -inf windows, N odd and
  below 32 (one image a lane), x at an odd halfword (one image a lane
  though N is even), both g layouts, the ReLU mask on and off, the folded
  NCHW write of K3a, K3a's windows wider than 8 through shared memory and
  (at N 128, too large for it) a row at a time, overlapping windows (3/2,
  3/1) on K7a's banded kernel;
- K8 on bf16 logits against its plain version (rtol and atol 1e-5),
  labels outside [0, C), NaN and all -inf rows;
- three runs bitwise equal, and ``variant_launches["bf16"]`` stepped by
  one a launch.

Every test needs a CUDA device and ``nvcc`` and skips with the reason
where either is missing.  No jax, no reference package:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_pool_bf16_card.py
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.core.layout import perm_between
from repro_torch.kernels import _build
from repro_torch.kernels.pool.backward import pool_backward_chwn
from repro_torch.kernels.pool.ops import pool_chwn
from repro_torch.kernels.pool.ref import pool_backward_ref, pool_ref
from repro_torch.kernels.softmax.ops import softmax_xent
from repro_torch.kernels.softmax.ref import softmax_xent_ref
from repro_torch.shapes import pool_out_hw

BF16 = torch.bfloat16
BF16_STEP = 2.0 ** -7

# K3a bf16: ((N, C, H, W), F, S, op) -- unet_mini b8's three pools first
K3A_CASES = [((8, 8, 32, 32), 2, 2, "max"), ((8, 16, 16, 16), 2, 2, "max"),
             ((8, 8, 32, 32), 32, 32, "avg"), ((3, 5, 15, 17), 3, 2, "max"),
             ((1, 4, 9, 9), 3, 1, "avg"), ((33, 3, 13, 11), 2, 2, "avg"),
             ((64, 2, 27, 27), 3, 2, "max"), ((6, 3, 16, 16), 7, 7, "max"),
             ((3, 4, 20, 20), 10, 10, "max"), ((6, 2, 24, 24), 12, 6, "avg"),
             ((128, 2, 32, 32), 32, 32, "avg")]
# K7a bf16: (N, C, H, F, S, op, g_layout, relu_mask) -- VGG16 b32's five
# and unet_mini b8's three launches first
K7A_CASES = [(32, 64, 224, 2, 2, "max", "CHWN", True),
             (32, 128, 112, 2, 2, "max", "CHWN", True),
             (32, 256, 56, 2, 2, "max", "CHWN", True),
             (32, 512, 28, 2, 2, "max", "CHWN", True),
             (32, 512, 14, 2, 2, "max", "NCHW", True),
             (8, 8, 32, 2, 2, "max", "CHWN", False),
             (8, 16, 16, 2, 2, "max", "CHWN", False),
             (8, 8, 32, 32, 32, "avg", "NCHW", False),
             (3, 5, 15, 2, 2, "max", "NCHW", True),
             (7, 4, 13, 3, 2, "max", "CHWN", True),
             (4, 6, 11, 3, 1, "max", "NCHW", False),
             (33, 3, 27, 3, 2, "avg", "CHWN", True),
             (2, 3, 17, 2, 3, "max", "CHWN", True),
             (16, 4, 20, 5, 2, "max", "NCHW", True),
             (128, 8, 13, 3, 2, "max", "CHWN", True)]


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


def _ties(shape, card, gen, special: bool):
    """bf16 values from few levels (ties in most windows); with
    ``special`` a NaN and an all -inf corner in the first two channels
    (CHWN)."""
    x = (torch.randint(-3, 4, shape, device=card, generator=gen)
         .to(torch.float32) / 2).to(BF16)
    if special:
        x[0, 0, 0, 0] = float("nan")
        x[min(1, shape[0] - 1), :3, :3, :] = -float("inf")
    return x


def _runs(fn, wrapper, first):
    """Two more runs bitwise equal to ``first``, each one bf16 launch."""
    for _ in range(2):
        before = wrapper.variant_launches["bf16"]
        again = fn()
        assert wrapper.variant_launches["bf16"] == before + 1
        assert torch.equal(again.view(torch.int16), first.view(torch.int16))


@pytest.mark.parametrize("case", K3A_CASES)
@pytest.mark.parametrize("dst", ["CHWN", "NCHW"])
def test_k3a_bf16_matches_plain(case, dst, card):
    (N, C, H, W), F, S, op = case
    gen = torch.Generator(device=card).manual_seed(N + C + H)
    x = torch.randn(C, H, W, N, device=card, generator=gen).to(BF16)
    before = pool_chwn.variant_launches["bf16"]
    got = pool_chwn(x, F, S, op, dst_layout=dst)
    assert pool_chwn.variant_launches["bf16"] == before + 1
    assert got.dtype == BF16
    _check(got, pool_ref(x, F, S, op, "CHWN", dst), op)
    _runs(lambda: pool_chwn(x, F, S, op, dst_layout=dst), pool_chwn, got)


@pytest.mark.parametrize("case", K3A_CASES[3:])
def test_k3a_bf16_ties_nan_and_odd_halfword(case, card):
    """Ties, a NaN, an all -inf window; then x one halfword past a 4-byte
    boundary, which runs one image a lane whatever N."""
    (N, C, H, W), F, S, op = case
    gen = torch.Generator(device=card).manual_seed(7 * N + C)
    x = _ties((C, H, W, N), card, gen, special=True)
    _check(pool_chwn(x, F, S, op), pool_ref(x, F, S, op, "CHWN"), op)
    base = torch.empty(x.numel() + 1, device=card, dtype=BF16)
    xo = base[1:].view(x.shape)
    xo.copy_(x)
    _check(pool_chwn(xo, F, S, op), pool_ref(x, F, S, op, "CHWN"), op)


def _k7a_inputs(case, card, seed, special):
    N, C, H, F, S, op, g_lay, relu = case
    gen = torch.Generator(device=card).manual_seed(seed)
    Ho = pool_out_hw(H, F, S)
    z = (_ties((C, H, H, N), card, gen, special) if special else
         torch.randn(C, H, H, N, device=card, generator=gen).to(BF16))
    g_nchw = torch.randn(N, C, Ho, Ho, device=card, generator=gen).to(BF16)
    g = g_nchw.permute(perm_between("NCHW", g_lay)).contiguous()
    return z, g


@pytest.mark.parametrize("case", K7A_CASES)
def test_k7a_bf16_matches_plain(case, card):
    N, C, H, F, S, op, g_lay, relu = case
    z, g = _k7a_inputs(case, card, N + C + H, special=False)

    def run():
        return pool_backward_chwn(z, g, F, S, op, g_layout=g_lay,
                                  relu_mask=relu)

    before = pool_backward_chwn.variant_launches["bf16"]
    got = run()
    assert pool_backward_chwn.variant_launches["bf16"] == before + 1
    assert got.dtype == BF16
    _check(got, pool_backward_ref(z, g, F, S, op, "CHWN", g_lay, relu), op)
    _runs(run, pool_backward_chwn, got)


@pytest.mark.parametrize("case", K7A_CASES[5:])
@pytest.mark.parametrize("relu", [False, True])
def test_k7a_bf16_ties_nan_and_odd_halfword(case, relu, card):
    """Ties (the first maximal tap in row-major order), a NaN window (routes
    nothing), an all -inf window (routes to tap 0), the mask on and off;
    then z and dx one halfword past a 4-byte boundary (one image a
    lane)."""
    N, C, H, F, S, op, g_lay, _ = case
    z, g = _k7a_inputs(case, card, 3 * N + H, special=True)
    want = pool_backward_ref(z, g, F, S, op, "CHWN", g_lay, relu)
    _check(pool_backward_chwn(z, g, F, S, op, g_layout=g_lay,
                              relu_mask=relu), want, op)
    base = torch.empty(z.numel() + 1, device=card, dtype=BF16)
    zo = base[1:].view(z.shape)
    zo.copy_(z)
    _check(pool_backward_chwn(zo, g, F, S, op, g_layout=g_lay,
                              relu_mask=relu), want, op)


@pytest.mark.parametrize("rows,cols", [(32, 1000), (8, 10), (7, 3),
                                       (5, 20001), (300, 1000), (6, 1500)])
def test_k8_bf16_matches_plain(rows, cols, card):
    gen = torch.Generator(device=card).manual_seed(rows + cols)
    x = (torch.randn(rows, cols, device=card, generator=gen) * 4).to(BF16)
    labels = torch.randint(0, cols, (rows,), device=card, generator=gen)
    labels[::3] = -1
    labels[1::3] = cols
    x[min(2, rows - 1), :] = -float("inf")
    x[min(3, rows - 1), 0] = float("nan")

    def run():
        return softmax_xent(x, labels)

    before = softmax_xent.variant_launches["bf16"]
    got = run()
    assert softmax_xent.variant_launches["bf16"] == before + 1
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, softmax_xent_ref(x, labels), rtol=1e-5,
                               atol=1e-5, equal_nan=True)
    for _ in range(2):
        assert torch.equal(run().view(torch.int32), got.view(torch.int32))
