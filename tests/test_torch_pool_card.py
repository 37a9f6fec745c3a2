"""The pool kernels (K3a, K3b) and the tiled transpose (K9a, K9b) against
their plain versions, on the card.

Every test needs a CUDA device and ``nvcc`` and skips with the reason
where either is missing.  The module imports neither ``jax`` nor the
reference package:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_pool_card.py

Max pool and transposes agree exactly (they select or move values); avg
pool within atol 1e-6 (the plain version may sum in another order).
"""
from __future__ import annotations

import itertools

import pytest
import torch

from repro_torch.core.layout import perm_between
from repro_torch.core.transform import apply_transform
from repro_torch.kernels import _build
from repro_torch.kernels.pool import ops as pool_ops
from repro_torch.kernels.pool.ref import pool_ref
from repro_torch.kernels.transpose import ops as tr_ops
from repro_torch.kernels.transpose.ref import (transpose2d_batched_ref,
                                               transpose2d_ref)

AVG_ATOL = 1e-6
POOL_CASES = list(itertools.product(("CHWN", "NCHW"), ("CHWN", "NCHW"),
                                    ("max", "avg"),
                                    ((2, 2), (3, 2), (3, 1), (7, 7))))
WRAPPER = {"CHWN": pool_ops.pool_chwn, "NCHW": pool_ops.pool_nchw}
SHAPES_2D = [(33, 70), (1, 1000), (1000, 1), (1, 1), (32, 150528),
             (150528, 32), (128, 154587)]
SHAPES_3D = [(3, 17, 40), (1, 33, 70), (2048, 1, 5)]


@pytest.fixture
def card():
    reason = _build.toolchain_missing()
    if reason:
        pytest.skip(reason)
    return torch.device("cuda")


def _pool_input(src: str, N: int, C: int, H: int, W: int, seed: int, dev):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(N, C, H, W, generator=gen)
    return x.permute(perm_between("NCHW", src)).contiguous().to(dev)


def _check(got, want, op: str) -> None:
    assert got.shape == want.shape and got.is_contiguous()
    if op == "max":
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=AVG_ATOL)


@pytest.mark.parametrize("src,dst,op,window", POOL_CASES,
                         ids=[f"{s}to{d}-{o}{f}s{st}"
                              for s, d, o, (f, st) in POOL_CASES])
def test_pool_kernel_matches_plain(src, dst, op, window, card):
    F, S = window
    wrapper = WRAPPER[src]
    for i, (N, C, H, W) in enumerate([(3, 5, 15, 17), (33, 7, 16, 9),
                                      (130, 3, 23, 23)]):
        x = _pool_input(src, N, C, H, W, POOL_CASES.index(
            (src, dst, op, window)) * 3 + i, card)
        before = wrapper.launches
        got = wrapper(x, F, S, op, dst_layout=dst)
        want = pool_ref(x, F, S, op, src, dst)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        _check(got, want, op)


@pytest.mark.parametrize("src", ["CHWN", "NCHW"])
def test_pool_kernel_propagates_nan(src, card):
    x = _pool_input(src, 33, 4, 13, 13, 7, "cpu")
    nchw = x.permute(perm_between(src, "NCHW"))        # a view of x
    nchw[1, 2, 4, 5] = float("nan")
    nchw[32, 0, 0, 0] = float("nan")
    nchw[0, 3, 12, 12] = float("nan")
    x = x.to(card)
    for dst in ("CHWN", "NCHW"):
        got = WRAPPER[src](x, 3, 2, "max", dst_layout=dst)
        want = pool_ref(x, 3, 2, "max", src, dst)
        torch.cuda.synchronize()
        assert torch.isnan(want).any()
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        torch.testing.assert_close(got, want, rtol=0, atol=0,
                                   equal_nan=True)


@pytest.mark.parametrize("shape", SHAPES_2D, ids=lambda s: f"{s[0]}x{s[1]}")
def test_transpose2d_kernel_matches_plain(shape, card):
    x = torch.randn(*shape, generator=torch.Generator().manual_seed(3)).to(
        card)
    before = tr_ops.transpose2d.launches
    got = tr_ops.transpose2d(x)
    torch.cuda.synchronize()
    assert tr_ops.transpose2d.launches == before + 1
    assert torch.equal(got, transpose2d_ref(x))


@pytest.mark.parametrize("shape", SHAPES_3D,
                         ids=lambda s: "x".join(map(str, s)))
def test_transpose2d_batched_kernel_matches_plain(shape, card):
    x = torch.randn(*shape, generator=torch.Generator().manual_seed(4)).to(
        card)
    before = tr_ops.transpose2d_batched.launches
    got = tr_ops.transpose2d_batched(x)
    torch.cuda.synchronize()
    assert tr_ops.transpose2d_batched.launches == before + 1
    assert torch.equal(got, transpose2d_batched_ref(x))


@pytest.mark.parametrize("src,dst", [("CHWN", "NCHW"), ("NCHW", "CHWN"),
                                     ("NCHW", "NHWC"), ("NHWC", "NCHW")])
def test_apply_transform_kernel_matches_permute(src, dst, card):
    dims = {"N": 5, "C": 3, "H": 33, "W": 31}
    x = torch.randn(*(dims[d] for d in src),
                    generator=torch.Generator().manual_seed(5)).to(card)
    got = apply_transform(x, src, dst, use_kernel=True)
    torch.cuda.synchronize()
    assert torch.equal(got, apply_transform(x, src, dst))


def test_kernels_reject_what_they_do_not_take(card):
    x = torch.zeros(2, 3, 8, 8, device=card)
    with pytest.raises(TypeError, match="float32"):
        pool_ops.pool_nchw(x.double(), 2, 2)
    with pytest.raises(ValueError, match="contiguous"):
        pool_ops.pool_nchw(x.transpose(2, 3), 2, 2)
    with pytest.raises(TypeError, match="float32"):
        tr_ops.transpose2d(torch.zeros(4, 4, device=card,
                                       dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        tr_ops.transpose2d(torch.zeros(4, 6, device=card).t())


def test_kernel_transform_raises_rather_than_permute(card):
    """With the kernel, a re-layout on the card launches K9 or raises: a
    non-contiguous input and a permutation neither kernel covers are
    refused, not copied by ``permute``."""
    x = torch.zeros(2, 3, 8, 8, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        apply_transform(x.transpose(0, 1), "NCHW", "CHWN", use_kernel=True)
    with pytest.raises(NotImplementedError, match="no transpose kernel"):
        apply_transform(x, "CHWN", "NHWC", use_kernel=True)
