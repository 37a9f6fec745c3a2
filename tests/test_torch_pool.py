"""Port standalone pools (K3a CHWN, K3b NCHW) against the reference.

The same seeded numpy input goes through the reference's Pallas pools
(``repro.kernels.pool.ops.pool_chwn``/``pool_nchw``, interpret mode) and
the port's ``pool_chwn``/``pool_nchw`` wrappers, which run the plain
version (``pool_ref``) for a CPU tensor: both source layouts x both
destination layouts x max/avg x four (F, S), at a ragged N = 3 and C = 5
on a 15 x 17 image.  Max agrees exactly; avg within atol 1e-6 (tighter
than the 1e-5 ``tests/test_kernels.py`` uses for pools: the sums of at
most 49 fp32 taps differ only in their order).  A NaN input lands in the
max output where the reference's lands.  ``test_torch_pool_card.py`` holds
the CUDA kernels against ``pool_ref`` on the card.
"""
from __future__ import annotations

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.pool import ops as ref_ops

from repro_torch.cnn.layers import pool_forward
from repro_torch.core.layout import perm_between
from repro_torch.kernels.pool import ops

AVG_ATOL = 1e-6
N, C, H, W = 3, 5, 15, 17
WINDOWS = [(2, 2), (3, 2), (3, 1), (7, 7)]
CASES = list(itertools.product(("CHWN", "NCHW"), ("CHWN", "NCHW"),
                               ("max", "avg"), WINDOWS))
PORT = {"CHWN": ops.pool_chwn, "NCHW": ops.pool_nchw}
REF = {"CHWN": ref_ops.pool_chwn, "NCHW": ref_ops.pool_nchw}


def _input(src: str, seed: int) -> np.ndarray:
    x = np.random.default_rng(seed).standard_normal((N, C, H, W), np.float32)
    return np.ascontiguousarray(x.transpose(perm_between("NCHW", src)))


def _check(got: np.ndarray, want: np.ndarray, op: str) -> None:
    assert got.shape == want.shape
    if op == "max":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=AVG_ATOL)


@pytest.mark.parametrize("src,dst,op,window", CASES,
                         ids=[f"{s}to{d}-{o}{f}s{st}"
                              for s, d, o, (f, st) in CASES])
def test_pool_matches_reference(src, dst, op, window):
    F, S = window
    x = _input(src, CASES.index((src, dst, op, window)))
    want = np.asarray(REF[src](jnp.asarray(x), F, S, op, dst_layout=dst,
                               interpret=True))
    got = PORT[src](torch.from_numpy(x), F, S, op, dst_layout=dst)
    _check(got.numpy(), want, op)
    for impl in ("cuda", "torch"):
        y = pool_forward(torch.from_numpy(x), src, F, S, op, impl=impl,
                         dst_layout=dst)
        _check(y.numpy(), want, op)


@pytest.mark.parametrize("src", ["CHWN", "NCHW"])
def test_max_pool_propagates_nan_as_the_reference(src):
    x = _input(src, 99)
    nchw = x.transpose(perm_between(src, "NCHW"))   # a view of x
    nchw[1, 2, 4, 5] = np.nan
    nchw[2, 0, 0, 0] = np.nan
    want = np.asarray(REF[src](jnp.asarray(x), 3, 2, "max", interpret=True))
    got = PORT[src](torch.from_numpy(x), 3, 2, "max").numpy()
    assert np.isnan(want).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got, want)


def test_pool_wrappers_reject_what_they_do_not_take():
    x = torch.zeros(2, 3, 8, 8)
    with pytest.raises(ValueError, match="unknown pool op"):
        ops.pool_nchw(x, 2, 2, "min")
    with pytest.raises(ValueError, match="does not fit"):
        ops.pool_nchw(x, 9, 1)
    with pytest.raises(ValueError, match="dst_layout"):
        ops.pool_chwn(x, 2, 2, dst_layout="NHWC")
    with pytest.raises(ValueError, match="4-D"):
        ops.pool_chwn(x[0], 2, 2)
    with pytest.raises(ValueError, match="no pool kernel"):
        pool_forward(x, "NHWC", 2, 2)
    assert ops.pool_chwn.launches == 0 and ops.pool_nchw.launches == 0
