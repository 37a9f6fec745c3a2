"""Port tiled transposes (K9a 2-D, K9b batched) and ``apply_transform``
against the reference.

The same seeded numpy arrays go through the reference's Pallas transposes
(``repro.kernels.transpose.ops``, interpret mode) and ``apply_transform
(use_pallas=True)``, and through the port's wrappers (the plain version
for a CPU tensor) and ``apply_transform(use_kernel=True)``, for every
ordered pair of CHWN / NCHW / NHWC: the CHWN <-> NCHW pairs collapse to a
2-D transpose, NCHW <-> NHWC to a batched one, and CHWN <-> NHWC to a
3-axis permutation that neither kernel takes.  A transpose moves values
without arithmetic, so equality is exact.  ``test_torch_pool_card.py``
holds the CUDA kernel against the plain version on the card.
"""
from __future__ import annotations

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.transform import apply_transform as ref_apply_transform
from repro.core.transform import naive_transform as ref_naive_transform
from repro.kernels.transpose import ops as ref_ops

from repro_torch.core.layout import plan_transform
from repro_torch.core.transform import apply_transform, naive_transform
from repro_torch.kernels.transpose import ops

SHAPES_2D = [(33, 70), (1, 1000), (1000, 1), (64, 128), (5, 3)]
SHAPES_3D = [(3, 17, 40), (1, 33, 70), (4, 1, 9)]
PAIRS = [p for p in itertools.permutations(("CHWN", "NCHW", "NHWC"), 2)]
DIMS = {"N": 3, "C": 5, "H": 6, "W": 7}


def _array(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape, np.float32)


@pytest.mark.parametrize("shape", SHAPES_2D, ids=lambda s: f"{s[0]}x{s[1]}")
def test_transpose2d_matches_reference(shape):
    x = _array(shape, sum(shape))
    want = np.asarray(ref_ops.transpose2d(jnp.asarray(x), interpret=True))
    got = ops.transpose2d(torch.from_numpy(x))
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", SHAPES_3D,
                         ids=lambda s: "x".join(map(str, s)))
def test_transpose2d_batched_matches_reference(shape):
    x = _array(shape, sum(shape))
    want = np.asarray(ref_ops.transpose2d_batched(jnp.asarray(x),
                                                  interpret=True))
    got = ops.transpose2d_batched(torch.from_numpy(x))
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("src,dst", PAIRS, ids=lambda p: p)
def test_apply_transform_matches_reference(src, dst):
    x = _array(tuple(DIMS[d] for d in src), PAIRS.index((src, dst)))
    want = np.asarray(ref_apply_transform(jnp.asarray(x), src, dst,
                                          use_pallas=True, interpret=True))
    np.testing.assert_array_equal(
        want, np.asarray(ref_naive_transform(jnp.asarray(x), src, dst)))
    for use_kernel in (False, True):
        got = apply_transform(torch.from_numpy(x), src, dst,
                              use_kernel=use_kernel)
        assert tuple(got.shape) == tuple(DIMS[d] for d in dst)
        assert got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        naive_transform(torch.from_numpy(x), src, dst).numpy(), want)


def test_which_pairs_reach_which_kernel():
    kinds = {}
    for src, dst in PAIRS:
        plan = plan_transform(src, dst)
        kinds[src, dst] = ("2d" if plan.is_2d_transpose else
                           "batched" if len(plan.perm) == 3
                           and plan.perm[0] == 0 else "permute")
    assert kinds == {("CHWN", "NCHW"): "2d", ("NCHW", "CHWN"): "2d",
                     ("NCHW", "NHWC"): "batched", ("NHWC", "NCHW"): "batched",
                     ("CHWN", "NHWC"): "permute", ("NHWC", "CHWN"): "permute"}


def test_transpose_wrappers_reject_what_they_do_not_take():
    with pytest.raises(ValueError, match=r"\[M, N\]"):
        ops.transpose2d(torch.zeros(2, 3, 4))
    with pytest.raises(ValueError, match=r"\[B, M, N\]"):
        ops.transpose2d_batched(torch.zeros(2, 3))
    assert ops.transpose2d.launches == 0
    assert ops.transpose2d_batched.launches == 0
