"""Port row softmax (K4) against the reference's softmax.

The same seeded numpy logits go through ``repro.kernels.softmax`` (its
plain version and its Pallas kernel in interpret mode) and the port's
``softmax`` wrapper, which runs the plain version on the CPU
(``test_torch_kernels_card.py`` holds the CUDA kernel against it on the
card).  Tolerance atol 1e-6 (fp32).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.softmax.ops import softmax as ref_softmax_pallas
from repro.kernels.softmax.ref import softmax_ref as ref_softmax

from repro_torch.cnn.layers import softmax_forward
from repro_torch.kernels.softmax.ops import softmax

ATOL = 1e-6
SHAPES = [(1, 10), (5, 37), (8, 1000), (32, 1000), (128, 1000)]


def _logits(shape, seed, scale=4.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape, np.float32) * scale).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_softmax_matches_reference(shape):
    x = _logits(shape, sum(shape))
    got = softmax(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref_softmax(jnp.asarray(x))),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        softmax_forward(torch.from_numpy(x), impl="torch").numpy(), got,
        rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES[:3], ids=lambda s: f"{s[0]}x{s[1]}")
def test_softmax_matches_reference_pallas(shape):
    x = _logits(shape, 7 + sum(shape))
    want = np.asarray(ref_softmax_pallas(jnp.asarray(x)))
    np.testing.assert_allclose(softmax(torch.from_numpy(x)).numpy(), want,
                               rtol=0, atol=ATOL)


def test_softmax_rejects_non_matrices_and_other_devices():
    with pytest.raises(ValueError, match=r"\[N, C\]"):
        softmax(torch.zeros(2, 3, 4))
    with pytest.raises(ValueError, match="not supported"):
        softmax(torch.zeros(2, 3, device="meta"))

