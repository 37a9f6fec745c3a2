"""Port fused unembed + cross entropy (K12) against the reference's.

The same seeded numpy h, table and labels go through
``repro.kernels.crossentropy`` (its Pallas kernel in interpret mode, and
its ``xent_ref``) and the port's ``fused_xent`` wrapper, which runs its
plain version on the CPU (``test_torch_lm_kernels_card.py`` holds the CUDA
kernel against it on the card).  Tolerance rtol / atol 1e-4
(``tests/test_kernels.py``); bf16 inputs 8 * BF16_EPS (``tests/test_bf16.py``).

Labels outside [0, V): the reference's kernel gives the bare logsumexp for
a label that hits no column (a negative one, or one past its block
padding), and the port gives it for every such label.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.crossentropy.ops import fused_xent as ref_fused_xent
from repro.kernels.crossentropy.ref import xent_ref as ref_xent

from repro_torch.kernels.crossentropy.ops import fused_xent, xent_splits
from repro_torch.kernels.crossentropy.ref import xent_ref

TOL = 1e-4
BF16_EPS = 2.0 ** -8
# the reference's test_fused_xent cases: (t, v, d, softcap)
REF_CASES = [(64, 1000, 128, None), (128, 513, 64, None),
             (32, 2000, 96, 30.0), (16, 128, 32, None)]


def _inputs(t, v, d, seed):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((t, d)).astype(np.float32)
    table = (rng.standard_normal((v, d)) * 0.05).astype(np.float32)
    labels = rng.integers(0, v, t).astype(np.int32)
    return h, table, labels


def _port(h, table, labels, softcap=None, dtype=torch.float32):
    return fused_xent(torch.from_numpy(h).to(dtype),
                      torch.from_numpy(table).to(dtype),
                      torch.from_numpy(labels), softcap=softcap)


def _ref(h, table, labels, softcap=None, dtype=jnp.float32, bv=256):
    return np.asarray(ref_fused_xent(jnp.asarray(h, dtype),
                                     jnp.asarray(table, dtype),
                                     jnp.asarray(labels), bv=bv,
                                     softcap=softcap))


@pytest.mark.parametrize("t,v,d,cap", REF_CASES)
def test_fused_xent_matches_reference(t, v, d, cap):
    h, table, labels = _inputs(t, v, d, t + v + d)
    got = _port(h, table, labels, cap)
    assert got.dtype == torch.float32 and got.shape == (t,)
    np.testing.assert_allclose(got.numpy(), _ref(h, table, labels, cap),
                               rtol=TOL, atol=TOL)
    oracle = np.asarray(ref_xent(jnp.asarray(h), jnp.asarray(table),
                                 jnp.asarray(labels), softcap=cap))
    np.testing.assert_allclose(got.numpy(), oracle, rtol=TOL, atol=TOL)


def test_single_token_matches_reference():
    h, table, labels = _inputs(1, 300, 48, 1)
    np.testing.assert_allclose(_port(h, table, labels).numpy(),
                               _ref(h, table, labels), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("cap", [None, 30.0])
def test_fused_xent_bf16_matches_reference(cap):
    h, table, labels = _inputs(32, 700, 64, 9)
    got = _port(h, table, labels, cap, torch.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), _ref(h, table, labels, cap, jnp.bfloat16), rtol=0,
        atol=8 * BF16_EPS)


def test_labels_that_hit_no_column_give_the_logsumexp():
    t, v = 8, 1000                    # the reference pads V to 1024 at bv 256
    h, table, _ = _inputs(t, v, 32, 3)
    labels = np.array([-1, -7, 1024, 5000, 0, 999, -1000, 2 ** 30],
                      np.int32)
    got = _port(h, table, labels).numpy()
    np.testing.assert_allclose(got, _ref(h, table, labels), rtol=TOL,
                               atol=TOL)
    logits = torch.from_numpy(h) @ torch.from_numpy(table).T
    lse = torch.logsumexp(logits, -1).numpy()
    miss = (labels < 0) | (labels >= v)
    np.testing.assert_allclose(got[miss], lse[miss], rtol=TOL, atol=TOL)
    # a label in [V, V + pad) hits the reference kernel's masked pad
    # column (a loss of ~1e30); the port treats it as a miss too
    pad_label = np.full(t, v + 3, np.int32)
    np.testing.assert_allclose(_port(h, table, pad_label).numpy(), lse,
                               rtol=TOL, atol=TOL)
    # the reference's oracle wraps a negative label onto the last column
    wrapped = np.asarray(ref_xent(jnp.asarray(h), jnp.asarray(table),
                                  jnp.asarray(labels)))
    assert abs(wrapped[0] - got[0]) > 1e-3


def test_int64_labels_and_the_plain_version_agree():
    h, table, labels = _inputs(16, 200, 32, 4)
    a = _port(h, table, labels)
    b = fused_xent(torch.from_numpy(h), torch.from_numpy(table),
                   torch.from_numpy(labels.astype(np.int64)))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(
        xent_ref(torch.from_numpy(h), torch.from_numpy(table),
                 torch.from_numpy(labels)), a, rtol=0, atol=0)


def test_fused_xent_refuses_bad_arguments():
    h, table, labels = (torch.from_numpy(a) for a in _inputs(4, 50, 8, 2))
    with pytest.raises(ValueError, match=r"h \[T, D\]"):
        fused_xent(h, table[:, :4], labels)
    with pytest.raises(TypeError, match="integer"):
        fused_xent(h, table, labels.float())
    with pytest.raises(ValueError, match="softcap"):
        fused_xent(h, table, labels, softcap=0.0)


@pytest.mark.parametrize("T,V", [(4096, 152064), (1024, 256000), (1, 10),
                                 (130, 513), (100000, 129), (1, 1000),
                                 (130, 50257), (1, 1), (4096, 1)])
def test_vocab_splits_cover_the_vocab_without_empty_splits(T, V):
    per, splits = xent_splits(T, V)
    v_tiles = -(-V // 128)
    assert per >= 1 and splits >= 1
    assert per * splits >= v_tiles > per * (splits - 1)
    assert xent_splits(T, V) == (per, splits)
