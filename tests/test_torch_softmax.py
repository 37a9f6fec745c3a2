"""Port row softmax (K4) against the reference's softmax.

The same seeded numpy logits go through ``repro.kernels.softmax`` (its
plain version and its Pallas kernel in interpret mode) and the port's
``softmax`` wrapper, which runs the plain version on the CPU
(``test_torch_kernels_card.py`` holds the CUDA kernel against it on the
card), at the classifier's shapes and Fig. 13's twelve.  Also the paper's
five-step baseline ``softmax_5step_ref`` and the Fig. 13 configs
(``configs.paper_table1``) against the reference's.  Tolerance atol 1e-6
(fp32).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_table1 as ref_table1
from repro.kernels.softmax.ops import softmax as ref_softmax_pallas
from repro.kernels.softmax.ref import softmax_5step_ref as ref_5step
from repro.kernels.softmax.ref import softmax_ref as ref_softmax

from repro_torch.cnn.layers import softmax_forward
from repro_torch.configs import paper_table1 as port_table1
from repro_torch.kernels.softmax.ops import softmax
from repro_torch.kernels.softmax.ref import softmax_5step_ref

ATOL = 1e-6
SHAPES = [(1, 10), (5, 37), (8, 1000), (32, 1000), (128, 1000)]
FIG13 = [(l.N, l.C) for l in port_table1.SOFTMAX_LAYERS]


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



@pytest.mark.parametrize("shape", FIG13, ids=lambda s: f"{s[0]}x{s[1]}")
def test_softmax_fig13_matches_reference(shape):
    # standard normal logits, as the reference's Fig. 13 benchmark draws
    # them (benchmarks/softmax_bench.py)
    x = _logits(shape, 13 + sum(shape), scale=1.0)
    got = softmax(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref_softmax(jnp.asarray(x))),
                               rtol=0, atol=ATOL)
    if shape[1] <= 1000:    # the interpreter's share of the suite's time
        np.testing.assert_allclose(
            got, np.asarray(ref_softmax_pallas(jnp.asarray(x))), rtol=0,
            atol=ATOL)


@pytest.mark.parametrize("shape", [(1, 10), (32, 1000), (64, 10000)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_softmax_5step_matches_reference(shape):
    x = _logits(shape, 5 + sum(shape), scale=1.0)   # Fig. 13's data
    got = softmax_5step_ref(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref_5step(jnp.asarray(x))),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, softmax(torch.from_numpy(x)).numpy(),
                               rtol=0, atol=ATOL)


def test_softmax_nan_and_all_neg_inf_rows_match_reference():
    x = _logits((4, 37), 3)
    x[1, 5] = np.nan
    x[2, :] = -np.inf
    x[3, :7] = -np.inf
    want = np.asarray(ref_softmax(jnp.asarray(x)))
    got = softmax(torch.from_numpy(x)).numpy()
    assert np.isnan(got[1]).all() and np.isnan(want[1]).all()
    assert np.isnan(got[2]).all() and np.isnan(want[2]).all()
    np.testing.assert_allclose(got[[0, 3]], want[[0, 3]], rtol=0, atol=ATOL)


@pytest.mark.parametrize("i", range(len(ref_table1.SOFTMAX_LAYERS)))
def test_softmax_layers_repr_match_reference(i):
    assert (repr(port_table1.SOFTMAX_LAYERS[i])
            == repr(ref_table1.SOFTMAX_LAYERS[i]))
    assert len(port_table1.SOFTMAX_LAYERS) == len(ref_table1.SOFTMAX_LAYERS)


@pytest.mark.parametrize("name", ["CONV_BY_NAME", "POOL_BY_NAME",
                                  "PAPER_PREFERRED_CONV_LAYOUT"])
def test_table1_dicts_repr_match_reference(name):
    assert repr(getattr(port_table1, name)) == repr(getattr(ref_table1, name))


# --------------------------------------------------------------------------
# What the CPU can say about the card's kernels: the online max and
# rescaled sum that K4 and K8 take over a row past 16384 columns (the loop
# variant of ``csrc/softmax.cu``: ``fold``, ``merge``), emulated in float32
# in the kernel's thread order, against the reference's kernels
# (interpret mode).
# --------------------------------------------------------------------------
_NINF = np.float32(-np.inf)
_LOOP_THREADS, _LOOP_LOADS = 1024, 4


def _nan_max(r, v):
    return v if (v > r or v != v) else r


def _fold(m, s, vals):
    bm = _NINF
    for v in vals:
        bm = _nan_max(bm, v)
    nm = _nan_max(m, bm)
    if m != nm:
        s = np.float32(s * np.exp(np.float32(m - nm)))
    for v in vals:
        s = np.float32(s + (np.float32(0) if v == _NINF
                            else np.exp(np.float32(v - nm))))
    return nm, s


def _merge(m, s, om, os_):
    nm = _nan_max(m, om)
    a = s if m == nm else np.float32(s * np.exp(np.float32(m - nm)))
    b = os_ if om == nm else np.float32(os_ * np.exp(np.float32(om - nm)))
    return nm, np.float32(a + b)


def _butterfly(pairs):
    """xor-shuffle merges over len(pairs) lanes; every lane's result."""
    pairs = list(pairs)
    off = len(pairs) // 2
    while off:
        pairs = [_merge(*pairs[i], *pairs[i ^ off])
                 for i in range(len(pairs))]
        off //= 2
    return pairs


def _loop_pair(row):
    """loop_kernel's (max, sum of exp(x - max)) of one row: each thread
    folds _LOOP_LOADS chunks at a time, then a warp's shuffles, then the
    warps' pairs."""
    cols = row.shape[0]
    W = 4 if cols % 4 == 0 else 1
    stride = _LOOP_THREADS * W
    pairs = []
    for t in range(_LOOP_THREADS):
        m, s = _NINF, np.float32(0)
        for c0 in range(t * W, cols, _LOOP_LOADS * stride):
            vals = []
            for b in range(_LOOP_LOADS):
                c = c0 + b * stride
                vals += ([row[c + k] for k in range(W)] if c < cols
                         else [_NINF] * W)
            m, s = _fold(m, s, vals)
        pairs.append((m, s))
    warps = [_butterfly(pairs[w:w + 32])[0]
             for w in range(0, _LOOP_THREADS, 32)]
    return _butterfly(warps)[0]


def _loop_rows(cols):
    x = _logits((5, cols), 29 + cols, scale=1.0)
    x[1, cols // 2] = np.float32(40.0)    # a late max: one column takes all
    x[2, 100] = np.nan
    x[3, :] = _NINF
    x[4, : cols // 2] = _NINF             # a run of -inf first
    return x


@pytest.mark.parametrize("cols", [16388, 20001])
def test_k4_loop_arithmetic_matches_reference(cols):
    x = _loop_rows(cols)
    got = np.empty_like(x)
    for r in range(x.shape[0]):
        m, s = _loop_pair(x[r])
        with np.errstate(invalid="ignore"):
            got[r] = np.exp(x[r] - m) / s
    want = np.asarray(ref_softmax(jnp.asarray(x)))
    for r in (2, 3):       # NaN anywhere, all -inf: a NaN row
        assert np.isnan(got[r]).all() and np.isnan(want[r]).all()
    np.testing.assert_allclose(got[[0, 1, 4]], want[[0, 1, 4]], rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("cols", [16388, 20001])
def test_k8_loop_arithmetic_matches_reference_kernel(cols):
    from repro.kernels.softmax.ops import softmax_xent as ref_xent
    x = _loop_rows(cols)
    # 1, 3 and 4 outside: the bare logsumexp, and NaN for the all -inf 3
    labels = np.array([5, cols, 7, cols + 3, -1])
    got = np.empty(5, np.float32)
    for r in range(5):
        m, s = _loop_pair(x[r])
        gold = x[r, labels[r]] if 0 <= labels[r] < cols else np.float32(0)
        with np.errstate(invalid="ignore", divide="ignore"):
            # xent_loss: an all -inf row (max -inf) is NaN, whatever label
            got[r] = (np.float32(np.nan) if m == _NINF else
                      np.float32(np.float32(np.log(s)) + m) - gold)
    want = np.asarray(ref_xent(jnp.asarray(x), jnp.asarray(labels,
                                                           jnp.int32)))
    for r in (2, 3):       # NaN in the row; all -inf, a label outside
        assert np.isnan(got[r]) and np.isnan(want[r])
    np.testing.assert_allclose(got[[0, 1, 4]], want[[0, 1, 4]], rtol=1e-5,
                               atol=1e-5)
