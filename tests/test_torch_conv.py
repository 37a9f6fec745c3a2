"""Port conv engines (K1 CHWN, K2 NCHW) against the reference fused block.

The same numpy inputs (seeded) go through
``repro.cnn.layers.fused_conv_block`` and the port's
``repro_torch.cnn.layers.fused_conv_block``.  On the CPU the port's
wrappers run the kernels' plain version; ``test_torch_kernels_card.py``
holds the CUDA kernels against it on the card.  Tolerance rtol 1e-4,
atol 1e-4 (fp32, sums in another order).
"""
from __future__ import annotations

import itertools
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cnn import layers as ref_layers

from repro_torch.cnn import layers as port_layers
from repro_torch.core.layout import perm_between
from repro_torch.kernels import _build
from repro_torch.kernels.conv import ops as conv_ops

RTOL = ATOL = 1e-4

STRIDES = (1, 2, 4)
PADS = (0, 1, 2)
FILTERS = (1, 3, 5, 11)
POOLS = (None, (2, 2, "max"), (3, 2, "max"), (2, 2, "avg"))
LAYOUT_PAIRS = tuple(itertools.product(("NCHW", "CHWN"), repeat=2))


def _grid(n_cases: int, seed: int = 0):
    """A seeded sample of the full grid (engine x stride x pad x F x pool x
    relu x bias x residual x src/dst), topped up so every value of every
    axis appears at least once."""
    axes = [("CHWN", "NCHW"), STRIDES, PADS, FILTERS, POOLS, (False, True),
            (False, True), (False, True), LAYOUT_PAIRS]
    rnd = random.Random(seed)
    full = list(itertools.product(*axes))
    cases = rnd.sample(full, n_cases)
    for a, vals in enumerate(axes):
        for v in vals:
            if not any(c[a] == v for c in cases):
                cases.append(next(c for c in full if c[a] == v))
    return cases


CASES = _grid(48)


def _case_id(c):
    lay, s, p, f, pool, relu, bias, res, (src, dst) = c
    ptag = "nopool" if pool is None else f"{pool[2]}{pool[0]}s{pool[1]}"
    return (f"{lay}-S{s}-P{p}-F{f}-{ptag}-{'relu' if relu else 'lin'}"
            f"{'-bias' if bias else ''}{'-res' if res else ''}-{src}to{dst}")


def _inputs(case, seed: int):
    """numpy (x NCHW, w OIHW, bias, res NCHW, res_layout) for one case; the
    image is sized so the conv output is 5..7 rows (pooled >= 1)."""
    lay, S, pad, F, pool, relu, bias, res, _ = case
    rng = np.random.default_rng(seed)
    N, Ci, Co = int(rng.integers(1, 4)), int(rng.integers(1, 6)), \
        int(rng.choice([4, 7, 16, 20]))
    Ho = int(rng.integers(5, 8))
    H = max(1, (Ho - 1) * S + F - 2 * pad + int(rng.integers(0, S)))
    Ho = (H + 2 * pad - F) // S + 1
    x = rng.standard_normal((N, Ci, H, H), np.float32)
    w = rng.standard_normal((Co, Ci, F, F), np.float32) / np.sqrt(Ci * F * F)
    b = rng.standard_normal((Co,), np.float32) if bias else None
    r = rng.standard_normal((N, Co, Ho, Ho), np.float32) if res else None
    res_layout = ("NCHW", "CHWN")[int(rng.integers(0, 2))]
    return x, w.astype(np.float32), b, r, res_layout


def _to(layout: str, a_nchw: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a_nchw.transpose(perm_between("NCHW",
                                                              layout)))


def _run_both(case, seed, ref_impl="xla", port_impl="cuda"):
    lay, S, pad, F, pool, relu, bias, res, (src, dst) = case
    x, w, b, r, rlay = _inputs(case, seed)
    xs = _to(src, x)
    rs = _to(rlay, r) if r is not None else None
    ref = ref_layers.fused_conv_block(
        jnp.asarray(xs), jnp.asarray(w), lay, S, pad,
        bias=None if b is None else jnp.asarray(b), relu=relu, pool=pool,
        res=None if rs is None else jnp.asarray(rs), res_layout=rlay,
        src_layout=src, dst_layout=dst, impl=ref_impl)

    def t(a):
        return None if a is None else torch.from_numpy(a)

    got = port_layers.fused_conv_block(
        t(xs), t(w), lay, S, pad, bias=t(b), relu=relu, pool=pool,
        res=t(rs), res_layout=rlay, src_layout=src, dst_layout=dst,
        impl=port_impl)
    return np.asarray(ref), got.cpu().numpy()


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_conv_block_matches_reference_xla(case):
    seed = CASES.index(case)
    ref, got = _run_both(case, seed)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    # the "torch" engine is the same plain version, called directly
    _, plain = _run_both(case, seed, port_impl="torch")
    np.testing.assert_array_equal(plain, got)


PALLAS_CASES = [
    ("CHWN", 1, 1, 3, (2, 2, "max"), True, True, False, ("NCHW", "NCHW")),
    ("NCHW", 2, 2, 5, (3, 2, "max"), True, False, True, ("CHWN", "CHWN")),
    ("CHWN", 4, 0, 11, (2, 2, "avg"), False, True, True, ("NCHW", "CHWN")),
    ("NCHW", 1, 0, 1, None, True, False, False, ("NCHW", "CHWN")),
]


@pytest.mark.parametrize("case", PALLAS_CASES,
                         ids=[_case_id(c) for c in PALLAS_CASES])
def test_conv_block_matches_reference_pallas(case):
    """Against the reference's Pallas kernels (interpret mode)."""
    ref, got = _run_both(case, 1000 + PALLAS_CASES.index(case),
                         ref_impl="pallas")
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_wrappers_reject_other_devices_and_bad_shapes():
    x = torch.zeros((2, 3, 8, 8), device="meta")
    w = torch.zeros((4, 3, 3, 3), device="meta")
    with pytest.raises(ValueError, match="not supported"):
        conv_ops.conv_im2col_nchw_fused(x, w)
    with pytest.raises(ValueError, match="w must be"):
        conv_ops.conv_direct_chwn(torch.zeros(3, 8, 8, 2), torch.zeros(3, 3))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build._nvcc()


def test_cpu_wrappers_launch_nothing():
    before = (conv_ops.conv_direct_chwn.launches,
              conv_ops.conv_im2col_nchw_fused.launches)
    _run_both(CASES[0], 0)
    assert (conv_ops.conv_direct_chwn.launches,
            conv_ops.conv_im2col_nchw_fused.launches) == before

