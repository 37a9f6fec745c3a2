"""Port tiled matmul (K10) and the matrix-expansion and FFT convs against
the reference's.

The same seeded numpy inputs go through ``repro.kernels.matmul`` /
``repro.kernels.conv`` (the Pallas matmul in interpret mode) and the port's
wrappers, which run their plain versions on the CPU
(``test_torch_lm_kernels_card.py`` holds the CUDA kernel against them on
the card).  Tolerances are the reference's own (``tests/test_kernels.py``):
matmul rtol 2e-5 / atol 2e-4, the im2col conv rtol 1e-4 / atol 1e-3, the
FFT conv rtol 1e-3 / atol 1e-2.  bf16 products: 8 * BF16_EPS (rtol and
atol), one bf16 rounding of an fp32 sum that the two packages add in
different orders (``tests/test_bf16.py`` holds bf16 outputs to 8 *
BF16_EPS).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cnn.layers import conv_forward as ref_conv_forward
from repro.configs.paper_table1 import CONV_LAYERS as REF_TABLE1
from repro.kernels.conv.ops import conv_fft_nchw as ref_conv_fft
from repro.kernels.conv.ops import conv_im2col_nchw as ref_conv_im2col
from repro.kernels.conv.ref import im2col_nchw as ref_im2col
from repro.kernels.matmul.ops import matmul as ref_matmul

from repro_torch.cnn.layers import conv_forward
from repro_torch.configs.paper_table1 import CONV_LAYERS
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.conv.ops import conv_fft_nchw, conv_im2col_nchw
from repro_torch.kernels.conv.ref import conv_ref, im2col_nchw
from repro_torch.kernels.matmul.ops import matmul
from repro_torch.kernels.matmul.ref import matmul_ref

BF16_EPS = 2.0 ** -8
MATMUL_SHAPES = [(256, 256, 256), (100, 300, 50), (8, 1024, 128), (1, 7, 3)]
# the reference's CONV_CASES: (Ci, H, W, N, F, Co, S, pad)
CONV_CASES = [(1, 28, 28, 32, 5, 16, 1, 0), (16, 14, 14, 64, 5, 16, 1, 2),
              (3, 32, 32, 32, 3, 8, 2, 0), (8, 13, 13, 32, 3, 16, 1, 1)]
# two Table-1 layers at batch 2: lenet's CV2 (K = 400) and zfnet's CV7
# (K = 2304, the reduction of the deep layers)
TABLE1_CASES = ["CV2", "CV7"]


def _np(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _conv_inputs(N, Ci, H, W, F, Co, seed):
    return (_np((N, Ci, H, W), seed),
            _np((Co, Ci, F, F), seed + 1, 0.1))


@pytest.mark.parametrize("m,k,n", MATMUL_SHAPES,
                         ids=lambda v: str(v))
def test_matmul_matches_reference(m, k, n):
    x, y = _np((m, k), m + k), _np((k, n), k + n)
    want = np.asarray(ref_matmul(jnp.asarray(x), jnp.asarray(y)))
    got = matmul(torch.from_numpy(x), torch.from_numpy(y))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("m,k,n", MATMUL_SHAPES,
                         ids=lambda v: str(v))
def test_matmul_bf16_matches_reference(m, k, n):
    x = _np((m, k), 3 * m + k, 1.0 / np.sqrt(k))
    y = _np((k, n), 3 * k + n)
    want = np.asarray(ref_matmul(jnp.asarray(x, jnp.bfloat16),
                                 jnp.asarray(y, jnp.bfloat16))
                      .astype(jnp.float32))
    got = matmul(torch.from_numpy(x).bfloat16(),
                 torch.from_numpy(y).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want,
                               rtol=8 * BF16_EPS, atol=8 * BF16_EPS)


def test_matmul_takes_strided_views_and_checks_shapes():
    x, y = _np((40, 27), 1), _np((64, 27), 2)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    got = matmul(xt, yt.T)                      # y as a transposed view
    np.testing.assert_allclose(got.numpy(), x @ y.T, rtol=2e-5, atol=2e-4)
    torch.testing.assert_close(matmul_ref(xt, yt.T), got)
    with pytest.raises(ValueError, match=r"x \[M, K\] and y \[K, N\]"):
        matmul(xt, yt)
    with pytest.raises(ValueError, match="not supported"):
        matmul(xt.to("meta"), yt.T.to("meta"))


@pytest.mark.parametrize("Ci,H,W,N,F,Co,S,pad", CONV_CASES)
def test_im2col_patches_match_reference(Ci, H, W, N, F, Co, S, pad):
    x, _ = _conv_inputs(N, Ci, H, W, F, Co, Ci + H)
    want, want_dims = ref_im2col(jnp.asarray(x), F, S, pad)
    got, dims = im2col_nchw(torch.from_numpy(x), F, S, pad)
    assert dims == tuple(want_dims)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("use_kernel_mm", [True, False])
@pytest.mark.parametrize("Ci,H,W,N,F,Co,S,pad", CONV_CASES)
def test_conv_im2col_matches_reference(Ci, H, W, N, F, Co, S, pad,
                                       use_kernel_mm):
    x, w = _conv_inputs(N, Ci, H, W, F, Co, 7 * Ci + H)
    want = np.asarray(ref_conv_im2col(jnp.asarray(x), jnp.asarray(w),
                                      stride=S, pad=pad,
                                      use_pallas_mm=use_kernel_mm))
    reset_launch_counts()
    got = conv_im2col_nchw(torch.from_numpy(x), torch.from_numpy(w), S, pad,
                           use_kernel_mm=use_kernel_mm)
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)
    assert launch_counts()["matmul"] == 0       # CPU tensors: plain version


@pytest.mark.parametrize("name", TABLE1_CASES)
def test_conv_im2col_on_table1_layers_matches_reference(name):
    layer = next(c for c in CONV_LAYERS if c.name == name)
    assert repr(layer) == repr(next(c for c in REF_TABLE1 if c.name == name))
    x, w = _conv_inputs(2, layer.Ci, layer.HW, layer.HW, layer.F, layer.Co,
                        layer.Co)
    w = w / np.float32(np.sqrt(layer.Ci * layer.F * layer.F) * 0.1)
    want = np.asarray(ref_conv_im2col(jnp.asarray(x), jnp.asarray(w),
                                      stride=layer.S, pad=layer.pad))
    got = conv_im2col_nchw(torch.from_numpy(x), torch.from_numpy(w), layer.S,
                           layer.pad)
    assert got.shape == (2, layer.Co, layer.out_hw, layer.out_hw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(
        got.numpy(), conv_ref(torch.from_numpy(x), torch.from_numpy(w),
                              layer.S, layer.pad).numpy(),
        rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("Ci,H,W,N,F,Co,S,pad", CONV_CASES)
def test_conv_fft_matches_reference(Ci, H, W, N, F, Co, S, pad):
    x, w = _conv_inputs(N, Ci, H, W, F, Co, 11 * Ci + H)
    want = np.asarray(ref_conv_fft(jnp.asarray(x), jnp.asarray(w), stride=S,
                                   pad=pad))
    got = conv_fft_nchw(torch.from_numpy(x), torch.from_numpy(w), S, pad)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-2)
    np.testing.assert_allclose(
        got.numpy(), conv_ref(torch.from_numpy(x), torch.from_numpy(w), S,
                              pad).numpy(), rtol=1e-3, atol=1e-2)


@pytest.mark.parametrize("Ci,H,W,N,F,Co,S,pad", CONV_CASES[:2])
def test_conv_forward_fft_matches_reference(Ci, H, W, N, F, Co, S, pad):
    x, w = _conv_inputs(N, Ci, H, W, F, Co, 13 * Ci + H)
    want = np.asarray(ref_conv_forward(jnp.asarray(x), jnp.asarray(w),
                                       "NCHW", S, pad, impl="fft"))
    got = conv_forward(torch.from_numpy(x), torch.from_numpy(w), "NCHW", S,
                       pad, impl="fft")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-2)


def test_conv_forward_fft_refuses_chwn():
    x = torch.zeros(3, 8, 8, 2)
    w = torch.zeros(4, 3, 3, 3)
    with pytest.raises(ValueError, match="bound to NCHW"):
        conv_forward(x, w, "CHWN", 1, 0, impl="fft")
