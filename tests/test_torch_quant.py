"""Port ``repro_torch.quant`` against the reference ``repro.quant``.

The same seeded float32 inputs go through both packages' ``quantize``:
the int8 values and the per-channel scales must be bitwise equal (both
divide in float32 and round half to even), and so must ``dequantize``,
``fold_scale_into_weights`` (in float32 and in bf16, where the cast back
rounds) and ``fake_quant``'s forward value.  Then the port's own
identities, as the reference's tests state them: the fold-scale rewrite
(``conv(dequant(q), w) == conv(q, fold(w))`` within 1e-5) and the
straight-through gradient (exact to 1e-6).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import dtypes as ref_dtypes
from repro import quant as ref_quant

from repro_torch import dtypes as port_dtypes
from repro_torch import quant
from repro_torch.cnn.layers import conv_forward

# (shape, channel axis): NCHW and CHWN activations, a vector of channels
QUANT_CASES = [((2, 8, 6, 6), 1), ((8, 5, 5, 3), 0), ((4, 3, 7, 7), -3),
               ((16, 33), 1), ((3, 2, 2, 9), 1)]


def _x(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape, np.float32) * np.float32(3.0)
    return x


def _ref_np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("shape,axis", QUANT_CASES)
def test_quantize_bitwise_equal_to_reference(shape, axis):
    x = _x(shape, len(shape) + abs(axis))
    # a channel of zeros (scale 1) and exact half levels (ties to even)
    idx = [slice(None)] * len(shape)
    idx[axis] = 0
    x[tuple(idx)] = 0.0
    q, s = quant.quantize(torch.from_numpy(x), axis)
    rq, rs = ref_quant.quantize(jnp.asarray(x), axis)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    assert s.numpy()[0] == 1.0
    deq = quant.dequantize(q, s, axis)
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(ref_quant.dequantize(rq, rs, axis)))
    bound = np.abs(x).max(axis=tuple(a for a in range(x.ndim)
                                     if a != axis % x.ndim))
    assert np.all(np.abs(q.numpy().astype(np.int32)) <= 127)
    assert np.all(np.abs(deq.numpy() - x) <= np.expand_dims(
        s.numpy() / 2 + 1e-7, [a for a in range(x.ndim) if a != axis % x.ndim]))
    assert np.all(bound >= 0)


def test_quantize_rounds_ties_to_even():
    s = np.float32(1.0 / 127.0)
    # channel max 127 levels exactly, so the scale is 1/127 and these are
    # k + 0.5 levels: even k stays, odd k rounds up
    levels = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5], np.float32)
    x = (levels * s)[None, :].T.copy()      # [6, 1], channel axis 1
    q, _ = quant.quantize(torch.from_numpy(x), 1)
    rq, _ = ref_quant.quantize(jnp.asarray(x), 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fold_scale_into_weights_bitwise_equal_to_reference(dtype):
    rng = np.random.default_rng(7)
    w = rng.standard_normal((4, 8, 3, 3), np.float32)
    scale = np.abs(rng.standard_normal((8,), np.float32)) / 127
    tw = torch.from_numpy(w).to(port_dtypes.torch_dtype(dtype))
    jw = jnp.asarray(w).astype(ref_dtypes.jnp_dtype(dtype))
    got = quant.fold_scale_into_weights(tw, torch.from_numpy(scale))
    want = ref_quant.fold_scale_into_weights(jw, jnp.asarray(scale))
    assert got.dtype == tw.dtype
    np.testing.assert_array_equal(got.float().numpy(), _ref_np(want))


def test_fold_scale_into_weights_exact():
    """conv(q * s[ci], w) == conv(q, s[ci] * w[ci]): the per-channel scale
    factors out of the channel contraction (the port's plain conv takes
    int8 x)."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 8, 6, 6), np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 8, 3, 3), np.float32))
    q, scale = quant.quantize(x, 1)
    y_deq = conv_forward(quant.dequantize(q, scale, 1), w, "NCHW",
                         impl="torch")
    y_fold = conv_forward(q, quant.fold_scale_into_weights(w, scale), "NCHW",
                          impl="torch")
    assert y_fold.dtype == torch.float32
    np.testing.assert_allclose(y_fold.numpy(), y_deq.numpy(), atol=1e-5)
    # and the CHWN engine's plain version takes int8 x too
    y_chwn = conv_forward(q.permute(1, 2, 3, 0).contiguous(),
                          quant.fold_scale_into_weights(w, scale), "CHWN",
                          impl="cuda")
    np.testing.assert_allclose(y_chwn.permute(3, 0, 1, 2).numpy(),
                               y_deq.numpy(), atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fake_quant_value_equal_to_reference(dtype):
    x = _x((4, 3, 5, 5), 3)
    got = quant.fake_quant(
        torch.from_numpy(x).to(port_dtypes.torch_dtype(dtype)), 1)
    want = ref_quant.fake_quant(
        jnp.asarray(x).astype(ref_dtypes.jnp_dtype(dtype)), 1)
    np.testing.assert_array_equal(got.float().numpy(), _ref_np(want))


def test_fake_quant_straight_through_gradient():
    x = torch.from_numpy(_x((4, 3, 5, 5), 0)).requires_grad_(True)
    (g,) = torch.autograd.grad((quant.fake_quant(x, 1) ** 2).sum(), x)
    # STE: d/dx sum(fq(x)^2) == 2 fq(x) exactly (identity through the cast)
    np.testing.assert_allclose(g.numpy(),
                               (2 * quant.fake_quant(x, 1)).detach().numpy(),
                               atol=1e-6)
    rg = jax.grad(lambda t: jnp.sum(ref_quant.fake_quant(t, 1) ** 2))(
        jnp.asarray(x.detach().numpy()))
    np.testing.assert_allclose(g.numpy(), np.asarray(rg), atol=1e-6)


def test_constants_match_reference():
    assert quant.QMAX == ref_quant.QMAX
    assert quant.INT8_FORWARD_ATOL == ref_quant.INT8_FORWARD_ATOL


@pytest.mark.parametrize("name", ["float32", "fp32", "bf16", "bfloat16",
                                  "float16", "f16", "int8", "i8"])
def test_is_float_dtype_matches_reference(name):
    assert port_dtypes.FLOAT_DTYPES == ref_dtypes.FLOAT_DTYPES
    assert (port_dtypes.is_float_dtype(name)
            == ref_dtypes.is_float_dtype(name))
    assert port_dtypes.is_float_dtype(name) == (
        port_dtypes.canon_dtype(name) != "int8")
