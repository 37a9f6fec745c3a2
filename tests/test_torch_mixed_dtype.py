"""Mixed-dtype (int8 boundary) execution in the port against the reference.

(a) K1 and K2 with int8 input (per-channel quantized activations, the
scale folded into float32 or bf16 weights): the plain versions on CPU
tensors against the reference's Pallas kernels in interpret mode, on the
same int8 values.  float32 weights: the fp32 kernels' tolerance, rtol
1e-4 / atol 1e-3; bf16 weights (a bf16 output): one bf16 step,
|got - want| <= 2^-7 |want| + 1e-5 max|want|.
(b) The reference test's three-conv net (``tests/test_mixed_dtype.py``
NET3) under the reference planner's mixed plan at base float32 (conv2's
output stores int8), carried over: the port's ``forward_fused`` against the
reference's Pallas (interpret) and xla forwards within
``INT8_FORWARD_ATOL`` (2e-2; the largest difference seen is far below),
the int8 boundary the same level on at least 99.9 % of its entries and
within one level on all, ``RunStats`` equal field for field, and against
the port's uniform float32 forward within ``INT8_FORWARD_ATOL``, with the
boundary's bytes priced at 1 byte an element.  The same at base bf16.
(c) The straight-through mixed training step stays differentiable: five
SGD steps on the float32 carrier lower the loss, whose first value is
the reference's.
(d) ``CNNServer(dtype="bf16", dtype_policy="mixed")`` on the CPU
(analytic thresholds): int8 in the plans, both threshold rows, the
report line, and answers within ``INT8_FORWARD_ATOL`` of a bf16 uniform
server's.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.cnn.network as ref_network
from repro.cnn.network import forward_fused as ref_forward_fused
from repro.cnn.network import loss_fn_fused as ref_loss_fn_fused
from repro.cnn.network import plan_network_fused as ref_plan_fused
from repro.configs.base import CNNConfig as RefCNNConfig
from repro.configs.base import ConvSpec as RefConvSpec
from repro.kernels.conv import ops as ref_ops

import repro_torch.cnn.network as port_network
from repro_torch.cnn.layers import init_cnn, params_from_numpy
from repro_torch.cnn.network import (forward_fused, init_velocity,
                                     input_shape, loss_fn_fused,
                                     make_train_step_fused)
from repro_torch.configs.base import CNNConfig, ConvSpec
from repro_torch.core.layout import perm_between
from repro_torch.kernels.conv import ops as conv_ops
from repro_torch.launch.cnn_serve import CNNServer, ImageRequest
from repro_torch.quant import INT8_FORWARD_ATOL
from repro_torch.serve.plan_cache import _plan_from_obj

CONV_RTOL, CONV_ATOL = 1e-4, 1e-3
BF16_STEP = 2.0 ** -7
LEVEL_SHARE = 0.999      # int8 boundary entries at the same level


def _layers(conv, pool):
    return (
        conv("conv1", 16, 3, 1, 1), conv("relu1", 0, 0, kind="relu"),
        pool("pool1", 2, 2),
        conv("conv2", 32, 3, 1, 1), conv("relu2", 0, 0, kind="relu"),
        conv("conv3", 32, 3, 1, 1), conv("relu3", 0, 0, kind="relu"),
        pool("pool2", 2, 2),
        conv("flatten", 0, 0, kind="flatten"),
        conv("fc1", 0, 0, kind="fc"),
        conv("softmax", 0, 0, kind="softmax"))


def _net3(cfg_cls, spec_cls):
    """NET3 of the reference's ``tests/test_mixed_dtype.py``: three conv
    chains, the middle one's output int8-eligible."""
    def conv(name, co, k, s=1, p=0, kind="conv"):
        if kind == "conv":
            return spec_cls(name, "conv", out_channels=co, kernel=k,
                            stride=s, pad=p)
        if kind == "fc":
            return spec_cls(name, "fc", fc_out=10)
        return spec_cls(name, kind)

    def pool(name, k, s):
        return spec_cls(name, "pool", kernel=k, stride=s, pool_op="max")

    return cfg_cls(name="net3", batch=2, in_channels=3, image_hw=16,
                   num_classes=10, layers=_layers(conv, pool))


NET3 = _net3(CNNConfig, ConvSpec)
REF_NET3 = _net3(RefCNNConfig, RefConvSpec)


def _to(layout, a):
    return np.ascontiguousarray(a.transpose(perm_between("NCHW", layout)))


def _np(t):
    return (t.float().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(jnp.asarray(t).astype(jnp.float32)))


def _assert_bf16_close(got, want):
    got, want = got.astype(np.float64), want.astype(np.float64)
    bound = BF16_STEP * np.abs(want) + 1e-5 * np.abs(want).max()
    assert np.all(np.abs(got - want) <= bound)


# (engine, w dtype, N, Ci, H, Co, F, S, pad, pool, res, src, dst)
INT8_CASES = [
    ("CHWN", "float32", 4, 8, 9, 12, 3, 1, 1, (2, 2, "max"), False, "CHWN",
     "CHWN"),
    ("CHWN", "bfloat16", 3, 6, 8, 7, 3, 1, 1, None, True, "NCHW", "CHWN"),
    ("CHWN", "bfloat16", 5, 3, 11, 16, 5, 2, 2, (3, 2, "max"), False,
     "CHWN", "NCHW"),
    ("NCHW", "float32", 2, 5, 10, 9, 3, 1, 1, None, True, "NCHW", "NCHW"),
    ("NCHW", "bfloat16", 3, 8, 8, 12, 1, 1, 0, (2, 2, "avg"), False, "CHWN",
     "NCHW"),
    ("NCHW", "bfloat16", 1, 16, 9, 20, 3, 1, 1, (2, 2, "max"), True, "NCHW",
     "CHWN"),
]


@pytest.mark.parametrize("case", INT8_CASES)
def test_int8_input_conv_matches_reference_kernel(case):
    eng, wdt, N, Ci, H, Co, F, S, pad, pool, res, src, dst = case
    rng = np.random.default_rng(INT8_CASES.index(case))
    Ho = (H + 2 * pad - F) // S + 1
    q = _to(src, rng.integers(-127, 128, (N, Ci, H, H)).astype(np.int8))
    w = (rng.standard_normal((Co, Ci, F, F), np.float32)
         / np.float32(127 * np.sqrt(Ci * F * F)))
    b = rng.standard_normal((Co,), np.float32)
    r = rng.standard_normal((N, Co, Ho, Ho), np.float32) if res else None
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[wdt]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[wdt]

    def t(a):
        return None if a is None else torch.from_numpy(a).to(tdt)

    def j(a):
        return None if a is None else jnp.asarray(a).astype(jdt)

    kw = dict(relu=True, pool=pool, res_layout="NCHW", src_layout=src,
              dst_layout=dst)
    if eng == "CHWN":
        want = ref_ops.conv_direct_chwn(
            jnp.asarray(q), jnp.transpose(j(w), (1, 2, 3, 0)), S, pad, 2,
            True, bias=j(b), res=j(r), **kw)
        got = conv_ops.conv_direct_chwn(
            torch.from_numpy(q), t(w).permute(1, 2, 3, 0).contiguous(), S,
            pad, bias=t(b), res=t(r), **kw)
    else:
        want = ref_ops.conv_im2col_nchw_fused(
            jnp.asarray(q), j(w), S, pad, True, bias=j(b), res=j(r), **kw)
        got = conv_ops.conv_im2col_nchw_fused(
            torch.from_numpy(q), t(w), S, pad, bias=t(b), res=t(r), **kw)
    assert got.dtype == tdt and want.dtype == jdt
    if wdt == "float32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=CONV_RTOL,
                                   atol=CONV_ATOL)
    else:
        _assert_bf16_close(_np(got), _np(want))


def _record(module, monkeypatch):
    """Wrap ``module.quantize`` to keep every (int8 values, scale) it
    returns: the int8 boundaries of a forward."""
    seen = []
    real = module.quantize

    def quantize(x, axis):
        q, s = real(x, axis)
        seen.append(_np(q).astype(np.int32))
        return q, s

    monkeypatch.setattr(module, "quantize", quantize)
    return seen


def _plans(dtype="float32"):
    ref_u = ref_plan_fused(REF_NET3, dtype=dtype, stack_policy="off")
    ref_m = ref_plan_fused(REF_NET3, dtype=dtype, policy="mixed")
    port = [_plan_from_obj(dataclasses.asdict(p)) for p in (ref_u, ref_m)]
    return ref_u, ref_m, port[0], port[1]


def _jparams(tree, dtype):
    return {k: {n: jnp.asarray(v).astype(dtype) for n, v in d.items()}
            for k, d in tree.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_net3_mixed_forward_matches_reference(dtype, monkeypatch):
    ref_u, ref_m, plan_u, plan_m = _plans(dtype)
    sig = "f8f" if dtype == "float32" else "b8b"
    assert plan_m.dtype_signature == sig       # conv2's output stores int8
    tree = init_cnn(NET3, 0)
    x = np.random.default_rng(1).standard_normal(input_shape(NET3),
                                                 np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    params = params_from_numpy(tree, "cpu", dtype)
    xt = torch.from_numpy(x).to(tdt)
    port_q = _record(port_network, monkeypatch)
    ym, sm = forward_fused(params, xt, NET3, plan_m)
    assert ym.dtype == tdt
    assert len(port_q) == 1
    ref_q = _record(ref_network, monkeypatch)
    diffs = {}
    for impl in ("pallas", "xla"):
        ry, rst = ref_forward_fused(_jparams(tree, jdt),
                                    jnp.asarray(x).astype(jdt), REF_NET3,
                                    ref_m, impl=impl)
        diffs[impl] = float(np.abs(_np(ym) - _np(ry)).max())
        assert diffs[impl] <= INT8_FORWARD_ATOL, diffs
        assert dataclasses.asdict(sm) == dataclasses.asdict(rst)
        # the stored int8 boundary: the same levels but for rounding ties
        lv = np.abs(port_q[0] - ref_q[-1])
        assert lv.shape == port_q[0].shape
        assert lv.max() <= 1
        assert (lv == 0).mean() >= LEVEL_SHARE, (lv == 0).mean()
    # mixed against uniform at the same base dtype
    yu, su = forward_fused(params, xt, NET3, plan_u)
    diff = float(np.abs(_np(ym) - _np(yu)).max())
    assert 0.0 < diff <= INT8_FORWARD_ATOL, diff
    # conv2's output [2, 32, 8, 8] crosses memory twice at 1 byte, not db
    boundary = 2 * 32 * 8 * 8
    db = 4 if dtype == "float32" else 2
    assert su.hbm_bytes - sm.hbm_bytes == 2 * (db - 1) * boundary


def test_int8_into_a_nonconv_op_is_dequantized():
    """A hand-built plan whose last conv stores int8 into the flatten (no
    plan does that) dequantizes before the float ops, as the reference's
    executor does: the same probabilities within the int8 tolerance and
    the same ``RunStats``."""
    _, ref_m, _, _ = _plans()
    i = max(i for i, op in enumerate(ref_m.ops) if op.kind == "conv")
    assert ref_m.ops[i + 1].kind != "conv"
    ref_h = dataclasses.replace(ref_m, ops=ref_m.ops[:i] + [
        dataclasses.replace(ref_m.ops[i], dst_dtype="int8")]
        + ref_m.ops[i + 1:])
    plan_h = _plan_from_obj(dataclasses.asdict(ref_h))
    tree = init_cnn(NET3, 0)
    x = np.random.default_rng(2).standard_normal(input_shape(NET3),
                                                 np.float32)
    y, st = forward_fused(params_from_numpy(tree, "cpu"),
                          torch.from_numpy(x), NET3, plan_h)
    ry, rst = ref_forward_fused(jax.tree.map(jnp.asarray, tree),
                                jnp.asarray(x), REF_NET3, ref_h, impl="xla")
    assert y.dtype == torch.float32
    assert float(np.abs(_np(y) - _np(ry)).max()) <= INT8_FORWARD_ATOL
    assert dataclasses.asdict(st) == dataclasses.asdict(rst)


def test_mixed_training_step_differentiable():
    """Five SGD steps through the straight-through int8 boundary (float32
    carrier): the loss goes down and stays finite, the parameters stay
    float32, and the first loss is the reference's at the same
    parameters."""
    _, ref_m, _, plan_m = _plans()
    tree = init_cnn(NET3, 0)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(input_shape(NET3), np.float32)
    labels = rng.integers(0, NET3.num_classes, NET3.batch)
    params = params_from_numpy(tree, "cpu")
    xt, yt = torch.from_numpy(x), torch.from_numpy(labels)
    loss0 = float(loss_fn_fused(params, xt, yt, NET3, plan_m))
    ref0 = float(ref_loss_fn_fused(jax.tree.map(jnp.asarray, tree),
                                   jnp.asarray(x), jnp.asarray(labels),
                                   REF_NET3, ref_m, impl="xla"))
    assert abs(loss0 - ref0) <= 1e-4, (loss0, ref0)
    step = make_train_step_fused(NET3, plan_m)
    p, v = params, init_velocity(params)
    losses = []
    for _ in range(5):
        p, v, loss = step(p, v, xt, yt)
        losses.append(float(loss))
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    assert all(t.dtype == torch.float32 for d in p.values()
               for t in d.values())


def test_server_bf16_mixed_on_cpu():
    kw = dict(reduced=True, max_bucket=8, device="cpu", seed=0,
              calibration="analytic", dtype="bf16")
    srv = CNNServer("alexnet", dtype_policy="mixed", **kw)
    uni = CNNServer("alexnet", dtype_policy="uniform", stack="off", **kw)
    assert srv.rows == ["bfloat16", "int8"]
    assert srv.model.layers["conv1"]["w"].dtype == torch.bfloat16
    rng = np.random.default_rng(4)
    c, h = srv.cfg.in_channels, srv.cfg.image_hw
    images = [rng.standard_normal((c, h, h), np.float32) for _ in range(6)]
    got = srv.run([ImageRequest(i, im) for i, im in enumerate(images)])
    want = uni.run([ImageRequest(i, im) for i, im in enumerate(images)])
    diff = max(float(np.abs(got[i] - want[i]).max()) for i in got)
    assert diff <= INT8_FORWARD_ATOL, diff
    for p in got.values():
        assert np.isfinite(p).all() and abs(p.sum() - 1) < 0.05
    lines = srv.report_lines()
    head = lines[0]
    assert "dtype=bfloat16 policy=mixed" in head
    assert "thresholds[bfloat16]=Ct:" in head
    assert "thresholds[int8]=Ct:" in head
    assert any("conv_dtypes=" in ln and "8" in ln.split("conv_dtypes=")[1]
               .split()[0] for ln in lines[1:])
