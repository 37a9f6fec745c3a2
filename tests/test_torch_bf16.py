"""bf16 storage in the port against the reference, on the CPU.

(a) The kernels' plain versions in bf16 (K1 ``conv_direct_chwn``, K2
``conv_im2col_nchw_fused``, K5a ``conv_stack_chwn`` and K4 ``softmax``, on
CPU tensors) against the reference's Pallas kernels in interpret mode on
the same seeded bf16 inputs.  Both sides accumulate in float32 and round
once to bf16, so they may differ by one bf16 step:
|got - want| <= 2^-7 |want| + 1e-5 max|want|.  The stack's mid activation
stays float32 on both sides (the plain version is checked to be exactly
two float32-mid convs, not two bf16 ones).
(b) ``forward_fused`` in bf16 on LeNet (the reference planner's bf16 plan,
carried over) against the reference's bf16 Pallas forward on the same
plan and weights: probabilities within 2^-7 + 1e-5 (one bf16 step of a
probability below 1), ``RunStats`` equal; and against the port's own
float32 forward within 8 * eps(bf16) = 0.0625, the reference's bound
(``tests/test_bf16.py``), with no standalone transform.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cnn.network import forward_fused as ref_forward_fused
from repro.cnn.network import plan_network_fused as ref_plan_fused
from repro.configs.cnn_networks import CNN_CONFIGS as REF_CONFIGS
from repro.kernels.conv import ops as ref_ops
from repro.kernels.softmax.ops import softmax as ref_softmax

from repro_torch.cnn import layers as port_layers
from repro_torch.cnn.layers import init_cnn, params_from_numpy
from repro_torch.cnn.network import forward_fused, input_shape
from repro_torch.configs.cnn_networks import CNN_CONFIGS
from repro_torch.core.layout import perm_between
from repro_torch.kernels.conv import ops as conv_ops
from repro_torch.kernels.conv.ref import conv_ref, conv_stack_ref
from repro_torch.kernels.softmax.ops import softmax
from repro_torch.serve.plan_cache import _plan_from_obj

BF16_STEP = 2.0 ** -7            # eps(bf16): one step relative to a value
BF16_EPS = 2.0 ** -7
BF16_PROBS_ATOL = 8 * BF16_EPS   # bf16 against fp32, the reference's bound
OTHER = {"NCHW": "CHWN", "CHWN": "NCHW"}


def assert_bf16_close(got: np.ndarray, want: np.ndarray) -> float:
    """|got - want| <= 2^-7 |want| + 1e-5 max|want|; returns the largest
    |got - want|."""
    got, want = got.astype(np.float64), want.astype(np.float64)
    assert got.shape == want.shape
    bound = BF16_STEP * np.abs(want) + 1e-5 * np.abs(want).max()
    err = np.abs(got - want)
    assert np.all(err <= bound), float((err - bound).max())
    return float(err.max())


def _to(layout, a):
    return np.ascontiguousarray(a.transpose(perm_between("NCHW", layout)))


def _bf(a):
    """numpy float32 -> (torch bf16, jnp bf16), the same values."""
    if a is None:
        return None, None
    return (torch.from_numpy(a).to(torch.bfloat16),
            jnp.asarray(a).astype(jnp.bfloat16))


def _np(t):
    return (t.float().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(jnp.asarray(t).astype(jnp.float32)))


# (engine, N, Ci, H, Co, F, S, pad, pool, relu, bias, res, src, dst)
CONV_CASES = [
    ("CHWN", 3, 5, 9, 7, 3, 1, 1, (2, 2, "max"), True, True, False,
     "CHWN", "CHWN"),
    ("CHWN", 2, 3, 11, 16, 5, 2, 2, None, True, False, True, "NCHW",
     "CHWN"),
    ("CHWN", 5, 4, 8, 20, 3, 1, 0, (2, 2, "avg"), False, True, True,
     "CHWN", "NCHW"),
    ("NCHW", 2, 3, 10, 9, 3, 1, 1, (2, 2, "max"), True, True, False,
     "NCHW", "NCHW"),
    ("NCHW", 3, 8, 7, 12, 1, 1, 0, None, True, False, True, "CHWN",
     "NCHW"),
    ("NCHW", 1, 6, 13, 5, 3, 2, 1, (3, 2, "max"), False, True, True,
     "NCHW", "CHWN"),
]


def _conv_inputs(case, seed):
    eng, N, Ci, H, Co, F, S, pad, pool, relu, bias, res, src, dst = case
    rng = np.random.default_rng(seed)
    Ho = (H + 2 * pad - F) // S + 1
    x = rng.standard_normal((N, Ci, H, H), np.float32)
    w = rng.standard_normal((Co, Ci, F, F), np.float32) / np.sqrt(Ci * F * F)
    b = rng.standard_normal((Co,), np.float32) if bias else None
    rlay = OTHER[eng] if seed % 2 else eng
    r = (_to(rlay, rng.standard_normal((N, Co, Ho, Ho), np.float32))
         if res else None)
    return _to(src, x), w.astype(np.float32), b, r, rlay


@pytest.mark.parametrize("case", CONV_CASES)
def test_bf16_conv_matches_reference_kernel(case):
    eng, N, Ci, H, Co, F, S, pad, pool, relu, bias, res, src, dst = case
    x, w, b, r, rlay = _conv_inputs(case, CONV_CASES.index(case))
    (tx, jx), (tw, jw), (tb, jb), (tr, jr) = map(_bf, (x, w, b, r))
    kw = dict(relu=relu, pool=pool, res_layout=rlay, src_layout=src,
              dst_layout=dst)
    if eng == "CHWN":
        want = ref_ops.conv_direct_chwn(
            jx, jnp.transpose(jw, (1, 2, 3, 0)), S, pad, 2, True, bias=jb,
            res=jr, **kw)
        got = conv_ops.conv_direct_chwn(
            tx, tw.permute(1, 2, 3, 0).contiguous(), S, pad, bias=tb,
            res=tr, **kw)
    else:
        want = ref_ops.conv_im2col_nchw_fused(jx, jw, S, pad, True, bias=jb,
                                              res=jr, **kw)
        got = conv_ops.conv_im2col_nchw_fused(tx, tw, S, pad, bias=tb,
                                              res=tr, **kw)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert_bf16_close(_np(got), _np(want))
    # the plain version rounds once: its float32 run, rounded, is it
    y32 = conv_ref(tx, tw, S, pad, bias=tb, res=tr, out_dtype=torch.float32,
                   **kw)
    assert torch.equal(y32.to(torch.bfloat16), got)


# (H, Ci, Cm, Co, F1, S1, P1, F2, S2, P2, pool, res, biases, src, dst)
STACK_CASES = [
    (8, 3, 16, 16, 3, 1, 1, 3, 1, 1, (2, 2, "max"), False, True, "NCHW",
     "CHWN"),
    (9, 4, 6, 5, 3, 1, 1, 3, 1, 1, None, True, False, "CHWN", "CHWN"),
    (11, 3, 5, 7, 3, 2, 1, 3, 1, 1, (2, 2, "avg"), True, True, "CHWN",
     "NCHW"),
]


@pytest.mark.parametrize("case", STACK_CASES)
def test_bf16_stack_matches_reference_kernel_mid_float32(case):
    H, Ci, Cm, Co, F1, S1, P1, F2, S2, P2, pool, res, biases, src, dst = \
        case
    rng = np.random.default_rng(STACK_CASES.index(case))
    N = 4
    x = _to(src, rng.standard_normal((N, Ci, H, H), np.float32))
    w1 = rng.standard_normal((Cm, Ci, F1, F1), np.float32) * np.float32(0.3)
    w2 = rng.standard_normal((Co, Cm, F2, F2), np.float32) * np.float32(0.3)
    Ho1 = (H + 2 * P1 - F1) // S1 + 1
    Ho2 = (Ho1 + 2 * P2 - F2) // S2 + 1
    r = (_to("NCHW", rng.standard_normal((N, Co, Ho2, Ho2), np.float32))
         if res else None)
    b1 = rng.standard_normal((Cm,), np.float32) if biases else None
    b2 = rng.standard_normal((Co,), np.float32) if biases else None
    (tx, jx), (tw1, jw1), (tw2, jw2), (tr, jr), (tb1, jb1), (tb2, jb2) = \
        map(_bf, (x, w1, w2, r, b1, b2))
    kw = dict(relu1=True, relu2=True, pool=pool, res_layout="NCHW",
              src_layout=src, dst_layout=dst)
    chwn = (1, 2, 3, 0)
    want = ref_ops.conv_stack_chwn(
        jx, jnp.transpose(jw1, chwn), jnp.transpose(jw2, chwn), S1, P1, S2,
        P2, 2, True, bias1=jb1, bias2=jb2, res=jr, **kw)
    got = conv_ops.conv_stack_chwn(
        tx, tw1.permute(*chwn).contiguous(), tw2.permute(*chwn).contiguous(),
        S1, P1, S2, P2, bias1=tb1, bias2=tb2, res=tr, **kw)
    assert got.dtype == torch.bfloat16
    assert_bf16_close(_np(got), _np(want))
    # the mid stays float32: exactly conv2 over conv1's unrounded output
    mid = conv_ref(tx, tw1, S1, P1, bias=tb1, relu=True, src_layout=src,
                   out_dtype=torch.float32)
    two = conv_ref(mid, tw2, S2, P2, bias=tb2, relu=True, pool=pool, res=tr,
                   res_layout="NCHW", dst_layout=dst)
    assert torch.equal(two, got)
    plain = conv_stack_ref(tx, tw1, tw2, S1, P1, S2, P2, bias1=tb1,
                           bias2=tb2, res=tr, **kw)
    assert torch.equal(plain, got)
    # the torch engine is the same plain version
    if b1 is None:
        eng = port_layers.fused_conv_stack(
            tx, tw1, tw2, "CHWN", S1, P1, S2, P2, relu1=True, relu2=True,
            pool=pool, res=tr, res_layout="NCHW", src_layout=src,
            dst_layout=dst, impl="torch")
        assert torch.equal(eng, got)


@pytest.mark.parametrize("shape", [(2, 10), (32, 1000), (7, 101),
                                   (3, 4096)])
def test_bf16_softmax_matches_reference_kernel(shape):
    rng = np.random.default_rng(shape[1])
    x = rng.standard_normal(shape, np.float32) * np.float32(4)
    tx, jx = _bf(x)
    got = softmax(tx)
    want = ref_softmax(jx, interpret=True)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert_bf16_close(_np(got), _np(want))


def _lenet(batch):
    cfg = CNN_CONFIGS["lenet"].replace(batch=batch)
    ref_cfg = REF_CONFIGS["lenet"].replace(batch=batch)
    ref_plan = ref_plan_fused(ref_cfg, dtype="bf16")
    plan = _plan_from_obj(dataclasses.asdict(ref_plan))
    tree = init_cnn(cfg, 0)
    x = np.random.default_rng(batch).standard_normal(input_shape(cfg),
                                                     np.float32)
    return cfg, ref_cfg, plan, ref_plan, tree, x


@pytest.mark.parametrize("batch", [2, 6])
def test_bf16_forward_matches_reference_and_fp32(batch):
    cfg, ref_cfg, plan, ref_plan, tree, x = _lenet(batch)
    p16 = params_from_numpy(tree, "cpu", "bf16")
    x16 = torch.from_numpy(x).to(torch.bfloat16)
    y16, st = forward_fused(p16, x16, cfg, plan)
    assert y16.dtype == torch.bfloat16
    assert st.transforms == 0                 # the bf16 plan fully folded
    ref_params = {k: {n: jnp.asarray(v).astype(jnp.bfloat16)
                      for n, v in d.items()} for k, d in tree.items()}
    ry, rst = ref_forward_fused(ref_params,
                                jnp.asarray(x).astype(jnp.bfloat16),
                                ref_cfg, ref_plan, impl="pallas")
    diff = np.abs(_np(y16) - _np(ry)).max()
    assert diff <= BF16_STEP + 1e-5, diff
    assert dataclasses.asdict(st) == dataclasses.asdict(rst)
    # against the port's own float32 forward of the same weights
    plan32 = _plan_from_obj(dataclasses.asdict(ref_plan_fused(ref_cfg)))
    y32, st32 = forward_fused(params_from_numpy(tree, "cpu"),
                              torch.from_numpy(x), cfg, plan32)
    diff32 = np.abs(_np(y16) - y32.numpy()).max()
    assert diff32 <= BF16_PROBS_ATOL, diff32
    assert st.hbm_bytes < st32.hbm_bytes      # half the bytes a tensor


def test_bf16_init_rounds_once_to_nearest_even():
    cfg = CNN_CONFIGS["lenet"]
    t32, t16 = init_cnn(cfg, 3), init_cnn(cfg, 3, "bf16")
    for layer, p in t32.items():
        for k, v in p.items():
            want = torch.from_numpy(v).to(torch.bfloat16)
            assert t16[layer][k].dtype == np.float32
            assert torch.equal(torch.from_numpy(t16[layer][k]).to(
                torch.bfloat16), want)
            assert np.array_equal(t16[layer][k], want.float().numpy())
    p = params_from_numpy(t32, "cpu", "bfloat16")
    assert p["conv1"]["w"].dtype == torch.bfloat16
    assert torch.equal(p["conv1"]["w"],
                       torch.from_numpy(t32["conv1"]["w"]).to(torch.bfloat16))
    # a JAX bf16 array crosses exactly, through float32
    jw = jnp.asarray(t32["conv1"]["w"]).astype(jnp.bfloat16)
    crossed = params_from_numpy({"c": {"w": jw}}, "cpu", "bf16")["c"]["w"]
    assert torch.equal(crossed, p["conv1"]["w"])
