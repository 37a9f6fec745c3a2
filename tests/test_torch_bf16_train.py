"""bf16 training in the port against the reference, on the CPU.

(a) The plain versions of the training path's kernels in bf16, on CPU
tensors through the port's wrappers, against the reference's Pallas
kernels in interpret mode on the same seeded bf16 inputs: the pools K3a/
K3b and the pool backwards K7a/K7b (max exactly: a bf16 max is exact and
each dx element sums its windows' shares in float32 in the same order;
avg within one bf16 step), the transposes K9a/K9b (exactly), the weight
gradient K6 (float32 out on both sides, from exact bf16 products: within
1e-5 scale-relative), the NCHW stack K5b and the ``save_act`` output z of
K1/K2 (within one bf16 step, |got - want| <= 2^-7 |want| + 1e-5
max|want|: both sum in float32 and round once).  XLA's CPU runtime runs
every one of these reference kernels in bf16.
(b) The SGD update of a bf16 tree gives the reference's bits: JAX rounds
the weak-typed ``momentum`` and ``lr`` to bf16 before it multiplies; a
float32 tree keeps the bits of the float32 update.
(c) 5 bf16 training steps of ``make_train_step_fused`` (the "cuda" engine
on CPU tensors: the plain versions through the kernels' autograd
Functions) over the reference planner's bf16 plans, carried over, against
the reference's ``make_train_step_fused(impl="pallas")`` (its "xla"
engine refuses bf16 training: its conv gets a float32 bias).  Reduced
LeNet at batch 3 and cifarnet at batch 3: the same parameters, bit for
bit, and the same losses (cifarnet's last one float32 step apart: the
mean over the batch sums in another order).  LeNet at batch 64 (its
first conv CHWN, on K1's plain version) and reduced VGG16 at batch 3:
losses within 5e-4 and 1e-6, and every parameter within two bf16 steps
of its scale (2 * 2^-7 max|want|) of the reference's, but VGG16's fc6
and fc7 biases: they start at 0, so after 5 steps they are the step
gradients summed, and where a ReLU mask flipped (below) a unit's
gradient lands elsewhere; they are held in the L2 norm, within 2^-4 of
the reference's.

Why trajectories part at all, though every op rounds as the reference's:
the float32 sums inside a conv or fc run in another order (``F.conv2d``
and ``torch.matmul`` against the reference's per-tap einsums and XLA's
dot), so where a float32 result lies on a bf16 rounding boundary the two
round it one bf16 step apart; downstream, ReLU masks and pool maxima of
rounded activations flip.  ``test_alexnet_bf16_gap_starts_at_conv1_and_
is_not_the_ports`` traces it on reduced AlexNet (96 px, batch 3), whose
trajectories part soonest: the first op that differs is conv1
(1 of its 28,800 outputs one step apart); the step-1 gradient of fc7
then differs by 28 % of its largest entry at 74 of 4,096 biases, yet in
the L2 norm the port's fc7 gradient lies 2.3 % from the float64 gradient
of the same bf16 weights and input and the reference's 4.1 %: both
packages are as far from float64, and the port is not at fault.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cnn import network as ref_network
from repro.configs.cnn_networks import CNN_CONFIGS as REF_CONFIGS
from repro.configs.cnn_networks import reduced_cnn as ref_reduced
from repro.kernels.conv import backward as ref_bwd
from repro.kernels.conv import ops as ref_ops
from repro.kernels.pool import ops as ref_pool
from repro.kernels.pool.backward import pool_backward as ref_pool_backward
from repro.kernels.transpose import ops as ref_transpose

from repro_torch.cnn.layers import init_cnn, params_from_numpy
from repro_torch.cnn.network import (_sgd_step, forward_fused,
                                     init_velocity, input_shape,
                                     loss_fn_fused, make_train_step_fused,
                                     value_and_grad)
from repro_torch.configs import cnn_networks as port_networks
from repro_torch.core.layout import perm_between
from repro_torch.kernels.conv import ops as conv_ops
from repro_torch.kernels.conv.backward import conv_wgrad
from repro_torch.kernels.pool.backward import pool_backward
from repro_torch.kernels.pool.ops import pool_chwn, pool_nchw
from repro_torch.kernels.transpose.ops import (transpose2d,
                                               transpose2d_batched)
from repro_torch.serve.plan_cache import _plan_from_obj

BF16_STEP = 2.0 ** -7
WGRAD_TOL = 1e-5
OTHER = {"NCHW": "CHWN", "CHWN": "NCHW"}
STEPS = 5


def assert_bf16_close(got: np.ndarray, want: np.ndarray) -> None:
    got, want = got.astype(np.float64), want.astype(np.float64)
    assert got.shape == want.shape
    bound = BF16_STEP * np.abs(want) + 1e-5 * np.abs(want).max()
    assert np.all(np.abs(got - want) <= bound), float(
        (np.abs(got - want) - bound).max())


def _rand(shape, seed, layout="NCHW", scale=1.0):
    """(torch bf16, jnp bf16) of the same seeded values, in ``layout``."""
    a = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * np.float32(scale)
    if len(shape) == 4:
        a = np.ascontiguousarray(a.transpose(perm_between("NCHW", layout)))
    return (torch.from_numpy(a).to(torch.bfloat16),
            jnp.asarray(a).astype(jnp.bfloat16))


def _tied(shape, seed, layout):
    """bf16 values on a coarse grid: many pool windows hold equal maxima."""
    a = np.random.default_rng(seed).integers(-3, 4, shape).astype(
        np.float32) / 4
    a = np.ascontiguousarray(a.transpose(perm_between("NCHW", layout)))
    return (torch.from_numpy(a).to(torch.bfloat16),
            jnp.asarray(a).astype(jnp.bfloat16))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


# (N, C, H, F, S): 2/2, the overlapping 3/2, 3/3, a global window
POOL_SHAPES = [(3, 5, 8, 2, 2), (2, 4, 9, 3, 2), (3, 2, 9, 3, 3),
               (2, 3, 4, 4, 4)]


@pytest.mark.parametrize("layout", ["CHWN", "NCHW"])
@pytest.mark.parametrize("op", ["max", "avg"])
def test_k3_bf16_plain_matches_reference(layout, op):
    for i, (N, C, H, F, S) in enumerate(POOL_SHAPES):
        xt, xj = _rand((N, C, H, H), i, layout)
        for dst in (layout, OTHER[layout]):
            if layout == "CHWN":
                got = pool_chwn(xt, F, S, op, dst_layout=dst)
                want = ref_pool.pool_chwn(xj, F, S, op, dst_layout=dst)
            else:
                got = pool_nchw(xt, F, S, op, dst_layout=dst)
                want = ref_pool.pool_nchw(xj, F, S, op, dst_layout=dst)
            assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
            if op == "max":
                np.testing.assert_array_equal(_np(got), _np(want))
            else:
                assert_bf16_close(_np(got), _np(want))


@pytest.mark.parametrize("layout", ["CHWN", "NCHW"])
@pytest.mark.parametrize("op", ["max", "avg"])
def test_k7_bf16_plain_matches_reference(layout, op):
    for i, (N, C, H, F, S) in enumerate(POOL_SHAPES):
        for ties, relu, g_layout in ((False, True, layout),
                                     (True, True, OTHER[layout]),
                                     (True, False, layout)):
            seed = 10 * i + ties
            xt, xj = (_tied((N, C, H, H), seed, layout) if ties
                      else _rand((N, C, H, H), seed, layout))
            Ho = (H - F) // S + 1
            gt, gj = _rand((N, C, Ho, Ho), seed + 1, g_layout)
            got = pool_backward(xt, gt, F, S, op, layout=layout,
                                g_layout=g_layout, relu_mask=relu)
            want = ref_pool_backward(xj, gj, F, S, op, layout=layout,
                                     g_layout=g_layout, relu_mask=relu)
            assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
            if op == "max":
                np.testing.assert_array_equal(_np(got), _np(want))
            else:
                assert_bf16_close(_np(got), _np(want))


@pytest.mark.parametrize("shape", [(37, 45), (64, 96), (3, 33, 70)])
def test_k9_bf16_plain_matches_reference(shape):
    a = np.random.default_rng(len(shape)).standard_normal(shape).astype(
        np.float32)
    xt = torch.from_numpy(a).to(torch.bfloat16)
    xj = jnp.asarray(a).astype(jnp.bfloat16)
    if len(shape) == 2:
        got, want = transpose2d(xt), ref_transpose.transpose2d(xj)
    else:
        got = transpose2d_batched(xt)
        want = ref_transpose.transpose2d_batched(xj)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(want))


# (N, Ci, H, Co, F, S, pad)
WGRAD_SHAPES = [(3, 4, 9, 6, 3, 1, 1), (2, 3, 13, 5, 5, 2, 2),
                (4, 8, 8, 7, 1, 2, 0)]


@pytest.mark.parametrize("x_layout", ["CHWN", "NCHW"])
@pytest.mark.parametrize("g_layout", ["CHWN", "NCHW"])
def test_k6_bf16_plain_matches_reference(x_layout, g_layout):
    for i, (N, Ci, H, Co, F, S, pad) in enumerate(WGRAD_SHAPES):
        Ho = (H + 2 * pad - F) // S + 1
        xt, xj = _rand((N, Ci, H, H), i, x_layout)
        gt, gj = _rand((N, Co, Ho, Ho), i + 7, g_layout)
        got = conv_wgrad(xt, gt, F, S, pad, x_layout=x_layout,
                         g_layout=g_layout)
        want = ref_bwd.conv_wgrad(xj, gj, F, S, pad, x_layout=x_layout,
                                  g_layout=g_layout)
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        want = np.asarray(want, np.float64)
        err = np.abs(got.double().numpy() - want).max()
        assert err <= WGRAD_TOL * max(1.0, np.abs(want).max()), (i, err)


# (N, Ci, H, Cm, Co, F1, S1, P1, F2, S2, P2, pool, res, src, dst)
STACK_CASES = [
    (2, 5, 8, 8, 6, 3, 1, 1, 3, 1, 1, None, "NCHW", "NCHW", "NCHW"),
    (3, 4, 9, 6, 5, 3, 2, 1, 3, 1, 1, None, "CHWN", "CHWN", "NCHW"),
    (2, 3, 8, 4, 7, 3, 1, 1, 3, 1, 1, (2, 2, "max"), None, "NCHW", "CHWN"),
]


@pytest.mark.parametrize("case", STACK_CASES)
def test_k5b_bf16_plain_matches_reference(case):
    N, Ci, H, Cm, Co, F1, S1, P1, F2, S2, P2, pool, rlay, src, dst = case
    seed = 100 * STACK_CASES.index(case)
    Ho2 = (((H + 2 * P1 - F1) // S1 + 1) + 2 * P2 - F2) // S2 + 1
    xt, xj = _rand((N, Ci, H, H), seed, src)
    w1t, w1j = _rand((Cm, Ci, F1, F1), seed + 1, scale=1 / np.sqrt(Ci * 9))
    w2t, w2j = _rand((Co, Cm, F2, F2), seed + 2, scale=1 / np.sqrt(Cm * 9))
    b1t, b1j = _rand((Cm,), seed + 3, scale=0.1)
    rt, rj = (_rand((N, Co, Ho2, Ho2), seed + 4, rlay) if rlay
              else (None, None))
    kw = dict(relu1=True, relu2=True, pool=pool, res_layout=rlay or "NCHW",
              src_layout=src, dst_layout=dst)
    got = conv_ops.conv_stack_nchw(xt, w1t, w2t, S1, P1, S2, P2, bias1=b1t,
                                   res=rt, **kw)
    want = ref_ops.conv_stack_nchw(xj, w1j, w2j, S1, P1, S2, P2, bias1=b1j,
                                   res=rj, **kw)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert_bf16_close(_np(got), _np(want))


# (engine, N, Ci, H, Co, F, S, pad, pool, relu, res, src, dst): every conv
# output under a pool window (so both sides write all of z)
SAVE_ACT_CASES = [
    ("CHWN", 3, 4, 8, 6, 3, 1, 1, (2, 2, "max"), True, None, "CHWN",
     "CHWN"),
    ("CHWN", 2, 3, 11, 5, 3, 1, 0, (3, 2, "max"), True, "NCHW", "NCHW",
     "NCHW"),
    ("NCHW", 3, 4, 8, 6, 3, 1, 1, (2, 2, "max"), True, "CHWN", "NCHW",
     "CHWN"),
    ("NCHW", 2, 5, 10, 4, 3, 1, 1, (2, 2, "avg"), False, None, "CHWN",
     "NCHW"),
]


@pytest.mark.parametrize("case", SAVE_ACT_CASES)
def test_save_act_z_bf16_plain_matches_reference(case):
    eng, N, Ci, H, Co, F, S, pad, pool, relu, rlay, src, dst = case
    seed = 200 * SAVE_ACT_CASES.index(case)
    Ho = (H + 2 * pad - F) // S + 1
    xt, xj = _rand((N, Ci, H, H), seed, src)
    wt, wj = _rand((Co, Ci, F, F), seed + 1, scale=1 / np.sqrt(Ci * F * F))
    rt, rj = (_rand((N, Co, Ho, Ho), seed + 2, rlay) if rlay
              else (None, None))
    rl = rlay or eng
    if eng == "CHWN":
        wk = wt.permute(1, 2, 3, 0).contiguous()
        want = ref_ops._conv_chwn_core(
            xj, jnp.transpose(wj, (1, 2, 3, 0)), None, rj, S, pad, 128,
            True, relu, pool, src, dst, rl, save_act=True)
    else:
        wk = wt
        want = ref_ops._conv_nchw_core(xj, wj, None, rj, S, pad, True, relu,
                                       pool, src, dst, rl, save_act=True)
    y, z = conv_ops._conv(eng, xt, wk, S, pad, relu=relu, pool=pool, res=rt,
                          res_layout=rl, src_layout=src, dst_layout=dst,
                          save_act=True)
    assert y.dtype == z.dtype == torch.bfloat16
    assert want[1].dtype == jnp.bfloat16
    assert_bf16_close(_np(y), _np(want[0]))
    assert_bf16_close(_np(z), _np(want[1]))


MOMENTUM, LR = 0.9, 0.01


def _ref_update(p, v, g):
    """The reference's update, as its jitted step takes it."""
    return jax.jit(lambda p, v, g: (
        lambda nv: (p + nv, nv))(MOMENTUM * v - LR * g))(p, v, g)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_sgd_update_gives_the_reference_bits(dtype):
    """``_sgd_step`` on 100 000 random elements: a bf16 tree gives the
    reference's bits (before the scalars took the leaf's dtype, 20 372 of
    100 000 updated parameters differed).  A float32 tree keeps the bits
    of the Python-float update it had, which are the reference's within
    float32 rounding of ``momentum * v``: XLA contracts ``momentum * v -
    lr * g`` into one fused multiply-add, fma(momentum, v, -(lr * g)),
    where torch rounds that product first (a bf16 product is exact in
    float32, so there the two agree)."""
    rng = np.random.default_rng(0)
    p, v, g = (rng.standard_normal(100_000).astype(np.float32) * s
               for s in (1.0, 0.1, 0.5))
    tdt = getattr(torch, dtype)
    pt, vt, gt = (torch.from_numpy(a).to(tdt) for a in (p, v, g))

    def loss(params, x, y):   # its gradient is g, exactly
        return (params["l"]["w"].float() * gt.float()).sum()

    new_p, new_v, _ = _sgd_step(loss, LR, MOMENTUM)(
        {"l": {"w": pt}}, {"l": {"w": vt}}, None, None)
    jdt = getattr(jnp, dtype)
    want_p, want_v = _ref_update(*(jnp.asarray(a).astype(jdt)
                                   for a in (p, v, g)))
    assert new_p["l"]["w"].dtype == tdt
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_np(new_v["l"]["w"]), _np(want_v))
        np.testing.assert_array_equal(_np(new_p["l"]["w"]), _np(want_p))
        return
    old_v = MOMENTUM * vt - LR * gt   # the Python-float form it replaced
    assert torch.equal(new_v["l"]["w"], old_v)
    assert torch.equal(new_p["l"]["w"], pt + old_v)
    got_v = new_v["l"]["w"].numpy()
    fma = (np.float64(np.float32(MOMENTUM)) * v.astype(np.float64)
           - (np.float32(LR) * g).astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(_np(want_v), fma)
    # torch rounds m * v before the subtraction: half a float32 step of
    # that product (and of the difference) apart from the fused one
    terms = (np.abs(np.float32(MOMENTUM) * v).astype(np.float64)
             + np.abs(np.float32(LR) * g).astype(np.float64))
    assert np.all(np.abs(got_v.astype(np.float64) - fma) <= 2.0 ** -23 * terms)


def _setup(network: str, batch: int):
    ref_cfg = ref_reduced(REF_CONFIGS[network], batch=batch)
    cfg = port_networks.reduced_cnn(port_networks.CNN_CONFIGS[network],
                                    batch=batch)
    ref_plan = ref_network.plan_network_fused(ref_cfg, dtype="bf16")
    plan = _plan_from_obj(dataclasses.asdict(ref_plan))
    tree = init_cnn(cfg, 0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(input_shape(cfg), np.float32)
    y = rng.integers(0, cfg.num_classes, size=batch)
    return ref_cfg, ref_plan, cfg, plan, tree, x, y


# (network, batch, loss tolerance, parameters bit for bit, the parameters
# a flipped ReLU mask separates (PERF.md §7): compared in the L2 norm)
TRAINED = [("lenet", 3, 0.0, True, ()), ("cifarnet", 3, 1e-6, True, ()),
           ("lenet", 64, 5e-4, False, ()),
           ("vgg16", 3, 1e-6, False, (("fc6", "b"), ("fc7", "b")))]


@pytest.mark.parametrize("network,batch,loss_tol,exact,flipped", TRAINED,
                         ids=[f"{n}-b{b}" for n, b, *_ in TRAINED])
def test_bf16_train_steps_match_reference(network, batch, loss_tol, exact,
                                          flipped):
    ref_cfg, ref_plan, cfg, plan, tree, x, y = _setup(network, batch)
    rp = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), tree)
    rv = ref_network.init_velocity(rp)
    ref_step = ref_network.make_train_step_fused(ref_cfg, ref_plan,
                                                 impl="pallas")
    xj, yj = jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(y, jnp.int32)
    params = params_from_numpy(tree, "cpu", "bf16")
    vel = init_velocity(params)
    step = make_train_step_fused(cfg, plan)
    xt, yt = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(y)
    ref_losses, losses = [], []
    for _ in range(STEPS):
        rp, rv, rl = ref_step(rp, rv, xj, yj)
        params, vel, loss = step(params, vel, xt, yt)
        ref_losses.append(float(rl))
        losses.append(float(loss))
    assert all(np.isfinite(losses))
    np.testing.assert_allclose(losses, ref_losses, rtol=0, atol=loss_tol)
    for layer, p in rp.items():
        for k, a in p.items():
            got, want = params[layer][k], _np(a)
            assert got.dtype == torch.bfloat16
            if exact:
                np.testing.assert_array_equal(_np(got), want)
            elif (layer, k) in flipped:
                d = np.linalg.norm(_np(got) - want)
                assert d <= 2.0 ** -4 * np.linalg.norm(want), (layer, k)
            else:
                d = np.abs(_np(got) - want).max()
                assert d <= 2 * BF16_STEP * np.abs(want).max(), (layer, k)


def test_alexnet_bf16_gap_starts_at_conv1_and_is_not_the_ports():
    """Reduced AlexNet (96 px, batch 3) in bf16 over the reference's bf16
    plan, one step: the first op whose output differs between the port and
    the reference is conv1, at a few of its outputs, each one bf16 step
    apart (the float32 sums run in another order, and those values lay on
    a bf16 rounding boundary); the step-1 gradients then part (ReLU masks
    flip downstream), yet every parameter's port gradient lies no further
    from the float64 gradient of the same bf16 weights and input, in the
    L2 norm, than 1.25x the reference's does.  Prints what it measures
    (``pytest -s -k alexnet``): the numbers of PERF.md §7."""
    ref_cfg = ref_reduced(REF_CONFIGS["alexnet"], batch=3).replace(
        image_hw=96)
    cfg = port_networks.reduced_cnn(port_networks.CNN_CONFIGS["alexnet"],
                                    batch=3).replace(image_hw=96)
    ref_plan = ref_network.plan_network_fused(ref_cfg, dtype="bf16")
    plan = _plan_from_obj(dataclasses.asdict(ref_plan))
    tree = init_cnn(cfg, 0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(input_shape(cfg), np.float32)
    y = rng.integers(0, cfg.num_classes, size=3)
    rp = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), tree)
    params = params_from_numpy(tree, "cpu", "bf16")
    xj, xt = jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(
        torch.bfloat16)
    # conv1 alone: a handful of outputs one bf16 step apart
    one = dataclasses.replace(ref_plan, ops=ref_plan.ops[:1])
    want = _np(ref_network.forward_fused(rp, xj, ref_cfg, one,
                                         impl="pallas")[0])
    got = _np(forward_fused(params, xt, cfg,
                            dataclasses.replace(plan, ops=plan.ops[:1]))[0])
    apart = got != want
    print(f"conv1: {apart.sum()} of {apart.size} outputs apart")
    assert 0 < apart.sum() <= 1e-3 * apart.size
    step = BF16_STEP * np.maximum(np.abs(got), np.abs(want))
    assert np.all(np.abs(got - want)[apart] <= step[apart])
    # the step-1 gradients: the port no further from float64 than the
    # reference
    ref_g = jax.grad(lambda p: ref_network.loss_fn_fused(
        p, xj, jnp.asarray(y, jnp.int32), ref_cfg, ref_plan, "pallas"))(rp)
    yt = torch.from_numpy(y)
    port_g = value_and_grad(lambda q, a, b: loss_fn_fused(q, a, b, cfg, plan),
                            params, xt, yt)[1]
    p64 = {l: {k: v.double() for k, v in q.items()}
           for l, q in params.items()}
    g64 = value_and_grad(
        lambda q, a, b: loss_fn_fused(q, a, b, cfg, plan, "torch"), p64,
        xt.double(), yt)[1]
    for layer, gs in g64.items():
        for k, r in gs.items():
            r = r.numpy()
            pg = port_g[layer][k].double().numpy()
            rg = _np(ref_g[layer][k]).astype(np.float64)
            d_port, d_ref = np.linalg.norm(pg - r), np.linalg.norm(rg - r)
            apart = np.abs(pg - rg).max() / np.abs(r).max()
            print(f"{layer}.{k}: port - reference, largest {apart:.3g} of "
                  f"max|float64|, at {(pg != rg).sum()} of {r.size}; L2 "
                  f"from float64 port {d_port / np.linalg.norm(r):.3g}, "
                  f"reference {d_ref / np.linalg.norm(r):.3g}")
            assert d_port <= 1.25 * d_ref, (layer, k, d_port, d_ref)
