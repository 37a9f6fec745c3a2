"""The port's training step against the reference's, on the CPU.

(a) ``make_train_step_fused``: lenet, alexnet (96 px), vgg16 and resnet18
at ``reduced_cnn`` size and batch 3, on the reference planner's plans at
both stack policies (carried over in the plan-cache JSON form).  The same
seeded weights (``init_cnn`` here, ``jnp.asarray`` there), input and labels
go through 5 steps of the port on both engines (on CPU tensors the "cuda"
engine runs the kernels' plain versions through their autograd Functions)
and 5 steps of the reference's ``make_train_step_fused(impl="xla")``.
Losses agree within 1e-4 at every step, the reference's own bound
(``tests/test_backward.py::test_train_step_fused_matches_xla``), and the
parameters after 5 steps within 1e-5 of the reference, scale-relative
(``assert_grads_close``'s form).  lenet at batch 64 and cifarnet at 128,
where the plans flip convs to CHWN with layout folds, run the CHWN
engine's backward; lenet is also held against the reference's Pallas
engine in interpret mode.
(b) ``forward_fused(training=True)`` and ``forward(training=True)``:
``RunStats`` equal to the reference's, ``bwd_hbm_bytes`` included.
(c) The unfused ``make_train_step`` against the reference's.
(d) A step on CPU tensors launches no kernel.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cnn import network as ref_network
from repro.configs.cnn_networks import CNN_CONFIGS, reduced_cnn

from repro_torch import kernels as K
from repro_torch.cnn.layers import init_cnn, params_from_numpy
from repro_torch.cnn.network import (forward, forward_fused, init_velocity,
                                     input_shape, make_train_step,
                                     make_train_step_fused)
from repro_torch.configs import cnn_networks as port_networks
from repro_torch.serve.plan_cache import _plan_from_obj

LOSS_ATOL = 1e-4
PARAM_TOL = 1e-5
STEPS = 5
NETWORKS = ["lenet", "alexnet", "vgg16", "resnet18"]
IMAGE_HW = {"alexnet": 96}


def assert_close_scaled(got, ref, tol: float = PARAM_TOL) -> None:
    """|got - ref| <= tol * max(1, max|ref|) (and rtol tol)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = max(1.0, np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * scale)


def _setup(network: str, stack: str, batch: int = 3, seed: int = 0):
    ref_cfg = reduced_cnn(CNN_CONFIGS[network], batch=batch)
    cfg = port_networks.reduced_cnn(port_networks.CNN_CONFIGS[network],
                                    batch=batch)
    if network in IMAGE_HW:
        ref_cfg = ref_cfg.replace(image_hw=IMAGE_HW[network])
        cfg = cfg.replace(image_hw=IMAGE_HW[network])
    ref_plan = ref_network.plan_network_fused(ref_cfg, stack_policy=stack)
    plan = _plan_from_obj(dataclasses.asdict(ref_plan))
    tree = init_cnn(cfg, seed)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal(input_shape(cfg), np.float32)
    y = rng.integers(0, cfg.num_classes, size=cfg.batch)
    return ref_cfg, ref_plan, cfg, plan, tree, x, y


def _run_ref(step, tree, x, y):
    params = jax.tree.map(jnp.asarray, tree)
    vel = ref_network.init_velocity(params)
    xj, yj = jnp.asarray(x), jnp.asarray(y, jnp.int32)
    losses = []
    for _ in range(STEPS):
        params, vel, loss = step(params, vel, xj, yj)
        losses.append(float(loss))
    return losses, params


def _run_port(step, tree, x, y):
    params = params_from_numpy(tree, "cpu")
    vel = init_velocity(params)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    losses = []
    for _ in range(STEPS):
        params, vel, loss = step(params, vel, xt, yt)
        losses.append(float(loss))
    return losses, params


def _check(losses, params, ref_losses, ref_params) -> None:
    assert all(np.isfinite(losses))
    np.testing.assert_allclose(losses, ref_losses, rtol=0, atol=LOSS_ATOL)
    for layer, p in ref_params.items():
        for k, v in p.items():
            assert_close_scaled(params[layer][k].numpy(), v)


@pytest.mark.parametrize("stack", ["off", "auto"])
@pytest.mark.parametrize("network", NETWORKS)
def test_train_step_fused_matches_reference(network, stack):
    ref_cfg, ref_plan, cfg, plan, tree, x, y = _setup(network, stack)
    ref_losses, ref_params = _run_ref(
        ref_network.make_train_step_fused(ref_cfg, ref_plan, impl="xla"),
        tree, x, y)
    for impl in ("cuda", "torch"):
        losses, params = _run_port(
            make_train_step_fused(cfg, plan, impl=impl), tree, x, y)
        _check(losses, params, ref_losses, ref_params)


@pytest.mark.parametrize("network,batch", [("lenet", 64), ("cifarnet", 128)])
def test_train_step_fused_matches_reference_on_chwn_plans(network, batch):
    """Batches at which the planner flips convs to CHWN, with src/dst
    folds: the CHWN engine's backward (K1 dgrad, K7a) on a whole network."""
    ref_cfg, ref_plan, cfg, plan, tree, x, y = _setup(network, "auto", batch)
    assert any(op.kind == "conv" and op.layout == "CHWN"
               for op in plan.ops)
    ref_losses, ref_params = _run_ref(
        ref_network.make_train_step_fused(ref_cfg, ref_plan, impl="xla"),
        tree, x, y)
    losses, params = _run_port(make_train_step_fused(cfg, plan), tree, x, y)
    _check(losses, params, ref_losses, ref_params)


def test_train_step_fused_matches_reference_pallas_engine():
    """lenet through the reference's fused Pallas engine (interpret mode),
    whose backward runs its dgrad/wgrad/pool-backward kernels."""
    ref_cfg, ref_plan, cfg, plan, tree, x, y = _setup("lenet", "auto")
    ref_losses, ref_params = _run_ref(
        ref_network.make_train_step_fused(ref_cfg, ref_plan,
                                          impl="pallas"), tree, x, y)
    losses, params = _run_port(make_train_step_fused(cfg, plan), tree, x, y)
    _check(losses, params, ref_losses, ref_params)


def _stats(st):
    return (st.hbm_bytes, st.bwd_hbm_bytes, st.total_hbm_bytes,
            st.transforms, st.transform_bytes, st.fused_ops)


@pytest.mark.parametrize("stack", ["off", "auto"])
@pytest.mark.parametrize("network", NETWORKS + ["unet_mini"])
def test_training_run_stats_match_reference(network, stack):
    ref_cfg, ref_plan, cfg, plan, tree, x, _ = _setup(network, stack)
    ref_params = jax.tree.map(jnp.asarray, tree)
    params = params_from_numpy(tree, "cpu")
    xt = torch.from_numpy(x)
    _, ref_st = ref_network.forward_fused(ref_params, jnp.asarray(x),
                                          ref_cfg, ref_plan, impl="xla",
                                          training=True)
    _, st = forward_fused(params, xt, cfg, plan, impl="torch",
                          training=True)
    assert _stats(st) == _stats(ref_st)
    assert st.bwd_hbm_bytes > 0
    layouts = ref_network.plan_network(ref_cfg, "opt")
    _, ref_su = ref_network.forward(ref_params, jnp.asarray(x), ref_cfg,
                                    layouts, impl="xla", training=True)
    _, su = forward(params, xt, cfg, layouts, impl="torch", training=True)
    assert _stats(su) == _stats(ref_su)
    # the reference's acceptance: fused training moves fewer bytes
    assert st.total_hbm_bytes < su.total_hbm_bytes
    _, st_inf = forward_fused(params, xt, cfg, plan, impl="torch")
    assert (st_inf.hbm_bytes, st_inf.bwd_hbm_bytes) == (st.hbm_bytes, 0)


def test_unfused_train_step_matches_reference():
    ref_cfg, _, cfg, _, tree, x, y = _setup("alexnet", "off")
    layouts = ref_network.plan_network(ref_cfg, "opt")
    ref_losses, ref_params = _run_ref(
        ref_network.make_train_step(ref_cfg, layouts), tree, x, y)
    for impl in ("torch", "cuda"):
        losses, params = _run_port(make_train_step(cfg, layouts, impl=impl),
                                   tree, x, y)
        _check(losses, params, ref_losses, ref_params)


def test_cpu_training_launches_no_kernel():
    _, _, cfg, plan, tree, x, y = _setup("resnet18", "auto")
    params = params_from_numpy(tree, "cpu")
    step = make_train_step_fused(cfg, plan)
    K.reset_launch_counts()
    new, _, loss = step(params, init_velocity(params), torch.from_numpy(x),
                        torch.from_numpy(y).long())
    assert np.isfinite(float(loss))
    assert set(K.launch_counts().values()) == {0}
    assert not any(v.requires_grad for p in new.values() for v in p.values())
