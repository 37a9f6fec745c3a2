"""Port ``forward_fused`` against the reference ``forward_fused``.

For each network at ``reduced_cnn`` size (96 px for alexnet and zfnet,
whose stride-heavy stems leave nothing of a 32 px image) the reference
planner makes the ``stack_policy="off"`` plan; the port runs that same plan
(carried over in the plan-cache JSON form) on the same weights
(``init_cnn`` here, ``jnp.asarray`` there) and the same seeded input.  Class probabilities
agree within 1e-5; ``RunStats`` traffic and op counts agree exactly.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cnn.network import forward_fused as ref_forward_fused
from repro.cnn.network import plan_network_fused
from repro.configs.cnn_networks import CNN_CONFIGS, reduced_cnn

from repro_torch.cnn.layers import init_cnn, params_from_numpy
from repro_torch.cnn.network import (FusedCNN, batch_output_ok,
                                     forward_fused, input_shape)
from repro_torch.configs import cnn_networks as port_networks
from repro_torch.serve.plan_cache import _plan_from_obj

PROB_ATOL = 1e-5
NETWORKS = ["lenet", "cifarnet", "alexnet", "zfnet", "vgg16", "resnet18",
            "unet_mini"]
IMAGE_HW = {"alexnet": 96, "zfnet": 96}
# batches big enough that the plans flip convs to CHWN (with src/dst folds)
FLIP_CASES = [("lenet", 64), ("lenet", 128), ("cifarnet", 128)]


def _setup(network: str, batch: int = 3, seed: int = 0):
    ref_cfg = reduced_cnn(CNN_CONFIGS[network], batch=batch)
    cfg = port_networks.reduced_cnn(port_networks.CNN_CONFIGS[network],
                                    batch=batch)
    if network in IMAGE_HW:
        ref_cfg = ref_cfg.replace(image_hw=IMAGE_HW[network])
        cfg = cfg.replace(image_hw=IMAGE_HW[network])
    ref_plan = plan_network_fused(ref_cfg, stack_policy="off")
    plan = _plan_from_obj(dataclasses.asdict(ref_plan))
    tree = init_cnn(cfg, seed)
    x = np.random.default_rng(seed + 1).standard_normal(
        input_shape(cfg), np.float32)
    return ref_cfg, ref_plan, cfg, plan, tree, x


@pytest.mark.parametrize("network,batch",
                         [(n, 3) for n in NETWORKS] + FLIP_CASES)
def test_forward_fused_matches_reference(network, batch):
    ref_cfg, ref_plan, cfg, plan, tree, x = _setup(network, batch)
    ref_params = jax.tree.map(jnp.asarray, tree)
    ref_y, ref_st = ref_forward_fused(ref_params, jnp.asarray(x), ref_cfg,
                                      ref_plan, impl="xla")
    for impl in ("cuda", "torch"):       # on the CPU: both plain versions
        y, st = forward_fused(params_from_numpy(tree, "cpu"),
                              torch.from_numpy(x), cfg, plan, impl=impl)
        assert tuple(y.shape) == (cfg.batch, cfg.num_classes)
        np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), rtol=0,
                                   atol=PROB_ATOL)
        assert (st.hbm_bytes, st.fused_ops, st.transforms,
                st.transform_bytes) == (ref_st.hbm_bytes, ref_st.fused_ops,
                                        ref_st.transforms,
                                        ref_st.transform_bytes)
        assert bool(batch_output_ok(y))


def test_init_cnn_distribution_and_shapes():
    cfg = port_networks.CNN_CONFIGS["alexnet"]
    tree = init_cnn(cfg, seed=3)
    w = tree["conv2"]["w"]
    assert w.shape == (256, 96, 5, 5) and w.dtype == np.float32
    assert abs(w.std() * np.sqrt(96 * 25) - 1.0) < 0.01
    assert tree["fc6"]["w"].shape == (256 * 6 * 6, 4096)
    assert not tree["fc8"]["b"].any()
    again = init_cnn(cfg, seed=3)
    assert np.array_equal(again["conv1"]["w"], tree["conv1"]["w"])


def test_fused_cnn_module_runs_the_plan():
    _, _, cfg, plan, tree, x = _setup("lenet")
    model = FusedCNN(cfg, tree, torch.device("cpu"))
    y, _ = model(torch.from_numpy(x), plan)
    want, _ = forward_fused(params_from_numpy(tree, "cpu"),
                            torch.from_numpy(x), cfg, plan)
    assert torch.equal(y, want)
    assert not any(p.requires_grad for p in model.parameters())


def test_unported_plan_features_raise():
    """int8 into or out of a stack op has no kernel (no plan makes one):
    the executor raises rather than run a plain version."""
    ref_cfg, _, cfg, _, tree, x = _setup("vgg16")
    plan = _plan_from_obj(dataclasses.asdict(plan_network_fused(ref_cfg)))
    params = params_from_numpy(tree, "cpu")
    i = next(i for i, op in enumerate(plan.ops) if op.stack_index is not None)
    for field in ("src_dtype", "dst_dtype"):
        mixed = dataclasses.replace(plan, ops=plan.ops[:i] + [
            dataclasses.replace(plan.ops[i], **{field: "int8"})]
            + plan.ops[i + 1:])
        with pytest.raises(NotImplementedError, match="int8"):
            forward_fused(params, torch.from_numpy(x), cfg, mixed)
