"""Plans the port prices for the H100 run in both executors alike.

For lenet, cifarnet and unet_mini (reduced) the port plans on its default
(H100) profile at buckets that flip the layouts, at both stack policies;
each plan goes through JSON into the reference's ``FusedPlan`` and runs in
the reference's ``forward_fused(impl="xla")``, and the port's
``forward_fused`` runs it on CPU tensors (the kernels' plain versions) and
on the torch engine, on the same numpy weights and input: probabilities
within 1e-5, ``RunStats`` equal.
"""
from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cnn.network import forward_fused as ref_forward_fused
from repro.configs.cnn_networks import CNN_CONFIGS, reduced_cnn
from repro.serve.plan_cache import _plan_from_obj as ref_plan_from_obj

from repro_torch.cnn.layers import init_cnn, params_from_numpy
from repro_torch.cnn.network import (forward_fused, input_shape,
                                     plan_network_fused)
from repro_torch.configs import cnn_networks as port_networks

PROB_ATOL = 1e-5
CASES = [("lenet", (1, 8)), ("cifarnet", (1, 8)), ("unet_mini", (1, 2, 8))]


def _cfgs(network: str, batch: int):
    ref_cfg = CNN_CONFIGS[network].replace(batch=batch)
    cfg = port_networks.CNN_CONFIGS[network].replace(batch=batch)
    if network == "unet_mini":
        ref_cfg = reduced_cnn(CNN_CONFIGS[network], batch=batch)
        cfg = port_networks.reduced_cnn(port_networks.CNN_CONFIGS[network],
                                        batch=batch)
    return ref_cfg, cfg


def _stats(st):
    return (st.transforms, st.transform_bytes, st.hbm_bytes, st.fused_ops)


@pytest.mark.parametrize("stack", ["auto", "off"])
@pytest.mark.parametrize("network,batches", CASES)
def test_h100_plans_run_alike_in_both_executors(network, batches, stack):
    signatures = set()
    for b in batches:
        ref_cfg, cfg = _cfgs(network, b)
        plan = plan_network_fused(cfg, stack_policy=stack)
        signatures.add(plan.conv_signature)
        ref_plan = ref_plan_from_obj(json.loads(json.dumps(
            dataclasses.asdict(plan))))
        assert dataclasses.asdict(ref_plan) == dataclasses.asdict(plan)
        tree = init_cnn(cfg, seed=b)
        x = np.random.default_rng(b).standard_normal(input_shape(cfg),
                                                     np.float32)
        want, ref_st = ref_forward_fused(jax.tree.map(jnp.asarray, tree),
                                         jnp.asarray(x), ref_cfg, ref_plan,
                                         impl="xla")
        params = params_from_numpy(tree, "cpu")
        for impl in ("cuda", "torch"):
            y, st = forward_fused(params, torch.from_numpy(x), cfg, plan,
                                  impl=impl)
            assert tuple(y.shape) == (b, cfg.num_classes)
            np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=0,
                                       atol=PROB_ATOL)
            assert _stats(st) == _stats(ref_st)
            assert st.hbm_bytes == plan.fused_bytes
    # the batches chosen flip the H100 plan's conv layouts
    assert len(signatures) > 1
