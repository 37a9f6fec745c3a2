"""The port's unfused executor (``plan_network`` + ``forward``) against the
reference's.

(a) Every network of ``CNN_CONFIGS`` at ``reduced_cnn`` size (96 px for
alexnet and zfnet, as ``test_torch_network.py``) in the paper's three
modes, with the reference's layouts from its ``plan_network``: the port's
``forward`` (both engines; on the CPU the "cuda" engine runs the
kernels' plain versions) against the reference's ``forward(impl="xla")``
on the same weights and seeded input.  Probabilities within 1e-5,
``RunStats`` equal.  Lenet at batch 64 in "opt" (which flips it to CHWN)
is also held against the reference's Pallas engine in interpret mode with
the Pallas transpose.
(b) ``plan_network``: "opt" from the packaged plan files equals the
reference's DP at every packaged bucket; the heuristic mode equals the
reference's ``paper_heuristic_layouts``; ``network_descs`` equal the
reference's letter for letter.
(c) What the port cannot plan or run raises.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cnn import network as ref_network
from repro.configs.cnn_networks import CNN_CONFIGS, reduced_cnn
from repro.core import Thresholds as RefThresholds
from repro.core.selector import paper_heuristic_layouts

from repro_torch.cnn.layers import init_cnn, params_from_numpy
from repro_torch.cnn.network import (forward, input_shape, network_descs,
                                     plan_network)
from repro_torch.configs import cnn_networks as port_networks
from repro_torch.kernels.transpose import ops as tr_ops
from repro_torch.perfmodel import Thresholds
from repro_torch.serve.plan_cache import PlanMissError, packaged_plans
from tests.test_torch_plans import PACKAGED

PROB_ATOL = 1e-5
NETWORKS = ["lenet", "cifarnet", "alexnet", "zfnet", "vgg16", "resnet18",
            "unet_mini"]
MODES = ["cuda-convnet", "cudnn", "opt"]
IMAGE_HW = {"alexnet": 96, "zfnet": 96}
THRESHOLDS = [(4, 64), (64, 16), (512, 512)]


def _cfgs(network: str, batch: int):
    ref_cfg = reduced_cnn(CNN_CONFIGS[network], batch=batch)
    cfg = port_networks.reduced_cnn(port_networks.CNN_CONFIGS[network],
                                    batch=batch)
    if network in IMAGE_HW:
        ref_cfg = ref_cfg.replace(image_hw=IMAGE_HW[network])
        cfg = cfg.replace(image_hw=IMAGE_HW[network])
    return ref_cfg, cfg


def _inputs(cfg, seed: int = 0):
    tree = init_cnn(cfg, seed)
    x = np.random.default_rng(seed + 1).standard_normal(input_shape(cfg),
                                                        np.float32)
    return tree, x


def _stats(st):
    return (st.transforms, st.transform_bytes, st.hbm_bytes, st.fused_ops)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("network", NETWORKS)
def test_forward_matches_reference(network, mode):
    ref_cfg, cfg = _cfgs(network, 3)
    layouts = ref_network.plan_network(ref_cfg, mode)
    tree, x = _inputs(cfg)
    ref_y, ref_st = ref_network.forward(jax.tree.map(jnp.asarray, tree),
                                        jnp.asarray(x), ref_cfg, layouts,
                                        impl="xla")
    params = params_from_numpy(tree, "cpu")
    for impl in ("cuda", "torch"):
        y, st = forward(params, torch.from_numpy(x), cfg, layouts, impl=impl)
        assert tuple(y.shape) == (cfg.batch, cfg.num_classes)
        np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), rtol=0,
                                   atol=PROB_ATOL)
        assert _stats(st) == _stats(ref_st)


def test_lenet_opt_matches_reference_pallas_engine():
    ref_cfg, cfg = _cfgs("lenet", 64)
    layouts = ref_network.plan_network(ref_cfg, "opt")
    assert "CHWN" in layouts and layouts[0] == "CHWN"
    tree, x = _inputs(cfg, seed=5)
    ref_y, ref_st = ref_network.forward(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x), ref_cfg, layouts,
        impl="pallas", interpret=True, use_pallas_transform=True)
    y, st = forward(params_from_numpy(tree, "cpu"), torch.from_numpy(x), cfg,
                    layouts, impl="cuda")
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), rtol=0,
                               atol=PROB_ATOL)
    assert _stats(st) == _stats(ref_st) and st.transforms >= 1


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_relayouts_reach_the_transpose_wrapper_on_the_cuda_engine(
        impl, monkeypatch):
    """The "cuda" engine hands every re-layout to K9a's wrapper (which runs
    its plain version only because the tensor is on the CPU); the "torch"
    engine never does."""
    calls = []
    real = tr_ops.transpose2d

    def spy(x):
        calls.append(tuple(x.shape))
        return real(x)

    monkeypatch.setattr(tr_ops, "transpose2d", spy)
    _, cfg = _cfgs("vgg16", 3)
    tree, x = _inputs(cfg)
    layouts = ["CHWN" if i % 3 else "NCHW" for i in range(len(cfg.layers))]
    _, st = forward(params_from_numpy(tree, "cpu"), torch.from_numpy(x),
                    cfg, layouts, impl=impl)
    assert st.transforms >= 2
    assert len(calls) == (st.transforms if impl == "cuda" else 0)


@pytest.mark.parametrize("network", sorted(PACKAGED))
def test_opt_layouts_from_packaged_plans_match_reference_dp(network):
    b = 1
    while b <= PACKAGED[network]:
        ref_cfg = CNN_CONFIGS[network].replace(batch=b)
        cfg = port_networks.CNN_CONFIGS[network].replace(batch=b)
        assert (plan_network(cfg, "opt")
                == ref_network.plan_network(ref_cfg, "opt")), b
        b *= 2


def test_opt_layouts_at_the_smoke_batches():
    vgg = port_networks.CNN_CONFIGS["vgg16"]
    alex = port_networks.CNN_CONFIGS["alexnet"]
    assert "".join(l[0] for l in plan_network(vgg, "opt")) == (
        "C" * 17 + "N" * 5 + "CC" + "N" * 5 + "C" * 9)
    assert plan_network(alex, "opt") == ["CHWN"] * len(alex.layers)
    assert plan_network(vgg, "cudnn") == ["NCHW"] * len(vgg.layers)
    assert plan_network(alex, "cuda-convnet") == ["CHWN"] * len(alex.layers)


@pytest.mark.parametrize("ct,nt", THRESHOLDS)
@pytest.mark.parametrize("network", NETWORKS)
def test_heuristic_layouts_match_reference(network, ct, nt):
    for batch in (3, 64):
        ref_cfg, cfg = _cfgs(network, batch)
        want = paper_heuristic_layouts(
            ref_network.network_descs(ref_cfg), RefThresholds(ct, nt))
        assert plan_network(cfg, "opt", Thresholds(ct, nt),
                            use_dp=False) == want


@pytest.mark.parametrize("network", NETWORKS)
def test_network_descs_match_reference(network):
    for dtype in ("float32", "bf16"):
        assert (repr(network_descs(port_networks.CNN_CONFIGS[network],
                                   dtype))
                == repr(ref_network.network_descs(CNN_CONFIGS[network],
                                                  dtype)))


def test_what_the_port_cannot_plan_or_run_raises():
    vgg = port_networks.CNN_CONFIGS["vgg16"]
    assert not packaged_plans("lenet").exists()
    for cfg, kw in [(port_networks.CNN_CONFIGS["lenet"], {}),
                    (vgg.replace(batch=3), {}), (vgg.replace(batch=64), {}),
                    (vgg, {"dtype": "bf16"}),
                    (port_networks.reduced_cnn(vgg, batch=4), {})]:
        with pytest.raises(PlanMissError):
            plan_network(cfg, "opt", **kw)
    with pytest.raises(ValueError, match="thresholds"):
        plan_network(vgg, "opt", use_dp=False)
    with pytest.raises(ValueError, match="unknown mode"):
        plan_network(vgg, "fastest")
