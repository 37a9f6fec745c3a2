"""Port conv->conv stacks (K5a CHWN, K5b NCHW) against the reference.

(a) The same seeded numpy inputs go through the reference's
``repro.cnn.layers.fused_conv_stack`` (``impl="pallas"`` in interpret mode
and ``impl="xla"``) and through the port: its plain version
``conv_stack_ref``, both wrappers' CPU path, and its ``fused_conv_stack``
with either engine.  Every case of ``tests/test_stack_fusion.py::CASES``
runs on both engines, plus cases with the residual in the other layout,
src/dst layout folds, a stride-2 conv1 and biases.  Tolerance atol 1e-5,
the reference test's own.
(b) The port's ``forward_fused`` on the reference planner's
``stack_policy="auto"`` plans against the reference ``forward_fused``
(``impl="xla"``): probabilities within 1e-5, ``RunStats`` equal.
(c) The wrappers reject bad shapes and launch nothing on the CPU; a tile
that no block's shared memory holds raises.

``test_torch_kernels_card.py`` holds the CUDA kernels against
``conv_stack_ref`` on the card.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cnn import layers as ref_layers
from repro.cnn.network import forward_fused as ref_forward_fused
from repro.cnn.network import plan_network_fused
from repro.configs.cnn_networks import CNN_CONFIGS, reduced_cnn
from repro.kernels.conv import ops as ref_ops

from repro_torch.cnn import layers as port_layers
from repro_torch.cnn.layers import init_cnn, params_from_numpy
from repro_torch.cnn.network import forward_fused, input_shape
from repro_torch.configs import cnn_networks as port_networks
from repro_torch.core.layout import perm_between
from repro_torch.kernels.conv import ops as conv_ops
from repro_torch.kernels.conv.ref import conv_stack_ref
from repro_torch.serve.plan_cache import _plan_from_obj
from tests.test_stack_fusion import CASES as REF_CASES

ATOL = 1e-5
PROB_ATOL = 1e-5
OTHER = {"NCHW": "CHWN", "CHWN": "NCHW"}

# name -> (H, Ci, Cm, Co, F1, S1, P1, F2, S2, P2, pool, res), as
# test_stack_fusion.CASES, plus how the case departs from the engine's own
# layout: (res in the other layout, src other, dst other, biases)
EXTRA = {
    "res_other_layout": ((8, 3, 5, 7, 3, 1, 1, 3, 1, 1, None, True),
                         (True, False, False, False)),
    "src_dst_folds":    ((9, 4, 6, 5, 3, 1, 1, 3, 1, 1, (2, 2, "max"),
                          False), (False, True, True, False)),
    "s1_2_res_other":   ((11, 3, 5, 7, 3, 2, 1, 3, 1, 1, None, True),
                         (True, True, False, False)),
    "biases_avg_pool":  ((8, 3, 5, 7, 3, 1, 1, 3, 1, 1, (2, 2, "avg"),
                          True), (False, False, True, True)),
}
CASES = [(name, spec, (False, False, False, False))
         for name, spec in sorted(REF_CASES.items())]
CASES += [(name, spec, how) for name, (spec, how) in EXTRA.items()]


def _to(layout: str, a_nchw: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a_nchw.transpose(perm_between("NCHW",
                                                              layout)))


def _inputs(layout, spec, how, seed):
    H, Ci, Cm, Co, F1, S1, P1, F2, S2, P2, pool, want_res = spec
    res_other, src_other, dst_other, biases = how
    rng = np.random.default_rng(seed)
    N = 2
    x = rng.standard_normal((N, Ci, H, H), np.float32)
    w1 = (rng.standard_normal((Cm, Ci, F1, F1), np.float32)
          * np.float32(0.2))
    w2 = (rng.standard_normal((Co, Cm, F2, F2), np.float32)
          * np.float32(0.2))
    Ho1 = (H + 2 * P1 - F1) // S1 + 1
    Ho2 = (Ho1 + 2 * P2 - F2) // S2 + 1
    rlay = OTHER[layout] if res_other else layout
    res = (_to(rlay, rng.standard_normal((N, Co, Ho2, Ho2), np.float32))
           if want_res else None)
    b1 = rng.standard_normal((Cm,), np.float32) if biases else None
    b2 = rng.standard_normal((Co,), np.float32) if biases else None
    src = OTHER[layout] if src_other else layout
    dst = OTHER[layout] if dst_other else layout
    return dict(x=_to(src, x), w1=w1, w2=w2, b1=b1, b2=b2, res=res,
                rlay=rlay, src=src, dst=dst, S1=S1, P1=P1, S2=S2, P2=P2,
                pool=pool)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _reference(layout, d, impl):
    """The reference stack: ``fused_conv_stack`` without biases (as its
    executor calls it), the ops-level wrapper with them."""
    if d["b1"] is None:
        return np.asarray(ref_layers.fused_conv_stack(
            _j(d["x"]), _j(d["w1"]), _j(d["w2"]), layout, d["S1"], d["P1"],
            d["S2"], d["P2"], relu1=True, relu2=True, pool=d["pool"],
            res=_j(d["res"]), res_layout=d["rlay"], src_layout=d["src"],
            dst_layout=d["dst"], nt=2, impl=impl))
    assert impl == "pallas"
    w1, w2 = _j(d["w1"]), _j(d["w2"])
    kw = dict(bias1=_j(d["b1"]), bias2=_j(d["b2"]), relu1=True, relu2=True,
              pool=d["pool"], res=_j(d["res"]), res_layout=d["rlay"],
              src_layout=d["src"], dst_layout=d["dst"])
    if layout == "CHWN":
        return np.asarray(ref_ops.conv_stack_chwn(
            _j(d["x"]), jnp.transpose(w1, (1, 2, 3, 0)),
            jnp.transpose(w2, (1, 2, 3, 0)), d["S1"], d["P1"], d["S2"],
            d["P2"], 2, True, **kw))
    return np.asarray(ref_ops.conv_stack_nchw(
        _j(d["x"]), w1, w2, d["S1"], d["P1"], d["S2"], d["P2"], True, **kw))


def _port_wrapper(layout, d):
    kw = dict(bias1=_t(d["b1"]), bias2=_t(d["b2"]), relu1=True, relu2=True,
              pool=d["pool"], res=_t(d["res"]), res_layout=d["rlay"],
              src_layout=d["src"], dst_layout=d["dst"])
    args = (d["S1"], d["P1"], d["S2"], d["P2"])
    if layout == "CHWN":
        return conv_ops.conv_stack_chwn(
            _t(d["x"]), _t(d["w1"]).permute(1, 2, 3, 0).contiguous(),
            _t(d["w2"]).permute(1, 2, 3, 0).contiguous(), *args, **kw)
    return conv_ops.conv_stack_nchw(_t(d["x"]), _t(d["w1"]), _t(d["w2"]),
                                    *args, **kw)


@pytest.mark.parametrize("layout", ["CHWN", "NCHW"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_stack_matches_reference(layout, case):
    name, spec, how = case
    d = _inputs(layout, spec, how, seed=CASES.index(case))
    want = _reference(layout, d, "pallas")
    plain = conv_stack_ref(
        _t(d["x"]), _t(d["w1"]), _t(d["w2"]), d["S1"], d["P1"], d["S2"],
        d["P2"], bias1=_t(d["b1"]), bias2=_t(d["b2"]), relu1=True,
        relu2=True, pool=d["pool"], res=_t(d["res"]), res_layout=d["rlay"],
        src_layout=d["src"], dst_layout=d["dst"]).numpy()
    assert plain.shape == want.shape
    np.testing.assert_allclose(plain, want, rtol=0, atol=ATOL)
    got = _port_wrapper(layout, d).numpy()
    np.testing.assert_array_equal(got, plain)
    if d["b1"] is None:
        np.testing.assert_allclose(plain, _reference(layout, d, "xla"),
                                   rtol=0, atol=ATOL)
        for impl in ("cuda", "torch"):
            y = port_layers.fused_conv_stack(
                _t(d["x"]), _t(d["w1"]), _t(d["w2"]), layout, d["S1"],
                d["P1"], d["S2"], d["P2"], relu1=True, relu2=True,
                pool=d["pool"], res=_t(d["res"]), res_layout=d["rlay"],
                src_layout=d["src"], dst_layout=d["dst"], impl=impl)
            np.testing.assert_allclose(y.numpy(), want, rtol=0, atol=ATOL)


# -- (b) whole stacked plans -------------------------------------------------

FORWARD_CASES = [("vgg16", 3), ("resnet18", 3), ("resnet18", 64),
                 ("lenet", 3)]


def _stacked_setup(network: str, batch: int, seed: int = 0):
    ref_cfg = reduced_cnn(CNN_CONFIGS[network], batch=batch)
    cfg = port_networks.reduced_cnn(port_networks.CNN_CONFIGS[network],
                                    batch=batch)
    ref_plan = plan_network_fused(ref_cfg, stack_policy="auto")
    plan = _plan_from_obj(dataclasses.asdict(ref_plan))
    tree = init_cnn(cfg, seed)
    x = np.random.default_rng(seed + 1).standard_normal(
        input_shape(cfg), np.float32)
    return ref_cfg, ref_plan, cfg, plan, tree, x


@pytest.mark.parametrize("network,batch", FORWARD_CASES,
                         ids=[f"{n}-b{b}" for n, b in FORWARD_CASES])
def test_forward_fused_on_stacked_plans_matches_reference(network, batch):
    ref_cfg, ref_plan, cfg, plan, tree, x = _stacked_setup(network, batch)
    if network != "lenet":           # lenet has no profitable pair
        assert plan.stacked_convs > 0
    if (network, batch) == ("resnet18", 64):
        stacks = [op for op in plan.ops if op.stack_index is not None]
        assert any(op.layout == "CHWN" for op in stacks)
        # a CHWN input folded into an NCHW stack (l2b2_convA)
        assert any(op.src_layout == "CHWN" and op.layout == "NCHW"
                   for op in stacks)
    ref_y, ref_st = ref_forward_fused(jax.tree.map(jnp.asarray, tree),
                                      jnp.asarray(x), ref_cfg, ref_plan,
                                      impl="xla")
    before = (conv_ops.conv_stack_chwn.launches,
              conv_ops.conv_stack_nchw.launches)
    for impl in ("cuda", "torch"):
        y, st = forward_fused(params_from_numpy(tree, "cpu"),
                              torch.from_numpy(x), cfg, plan, impl=impl)
        np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), rtol=0,
                                   atol=PROB_ATOL)
        assert dataclasses.astuple(st) == (ref_st.transforms,
                                           ref_st.transform_bytes,
                                           ref_st.fused_ops,
                                           ref_st.hbm_bytes,
                                           ref_st.bwd_hbm_bytes)
    assert (conv_ops.conv_stack_chwn.launches,
            conv_ops.conv_stack_nchw.launches) == before


# -- (c) what the wrappers refuse -------------------------------------------

def test_stack_wrappers_reject_bad_shapes():
    x = torch.zeros(2, 3, 8, 8)
    w1, w2 = torch.zeros(5, 3, 3, 3), torch.zeros(7, 5, 3, 3)
    with pytest.raises(ValueError, match="w2 takes"):
        conv_ops.conv_stack_nchw(x, w1, torch.zeros(7, 4, 3, 3))
    with pytest.raises(ValueError, match="channels"):
        conv_ops.conv_stack_nchw(torch.zeros(2, 4, 8, 8), w1, w2)
    with pytest.raises(ValueError, match="does not fit"):
        conv_ops.conv_stack_nchw(torch.zeros(2, 3, 3, 3), w1, w2)
    with pytest.raises(ValueError, match="bias1"):
        conv_ops.conv_stack_nchw(x, w1, w2, 1, 1, 1, 1,
                                 bias1=torch.zeros(7))
    with pytest.raises(ValueError, match="res shape"):
        conv_ops.conv_stack_nchw(x, w1, w2, 1, 1, 1, 1,
                                 res=torch.zeros(2, 7, 7, 7))
    with pytest.raises(ValueError, match="res_layout"):
        conv_ops.conv_stack_nchw(x, w1, w2, res_layout="NHWC")
    with pytest.raises(ValueError, match="w1/w2"):
        conv_ops.conv_stack_chwn(x, torch.zeros(3, 3), w2)
    with pytest.raises(ValueError, match="not supported"):
        conv_ops.conv_stack_nchw(x.to("meta"), w1.to("meta"),
                                 w2.to("meta"))


def test_stack_tiling_over_shared_memory_raises():
    # an 11x11 pool over an 11x11 stride-4 conv2: one pooled output needs a
    # 51x51 mid box, 64 channels of which are 666 KB
    with pytest.raises(ValueError, match="shared memory"):
        conv_ops.stack_tiling("NCHW", 1, 3, 200, 200, 8, 3, 1, 1, 8, 11, 4,
                              0, (11, 1, "max"))
    t = conv_ops.stack_tiling("NCHW", 32, 3, 224, 224, 64, 3, 1, 1, 64, 3,
                              1, 1, (2, 2, "max"))
    assert t.smem_bytes <= conv_ops.SMEM_PER_BLOCK
    assert t.executed_flops >= t.direct_flops > 0


def test_cpu_stack_wrappers_launch_nothing():
    before = (conv_ops.conv_stack_chwn.launches,
              conv_ops.conv_stack_nchw.launches)
    d = _inputs("NCHW", REF_CASES["base_3x3"], (False,) * 4, 0)
    _port_wrapper("NCHW", d)
    _port_wrapper("CHWN", _inputs("CHWN", REF_CASES["base_3x3"],
                                  (False,) * 4, 0))
    assert (conv_ops.conv_stack_chwn.launches,
            conv_ops.conv_stack_nchw.launches) == before
