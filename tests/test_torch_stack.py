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


# -- (d) K5a's cluster tiling (pure Python, the kernel's own arithmetic) ----

def _packaged_chwn_stacks(network):
    """(bucket, stack shape) of every CHWN stack in the packaged
    stack="auto" plans of ``network``, at every bucket the file holds."""
    from repro_torch.cnn.layers import layer_shapes, resolved_cfg_inputs
    from repro_torch.serve.plan_cache import PlanCache, packaged_plans
    cache = PlanCache(str(packaged_plans(network)))
    out = []
    b = cache.min_bucket
    while b <= cache.max_bucket:
        cfg = port_networks.CNN_CONFIGS[network].replace(batch=b)
        plan = cache.peek_fused(cfg, b, stack="auto")
        if plan is not None:
            shapes, rins = layer_shapes(cfg), resolved_cfg_inputs(cfg)
            for op in plan.ops:
                if op.kind != "conv" or op.stack_index is None \
                        or op.layout != "CHWN":
                    continue
                s1, s2 = cfg.layers[op.index], cfg.layers[op.stack_index]
                p = rins[op.index][0]
                _, ci, h, _ = input_shape(cfg) if p < 0 else shapes[p]
                pool = None
                if op.pool_index is not None:
                    ps = cfg.layers[op.pool_index]
                    pool = (ps.kernel, ps.stride, ps.pool_op)
                out.append((b, (b, ci, h, h, s1.out_channels, s1.kernel,
                                s1.stride, s1.pad, s2.out_channels,
                                s2.kernel, s2.stride, s2.pad, pool)))
        b *= 2
    return out


def _kernel_work(shape, t):
    """FLOPs ``cluster_stack_kernel`` executes at tiling ``t``, counted
    block by block as the kernel runs them (make_tile's clipped box, each
    rank's range of it in whole 64-position passes, conv1 passes of 128
    positions and a 64-wide tail, kBK-deep slices) -- independent of
    ``stack_tiling``'s grouped count."""
    N, Ci, H, W, Cm, F1, S1, P1, Co, F2, S2, P2, pool = shape
    Ho1, Wo1 = (H + 2 * P1 - F1) // S1 + 1, (W + 2 * P1 - F1) // S1 + 1
    Ho2, Wo2 = (Ho1 + 2 * P2 - F2) // S2 + 1, (Wo1 + 2 * P2 - F2) // S2 + 1
    pF, pS = (pool[0], pool[1]) if pool else (0, 0)
    UH, UW = (((Ho2 - pF) // pS + 1, (Wo2 - pF) // pS + 1) if pool
              else (Ho2, Wo2))
    BK, CM = 16, 64

    def span(o0, on, M1):
        m0, m1 = o0 * S2 - P2, (o0 + on - 1) * S2 - P2 + F2
        return max(0, min(m1, M1) - max(m0, 0))

    groups = -(-(-(-Co // t.bm)) // t.cluster)
    nsl1 = -(-(Ci * F1 * F1) // BK)
    total = 0
    for n0 in range(0, N, t.nb):
        for uh0 in range(0, UH, t.uth):
            for uw0 in range(0, UW, t.utw):
                nbc = min(t.nb, N - n0)
                uhn, uwn = min(t.uth, UH - uh0), min(t.utw, UW - uw0)
                if pool:
                    mh = span(uh0 * pS, (uhn - 1) * pS + pF, Ho1)
                    mw = span(uw0 * pS, (uwn - 1) * pS + pF, Wo1)
                else:
                    mh, mw = span(uh0, uhn, Ho1), span(uw0, uwn, Wo1)
                ra = nbc * mh * mw
                rr = (-(-ra // t.cluster) + 63) // 64 * 64
                for _ in range(groups):
                    for rank in range(t.cluster):
                        lo = min(ra, rank * rr)
                        hi = min(ra, lo + rr)
                        for cm0 in range(0, Cm, CM):
                            cmn = min(CM, Cm - cm0)
                            p0 = lo
                            while p0 < hi:          # 128 wide, a 64 tail
                                width = 128 if hi - p0 > 64 else 64
                                total += CM * width * nsl1 * BK
                                p0 += width
                            total += (t.bm * (16384 // t.bm)
                                      * -(-(cmn * F2 * F2) // BK) * BK)
    return 2 * total


# synthetic CHWN stacks beside the packaged ones: the card tests' shapes
# (N < 8, Co 130 / 40, pools, a stride-2 conv1), a deep Co and a large map
SYNTHETIC_CHWN = [
    (16, 256, 13, 13, 384, 3, 1, 1, 384, 3, 1, 1, None),
    (5, 7, 11, 11, 70, 3, 1, 1, 130, 3, 1, 1, None),
    (9, 6, 17, 17, 33, 3, 2, 1, 40, 3, 1, 1, None),
    (3, 3, 5, 5, 5, 3, 1, 0, 7, 3, 1, 0, None),
    (4, 16, 12, 12, 24, 3, 1, 1, 40, 3, 1, 1, (2, 2, "max")),
    (12, 8, 15, 15, 20, 3, 1, 1, 130, 3, 1, 1, (3, 2, "max")),
    (8, 9, 10, 10, 12, 3, 1, 1, 9, 3, 2, 2, (2, 2, "avg")),
    (32, 64, 28, 28, 96, 3, 1, 1, 2304, 3, 1, 1, None),
    (64, 32, 56, 56, 64, 3, 1, 1, 64, 3, 1, 1, (2, 2, "max")),
]


def _check_cluster_tiling(shape):
    t = conv_ops.stack_tiling("CHWN", *shape)
    N, Co = shape[0], shape[8]
    co_tiles = -(-Co // t.bm)
    groups = -(-co_tiles // t.cluster)
    grid_y = t.cluster * groups
    assert 1 <= t.cluster <= 8
    assert grid_y % t.cluster == 0 and grid_y * t.bm >= Co
    assert groups == -(-co_tiles // 8)         # one cluster covers Co if it can
    assert t.blocks % grid_y == 0
    assert t.smem_bytes <= conv_ops.SMEM_PER_BLOCK
    assert t.nb >= min(8, N) or t.nb * t.uth * t.utw > 0
    assert t.executed_flops >= t.direct_flops > 0
    assert t.executed_flops == _kernel_work(shape, t)
    return t


@pytest.mark.parametrize("network", ["alexnet", "vgg16", "resnet18"])
def test_cluster_tiling_of_every_packaged_chwn_stack(network):
    stacks = _packaged_chwn_stacks(network)
    if network == "alexnet":
        assert [b for b, _ in stacks] == [128]    # conv3 -> conv4 at b128
    for _, shape in stacks:
        _check_cluster_tiling(shape)


@pytest.mark.parametrize("shape", SYNTHETIC_CHWN, ids=str)
def test_cluster_tiling_prices_the_kernel_exactly(shape):
    t = _check_cluster_tiling(shape)
    if shape[0] >= 8:
        assert t.nb >= 8                       # gathers run along n


def test_alexnet_conv3_conv4_executes_at_most_twice_the_direct_work():
    (_, shape), = _packaged_chwn_stacks("alexnet")
    t = conv_ops.stack_tiling("CHWN", *shape)
    assert t.cluster * t.bm >= 384 and t.cluster > 1
    # a tile that recomputes conv1 once per Co slice executes 4.15x
    assert t.executed_flops / t.direct_flops <= 2.0


def test_nchw_stack_tiling_pins_the_vgg16_conv1_tile():
    """K5b runs without a cluster (beside K5a's cluster kernel), and its
    tile on VGG16 conv1_1 -> conv1_2 at batch 32 is pinned: 64 output channels by 6 x 8 pooled outputs (12 x 16 conv2
    outputs of one image, 192 of the tile's 256 columns); one 8-channel
    group of the 3-channel input a phase-A stage; 1.112x the direct FLOPs
    (conv1 on the 14 x 18 halo box, its 3 input channels padded to 8)."""
    t = conv_ops.stack_tiling("NCHW", 32, 3, 224, 224, 64, 3, 1, 1, 64, 3,
                              1, 1, (2, 2, "max"))
    assert t.cluster == 1
    assert (t.bm, t.nb, t.uth, t.utw) == (64, 1, 6, 8)
    assert conv_ops.k5b_layout(3, 3, 1, 3, 1, 2, 2, 64, 1, 6, 8) == (
        1, t.smem_bytes)
    assert t.blocks == 32 * 19 * 14
    assert round(t.executed_flops / t.direct_flops, 3) == 1.112
