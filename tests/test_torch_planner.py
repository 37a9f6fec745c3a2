"""The port's cost model (``repro_torch.perfmodel``) against the reference's.

Under a ``Hardware`` profile built from the reference's own constants
(``reference_hardware``: the v5e peak and bandwidth of
``repro.launch.mesh``, the lane/sublane tiling, coalescing span and stack
budget of ``repro.perfmodel.traffic``, the geometry of
``repro.kernels.conv.ops.stack_blocking``) every byte and seconds model
equals the reference's exactly, on the Table-1 layers and on the conv
layers of every network in ``CNN_CONFIGS``; so do ``calibrate``,
``cross_validate`` with a fake measure, ``CalibratedCostModel`` and
``plan_bytes``.  The port's default profile is the H100's, and its card
measure refuses the CPU.
"""
from __future__ import annotations

import dataclasses
import json

import pytest

from repro.configs.cnn_networks import CNN_CONFIGS
from repro.configs.paper_table1 import CONV_LAYERS as REF_CONV_LAYERS
from repro.configs.paper_table1 import ConvLayer as RefConvLayer
from repro.core.selector import plan_fused as ref_plan_fused
from repro.cnn.network import input_shape as ref_input_shape
from repro.cnn.network import network_descs as ref_network_descs
from repro.cnn.network import plan_network_fused as ref_plan_network_fused
from repro.kernels.conv.ops import stack_blocking as ref_stack_blocking
from repro.launch.mesh import HBM_BW, PEAK_FLOPS_BF16
from repro import perfmodel as ref_pm
from repro.perfmodel import traffic as ref_traffic
from repro.perfmodel.calibration import proxied_layer as ref_proxied_layer

from repro_torch import perfmodel as pm
from repro_torch.cnn.network import (input_shape, network_descs,
                                     plan_network_fused)
from repro_torch.configs import cnn_networks as port_networks
from repro_torch.configs.paper_table1 import ConvLayer
from repro_torch.core.selector import plan_fused
from repro_torch.kernels.conv.ops import stack_tiling
from repro_torch.perfmodel import traffic

DTYPE_BYTES = (4, 2, 1)


def reference_hardware() -> pm.Hardware:
    """The reference's device, as a port profile, from its own constants."""
    return pm.Hardware(
        name="reference (TPU v5e model)",
        peak_flops=tuple((b, PEAK_FLOPS_BF16) for b in DTYPE_BYTES),
        mem_bw=HBM_BW,
        minor=tuple((b, ref_traffic.LANES) for b in DTYPE_BYTES),
        second_minor=tuple(sorted(ref_traffic._SUBLANES.items())),
        co_block=ref_traffic.LANES,
        span_bytes=ref_traffic.LANES * 2,
        stack_gate="budget",
        stack_budget=ref_traffic.STACK_VMEM_BUDGET,
        stack_blocking=ref_stack_blocking)


REF_HW = reference_hardware()


def port_layer(l: RefConvLayer) -> ConvLayer:
    return ConvLayer(**dataclasses.asdict(l))


def _network_convs():
    """The reference's conv layers of every network, and its pairs of
    consecutive convs whose shapes chain."""
    convs, pairs = [], []
    for cfg in CNN_CONFIGS.values():
        descs = [d for d in ref_network_descs(cfg) if d.kind == "conv"]
        convs += [d.conv for d in descs]
        pairs += [(a.conv, b.conv) for a, b in zip(descs, descs[1:])
                  if b.conv.Ci == a.conv.Co and b.conv.HW == a.conv.out_hw]
    return convs, pairs


NET_CONVS, NET_PAIRS = _network_convs()
LAYERS = list(REF_CONV_LAYERS) + NET_CONVS
POOLS = [None, (2, 2), (3, 2)]


def test_the_reference_profile_is_the_reference_constants():
    assert REF_HW.peak(2) == PEAK_FLOPS_BF16 and REF_HW.mem_bw == HBM_BW
    for db in DTYPE_BYTES:
        assert REF_HW.second_minor_granule(db) == ref_traffic.sublanes(db)
    # an element size no profile prices raises, as the reference's does
    for hw in (REF_HW, None):
        with pytest.raises(ValueError, match="dtype_bytes=8"):
            traffic.tile_utilization((3, 3), 8, hw)
    with pytest.raises(ValueError):
        ref_traffic.tile_utilization((3, 3), 8)
    with pytest.raises(ValueError, match="stack gate"):
        dataclasses.replace(REF_HW, stack_gate="vmem")


@pytest.mark.parametrize("db", DTYPE_BYTES)
def test_conv_costs_match_reference(db):
    for ref_l in LAYERS:
        l = port_layer(ref_l)
        for shape in ((ref_l.Ci * ref_l.F ** 2, ref_l.N), (ref_l.N,), ()):
            assert (traffic.tile_utilization(shape, db, REF_HW)
                    == ref_traffic.tile_utilization(shape, db))
        assert traffic.conv_flops(l) == ref_traffic.conv_flops(ref_l)
        for lay in ("CHWN", "NCHW"):
            for packed in (True, False):
                got = traffic.conv_cost(l, lay, db, REF_HW,
                                        packed_span=packed)
                want = ref_traffic.conv_cost(ref_l, lay, db,
                                             packed_span=packed)
                assert (got.layout, got.compute_s, got.memory_s) == (
                    want.layout, want.compute_s, want.memory_s)
            got = traffic.conv_backward_cost(l, lay, db, relu=True,
                                             pool=(2, 2), hw=REF_HW)
            want = ref_traffic.conv_backward_cost(ref_l, lay, db, relu=True,
                                                  pool=(2, 2))
            assert (got.compute_s, got.memory_s) == (want.compute_s,
                                                     want.memory_s)
        assert (traffic.select_conv_layout_cost(l, db, REF_HW)
                == ref_traffic.select_conv_layout_cost(ref_l, db))
    with pytest.raises(ValueError):
        traffic.conv_cost(port_layer(LAYERS[0]), "NHWC", 4, REF_HW)


@pytest.mark.parametrize("db", DTYPE_BYTES)
def test_chain_and_backward_bytes_match_reference(db):
    for ref_l in LAYERS:
        l = port_layer(ref_l)
        for pool in POOLS:
            if pool and ref_l.out_hw < pool[0]:
                continue
            for relu in (False, True):
                for fused in (False, True):
                    for res in (False, True):
                        for io in ((None, None), (1, db), (db, 1)):
                            kw = dict(relu=relu, pool=pool, fused=fused,
                                      residual=res, in_dtype_bytes=io[0],
                                      out_dtype_bytes=io[1])
                            assert (traffic.chain_bytes(l, db, **kw)
                                    == ref_traffic.chain_bytes(ref_l, db,
                                                               **kw))
                    kw = dict(relu=relu, pool=pool, fused=fused)
                    assert (traffic.train_chain_bytes(l, "NCHW", db, **kw)
                            == ref_traffic.train_chain_bytes(ref_l, "NCHW",
                                                             db, **kw))
                got = traffic.fused_chain_cost(l, "CHWN", db, relu=relu,
                                               pool=pool, in_dtype_bytes=1,
                                               residual=True, hw=REF_HW)
                want = ref_traffic.fused_chain_cost(ref_l, "CHWN", db,
                                                    relu=relu, pool=pool,
                                                    in_dtype_bytes=1,
                                                    residual=True)
                assert (got.compute_s, got.memory_s) == (want.compute_s,
                                                         want.memory_s)
            assert (traffic.fusion_saved_bytes(l, db, relu=True, pool=pool)
                    == ref_traffic.fusion_saved_bytes(ref_l, db, relu=True,
                                                      pool=pool))


@pytest.mark.parametrize("db", DTYPE_BYTES)
def test_cast_models_match_reference(db):
    for ref_l in LAYERS:
        shape = (ref_l.N, ref_l.Ci, ref_l.HW, ref_l.HW)
        for dst in DTYPE_BYTES:
            assert (traffic.cast_bytes(shape, db, dst)
                    == ref_traffic.cast_bytes(shape, db, dst))
            assert (traffic.cast_cost(shape, db, dst, REF_HW)
                    == ref_traffic.cast_cost(shape, db, dst))
    assert traffic.cast_bytes((), 4, 1) == ref_traffic.cast_bytes((), 4, 1)


@pytest.mark.parametrize("db", DTYPE_BYTES)
def test_stack_models_match_reference(db):
    assert len(NET_PAIRS) > 20
    for ref_l1, ref_l2 in NET_PAIRS:
        l1, l2 = port_layer(ref_l1), port_layer(ref_l2)
        for pool in POOLS:
            if pool and ref_l2.out_hw < pool[0]:
                continue
            for lay in ("CHWN", "NCHW"):
                for res in (False, True):
                    kw = dict(pool=pool, residual=res, in_dtype_bytes=1)
                    assert (traffic.stack_vmem_bytes(l1, l2, lay, db,
                                                     hw=REF_HW, **kw)
                            == ref_traffic.stack_vmem_bytes(ref_l1, ref_l2,
                                                            lay, db, **kw))
                    assert (traffic.stack_nt(l1, l2, lay, db, hw=REF_HW,
                                             **kw)
                            == ref_traffic.stack_nt(ref_l1, ref_l2, lay, db,
                                                    **kw))
                    got = traffic.stack_fused_cost(l1, l2, lay, db,
                                                   out_dtype_bytes=1,
                                                   hw=REF_HW, **kw)
                    want = ref_traffic.stack_fused_cost(
                        ref_l1, ref_l2, lay, db, out_dtype_bytes=1, **kw)
                    assert (got.compute_s, got.memory_s) == (
                        want.compute_s, want.memory_s)
                    assert (traffic.stack_bytes(l1, l2, db,
                                                out_dtype_bytes=1, **kw)
                            == ref_traffic.stack_bytes(ref_l1, ref_l2, db,
                                                       out_dtype_bytes=1,
                                                       **kw))
            assert (traffic.stack_blocking(ref_l2.out_hw, ref_l1.F,
                                           ref_l1.S, ref_l2.F, ref_l2.S)
                    == ref_stack_blocking(ref_l2.out_hw, ref_l1.F, ref_l1.S,
                                          ref_l2.F, ref_l2.S))


def test_the_port_copy_of_stack_blocking_prices_like_the_reference():
    own = dataclasses.replace(REF_HW, stack_blocking=None)
    for ref_l1, ref_l2 in NET_PAIRS:
        l1, l2 = port_layer(ref_l1), port_layer(ref_l2)
        for lay in ("CHWN", "NCHW"):
            assert (traffic.stack_fused_cost(l1, l2, lay, 4, hw=own)
                    == traffic.stack_fused_cost(l1, l2, lay, 4, hw=REF_HW))
            assert (traffic.stack_nt(l1, l2, lay, 4, pool=(2, 2), hw=own)
                    == traffic.stack_nt(l1, l2, lay, 4, pool=(2, 2),
                                        hw=REF_HW))


@pytest.mark.parametrize("db", DTYPE_BYTES)
def test_calibrate_matches_reference(db):
    assert pm.calibrate(dtype_bytes=db, hw=REF_HW) == pm.Thresholds(
        **dataclasses.asdict(ref_pm.calibrate(dtype_bytes=db)))
    base = ConvLayer("CAL", 32, 96, 27, 5, 48, 1, "cal")
    ref_base = RefConvLayer("CAL", 32, 96, 27, 5, 48, 1, "cal")
    assert (dataclasses.asdict(pm.calibrate(base=base, dtype_bytes=db,
                                            hw=REF_HW))
            == dataclasses.asdict(ref_pm.calibrate(base=ref_base,
                                                   dtype_bytes=db)))


def test_calibrate_follows_the_measure_callback():
    seen = []

    def measure(l, lay):       # NCHW wins from Ci 16, CHWN from N 256
        seen.append((l.N, l.Ci, lay))
        if l.N == 64:
            return 1.0 if (lay == "NCHW") == (l.Ci >= 16) else 2.0
        return 1.0 if (lay == "CHWN") == (l.N >= 256) else 2.0

    assert pm.calibrate(measure=measure) == pm.Thresholds(16, 256)
    assert (seen[0][:2], seen[-1][:2]) == ((64, 1), (256, 256))


def _fake_measure(ref: bool, scale: float):
    """A measurement that is exactly ``scale`` x the reference model on the
    proxied layer (as the reference's own test builds it)."""
    def measure(l, layout):
        if ref:
            return scale * ref_traffic.conv_cost(ref_proxied_layer(l),
                                                 layout, 4).total_s
        return scale * traffic.conv_cost(pm.proxied_layer(l), layout, 4,
                                         REF_HW).total_s
    return measure


def test_cross_validate_and_the_calibrated_model_match_reference():
    want = ref_pm.cross_validate(_fake_measure(True, 2.5),
                                 hardware="fake-hw")
    got = pm.cross_validate(_fake_measure(False, 2.5), hardware="fake-hw",
                            hw=REF_HW)
    assert got.to_obj() == want.to_obj()
    assert len(got.points) == 12 and got.mean_rel_err < 1e-9
    cal = pm.CalibratedCostModel(got, REF_HW)
    ref_cal = ref_pm.CalibratedCostModel(want)
    l = ConvLayer("T", 64, 32, 14, 3, 16, 1, "t")
    ref_l = RefConvLayer("T", 64, 32, 14, 3, 16, 1, "t")
    for lay in ("CHWN", "NCHW"):
        assert cal.conv_cost(l, lay, 4) == pm.ConvCost(
            **dataclasses.asdict(ref_cal.conv_cost(ref_l, lay, 4)))
        assert cal.predict_seconds(1e-3, lay) == ref_cal.predict_seconds(
            1e-3, lay)
    assert cal.predict_seconds(1e-3, "other") == ref_cal.predict_seconds(
        1e-3, "other")
    assert cal.chain_bytes(l, 4) == ref_cal.chain_bytes(ref_l, 4)
    # plans under the calibrated model equal the reference's under its own
    for net in ("alexnet", "resnet18"):
        ref_cfg, cfg = CNN_CONFIGS[net], port_networks.CNN_CONFIGS[net]
        for stack in ("auto", "off"):
            ref_plan = ref_plan_fused(
                ref_network_descs(ref_cfg), input_layout="NCHW",
                input_shape=ref_input_shape(ref_cfg), stack_policy=stack,
                cost_model=ref_cal)
            plan = plan_fused(network_descs(cfg), input_layout="NCHW",
                              input_shape=input_shape(cfg),
                              stack_policy=stack, cost_model=cal)
            assert dataclasses.asdict(plan) == dataclasses.asdict(ref_plan)


@pytest.mark.parametrize("net", sorted(CNN_CONFIGS))
def test_plan_bytes_matches_the_planner_and_reference(net):
    ref_cfg, cfg = CNN_CONFIGS[net], port_networks.CNN_CONFIGS[net]
    ref_cm = pm.AnalyticCostModel(REF_HW)
    for policy in ("uniform", "mixed"):
        for stack in ("auto", "off"):
            for cm in (ref_cm, pm.default_cost_model()):
                plan = plan_network_fused(cfg, policy=policy,
                                          stack_policy=stack, cost_model=cm)
                assert cm.plan_bytes(network_descs(cfg), plan,
                                     input_shape=input_shape(cfg)) == \
                    plan.fused_bytes
            ref_plan = ref_plan_network_fused(ref_cfg, policy=policy,
                                              stack_policy=stack)
            plan = plan_network_fused(cfg, policy=policy, stack_policy=stack,
                                      cost_model=ref_cm)
            for training in (False, True):
                assert ref_cm.plan_bytes(
                    network_descs(cfg), plan, input_shape=input_shape(cfg),
                    training=training) == \
                    ref_pm.default_cost_model().plan_bytes(
                        ref_network_descs(ref_cfg), ref_plan,
                        input_shape=ref_input_shape(ref_cfg),
                        training=training)


def test_threshold_rows_load_in_either_package(tmp_path):
    path = str(tmp_path / "th.json")
    pm.save_thresholds(pm.Thresholds(32, 64), path, dtype="f32",
                       hardware="NVIDIA H100 80GB HBM3")
    ref_pm.save_thresholds(ref_pm.Thresholds(16, 128), path, dtype="bf16",
                           hardware="TPU v5e")
    assert (pm.load_thresholds(path, "bf16", hardware="TPU v5e")
            == pm.Thresholds(16, 128))
    assert (ref_pm.load_thresholds(path, "f32",
                                   hardware="NVIDIA H100 80GB HBM3")
            == ref_pm.Thresholds(32, 64))
    obj = json.load(open(path))
    assert obj["version"] == 3 and set(obj["hardware"]) == {
        "NVIDIA H100 80GB HBM3", "TPU v5e"}
    # legacy flat and per-dtype files load as the default row
    p1 = str(tmp_path / "v1.json")
    json.dump({"Ct": 8, "Nt": 32}, open(p1, "w"))
    assert pm.load_thresholds(p1, "f32", hardware="x") == pm.Thresholds(8, 32)
    p2 = str(tmp_path / "v2.json")
    json.dump({"version": 2, "rows": {"bf16": {"Ct": 4, "Nt": 16}}},
              open(p2, "w"))
    assert pm.load_thresholds(p2, "bfloat16") == pm.Thresholds(4, 16)
    with pytest.raises(KeyError):
        pm.load_thresholds(p2, "f32")
    # measured_thresholds reads a persisted row before it measures
    assert pm.measured_thresholds(path, dtype="bf16",
                                  hardware="TPU v5e") == pm.Thresholds(16, 128)
    calls = []
    th = pm.measured_thresholds(
        path, dtype="f32", hardware="cpu", force=True,
        measure=lambda l, lay: calls.append(lay) or (1.0 if lay == "CHWN"
                                                     else 2.0))
    assert th == pm.Thresholds(512, 16) and calls
    assert pm.load_thresholds(path, "f32", hardware="cpu") == th


def test_h100_profile_and_hardware_id():
    hw = pm.default_hardware()
    assert hw.name == "NVIDIA H100 80GB HBM3"
    assert (hw.mem_bw, hw.peak(2), hw.peak(4)) == (3.35e12, 989e12,
                                                   495e12 / 3)
    assert hw.stack_gate == "smem" and hw.span_bytes == 128
    assert pm.default_cost_model().hw == hw
    assert pm.hardware_id("cpu") == "cpu"
    # the reference's constants stay out of the port's default profile
    assert hw.mem_bw != HBM_BW and hw.peak(2) != PEAK_FLOPS_BF16
    th = pm.calibrate(dtype_bytes=4)
    assert th == pm.calibrate(dtype_bytes=4, hw=hw)


def test_h100_stack_gate_is_the_stack_kernels_tiling():
    hw = pm.default_hardware()
    seen = set()
    for ref_l1, ref_l2 in NET_PAIRS[:40]:
        l1, l2 = port_layer(ref_l1), port_layer(ref_l2)
        for lay in ("CHWN", "NCHW"):
            try:
                want = stack_tiling(lay, l1.N, l1.Ci, l1.HW, l1.HW, l1.Co,
                                    l1.F, l1.S, l1.pad, l2.Co, l2.F, l2.S,
                                    l2.pad, (2, 2, "max")).nb
            except ValueError:
                want = 0
            assert traffic.stack_nt(l1, l2, lay, 4, pool=(2, 2), hw=hw) == \
                want
            seen.add(want > 0)
    assert True in seen


def test_card_measure_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="CUDA device"):
        pm.card_conv_measure(device="cpu")


def test_h100_chain_gate_is_the_conv_kernels_tiling():
    """On the H100 profile a conv folds its pool only where K1's or K2's
    tile model has a tile: unet_mini's 32 x 32 global average pool fits
    neither, so it runs on its own; every other network's pools fold."""
    hw = pm.default_hardware()
    l = ConvLayer("dec1", 8, 8, 32, 3, 16, 1, "unet_mini", pad=1)
    for lay in ("CHWN", "NCHW"):
        assert not traffic.chain_fits(l, lay, (32, 32), hw)
        assert traffic.chain_fits(l, lay, None, hw)
        assert traffic.chain_fits(l, lay, (32, 32), REF_HW)
    plan = plan_network_fused(port_networks.CNN_CONFIGS["unet_mini"])
    gap = [op for op in plan.ops if op.name == "gap"]
    assert len(gap) == 1 and gap[0].kind == "pool"
    for net in ("lenet", "cifarnet", "alexnet", "zfnet", "vgg16"):
        plan = plan_network_fused(port_networks.CNN_CONFIGS[net],
                                  stack_policy="off")
        assert not any(op.kind == "pool" for op in plan.ops), net
